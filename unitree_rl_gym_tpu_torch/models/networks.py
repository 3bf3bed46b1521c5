"""Actor-critic networks (counterpart of ``unitree_rl_gym_tpu/models/
networks.py``: ``ActorCritic``, ``LSTMEncoder``, ``ActorCriticRecurrent``,
``reset_carry``, the Gaussian-policy helpers and ``build_network``),
rsl_rl's models: MLP actor and critic with a learned state-independent
log-std, and the recurrent variant whose actor and critic each read their
own LSTM memory (``memory_a``, ``memory_c``). The MLPs take any activation
of the JAX package's table (:data:`ACTIVATIONS`; ``crelu`` doubles the
width the next layer takes).

A network trained from scratch starts like Flax's defaults: lecun-normal
kernels (a normal cut at two standard deviations, std
sqrt(1/fan_in)/0.8796) and zero biases for ``Dense`` and for the LSTM's
input kernels, an orthogonal matrix for each recurrent gate kernel
(``OptimizedLSTMCell``), drawn from the caller's generator
(:func:`flax_init_`). ``dtype`` is the matmul compute type of the JAX
package's ``PolicyCfg.dtype``: parameters stay float32, the layers compute
in ``dtype`` and the heads return float32; the LSTM carry stays float32.

The recurrent carry is one float32 tensor ``[2, L, 2, N, H]``: memory
(actor, critic), layer, (c, h) as Flax's ``(c, h)`` carry, env, unit.

Weights come across from the JAX package by their Flax names
(``params/{actor,critic}/Dense_i/{kernel,bias}``, ``params/log_std`` and
``params/memory_{a,c}/lstm_l/{ii,if,ig,io}/kernel`` and
``{hi,hf,hg,ho}/{kernel,bias}``): from the exporter's ``policy_flat.npz``
(:func:`actor_critic_from_flat`), or from a live Flax param tree
(:func:`actor_critic_from_params`), or into an existing network to seed a
fine-tune (:func:`load_flat_params`, the counterpart of the JAX package's
``export.load_flat_params``).
"""

from __future__ import annotations

import copy
import json
import math
import os
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from unitree_rl_gym_tpu_torch.utils.profiling import span


class CReLU(nn.Module):
    """``crelu`` of the JAX package's table: relu(x) and relu(-x)
    concatenated on the last axis, so the layer after it takes twice the
    width."""

    def forward(self, x):
        return torch.cat((F.relu(x), F.relu(-x)), dim=-1)


# the JAX package's ``_ACTIVATIONS`` with Flax's constants: leaky_relu's
# slope 0.01 and selu's alpha and scale are torch's defaults too
ACTIVATIONS = {
    "elu": nn.ELU,
    "relu": nn.ReLU,
    "selu": nn.SELU,
    "crelu": CReLU,
    "lrelu": nn.LeakyReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
}
# the width an activation hands the next layer, per unit of its input
_WIDTH = {"crelu": 2}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

LOG2PI = math.log(2.0 * math.pi)
# std of the unit normal cut at +-2, which Flax's truncated-normal
# initialisers divide by (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``nn.Linear`` that computes in the dtype of its input (its float32
    parameters are cast to it), as a Flax ``Dense`` with ``dtype`` does."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def mlp(in_dim: int, hidden_dims: Sequence[int], out_dim: int,
        activation: str) -> nn.Sequential:
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation '{activation}' is not one of {sorted(ACTIVATIONS)}")
    layers, d = [], in_dim
    for h in hidden_dims:
        layers += [Dense(d, h), ACTIVATIONS[activation]()]
        d = h * _WIDTH.get(activation, 1)
    layers.append(Dense(d, out_dim))
    return nn.Sequential(*layers)


def _lecun_normal(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def flax_init_(module: nn.Module, generator: torch.Generator):
    """Flax's default init in place: every ``nn.Linear`` kernel and LSTM
    input kernel from a normal of std sqrt(1/fan_in)/0.8796 cut at two of
    those stds, each LSTM gate's recurrent kernel a random orthogonal
    matrix, biases zero."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal(m.weight, m.in_features, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LSTMCell):
                _lecun_normal(m.weight_ih, m.weight_ih.shape[1], generator)
                for w in m.weight_hh.chunk(4, dim=0):
                    nn.init.orthogonal_(w, generator=generator)
                nn.init.zeros_(m.bias_hh)


class _GaussianPolicy(nn.Module):
    """What both actor-critics share: the compute dtype, the learned
    log-std and the float32 inference copy."""

    is_recurrent = False

    def __init__(self, num_actions: int, init_noise_std: float, dtype: str):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"policy dtype must be one of {sorted(_DTYPES)}")
        self.dtype = dtype
        self.log_std = nn.Parameter(
            torch.full((num_actions,), float(np.log(init_noise_std)))
        )

    @property
    def _compute_dtype(self):
        """The torch dtype the heads and memories compute in."""
        return _DTYPES[self.dtype]

    def _head(self, seq, x):
        return seq(x.to(self._compute_dtype)).to(torch.float32)

    def inference_copy(self):
        """A float32 copy in eval mode (inference and export are float32;
        the bf16 compute type is a training-throughput setting)."""
        net = copy.deepcopy(self).eval()
        net.dtype = "float32"
        return net


class ActorCritic(_GaussianPolicy):
    """MLP actor-critic; Gaussian policy with a learned global log-std.
    ``forward(obs, critic_obs)`` -> (mu, std, value); ``act`` is the
    actor-only deterministic forward used for inference."""

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden_dims=(512, 256, 128),
                 critic_hidden_dims=(512, 256, 128), activation="elu",
                 init_noise_std=1.0, num_critic_obs=None, dtype="float32"):
        super().__init__(num_actions, init_noise_std, dtype)
        self.actor = mlp(num_obs, actor_hidden_dims, num_actions, activation)
        self.critic = mlp(num_critic_obs or num_obs, critic_hidden_dims, 1,
                          activation)

    def forward(self, obs, critic_obs=None):
        critic_obs = obs if critic_obs is None else critic_obs
        mu = self._head(self.actor, obs)
        value = self._head(self.critic, critic_obs)[..., 0]
        std = torch.exp(self.log_std).expand_as(mu)
        return mu, std, value

    def act(self, obs):
        with span("policy_act"):
            return self._head(self.actor, obs)


class LSTMCell(nn.Module):
    """Flax's ``OptimizedLSTMCell``: gates i, f, g, o from input kernels
    without bias (``weight_ih`` [4H, in], Flax ``ii/if/ig/io``) and
    recurrent kernels with bias (``weight_hh`` [4H, H], ``bias_hh``; Flax
    ``hi/hf/hg/ho``), ``c' = f c + i g``, ``h' = o tanh(c')``. Computes in
    the dtype of ``x``; ``c`` and ``h`` stay float32, so the mixed products
    promote as in JAX."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, x, c, h):
        dt = x.dtype
        y = (F.linear(h.to(dt), self.weight_hh.to(dt), self.bias_hh.to(dt))
             + F.linear(x, self.weight_ih.to(dt)))
        i, f, g, o = y.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        new_c = f * c + i * torch.tanh(g)
        new_h = o * torch.tanh(new_c)
        return new_c.to(torch.float32), new_h.to(torch.float32)


class LSTMEncoder(nn.Module):
    """Stacked LSTM over one time step; carry [L, 2, N, H] ((c, h) per
    layer). Returns the last layer's h (float32) and the new carry."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 1):
        super().__init__()
        self.cells = nn.ModuleList(
            LSTMCell(in_dim if i == 0 else hidden, hidden)
            for i in range(num_layers))

    def forward(self, x, carry, dtype=torch.float32):
        layers = []
        for cell, (c, h) in zip(self.cells, carry):
            c, x = cell(x.to(dtype), c, h)
            layers.append(torch.stack((c, x)))
        return x, torch.stack(layers)


class ActorCriticRecurrent(_GaussianPolicy):
    """LSTM actor-critic (rsl_rl ActorCriticRecurrent): separate memories
    for the actor (``memory_a``) and the critic (``memory_c``), each
    followed by its MLP head. ``forward(obs, critic_obs, carry)`` -> (mu,
    std, value, carry); ``act(obs, carry)`` -> (mu, carry) runs the actor
    branch alone and leaves the critic's carry as it was."""

    is_recurrent = True

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden_dims=(32,), critic_hidden_dims=(32,),
                 activation="elu", init_noise_std=0.8, rnn_hidden_size=64,
                 rnn_num_layers=1, num_critic_obs=None, dtype="float32"):
        super().__init__(num_actions, init_noise_std, dtype)
        self.rnn_hidden_size = rnn_hidden_size
        self.rnn_num_layers = rnn_num_layers
        self.memory_a = LSTMEncoder(num_obs, rnn_hidden_size, rnn_num_layers)
        self.memory_c = LSTMEncoder(num_critic_obs or num_obs, rnn_hidden_size,
                                    rnn_num_layers)
        self.actor = mlp(rnn_hidden_size, actor_hidden_dims, num_actions,
                         activation)
        self.critic = mlp(rnn_hidden_size, critic_hidden_dims, 1, activation)

    def initial_carry(self, batch: int):
        """Zero carry for ``batch`` envs on the network's device."""
        return torch.zeros((2, self.rnn_num_layers, 2, batch,
                            self.rnn_hidden_size), device=self.log_std.device)

    def forward(self, obs, critic_obs=None, carry=None):
        critic_obs = obs if critic_obs is None else critic_obs
        if carry is None:
            carry = self.initial_carry(obs.shape[0])
        dt = self._compute_dtype
        ha, carry_a = self.memory_a(obs, carry[0], dt)
        hc, carry_c = self.memory_c(critic_obs, carry[1], dt)
        mu = self._head(self.actor, ha)
        value = self._head(self.critic, hc)[..., 0]
        std = torch.exp(self.log_std).expand_as(mu)
        return mu, std, value, torch.stack((carry_a, carry_c))

    def act(self, obs, carry):
        with span("policy_act"):
            ha, carry_a = self.memory_a(obs, carry[0], self._compute_dtype)
            return self._head(self.actor, ha), torch.stack((carry_a, carry[1]))


def reset_carry(carry, done):
    """Zero the carry of done envs (rsl_rl ``Memory.reset(dones)``); None
    for a network without one."""
    if carry is None:
        return None
    return torch.where(done[:, None], 0.0, carry)


# --- Gaussian policy helpers -------------------------------------------------


def log_prob(mu, std, actions):
    z = (actions - mu) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * LOG2PI, dim=-1)


def entropy(std):
    return torch.sum(0.5 + 0.5 * LOG2PI + torch.log(std), dim=-1)


def kl_divergence(mu_old, std_old, mu_new, std_new):
    """rsl_rl's adaptive-KL formula (PPO.update, v1.0.2)."""
    return torch.sum(
        torch.log(std_new / std_old + 1e-5)
        + (std_old ** 2 + (mu_old - mu_new) ** 2) / (2.0 * std_new ** 2)
        - 0.5,
        dim=-1,
    )


def build_network(policy_cfg, num_obs: int, num_actions: int,
                  num_critic_obs=None, generator=None):
    """A freshly initialised network from ``TrainCfg.policy`` and its
    ``_class_name`` (``runner.policy_class_name``): Flax's init from
    ``generator`` (:func:`flax_init_`), on the CPU; the caller moves it."""
    kw = dict(
        actor_hidden_dims=tuple(policy_cfg.actor_hidden_dims),
        critic_hidden_dims=tuple(policy_cfg.critic_hidden_dims),
        activation=policy_cfg.activation,
        init_noise_std=policy_cfg.init_noise_std,
        num_critic_obs=num_critic_obs,
        dtype=getattr(policy_cfg, "dtype", "float32"),
    )
    if getattr(policy_cfg, "_class_name", None) == "ActorCriticRecurrent":
        if policy_cfg.rnn_type != "lstm":
            raise NotImplementedError(f"rnn_type '{policy_cfg.rnn_type}': "
                                      "the JAX package has only the LSTM")
        net = ActorCriticRecurrent(
            num_obs, num_actions, rnn_hidden_size=policy_cfg.rnn_hidden_size,
            rnn_num_layers=policy_cfg.rnn_num_layers, **kw)
    else:
        net = ActorCritic(num_obs, num_actions, **kw)
    flax_init_(net, generator)
    return net


def dense_stack(arrays: Dict[str, np.ndarray], head: str):
    """Flax kernels [in, out] and biases of ``params/<head>/Dense_i``."""
    out = []
    i = 0
    while f"params/{head}/Dense_{i}/kernel" in arrays:
        out.append((np.asarray(arrays[f"params/{head}/Dense_{i}/kernel"]),
                    np.asarray(arrays[f"params/{head}/Dense_{i}/bias"])))
        i += 1
    return out


_GATES = ("i", "f", "g", "o")


def lstm_stack(arrays: Dict[str, np.ndarray], scope: str, where: str = "weights"):
    """The layers of ``params/<scope>/lstm_l`` as torch's layout:
    (weight_ih [4H, in], weight_hh [4H, H], bias_hh [4H]), the gates'
    kernels transposed and stacked in i, f, g, o order
    (``export/export.py::_lstm_to_torch``). A missing layer 0 raises."""
    first = f"params/{scope}/lstm_0/ii/kernel"
    if first not in arrays:
        raise ValueError(f"{where}: no {first} (the {scope} LSTM weights of "
                         "a recurrent policy)")
    out = []
    l = 0
    while f"params/{scope}/lstm_{l}/ii/kernel" in arrays:
        pre = f"params/{scope}/lstm_{l}"
        out.append((
            np.concatenate([arrays[f"{pre}/i{g}/kernel"].T for g in _GATES]),
            np.concatenate([arrays[f"{pre}/h{g}/kernel"].T for g in _GATES]),
            np.concatenate([arrays[f"{pre}/h{g}/bias"] for g in _GATES]),
        ))
        l += 1
    return out


def actor_critic_from_flat(arrays: Dict[str, np.ndarray], meta: dict):
    """An :class:`ActorCritic` (``meta["is_recurrent"]``: an
    :class:`ActorCriticRecurrent`) holding the given Flax-named weights.
    Each Flax kernel [in, out] becomes the torch weight [out, in]. Takes the
    exporter's ``policy_flat.npz`` arrays or the JAX package's live params
    flattened to the same names; widths are read off the arrays."""
    actor = dense_stack(arrays, "actor")
    critic = dense_stack(arrays, "critic")
    if not actor:
        raise ValueError("no params/actor/Dense_0 in the weights")
    num_actions = actor[-1][0].shape[1]
    kw = dict(
        actor_hidden_dims=[k.shape[1] for k, _ in actor[:-1]],
        activation=meta.get("activation", "elu"),
        dtype=meta.get("dtype", "float32"),
    )
    if meta.get("is_recurrent"):
        mem_a = lstm_stack(arrays, "memory_a")
        mem_c = lstm_stack(arrays, "memory_c")
        hidden = mem_a[0][1].shape[1]
        net = ActorCriticRecurrent(
            mem_a[0][0].shape[1], num_actions,
            critic_hidden_dims=[k.shape[1] for k, _ in critic[:-1]] or [32],
            rnn_hidden_size=hidden, rnn_num_layers=len(mem_a),
            num_critic_obs=mem_c[0][0].shape[1], **kw)
    else:
        net = ActorCritic(
            actor[0][0].shape[0], num_actions,
            critic_hidden_dims=[k.shape[1] for k, _ in critic[:-1]] or [512, 256, 128],
            num_critic_obs=critic[0][0].shape[0] if critic else None, **kw)
    copy_flat(net, arrays)
    return net


def torch_layout(net, arrays, where="weights"):
    """The Flax-named ``arrays`` in ``net``'s layout: ``[(param, array)]``
    for every linear's weight (the kernel [in, out] transposed) and bias, a
    recurrent net's LSTM layers (:func:`lstm_stack`), and ``log_std``
    where ``arrays`` has ``params/log_std``. Takes a tree of the params'
    shape (the params themselves, or Adam's moments of them). Every layer
    of ``net`` must find its array with its shape, or this raises
    ``ValueError``."""
    pairs = []
    for head in ("actor", "critic"):
        linears = [m for m in getattr(net, head) if isinstance(m, nn.Linear)]
        dense = dense_stack(arrays, head)
        shapes = [tuple(lin.weight.shape[::-1]) for lin in linears]
        if [k.shape for k, _ in dense] != shapes:
            raise ValueError(f"{where}: {head} kernels {[k.shape for k, _ in dense]} "
                             f"do not fit the network's {shapes}")
        for lin, (k, b) in zip(linears, dense):
            pairs += [(lin.weight, k.T), (lin.bias, b)]
    if net.is_recurrent:
        for scope in ("memory_a", "memory_c"):
            cells = getattr(net, scope).cells
            layers = lstm_stack(arrays, scope, where)
            mine = [tuple(tuple(w.shape) for w in (c.weight_ih, c.weight_hh,
                                                   c.bias_hh)) for c in cells]
            theirs = [tuple(a.shape for a in layer) for layer in layers]
            if mine != theirs:
                raise ValueError(f"{where}: {scope} LSTM {theirs} does not fit "
                                 f"the network's {mine}")
            for c, layer in zip(cells, layers):
                pairs += list(zip((c.weight_ih, c.weight_hh, c.bias_hh), layer))
    if "params/log_std" in arrays:
        pairs.append((net.log_std, arrays["params/log_std"]))
    return pairs


def copy_flat(net, arrays, where="weights"):
    """Copy the Flax-named ``arrays`` into ``net`` (:func:`torch_layout`);
    nothing is copied unless every layer fits."""
    pairs = torch_layout(net, arrays, where)
    with torch.no_grad():
        for param, a in pairs:
            param.copy_(torch.as_tensor(np.asarray(a), dtype=torch.float32))


def flat_from_actor_critic(net) -> Dict[str, np.ndarray]:
    """The inverse of :func:`actor_critic_from_flat`: ``net``'s parameters
    as float32 numpy arrays under their Flax names, in the order of the JAX
    exporter's ``policy_flat.npz`` (``jax.tree_util``'s, keys sorted at
    every level): each weight [out, in] back to a kernel [in, out], and an
    LSTM layer's stacked i, f, g, o rows split into the input kernels
    ``ii/if/ig/io`` (no bias) and the recurrent ``hi/hf/hg/ho`` with their
    biases."""
    def arr(t):
        return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())

    tree = {"log_std": arr(net.log_std)}
    for head in ("actor", "critic"):
        linears = [m for m in getattr(net, head) if isinstance(m, nn.Linear)]
        tree[head] = {f"Dense_{i}": {"kernel": arr(lin.weight.T), "bias": arr(lin.bias)}
                      for i, lin in enumerate(linears)}
    if net.is_recurrent:
        for scope in ("memory_a", "memory_c"):
            tree[scope] = {}
            for l, c in enumerate(getattr(net, scope).cells):
                w_ih, w_hh, b_hh = (w.chunk(4, dim=0) for w in
                                    (c.weight_ih, c.weight_hh, c.bias_hh))
                layer = {}
                for g, wi, wh, b in zip(_GATES, w_ih, w_hh, b_hh):
                    layer[f"i{g}"] = {"kernel": arr(wi.T)}
                    layer[f"h{g}"] = {"kernel": arr(wh.T), "bias": arr(b)}
                tree[scope][f"lstm_{l}"] = layer
    return flatten_params({"params": tree})


def load_flat_params(net, path: str):
    """Load the full train params of a ``policy_flat.npz`` (``path`` is the
    file or its directory) into ``net`` in place: actor, critic, a
    recurrent net's memories and log-std by their Flax names, kernels
    transposed. Every layer of ``net`` must find its array, with its shape;
    returns ``net``."""
    f = path if path.endswith(".npz") else os.path.join(path, "policy_flat.npz")
    with np.load(f) as z:
        arrays = dict(z)
    if "params/log_std" not in arrays:
        raise ValueError(f"{f} holds no params/log_std")
    copy_flat(net, arrays, where=f)
    return net


def flatten_params(tree, prefix="") -> Dict[str, np.ndarray]:
    """A nested Flax param tree (``{"params": {"actor": {"Dense_0": ...}}}``)
    as ``{"params/actor/Dense_0/kernel": array, ...}``, keys sorted at every
    level as ``jax.tree_util`` orders them."""
    out = {}
    for k, v in sorted(tree.items()):
        name = f"{prefix}{k}"
        if hasattr(v, "items"):
            out.update(flatten_params(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def actor_critic_from_params(tree, **kw):
    """The network holding a JAX ``ActorCritic`` or ``ActorCriticRecurrent``
    param tree (numpy leaves); ``kw`` go to :func:`actor_critic_from_flat`'s
    meta (``is_recurrent=True`` for the LSTM)."""
    return actor_critic_from_flat(flatten_params(tree), dict(kw))


def load_flat_policy(path: str, device):
    """Load ``<path>/policy_flat.npz`` + ``policy_meta.json`` onto ``device``
    in eval mode."""
    with open(os.path.join(path, "policy_meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "policy_flat.npz")) as z:
        arrays = dict(z)
    return actor_critic_from_flat(arrays, meta).to(device).eval()
