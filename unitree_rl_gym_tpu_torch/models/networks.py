"""Actor-critic networks (counterpart of ``unitree_rl_gym_tpu/models/
networks.py``: ``ActorCritic``, the Gaussian-policy helpers and
``build_network``), rsl_rl's MLP model: elu MLP actor and critic, learned
state-independent log-std.

A network trained from scratch starts like Flax's ``Dense`` defaults:
lecun-normal kernels (a normal cut at two standard deviations, std
sqrt(1/fan_in)/0.8796) and zero biases (:func:`lecun_normal_`), drawn from
the caller's generator. ``dtype`` is the matmul compute type of the JAX
package's ``PolicyCfg.dtype``: parameters stay float32, the layers compute
in ``dtype`` and the heads return float32.

Weights come across from the JAX package by their Flax names
(``params/{actor,critic}/Dense_i/{kernel,bias}`` and ``params/log_std``):
from the exporter's ``policy_flat.npz`` (:func:`actor_critic_from_flat`), or
from a live Flax param tree (:func:`actor_critic_from_params`), or into an
existing network, actor, critic and log-std, to seed a fine-tune
(:func:`load_flat_params`, the counterpart of the JAX package's
``export.load_flat_params``). The recurrent policy is not ported yet.
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

# every policy the repo ships uses elu
_ACTIVATIONS = {"elu": nn.ELU}
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
    if activation not in _ACTIVATIONS:
        raise NotImplementedError(f"activation '{activation}' is not ported yet")
    layers, d = [], in_dim
    for h in hidden_dims:
        layers += [Dense(d, h), _ACTIVATIONS[activation]()]
        d = h
    layers.append(Dense(d, out_dim))
    return nn.Sequential(*layers)


def lecun_normal_(module: nn.Module, generator: torch.Generator):
    """Flax's default init in place: every ``nn.Linear`` kernel from a normal
    of std sqrt(1/fan_in)/0.8796 cut at two of those stds, biases zero."""
    with torch.no_grad():
        for lin in module.modules():
            if isinstance(lin, nn.Linear):
                std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                nn.init.zeros_(lin.bias)


class ActorCritic(nn.Module):
    """MLP actor-critic; Gaussian policy with a learned global log-std.
    ``forward(obs, critic_obs)`` -> (mu, std, value); ``act`` is the
    actor-only deterministic forward used for inference."""

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden_dims=(512, 256, 128),
                 critic_hidden_dims=(512, 256, 128), activation="elu",
                 init_noise_std=1.0, num_critic_obs=None, dtype="float32"):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"policy dtype must be one of {sorted(_DTYPES)}")
        self.dtype = dtype
        self.actor = mlp(num_obs, actor_hidden_dims, num_actions, activation)
        self.critic = mlp(num_critic_obs or num_obs, critic_hidden_dims, 1,
                          activation)
        self.log_std = nn.Parameter(
            torch.full((num_actions,), float(np.log(init_noise_std)))
        )

    def _head(self, seq, x):
        return seq(x.to(_DTYPES[self.dtype])).to(torch.float32)

    def forward(self, obs, critic_obs=None):
        critic_obs = obs if critic_obs is None else critic_obs
        mu = self._head(self.actor, obs)
        value = self._head(self.critic, critic_obs)[..., 0]
        std = torch.exp(self.log_std).expand_as(mu)
        return mu, std, value

    def act(self, obs):
        return self._head(self.actor, obs)

    def inference_copy(self) -> "ActorCritic":
        """A float32 copy in eval mode (inference and export are float32;
        the bf16 compute type is a training-throughput setting)."""
        net = copy.deepcopy(self).eval()
        net.dtype = "float32"
        return net


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
                  num_critic_obs=None, generator=None) -> ActorCritic:
    """A freshly initialised network from ``TrainCfg.policy`` (lecun-normal
    from ``generator``, on the CPU; the caller moves it)."""
    if getattr(policy_cfg, "_class_name", None) == "ActorCriticRecurrent":
        raise NotImplementedError("recurrent (LSTM) policies are not ported yet")
    net = ActorCritic(
        num_obs, num_actions,
        actor_hidden_dims=tuple(policy_cfg.actor_hidden_dims),
        critic_hidden_dims=tuple(policy_cfg.critic_hidden_dims),
        activation=policy_cfg.activation,
        init_noise_std=policy_cfg.init_noise_std,
        num_critic_obs=num_critic_obs,
        dtype=getattr(policy_cfg, "dtype", "float32"),
    )
    lecun_normal_(net, generator)
    return net


def _dense_stack(arrays: Dict[str, np.ndarray], head: str):
    """Flax kernels [in, out] and biases of ``params/<head>/Dense_i``."""
    out = []
    i = 0
    while f"params/{head}/Dense_{i}/kernel" in arrays:
        out.append((np.asarray(arrays[f"params/{head}/Dense_{i}/kernel"]),
                    np.asarray(arrays[f"params/{head}/Dense_{i}/bias"])))
        i += 1
    return out


def actor_critic_from_flat(arrays: Dict[str, np.ndarray], meta: dict) -> ActorCritic:
    """An :class:`ActorCritic` holding the given Flax-named weights. Each
    Flax kernel [in, out] becomes the ``nn.Linear`` weight [out, in]. Takes
    the exporter's ``policy_flat.npz`` arrays or the JAX package's live params
    flattened to the same names; hidden widths are read off the arrays."""
    if meta.get("is_recurrent"):
        raise NotImplementedError("recurrent (LSTM) policies are not ported yet")
    actor = _dense_stack(arrays, "actor")
    critic = _dense_stack(arrays, "critic")
    if not actor:
        raise ValueError("no params/actor/Dense_0 in the weights")
    num_obs, num_actions = actor[0][0].shape[0], actor[-1][0].shape[1]
    net = ActorCritic(
        num_obs, num_actions,
        actor_hidden_dims=[k.shape[1] for k, _ in actor[:-1]],
        critic_hidden_dims=[k.shape[1] for k, _ in critic[:-1]] or [512, 256, 128],
        activation=meta.get("activation", "elu"),
        num_critic_obs=critic[0][0].shape[0] if critic else None,
        dtype=meta.get("dtype", "float32"),
    )
    _copy_flat(net, actor, critic, arrays.get("params/log_std"))
    return net


def _copy_flat(net: ActorCritic, actor, critic, log_std):
    """Copy Flax kernels [in, out] (transposed) and biases into ``net``'s
    linears, and ``log_std`` where given; a shape that differs raises."""
    with torch.no_grad():
        for seq, dense in ((net.actor, actor), (net.critic, critic)):
            linears = [m for m in seq if isinstance(m, nn.Linear)]
            for lin, (k, b) in zip(linears, dense):
                lin.weight.copy_(torch.tensor(k.T, dtype=torch.float32))
                lin.bias.copy_(torch.tensor(b, dtype=torch.float32))
        if log_std is not None:
            net.log_std.copy_(torch.tensor(log_std, dtype=torch.float32))


def load_flat_params(net: ActorCritic, path: str) -> ActorCritic:
    """Load the full train params of a ``policy_flat.npz`` (``path`` is the
    file or its directory) into ``net`` in place: actor, critic and log-std
    by their Flax names, kernels transposed. Every layer of ``net`` must
    find its array, with its shape; returns ``net``."""
    f = path if path.endswith(".npz") else os.path.join(path, "policy_flat.npz")
    with np.load(f) as z:
        arrays = dict(z)
    actor = _dense_stack(arrays, "actor")
    critic = _dense_stack(arrays, "critic")
    for head, dense in (("actor", actor), ("critic", critic)):
        linears = [m for m in getattr(net, head) if isinstance(m, nn.Linear)]
        shapes = [tuple(lin.weight.shape[::-1]) for lin in linears]
        if [k.shape for k, _ in dense] != shapes:
            raise ValueError(f"{f}: {head} kernels {[k.shape for k, _ in dense]} "
                             f"do not fit the network's {shapes}")
    if "params/log_std" not in arrays:
        raise ValueError(f"{f} holds no params/log_std")
    _copy_flat(net, actor, critic, arrays["params/log_std"])
    return net


def flatten_params(tree, prefix="") -> Dict[str, np.ndarray]:
    """A nested Flax param tree (``{"params": {"actor": {"Dense_0": ...}}}``)
    as ``{"params/actor/Dense_0/kernel": array, ...}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if hasattr(v, "items"):
            out.update(flatten_params(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def actor_critic_from_params(tree, **kw) -> ActorCritic:
    """An :class:`ActorCritic` holding a JAX ``ActorCritic``'s param tree
    (numpy leaves); ``kw`` go to :func:`actor_critic_from_flat`'s meta."""
    return actor_critic_from_flat(flatten_params(tree), dict(kw))


def load_flat_policy(path: str, device) -> ActorCritic:
    """Load ``<path>/policy_flat.npz`` + ``policy_meta.json`` onto ``device``
    in eval mode."""
    with open(os.path.join(path, "policy_meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "policy_flat.npz")) as z:
        arrays = dict(z)
    return actor_critic_from_flat(arrays, meta).to(device).eval()
