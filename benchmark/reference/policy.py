"""The reference policy: rsl_rl's Gaussian actor-critic written out in plain
torch, from weights held as a plain dict (never the program's modules).

``params``: ``{"actor": [(W [out, in], b)], "critic": [...], "log_std":
[na]}`` and, for the recurrent policy, ``"memory_a"`` / ``"memory_c"``: one
``(W_ih [4H, in], W_hh [4H, H], b_hh [4H])`` per LSTM layer, gates in the
order i, f, g, o (Flax's ``OptimizedLSTMCell``: no input bias). Hidden
layers use elu. ``dtype`` is the matmul compute type: inputs and weights
are cast to it, the heads return float32 and the LSTM carry stays float32,
as the configuration's ``policy.dtype`` states. ``quant`` (the control of
the comparison) rounds every matmul input and weight through that type and
back first (``torch.float8_e4m3fn`` for a bfloat16 configuration,
"tf32" for a float32 one).
"""

import math

import numpy as np
import torch
from torch.nn import functional as F

LOG2PI = math.log(2.0 * math.pi)
_GATES = ("i", "f", "g", "o")


def _q(x, quant):
    """``x`` rounded through ``quant``: a torch dtype, or "tf32" (float32
    with its mantissa rounded to TF32's 10 bits, to nearest)."""
    if quant is None:
        return x
    if quant == "tf32":
        i = x.to(torch.float32).view(torch.int32)
        return ((i + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)
    return x.to(quant).to(x.dtype)


def linear(x, w, b, dtype, quant=None):
    x = _q(x.to(dtype), quant)
    w = _q(w.to(dtype), quant)
    return F.linear(x, w, None if b is None else b.to(dtype))


def mlp(layers, x, dtype, quant=None):
    """elu MLP; returns float32."""
    for i, (w, b) in enumerate(layers):
        x = linear(x, w, b, dtype, quant)
        if i < len(layers) - 1:
            x = F.elu(x)
    return x.to(torch.float32)


def lstm(layers, x, carry, dtype, quant=None):
    """One step of a stacked LSTM; ``carry`` [L, 2, N, H] float32 ((c, h)
    per layer). Returns (last h, new carry)."""
    out = []
    for (w_ih, w_hh, b_hh), (c, h) in zip(layers, carry):
        y = (linear(h, w_hh, b_hh, dtype, quant)
             + linear(x, w_ih, None, dtype, quant))
        i, f, g, o = y.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = (f * c + i * torch.tanh(g)).to(torch.float32)
        x = (o * torch.tanh(c)).to(torch.float32)
        out.append(torch.stack((c, x)))
    return x, torch.stack(out)


def forward(params, obs, critic_obs=None, dtype=torch.float32, quant=None):
    """(mu, std, value) of the MLP actor-critic."""
    critic_obs = obs if critic_obs is None else critic_obs
    mu = mlp(params["actor"], obs, dtype, quant)
    value = mlp(params["critic"], critic_obs, dtype, quant)[..., 0]
    std = torch.exp(params["log_std"]).expand_as(mu)
    return mu, std, value


def act_recurrent(params, obs, carry, dtype=torch.float32, quant=None):
    """(mu, carry) of the recurrent actor: ``carry`` [2, L, 2, N, H]
    (actor, critic memory); the critic's memory is left as it was."""
    h, carry_a = lstm(params["memory_a"], obs, carry[0], dtype, quant)
    return mlp(params["actor"], h, dtype, quant), torch.stack((carry_a, carry[1]))


def log_prob(mu, std, actions):
    z = (actions - mu) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * LOG2PI, dim=-1)


def entropy(std):
    return torch.sum(0.5 + 0.5 * LOG2PI + torch.log(std), dim=-1)


def kl_divergence(mu_old, std_old, mu_new, std_new):
    return torch.sum(
        torch.log(std_new / std_old + 1e-5)
        + (std_old ** 2 + (mu_old - mu_new) ** 2) / (2.0 * std_new ** 2)
        - 0.5, dim=-1)


def from_flat(path, device):
    """The policy of an exporter's ``policy_flat.npz`` (Flax names: kernels
    [in, out], the LSTM gates' kernels one array each) as ``params``."""
    with np.load(path) as z:
        a = {k: z[k] for k in z.files}

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)

    def dense(head):
        out, i = [], 0
        while f"params/{head}/Dense_{i}/kernel" in a:
            out.append((t(a[f"params/{head}/Dense_{i}/kernel"].T),
                        t(a[f"params/{head}/Dense_{i}/bias"])))
            i += 1
        return out

    params = {"actor": dense("actor"), "critic": dense("critic"),
              "log_std": t(a["params/log_std"])}
    for scope in ("memory_a", "memory_c"):
        layers, l = [], 0
        while f"params/{scope}/lstm_{l}/ii/kernel" in a:
            pre = f"params/{scope}/lstm_{l}"
            layers.append((
                t(np.concatenate([a[f"{pre}/i{g}/kernel"].T for g in _GATES])),
                t(np.concatenate([a[f"{pre}/h{g}/kernel"].T for g in _GATES])),
                t(np.concatenate([a[f"{pre}/h{g}/bias"] for g in _GATES]))))
            l += 1
        if layers:
            params[scope] = layers
    return params
