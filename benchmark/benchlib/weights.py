"""Seeded network weights, made on the device in a few large calls and
handed alike to the program and to the reference.

The benchmark's own layout is the reference's ``params`` dict (see
``reference/policy.py``); :func:`program_state_dict` names the same
tensors as the port's ``ActorCritic`` does (``nn.Sequential`` indices,
an activation between two linears)."""

import math

import torch


def mlp_shapes(in_dim, hidden, out_dim):
    dims = [in_dim] + list(hidden) + [out_dim]
    return [(b, a) for a, b in zip(dims[:-1], dims[1:])]


def mlp_params(seed, device, num_obs, num_critic_obs, num_actions,
               actor_hidden, critic_hidden, init_noise_std):
    """An MLP actor-critic's weights from ``seed``: one normal draw for
    every kernel at once, each scaled by 1/sqrt(fan_in); biases zero (as
    Flax's default init); log_std at log(init_noise_std)."""
    shapes = {"actor": mlp_shapes(num_obs, actor_hidden, num_actions),
              "critic": mlp_shapes(num_critic_obs, critic_hidden, 1)}
    total = sum(o * i for s in shapes.values() for o, i in s)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params, k = {}, 0
    for head, s in shapes.items():
        layers = []
        for o, i in s:
            w = flat[k:k + o * i].view(o, i) / math.sqrt(i)
            layers.append((w, torch.zeros(o, device=device)))
            k += o * i
        params[head] = layers
    params["log_std"] = torch.full((num_actions,), math.log(init_noise_std),
                                   device=device)
    return params


def program_state_dict(params):
    """``params`` under the port's ``ActorCritic`` state-dict names."""
    sd = {"log_std": params["log_std"]}
    for head in ("actor", "critic"):
        for i, (w, b) in enumerate(params[head]):
            sd[f"{head}.{2 * i}.weight"] = w
            sd[f"{head}.{2 * i}.bias"] = b
    return sd


def from_program_name(name):
    """The reference leaf name (``reference/ppo.py::leaves``) of a port
    parameter name."""
    if name == "log_std":
        return name
    head, idx, kind = name.split(".")
    return f"{head}.{int(idx) // 2}.{kind}"
