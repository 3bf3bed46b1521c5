"""Policy export (counterpart of ``unitree_rl_gym_tpu/export/export.py``).

Writes, from the port's ``OnPolicyRunner``, the JAX exporter's artifacts
with the same names, layouts and bytes, so that every consumer of them
(``deploy/``, the JAX package's C++ controller in
``unitree_rl_gym_tpu/deploy/cpp/``, and the reference's deploy scripts)
reads the port's policies unchanged:

1. ``policy_flat.npz`` + ``policy_meta.json``: the full train params under
   their Flax names (``networks.flat_from_actor_critic``), read by the
   numpy runtime (:mod:`.numpy_policy`), the MuJoCo harness and
   ``networks.load_flat_params`` (a fine-tune's seed);
2. ``policy.bin``: the flat binary of the C++ controller
   (``deploy/cpp/policy.cpp`` of the JAX package);
3. TorchScript ``policy_1.pt`` (MLP) or ``policy_lstm_1.pt`` (LSTM): a
   ``nn.Sequential`` of ``nn.Linear`` and activations, or
   :class:`PolicyExporterLSTM` (``memory``: an ``nn.LSTM`` with zero
   ``bias_ih``; ``actor``; the carry in the buffers ``hidden_state`` and
   ``cell_state``; ``reset_memory()``), the modules and names of the JAX
   exporter. They are built from CPU copies of the weights, whatever
   device the runner trains on, so the files load on a machine without a
   GPU.

Export is float32 whatever the runner's compute dtype (the params are
float32; ``_GaussianPolicy.inference_copy`` is the float32 yardstick).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch
from torch import nn

from unitree_rl_gym_tpu_torch.deploy import obs_layout
from unitree_rl_gym_tpu_torch.models import networks as nets

def export_flat(runner, path: str):
    """``policy_flat.npz`` of all params and the architecture's
    ``policy_meta.json``; returns the meta."""
    os.makedirs(path, exist_ok=True)
    flat = nets.flat_from_actor_critic(runner.net)
    np.savez(os.path.join(path, "policy_flat.npz"), **flat)
    pc = runner.cfg.policy
    meta = {
        "policy_class": runner.cfg.runner.policy_class_name,
        "num_actions": runner.env.num_actions,
        "num_obs": runner.env.num_obs,
        "actor_hidden_dims": list(pc.actor_hidden_dims),
        "activation": pc.activation,
        "rnn_hidden_size": pc.rnn_hidden_size,
        "rnn_num_layers": pc.rnn_num_layers,
        "is_recurrent": runner.net.is_recurrent,
    }
    # the deploy obs segment table where the policy reads the 50 Hz deploy
    # layout, so that consumers never hand-code offsets
    try:
        meta["obs_layout"] = obs_layout.layout_for(
            runner.env.num_obs, runner.env.num_actions).to_meta()
    except ValueError:
        meta["obs_layout"] = None  # a task's own layout (go2's 48-dim obs)
    with open(os.path.join(path, "policy_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


# the JAX exporter's own table (no crelu): a crelu policy is refused here,
# with a KeyError, after its npz, meta and policy.bin were written, as there
_TORCHSCRIPT_ACTIVATIONS = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh,
                            "selu": nn.SELU, "sigmoid": nn.Sigmoid,
                            "lrelu": nn.LeakyReLU}


def _actor_mlp_to_torch(flat, activation) -> nn.Sequential:
    """The actor's ``Dense_i`` layers as ``nn.Linear`` (weight = kernel.T),
    each but the last followed by the activation."""
    act = _TORCHSCRIPT_ACTIVATIONS[activation]
    dense = nets.dense_stack(flat, "actor")
    layers = []
    for i, (k, b) in enumerate(dense):
        lin = nn.Linear(k.shape[0], k.shape[1])
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(k.T.copy()))
            lin.bias.copy_(torch.from_numpy(b.copy()))
        layers.append(lin)
        if i < len(dense) - 1:
            layers.append(act())
    return nn.Sequential(*layers)


def _lstm_to_torch(flat, scope, input_dim, hidden, num_layers) -> nn.LSTM:
    """Flax ``OptimizedLSTMCell`` weights (input kernels ``ii/if/ig/io``, no
    bias; recurrent ``hi/hf/hg/ho`` with the bias) as an ``nn.LSTM`` whose
    ``bias_ih`` is zero."""
    lstm = nn.LSTM(input_dim, hidden, num_layers)
    with torch.no_grad():
        for l, (w_ih, w_hh, b_hh) in enumerate(nets.lstm_stack(flat, scope)):
            getattr(lstm, f"weight_ih_l{l}").copy_(torch.from_numpy(w_ih))
            getattr(lstm, f"weight_hh_l{l}").copy_(torch.from_numpy(w_hh))
            getattr(lstm, f"bias_ih_l{l}").zero_()
            getattr(lstm, f"bias_hh_l{l}").copy_(torch.from_numpy(b_hh))
    return lstm


def export_cpp_bin(runner, path: str):
    """``policy.bin``, the flat binary of the C++ deploy controller.

    Layout (v1, little-endian):
      u32 magic 'UTRL', u32 version=1, u32 is_recurrent, u32 num_obs,
      u32 num_actions, u32 rnn_hidden, u32 rnn_layers, u32 n_mlp_layers,
      u32 activation(0=elu);
      per LSTM layer: u32 in, u32 hidden, f32 w_ih[in,4H], f32 w_hh[h,4H],
        f32 bias[4H] (gate order i|f|g|o);
      per MLP layer: u32 in, u32 out, f32 kernel[in,out], f32 bias[out].
    MLP files carry rnn_hidden and rnn_layers 0.
    """
    os.makedirs(path, exist_ok=True)
    flat = nets.flat_from_actor_critic(runner.net)
    pc = runner.cfg.policy
    recurrent = runner.net.is_recurrent
    n_mlp = len(pc.actor_hidden_dims) + 1
    out_path = os.path.join(path, "policy.bin")
    with open(out_path, "wb") as f:
        f.write(struct.pack(
            "<9I", 0x4C525455, 1, int(recurrent),
            runner.env.num_obs, runner.env.num_actions,
            pc.rnn_hidden_size if recurrent else 0,
            pc.rnn_num_layers if recurrent else 0,
            n_mlp, 0,
        ))
        if recurrent:
            # the kernels in Flax's layout, [in, 4H] and [H, 4H]
            for w_ih, w_hh, b_hh in nets.lstm_stack(flat, "memory_a"):
                f.write(struct.pack("<2I", w_ih.shape[1], pc.rnn_hidden_size))
                for a in (w_ih.T, w_hh.T, b_hh):
                    f.write(a.astype("<f4").tobytes())
        for k, b in nets.dense_stack(flat, "actor"):
            f.write(struct.pack("<2I", k.shape[0], k.shape[1]))
            f.write(k.astype("<f4").tobytes())
            f.write(b.astype("<f4").tobytes())
    return out_path


class PolicyExporterLSTM(nn.Module):
    """Stateful single-stream LSTM policy: the carry lives in buffers that
    ``forward`` updates, and ``reset_memory()`` zeroes it."""

    def __init__(self, memory, actor, hidden, layers):
        super().__init__()
        self.memory = memory
        self.actor = actor
        self.register_buffer("hidden_state", torch.zeros(layers, 1, hidden))
        self.register_buffer("cell_state", torch.zeros(layers, 1, hidden))

    def forward(self, x):
        out, (h, c) = self.memory(x.unsqueeze(0), (self.hidden_state, self.cell_state))
        self.hidden_state[:] = h
        self.cell_state[:] = c
        return self.actor(out.squeeze(0))

    @torch.jit.export
    def reset_memory(self):
        self.hidden_state[:] = 0.0
        self.cell_state[:] = 0.0


def export_torchscript(runner, path: str):
    """``policy_1.pt`` (MLP) or ``policy_lstm_1.pt`` (LSTM), scripted from
    CPU modules; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    flat = nets.flat_from_actor_critic(runner.net)
    pc = runner.cfg.policy
    # the modules' own init draws are overwritten: leave the caller's
    # global generator as it was
    with torch.random.fork_rng(devices=[]):
        actor = _actor_mlp_to_torch(flat, pc.activation)
        if runner.net.is_recurrent:
            memory = _lstm_to_torch(flat, "memory_a", runner.env.num_obs,
                                    pc.rnn_hidden_size, pc.rnn_num_layers)
    if runner.net.is_recurrent:
        module = PolicyExporterLSTM(memory, actor, pc.rnn_hidden_size, pc.rnn_num_layers)
        out_path = os.path.join(path, "policy_lstm_1.pt")
    else:
        module = actor
        out_path = os.path.join(path, "policy_1.pt")
    torch.jit.script(module).save(out_path)
    return out_path


def export_policy(runner, path: str):
    """Every artifact: the flat npz and meta, ``policy.bin`` and the
    TorchScript file. Returns the meta."""
    meta = export_flat(runner, path)
    export_cpp_bin(runner, path)
    export_torchscript(runner, path)
    return meta
