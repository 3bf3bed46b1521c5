"""Dependency-free numpy inference of exported policies (counterpart of
``unitree_rl_gym_tpu/export/numpy_policy.py``, the same code).

Loads the flat-weight artifact written by :func:`export.export_flat`
(``policy_flat.npz`` + ``policy_meta.json``) and evaluates the actor —
MLP or LSTM — with nothing but numpy: the deploy-edge runtime for
platforms without torch, and the Python twin of the C++ controller's
``policy.bin`` evaluation."""

from __future__ import annotations

import json
import os

import numpy as np


def _elu(x):
    return np.where(x > 0, x, np.expm1(x))


_ACTS = {
    "elu": _elu,
    "relu": lambda x: np.maximum(x, 0.0),
    "tanh": np.tanh,
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
}


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class NumpyPolicy:
    """Stateful single-stream policy (matches the TorchScript exporter's
    semantics: hidden state carried internally, reset via reset_memory)."""

    def __init__(self, path: str):
        with open(os.path.join(path, "policy_meta.json")) as f:
            self.meta = json.load(f)
        self.w = dict(np.load(os.path.join(path, "policy_flat.npz")))
        self.is_recurrent = self.meta["is_recurrent"]
        self.hidden = None
        self.cell = None
        self.reset_memory()

    def reset_memory(self):
        if self.is_recurrent:
            # Lazily (re)initialised to the caller's batch size on the
            # next __call__ (single stream and batched eval both work).
            self.hidden = None
            self.cell = None

    def _ensure_memory(self, batch):
        h = self.meta["rnn_hidden_size"]
        n = self.meta["rnn_num_layers"]
        if self.hidden is None:
            # lazy init right after reset_memory(): adopt caller batch size
            self.hidden = [np.zeros((batch, h), np.float32)
                           for _ in range(n)]
            self.cell = [np.zeros((batch, h), np.float32)
                         for _ in range(n)]
        elif self.hidden[0].shape[0] != batch:
            # a silent zero-reset here would drop live recurrent state on a
            # mixed-batch caller (e.g. batched eval followed by a
            # single-stream call) — fail loudly instead
            raise ValueError(
                f"batch size changed {self.hidden[0].shape[0]} -> {batch} "
                "with live LSTM state; call reset_memory() first"
            )

    def _mlp(self, prefix, x):
        act = _ACTS[self.meta["activation"]]
        n = len(self.meta["actor_hidden_dims"])
        for i in range(n + 1):
            k = self.w[f"params/{prefix}/Dense_{i}/kernel"]
            b = self.w[f"params/{prefix}/Dense_{i}/bias"]
            x = x @ k + b
            if i < n:
                x = act(x)
        return x

    def _lstm_step(self, x):
        for l in range(self.meta["rnn_num_layers"]):
            p = f"params/memory_a/lstm_{l}"
            h, c = self.hidden[l], self.cell[l]
            i = _sigmoid(x @ self.w[f"{p}/ii/kernel"]
                         + h @ self.w[f"{p}/hi/kernel"]
                         + self.w[f"{p}/hi/bias"])
            f = _sigmoid(x @ self.w[f"{p}/if/kernel"]
                         + h @ self.w[f"{p}/hf/kernel"]
                         + self.w[f"{p}/hf/bias"])
            g = np.tanh(x @ self.w[f"{p}/ig/kernel"]
                        + h @ self.w[f"{p}/hg/kernel"]
                        + self.w[f"{p}/hg/bias"])
            o = _sigmoid(x @ self.w[f"{p}/io/kernel"]
                         + h @ self.w[f"{p}/ho/kernel"]
                         + self.w[f"{p}/ho/bias"])
            c = f * c + i * g
            h = o * np.tanh(c)
            self.hidden[l], self.cell[l] = h, c
            x = h
        return x

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        x = np.asarray(obs, np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if self.is_recurrent:
            self._ensure_memory(x.shape[0])
            x = self._lstm_step(x)
        a = self._mlp("actor", x)
        return a[0] if squeeze else a
