"""Read the JAX package's checkpoints, ``model_<it>.ckpt``, without flax.

The JAX runner writes ``flax.serialization.to_bytes`` of
``{"params", "opt_state", "lr", "key", "iteration"}``
(``unitree_rl_gym_tpu/rl/runner.py``, ``save``): msgpack of the payload's
state dict, in which every tuple (optax's chain state) is a dict keyed
``"0"``, ``"1"``, ..., every named tuple a dict of its fields, and every
array the msgpack extension type 1, itself msgpack of ``(shape, dtype
name, C-order bytes)``. ``msgpack`` is imported where a file is read, so
that the port imports without it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_NDARRAY = 1


def _array(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    if code != _NDARRAY:
        raise ValueError(f"msgpack extension type {code} is not a flax array")
    return _array(data)


def load(path: str) -> Dict:
    """The state dict of the ``flax.serialization.to_bytes`` payload in
    ``path``, with numpy arrays for its arrays."""
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
