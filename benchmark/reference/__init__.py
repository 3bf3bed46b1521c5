"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch code (the env step, its rewards and curricula, the terrain, the
robot model built from the URDF, and the SoA control step), with its own
policy (``policy.py``) and PPO arithmetic (``ppo.py``).

It imports nothing of the program and nothing of JAX. It is frozen here so
that a later change to the program is held to the arithmetic the benchmark
was accepted with. Robot files are read from the repository's
``resources/``, which the program reads too.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def resource(path: str) -> str:
    """A repo-relative path like ``resources/robots/go2/urdf/go2.urdf``
    resolved against the repository root."""
    path = path.format(UNITREE_RL_GYM_TPU_ROOT_DIR=ROOT_DIR)
    return path if os.path.isabs(path) else os.path.join(ROOT_DIR, path)


def resolve_device(device=None) -> torch.device:
    return torch.device("cuda" if device is None else device)
