"""CLI args, seeding and checkpoint discovery (counterpart of
``unitree_rl_gym_tpu/utils/helpers.py``). ``--device`` picks the torch device
(CUDA by default); ``--dist_backend`` the backend of a torchrun launch;
``--load_flat`` points play at a flat-weight policy directory,
``--view`` opens play's MuJoCo viewer and ``--headless`` is accepted and
does nothing, as in the JAX package (which, like legged_gym's CLI, takes
it; nothing opens a viewer unless ``--view`` asks).
``--num_envs`` is the global env count, whatever the number of ranks."""

from __future__ import annotations

import argparse
import os
import random
from typing import Optional

import numpy as np
import torch


def set_seed(seed: Optional[int]):
    """Seed host RNGs (the env's own torch.Generator is seeded from
    cfg.seed by the env)."""
    if seed is None or seed == -1:
        seed = np.random.randint(0, 10000)
    print(f"Setting seed: {seed}")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def get_load_path(root, load_run=-1, checkpoint=-1):
    """Latest-run / latest-checkpoint discovery (helpers.py:73-95) over
    ``model_<it>.pt`` (the port's) and ``model_<it>.ckpt`` (the JAX
    package's; both keep their runs under ``logs/<experiment_name>/``): the
    newest iteration of either suffix, the port's file where an iteration
    has both. Raises ``ValueError`` naming the directory that holds no
    such checkpoint."""
    try:
        runs = sorted(os.listdir(root))
        if "exported" in runs:
            runs.remove("exported")
        last_run = os.path.join(root, runs[-1])
    except (OSError, IndexError):
        raise ValueError("No runs in this directory: " + root) from None
    load_run = last_run if load_run == -1 else os.path.join(root, str(load_run))
    models = [f for f in os.listdir(load_run)
              if f.startswith("model_") and f.endswith((".pt", ".ckpt"))]
    if checkpoint != -1:
        models = [f for f in models if f.split("_")[1].split(".")[0] == str(checkpoint)]
    if not models:
        which = "" if checkpoint == -1 else f"_{checkpoint}"
        raise ValueError(f"No model{which}.pt or model{which}.ckpt checkpoint in "
                         f"this directory: {load_run}")
    models.sort(key=lambda m: (int(m.split("_")[1].split(".")[0]), m.endswith(".pt")))
    return os.path.join(load_run, models[-1])


def update_cfg_from_args(env_cfg, train_cfg, args):
    """Apply CLI overrides (reference helpers.py:97-120)."""
    if env_cfg is not None:
        if getattr(args, "num_envs", None) is not None:
            env_cfg.env.num_envs = args.num_envs
        if getattr(args, "seed", None) is not None:
            env_cfg.seed = args.seed
    if train_cfg is not None:
        if getattr(args, "seed", None) is not None:
            train_cfg.seed = args.seed
        if getattr(args, "max_iterations", None) is not None:
            train_cfg.runner.max_iterations = args.max_iterations
        if getattr(args, "resume", False):
            train_cfg.runner.resume = args.resume
        if getattr(args, "experiment_name", None) is not None:
            train_cfg.runner.experiment_name = args.experiment_name
        if getattr(args, "run_name", None) is not None:
            train_cfg.runner.run_name = args.run_name
        if getattr(args, "load_run", None) is not None:
            train_cfg.runner.load_run = args.load_run
        if getattr(args, "checkpoint", None) is not None:
            train_cfg.runner.checkpoint = args.checkpoint
    return env_cfg, train_cfg


def get_args(argv=None):
    """CLI surface of the train and play scripts."""
    p = argparse.ArgumentParser(description="RL Policy (PyTorch/CUDA port)")
    p.add_argument("--task", type=str, default="go2")
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--experiment_name", type=str)
    p.add_argument("--run_name", type=str)
    p.add_argument("--load_run", type=str)
    p.add_argument("--checkpoint", type=int)
    p.add_argument("--headless", action="store_true", default=False)
    p.add_argument("--num_envs", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--max_iterations", type=int)
    p.add_argument(
        "--load_flat", type=str, default=None,
        help="directory with policy_flat.npz + policy_meta.json "
             "(default: resources/pre_train/<task>)",
    )
    p.add_argument(
        "--view", action="store_true", default=False,
        help="play: replay env 0 in a MuJoCo viewer (needs mujoco and a display)",
    )
    p.add_argument(
        "--device", type=str, default="cuda",
        help="torch device: cuda (default; raises without a GPU) or cpu",
    )
    p.add_argument(
        "--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
        help="torch.distributed backend of a torchrun launch (default: nccl "
             "with a CUDA device per rank, gloo on the CPU; ranks that would "
             "share a card need gloo named here)",
    )
    return p.parse_args(argv)
