"""CPU smoke run of the port's training entry point: two iterations of
``scripts/train.py --task=go2 --num_envs=8 --device=cpu`` (the plain physics
version; no kernel launches), with finite metrics, the learning rate within
its float32 bounds and the checkpoint files written; without ``--device``
the script asks for CUDA."""

import math
import os

import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.scripts import train as train_script
from unitree_rl_gym_tpu_torch.utils import helpers
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

# float32 bounds of the adaptive learning rate
LR_MIN, LR_MAX = float(np.float32(1e-5)), float(np.float32(1e-2))


def check_rows(rows, terrain):
    """Two iterations of finite metrics, lr in bounds, the terrain level
    reported exactly on terrain."""
    assert len(rows) == 2
    for row in rows:
        for k, v in row.items():
            vals = v.values() if isinstance(v, dict) else [v]
            assert all(math.isfinite(float(u)) for u in vals), (k, v)
        assert row["nonfinite_steps"] == 0
        assert LR_MIN <= row["lr"] <= LR_MAX
        assert ("terrain_level" in row) == terrain


def test_train_script_two_iterations_on_cpu(tmp_path):
    before = cuda_step.LAUNCHES
    # an absolute --experiment_name puts the log dir under tmp_path
    rows = train_script.train(helpers.get_args([
        "--task=go2", "--num_envs=8", "--device=cpu", "--max_iterations=2",
        f"--experiment_name={tmp_path}",
    ]))
    check_rows(rows, terrain=False)
    assert cuda_step.LAUNCHES == before
    run = os.listdir(str(tmp_path))
    assert len(run) == 1
    files = os.listdir(os.path.join(str(tmp_path), run[0]))
    assert {"model_2.pt", "model_2.pt.json", "curves.json"} <= set(files)


def test_train_script_defaults_to_cuda():
    """Without ``--device`` the script asks for CUDA, which raises on a
    machine without a GPU (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_script.train(helpers.get_args(["--task=go2", "--num_envs=8"]))
