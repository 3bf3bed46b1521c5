"""``scripts/make_pretrain.py`` on the CPU: go2 at N=8, one iteration of 2
rollout steps, the artifacts written under a temporary ``--out``. They are the file set of the
shipped ``resources/pre_train/go2`` with its meta keys, ``policy.bin``'s
header is the C++ controller's for this MLP, ``NumpyPolicy`` on the written
npz gives the runner's float32 policy on its final observations within
1e-5 (float32 matmuls in numpy and torch, summed in other orders), and the
shipped fixtures under ``resources/pre_train`` are left as they were."""

import contextlib
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.export.numpy_policy import NumpyPolicy
from unitree_rl_gym_tpu_torch.scripts import make_pretrain
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

SHIPPED = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train")
STEPS = 2


def tree_digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            p = os.path.join(d, f)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """(shipped digest before, out dir, runner, stdout) of one run, its
    iteration cut to STEPS rollout steps."""
    tmp = tmp_path_factory.mktemp("make_pretrain")
    before = tree_digest(SHIPPED)
    out = tmp / "pre_train" / "go2"
    buf = io.StringIO()
    get_cfgs = task_registry.get_cfgs

    def short(name):
        env_cfg, train_cfg = get_cfgs(name)
        train_cfg.runner.num_steps_per_env = STEPS
        return env_cfg, train_cfg

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(task_registry, "get_cfgs", short)
        out_dir, runner = make_pretrain.main([
            "--task=go2", "--num_envs=8", "--device=cpu", "--max_iterations=1",
            f"--experiment_name={tmp / 'logs'}", f"--out={out}"])
    return before, out_dir, runner, buf.getvalue()


def test_make_pretrain_go2(made):
    before, out, _, stdout = made
    assert f"artifacts written to {out}" in stdout
    shipped = os.path.join(SHIPPED, "go2")
    assert sorted(os.listdir(out)) == sorted(os.listdir(shipped))
    with open(os.path.join(out, "policy_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(shipped, "policy_meta.json")) as f:
        assert set(meta) == set(json.load(f))
    assert meta["activation"] == "elu" and meta["num_obs"] == 48
    with open(os.path.join(out, "policy.bin"), "rb") as f:
        assert struct.unpack("<9I", f.read(36)) == (0x4C525455, 1, 0, 48, 12, 0, 0, 4, 0)
    with open(os.path.join(out, "curves.json")) as f:
        assert [row["it"] for row in json.load(f)] == [0]
    assert tree_digest(SHIPPED) == before


def test_numpy_policy_matches_runner(made):
    _, out, runner, _ = made
    obs = runner._obs
    want = runner.get_inference_policy()(obs).numpy()
    np.testing.assert_allclose(NumpyPolicy(out)(obs.numpy()), want, rtol=0, atol=1e-5)
