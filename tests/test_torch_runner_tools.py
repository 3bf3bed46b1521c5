"""Module 5's TensorBoard writer and module 12's tooling on the CPU:

- the runner's TensorBoard tags are the JAX runner's (``add_scalar`` calls
  of ``unitree_rl_gym_tpu/rl/runner.py``, read as text), with the values of
  each iteration's ``curves.json`` row (read back with tensorboard's
  ``EventAccumulator``; float32 in the event file, so rtol 1e-6), and
  ``UTRL_PROFILE_ITERS=1`` writes a trace under ``<log_dir>/profile``, with
  the PPO phases' and the env step's spans: go2 at N=8 with 2 steps an
  iteration at decimation 1 (the writer and the window do not depend on
  the rollout's length);
- ``utils/cache.enable_persistent_cache``: UTRL_BUILD_CACHE_DIR moves the
  kernel build directory and UTRL_BUILD_CACHE=0 turns it into a fresh
  temporary one, through ``cuda_step``'s path logic (no nvcc); the train
  script calls it;
- ``scripts/profile_residue.py --device=cpu`` at N=8 (the same cfgs)
  prints the JAX script's keys, with its differences;
- ``scripts/roofline.py``'s flop and byte counts, and its FMA chain's plain
  version, which rounds each round once as ``fmaf`` does.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.physics import backend as pb
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
from unitree_rl_gym_tpu_torch.scripts import profile_residue
from unitree_rl_gym_tpu_torch.scripts import roofline as rl
from unitree_rl_gym_tpu_torch.scripts import train as train_script
from unitree_rl_gym_tpu_torch.utils import cache, helpers
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

STEPS = 2


def jax_source(rel):
    with open(os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "unitree_rl_gym_tpu", rel)) as f:
        return f.read()


def short(env_cfg, train_cfg):
    """STEPS rollout steps an iteration, one physics substep a step."""
    train_cfg.runner.num_steps_per_env = STEPS
    env_cfg.control.decimation = 1
    return env_cfg, train_cfg


@pytest.fixture
def short_cfgs(monkeypatch):
    """The registry's cfgs made :func:`short`."""
    get_cfgs = task_registry.get_cfgs
    monkeypatch.setattr(task_registry, "get_cfgs", lambda name: short(*get_cfgs(name)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A go2 runner at N=8 (:func:`short`) after 2 iterations with a log dir
    and UTRL_PROFILE_ITERS=1."""
    log_dir = str(tmp_path_factory.mktemp("run"))
    env_cfg, train_cfg = short(*task_registry.get_cfgs("go2"))
    env_cfg.env.num_envs = 8
    env, _ = task_registry.make_env("go2", env_cfg=env_cfg, device="cpu")
    runner = OnPolicyRunner(env, train_cfg, log_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UTRL_PROFILE_ITERS", "1")
        rows = runner.learn(2)
    return runner, rows, log_dir


def test_writer_tags_and_values_are_the_jax_runners(trained):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    runner, rows, log_dir = trained
    assert runner._writer is not None
    src = jax_source("rl/runner.py")
    jax_tags = re.findall(r'add_scalar\(\s*f?"([^"]+)"', src)
    assert "Episode/terrain_level" in jax_tags and "Episode/rew_{name}" in jax_tags
    # flat ground: the terrain level is written only on terrain, as there
    want = {t for t in jax_tags if t not in ("Episode/rew_{name}", "Episode/terrain_level")}
    want |= {f"Episode/rew_{n}" for n in runner.env.episode_term_names}
    acc = EventAccumulator(log_dir)
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == want
    with open(os.path.join(log_dir, "curves.json")) as f:
        curves = json.load(f)
    assert [r["it"] for r in curves] == [0, 1]
    fields = {"Loss/value_function": "value_loss", "Loss/surrogate": "surrogate_loss",
              "Loss/learning_rate": "lr", "Perf/total_fps": "fps",
              "Train/mean_reward": "mean_step_reward",
              "Train/mean_episode_length": "mean_episode_length"}
    for tag in want:
        events = acc.Scalars(tag)
        assert [e.step for e in events] == [0, 1], tag
        for e, row in zip(events, curves):
            v = (row["episode_rew"][tag[len("Episode/rew_"):]] if tag.startswith("Episode/")
                 else row[fields[tag]])
            np.testing.assert_allclose(e.value, v, rtol=1e-6, atol=1e-30, err_msg=tag)


def test_profile_window_writes_a_trace(trained):
    runner, rows, log_dir = trained
    traces = os.listdir(os.path.join(log_dir, "profile"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(log_dir, "profile", traces[0])) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"ppo_update", "env_step"} <= names


def test_build_cache_knobs(trained, monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_step, "BUILD_DIR", cuda_step.BUILD_DIR)
    m = pb.soa_model_for(trained[0].env.robot.dyn)
    monkeypatch.delenv("UTRL_BUILD_CACHE", raising=False)
    monkeypatch.delenv("UTRL_BUILD_CACHE_DIR", raising=False)
    assert cache.enable_persistent_cache() == cuda_step.DEFAULT_BUILD_DIR
    assert cuda_step.DEFAULT_BUILD_DIR == os.path.join(
        UNITREE_RL_GYM_TPU_ROOT_DIR, "unitree_rl_gym_tpu_torch", "_build")
    key = os.path.relpath(cuda_step.library_path(m), cuda_step.DEFAULT_BUILD_DIR)
    monkeypatch.setenv("UTRL_BUILD_CACHE_DIR", str(tmp_path / "moved"))
    assert cache.enable_persistent_cache() == str(tmp_path / "moved")
    assert cuda_step.library_path(m) == str(tmp_path / "moved" / key)
    assert cuda_step.source_path((rl.FMA_SOURCE,), cuda_step.NVCC_FLAGS,
                                 "roofline_fma").startswith(str(tmp_path / "moved"))
    monkeypatch.setenv("UTRL_BUILD_CACHE", "0")
    fresh = [cache.enable_persistent_cache() for _ in range(2)]
    assert fresh[0] != fresh[1] and all(os.path.isdir(d) for d in fresh)
    assert all(not os.listdir(d) for d in fresh)
    assert cuda_step.library_path(m) == os.path.join(fresh[1], key)
    # the train script enables it, as the JAX one does
    monkeypatch.delenv("UTRL_BUILD_CACHE")
    train_script.train(helpers.get_args([
        "--task=go2", "--num_envs=8", "--device=cpu", "--max_iterations=0",
        f"--experiment_name={tmp_path / 'logs'}"]))
    assert cuda_step.BUILD_DIR == str(tmp_path / "moved")


def test_profile_residue_keys_and_differences(short_cfgs):
    src = jax_source("scripts/profile_residue.py")
    block = src[src.index("out = {"):src.index("print(json.dumps(out))")]
    jax_keys = re.findall(r'"(\w+)":', block)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        profile_residue.main(["--device=cpu", "--num_envs=8", "--iters=1"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(out) == jax_keys
    assert out["task"] == "go2" and out["num_envs"] == 8
    assert all(np.isfinite(v) and v > 0 for k, v in out.items()
               if k.endswith("_ms") and len(k) > 2 and k[1] == "_")
    for diff, a, b in (("policy_ms", "B_rollout_ms", "C_env_scan_ms"),
                       ("obs_noise_rng_ms", "C_env_scan_ms", "D_env_scan_no_noise_ms"),
                       ("env_residue_ms", "D_env_scan_no_noise_ms", "E_kernel_scan_ms"),
                       ("update_gae_ms", "A_full_iter_ms", "B_rollout_ms")):
        # each is rounded to 0.01 from the unrounded times, as in the JAX script
        assert abs(out[diff] - (out[a] - out[b])) <= 0.0101, diff
    assert out["env_steps_per_s"] == round(8 * STEPS / out["A_full_iter_ms"] * 1e3, 0)


def test_roofline_counts():
    assert rl.gemm_flops() == 4 * 2 * 8192 ** 3
    assert rl.thin_flops() == 32 * 2 * 24576 * (48 * 512 + 512 * 256 + 256 * 128 + 128 * 12)
    assert rl.fma_flops() == 2 * 256 * 8 * 2048 * 2048
    assert rl.fma_bytes() == 2 * 4 * 2048 * 2048
    assert rl.hbm_bytes() == 16 * 2 * 256 * 1024 * 1024
    assert set(rl.RATE_DATASHEET.values()) <= set(rl.DATASHEET_H100_SXM)


def test_fma_chain_plain_rounds_as_fmaf():
    """On a CPU tensor the wrapper runs the plain version; each round equals
    a float32 fused multiply-add (float64 product and sum, rounded once)."""
    x = (np.random.default_rng(0).random((32, 32)) + 0.5).astype(np.float32)
    want = x.copy()
    a, b = np.float32(rl.FMA_A), np.float32(rl.FMA_B)
    for _ in range(4 * rl.FMA_INNER):
        want = (want.astype(np.float64) * np.float64(a) + np.float64(b)).astype(np.float32)
    before = rl.LAUNCHES_FMA
    got = rl.fma_chain(torch.from_numpy(x), outer=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert rl.LAUNCHES_FMA == before
    with pytest.raises(ValueError):
        rl.fma_chain(torch.zeros(4, device="meta"))
