"""CPU smoke of the port's slice: ``scripts/play.py``'s loop for go2 at N=8
for 20 steps with ``device="cpu"`` (the physics through the plain version;
kernel K1 launches only on CUDA tensors)."""

import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu_torch import resolve_device
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.scripts import play
from unitree_rl_gym_tpu_torch.utils import helpers


@pytest.fixture(scope="module")
def run():
    args = helpers.get_args(["--task=go2", "--num_envs=8", "--device=cpu"])
    env = play.make_play_env(args, resolve_device(args.device))
    policy = load_flat_policy(play.policy_dir(args), env.device)
    before = cuda_step.LAUNCHES
    state, obs = env.reset_all()
    state, obs, stats = play.rollout(env, policy, state, obs, num_steps=20,
                                     settle=5)
    return env, state, obs, stats, cuda_step.LAUNCHES - before


def test_slice_outputs_finite(run):
    env, state, obs, stats, _ = run
    assert tuple(obs.shape) == (8, 48)
    assert torch.isfinite(obs).all()
    for k in ("base_pos", "base_quat", "joint_q", "v"):
        assert torch.isfinite(getattr(state.phys, k)).all()
    assert all(np.isfinite(v) for v in stats.values() if isinstance(v, float))


def test_slice_no_kernel_launch_on_cpu(run):
    assert run[4] == 0


def test_play_env_overrides(run):
    env = run[0]
    assert env.num_envs == 8          # --num_envs overrides the cap of 100
    assert not env.cfg.noise.add_noise
    assert not env.cfg.domain_rand.push_robots
    assert not env.cfg.domain_rand.randomize_friction


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)


@pytest.mark.parametrize("task", ["h1", "h1_2", "g1", "go2_handstand"])
def test_unported_tasks_raise(task):
    """Every task is ported now: its cfgs and class are registered, with
    the JAX package's obs sizes (privileged obs for the humanoids' critic)
    and, for the humanoids, the LSTM policy."""
    obs, priv, cls = {
        "h1": (41, 44, "H1Env"), "h1_2": (47, 50, "H1_2Env"),
        "g1": (47, 50, "G1Env"), "go2_handstand": (46, 46, "GO2HandstandEnv"),
    }[task]
    cfg, train_cfg = task_registry.get_cfgs(task)
    assert cfg.env.num_observations == obs
    assert cfg.env.num_privileged_obs == priv
    assert train_cfg.runner.experiment_name == task
    assert task_registry.get_task_class(task).__name__ == cls
    if task != "go2_handstand":
        assert train_cfg.runner.policy_class_name == "ActorCriticRecurrent"


@pytest.mark.parametrize("knob", ["heightfield", "contact_stiffness", "pd_gain",
                                  "act_delay"])
def test_unported_features_raise(knob):
    """Every knob here is ported now: the heightfield env builds its
    terrain, and each DR knob builds an env whose reset draws the knob's
    per-env values within their range."""
    cfg, _ = task_registry.get_cfgs("go2")
    cfg.env.num_envs = 2
    if knob == "heightfield":
        cfg.terrain.mesh_type = "heightfield"
        env = task_registry.get_task_class("go2")(cfg, device="cpu")
        assert env.terrain is not None and env.grid.heights.shape == (1300, 2100)
        return
    if knob == "contact_stiffness":
        cfg.domain_rand.randomize_contact_stiffness = True
        field, (lo, hi) = "cstiff", cfg.domain_rand.contact_stiffness_range
    elif knob == "pd_gain":
        cfg.domain_rand.randomize_pd_gain = True
        field, (lo, hi) = "pd_gain", cfg.domain_rand.pd_gain_range
    else:
        cfg.domain_rand.action_delay_prob = 0.5
        field, (lo, hi) = "act_delay", (0, 1)
    env = task_registry.get_task_class("go2")(cfg, device="cpu")
    state, obs = env.reset_all()
    drawn = getattr(state, field)
    assert drawn.shape == (2,)
    assert bool(((drawn >= lo) & (drawn <= hi)).all())
    assert torch.isfinite(obs).all()
