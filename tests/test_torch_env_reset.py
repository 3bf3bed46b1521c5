"""Port parity of ``LeggedEnv.step`` past resets: the PyTorch step (on the
CPU, through the plain physics version) against the JAX step for go2 at
N=16 on the tiny heightfield of tests/test_pallas_terrain.py, with the
terrain and command curricula, pushes and observation noise on, every env
compared through every step.

Each port step takes the JAX step's own draws (commands, curriculum
levels, reset states and spawn jitter, push velocities, noise), recomputed
from the JAX state's key (tests/torch_jax_draws.py), so the reset branch is
compared where it never was: the ``sel`` merge and state zeroing, the
episode-logging extras, the stale-window ``gh`` fallback at reset,
``_sample_reset``, ``terrain_curriculum_at_reset``,
``command_curriculum_at_reset`` and ``push_robots``. Episodes are short
(12 control steps, started at random lengths), pushes come every 6 steps
and at every reset, commands are resampled every 5 steps; decimation is 1,
where the JAX CPU path's per-substep heights coincide with the port's
frozen ``gh`` (tests/test_torch_env_terrain.py). The start state is the
port's ``reset_all`` after one JAX step (its ``gh`` carry then holds the
heights under the actual points).

``done`` and every integer or boolean field match exactly; every float at
the physics tolerance, atol 5e-5 / rtol 1e-4 (tests/test_soa_backend.py).
At least ``MIN_RESETS`` resets, with every env reset at least once, must
be compared. One JAX program (``env.step``) is compiled, and one small one
(the draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_env import state_to_numpy
from tests.test_torch_env_terrain import to_jax
from tests.test_torch_kernel_host import tiny_terrain
from tests.torch_jax_draws import Injected, step_draws_fn
from unitree_rl_gym_tpu.envs.base_env import LeggedEnv as JaxEnv
from unitree_rl_gym_tpu.envs.go2 import go2_rough_cfg as jax_go2_cfg
from unitree_rl_gym_tpu_torch.envs.base_env import EnvState, LeggedEnv
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg

N = 16
STEPS = 24
MIN_RESETS = 24
TOL = dict(atol=5e-5, rtol=1e-4)
EXTRAS = ("episode_sums_at_reset", "episode_reset_count",
          "episode_length_at_reset", "terrain_level_mean", "max_command_x",
          "time_outs")


def reset_cfg(cfg):
    """Short episodes on the tiny heightfield with every in-step draw on."""
    cfg = tiny_terrain(cfg)
    cfg.env.num_envs = N
    cfg.control.decimation = 1              # sim dt 0.005 s a control step
    cfg.env.episode_length_s = 0.06         # 12 control steps
    # the base spawns within +-1 m of its sub-terrain's origin, so on 2 m
    # sub-terrains many envs walk "past half of it" by their reset: they
    # move up a row, and off the last row to a random one
    cfg.terrain.terrain_length = cfg.terrain.terrain_width = 2.0
    cfg.commands.resampling_time = 0.025    # every 5 steps
    # commands start below the 0.2 m/s cut (zeroed): the envs stand, track
    # well, and the command curriculum widens the vx range at the resets
    # of whole episodes
    cfg.commands.curriculum = True
    cfg.commands.ranges["lin_vel_x"] = [-0.1, 0.1]
    cfg.commands.ranges["lin_vel_y"] = [-0.1, 0.1]
    cfg.noise.add_noise = True
    cfg.domain_rand.push_robots = True
    cfg.domain_rand.push_interval_s = 0.03  # every 6 steps, and at reset
    cfg.domain_rand.max_push_vel_xy = 0.1
    return cfg


@pytest.fixture(scope="module")
def traces():
    jenv = JaxEnv(reset_cfg(jax_go2_cfg()))
    tenv = LeggedEnv(reset_cfg(go2_rough_cfg()), device="cpu")
    assert tenv.max_episode_length == jenv.max_episode_length == 12
    step = jax.jit(jenv.step)
    draws = step_draws_fn(jenv)
    tstate, _ = tenv.reset_all(init_at_random_ep_len=True)
    rng = np.random.default_rng(0)

    def actions():
        return (0.3 * rng.standard_normal((N, 12))).astype(np.float32)

    jstate, *_ = step(to_jax(tstate), jnp.asarray(actions()))
    tstate = EnvState.from_numpy(state_to_numpy(jstate), "cpu")
    inj = Injected(tenv)
    out = []
    for _ in range(STEPS):
        a = actions()
        d, key_after = draws(jstate.key)
        inj.feed(d)
        jstate, jobs, _, jrew, jdone, jext = step(jstate, jnp.asarray(a))
        assert np.array_equal(np.asarray(jstate.key), np.asarray(key_after))
        tstate, tobs, _, trew, tdone, text = tenv.step(tstate, torch.from_numpy(a))
        inj.done()
        out.append({
            "jax": state_to_numpy(jstate), "port": tstate,
            "obs": (np.asarray(jobs), tobs.numpy()),
            "reward": (np.asarray(jrew), trew.numpy()),
            "done": (np.asarray(jdone), tdone.numpy()),
            "extras": {k: (np.asarray(jext[k]), text[k].numpy()) for k in EXTRAS},
            "episode": {k: (np.asarray(v), text["episode"][k].numpy())
                        for k, v in jext["episode"].items()},
            "draws": len(d),
        })
    return jenv, tenv, inj, out


def _close(t, j, what):
    if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, err_msg=what, **TOL)


def test_resets_compared(traces):
    jenv, _, inj, out = traces
    done = np.stack([r["done"][0] for r in out])
    assert int(done.sum()) >= MIN_RESETS, int(done.sum())
    assert done.any(axis=0).all(), done.any(axis=0)
    # a reset env stands on its stale-window platform height until the
    # next refresh, and is pushed as its new episode starts
    assert any(r["jax"]["win_stale"].any() for r in out)
    pushed = sum(int((r["jax"]["episode_length"] % 6 == 0).sum()) for r in out)
    assert pushed >= N, pushed
    # the curricula acted: some reset moved an env's row, and the vx
    # command range widened from its start
    levels = np.stack([r["jax"]["terrain_level"] for r in out])
    assert (np.diff(levels, axis=0) != 0).any()
    assert out[-1]["jax"]["cmd_vx_range"][1] > 0.1 + 0.4
    assert inj.count == sum(r["draws"] for r in out) == STEPS * 12


def test_done_matches(traces):
    for i, rec in enumerate(traces[3]):
        np.testing.assert_array_equal(rec["done"][1], rec["done"][0], err_msg=str(i))


@pytest.mark.parametrize("field", [
    "base_pos", "base_quat", "joint_q", "v", "episode_length", "commands",
    "actions", "last_actions", "last_dof_vel", "feet_air_time",
    "last_contacts", "episode_sums", "env_origin", "terrain_level",
    "terrain_type", "cmd_vx_range", "obs", "gh", "win", "win_corner",
    "win_stale"])
def test_state_matches(traces, field):
    for i, rec in enumerate(traces[3]):
        j, t = rec["jax"], rec["port"]
        if field in ("base_pos", "base_quat", "joint_q", "v"):
            _close(getattr(t.phys, field).numpy(), j["phys"][field], f"{field} {i}")
        else:
            _close(getattr(t, field).numpy(), j[field], f"{field} {i}")


@pytest.mark.parametrize("what", ["obs", "reward"])
def test_outputs_match(traces, what):
    for i, rec in enumerate(traces[3]):
        _close(rec[what][1], rec[what][0], f"{what} {i}")


@pytest.mark.parametrize("key", EXTRAS + ("episode",))
def test_extras_match(traces, key):
    for i, rec in enumerate(traces[3]):
        pairs = rec["episode"] if key == "episode" else {key: rec["extras"][key]}
        for k, (j, t) in pairs.items():
            _close(t, j, f"{k} {i}")
