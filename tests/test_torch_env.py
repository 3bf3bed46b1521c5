"""Port parity: the PyTorch ``LeggedEnv.step`` (unitree_rl_gym_tpu_torch,
on the CPU, through the plain physics version) against the JAX
``LeggedEnv.step`` for go2 at N=8, starting from one JAX ``reset_all``
converted with ``EnvState.from_numpy``.

Noise and pushes are off, so a step draws randomness only for resets (and
command resampling, which does not fall in these steps); the two packages
draw from different generators, so steps are compared only until the first
env resets, and at least 10 must be compared. Tolerance: the physics bar
the JAX suite sets between its own backends (tests/test_soa_backend.py),
atol 5e-5 / rtol 1e-4; ``done`` must match exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.envs.base_env import LeggedEnv as JaxEnv
from unitree_rl_gym_tpu.envs.go2 import go2_rough_cfg as jax_go2_cfg
from unitree_rl_gym_tpu_torch.envs.base_env import EnvState, LeggedEnv
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8
STEPS = 16
TOL = dict(atol=5e-5, rtol=1e-4)


def _eval_cfg(cfg):
    cfg.env.num_envs = N
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    return cfg


def state_to_numpy(state) -> dict:
    """Numpy leaves of a JAX EnvState, in the layout EnvState.from_numpy
    takes."""
    d = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if f.name == "phys":
            d["phys"] = {k: np.asarray(getattr(val, k))
                         for k in ("base_pos", "base_quat", "joint_q", "v")}
        elif val is not None:
            d[f.name] = np.asarray(val)
    return d


@pytest.fixture(scope="module")
def traces():
    jenv = JaxEnv(_eval_cfg(jax_go2_cfg()))
    tenv = LeggedEnv(_eval_cfg(go2_rough_cfg()), device="cpu")
    jstate, _ = jenv.reset_all(jax.random.PRNGKey(0))
    tstate = EnvState.from_numpy(state_to_numpy(jstate), "cpu")
    step = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        a = (0.3 * rng.standard_normal((N, 12))).astype(np.float32)
        jstate, jobs, _, jrew, jdone, jext = step(jstate, jnp.asarray(a))
        tstate, tobs, _, trew, tdone, text = tenv.step(tstate, torch.from_numpy(a))
        out.append((state_to_numpy(jstate), np.asarray(jobs), np.asarray(jrew),
                    np.asarray(jdone), np.asarray(jext["time_outs"]),
                    tstate, tobs.numpy(), trew.numpy(), tdone.numpy(),
                    text["time_outs"].numpy()))
    return jenv, tenv, out


def _compared(out):
    """Steps before the first reset in any env (both packages agree on
    where that is, checked by test_done_matches)."""
    n = 0
    for rec in out:
        if rec[3].any() or rec[8].any():
            break
        n += 1
    return out[:n]


def test_enough_steps_compared(traces):
    _, _, out = traces
    assert len(_compared(out)) >= 10


def test_done_matches(traces):
    _, _, out = traces
    for rec in _compared(out) + out[len(_compared(out)):][:1]:
        np.testing.assert_array_equal(rec[3], rec[8])
        np.testing.assert_array_equal(rec[4], rec[9])


@pytest.mark.parametrize("field", ["base_pos", "base_quat", "joint_q", "v"])
def test_physics_state_matches(traces, field):
    _, _, out = traces
    for rec in _compared(out):
        np.testing.assert_allclose(
            getattr(rec[5].phys, field).numpy(), rec[0]["phys"][field], **TOL
        )


@pytest.mark.parametrize("what", ["obs", "reward", "episode_sums", "commands",
                                  "feet_air_time", "last_contacts"])
def test_env_outputs_match(traces, what):
    _, _, out = traces
    for rec in _compared(out):
        j, t = {
            "obs": (rec[1], rec[6]),
            "reward": (rec[2], rec[7]),
            "episode_sums": (rec[0]["episode_sums"], rec[5].episode_sums.numpy()),
            "commands": (rec[0]["commands"], rec[5].commands.numpy()),
            "feet_air_time": (rec[0]["feet_air_time"],
                              rec[5].feet_air_time.numpy()),
            "last_contacts": (rec[0]["last_contacts"],
                              rec[5].last_contacts.numpy()),
        }[what]
        if j.dtype == bool:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **TOL)


def test_reward_terms_match(traces):
    jenv, tenv, _ = traces
    assert tenv.episode_term_names == jenv.episode_term_names
    np.testing.assert_allclose(tenv.reward_scales, jenv.reward_scales, rtol=1e-12)
