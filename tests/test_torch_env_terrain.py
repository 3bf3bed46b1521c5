"""Port parity of the terrain env: the PyTorch ``LeggedEnv.step`` on the
tiny heightfield of tests/test_pallas_terrain.py (terrain curriculum on,
on the CPU, through the plain physics version) against the JAX
``LeggedEnv.step`` for go2 at N=8, at decimation 1.

The port follows the JAX package's kernel formulation on every device
(heights under the points frozen over the control step, from the lag-1
``gh`` carry), while the JAX CPU path samples the heightfield every
substep; with one substep per control step the two coincide (the docstring
of tests/test_pallas_terrain.py). The JAX state that starts the comparison
is taken after one JAX step, so that its ``gh`` carry holds the heights
under the actual points (a reset seeds it from the default pose): the
port's ``reset_all`` state goes to JAX, takes one jitted JAX step, and
comes back with ``EnvState.from_numpy``. Noise and pushes are off; the two
packages draw from different generators, so steps are compared until the
first env resets, and at least 10 must be compared. Tolerance: atol 5e-5 /
rtol 1e-4 (tests/test_torch_env.py), the height carry ``gh`` within 1e-5;
``done`` must match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_env import state_to_numpy
from tests.test_torch_kernel_host import tiny_terrain
from unitree_rl_gym_tpu.envs.base_env import EnvState as JaxEnvState
from unitree_rl_gym_tpu.envs.base_env import LeggedEnv as JaxEnv
from unitree_rl_gym_tpu.envs.go2 import go2_rough_cfg as jax_go2_cfg
from unitree_rl_gym_tpu.physics import engine as jeng
from unitree_rl_gym_tpu_torch.envs.base_env import EnvState, LeggedEnv
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg

N = 8
STEPS = 14
TOL = dict(atol=5e-5, rtol=1e-4)


def _cfg(cfg):
    cfg = tiny_terrain(cfg)
    cfg.env.num_envs = N
    cfg.control.decimation = 1
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    return cfg


def to_jax(state) -> JaxEnvState:
    """The port's EnvState as a JAX EnvState (PRNG key 0)."""
    kw = {}
    for f in JaxEnvState.__dataclass_fields__:
        if f == "phys":
            kw[f] = jeng.PhysicsState(**{
                k: jnp.asarray(getattr(state.phys, k).numpy())
                for k in ("base_pos", "base_quat", "joint_q", "v")})
        elif f == "key":
            kw[f] = jax.random.PRNGKey(0)
        else:
            val = getattr(state, f, None)
            kw[f] = None if val is None else jnp.asarray(val.numpy())
    return JaxEnvState(**kw)


@pytest.fixture(scope="module")
def traces():
    jenv = JaxEnv(_cfg(jax_go2_cfg()))
    tenv = LeggedEnv(_cfg(go2_rough_cfg()), device="cpu")
    np.testing.assert_array_equal(tenv.terrain.height_field_raw,
                                  jenv.terrain.height_field_raw)
    step = jax.jit(jenv.step)
    tstate, _ = tenv.reset_all()
    rng = np.random.default_rng(0)

    def actions():
        return (0.3 * rng.standard_normal((N, 12))).astype(np.float32)

    jstate, *_ = step(to_jax(tstate), jnp.asarray(actions()))
    tstate = EnvState.from_numpy(state_to_numpy(jstate), "cpu")
    out = []
    for _ in range(STEPS):
        a = actions()
        jstate, jobs, _, jrew, jdone, jext = step(jstate, jnp.asarray(a))
        tstate, tobs, _, trew, tdone, text = tenv.step(tstate, torch.from_numpy(a))
        out.append((state_to_numpy(jstate), np.asarray(jobs), np.asarray(jrew),
                    np.asarray(jdone), tstate, tobs.numpy(), trew.numpy(),
                    tdone.numpy(), float(jext["terrain_level_mean"]),
                    float(text["terrain_level_mean"])))
    return out


def _compared(out):
    n = 0
    for rec in out:
        if rec[3].any() or rec[7].any():
            break
        n += 1
    return out[:n]


def test_enough_steps_compared(traces):
    assert len(_compared(traces)) >= 10


def test_done_matches(traces):
    n = len(_compared(traces))
    for rec in traces[:n + 1]:
        np.testing.assert_array_equal(rec[3], rec[7])


@pytest.mark.parametrize("field", ["base_pos", "base_quat", "joint_q", "v"])
def test_physics_state_matches(traces, field):
    for rec in _compared(traces):
        np.testing.assert_allclose(
            getattr(rec[4].phys, field).numpy(), rec[0]["phys"][field], **TOL)


@pytest.mark.parametrize("what", ["obs", "reward", "gh", "terrain"])
def test_env_outputs_match(traces, what):
    for rec in _compared(traces):
        j, t = rec[0], rec[4]
        if what == "obs":
            np.testing.assert_allclose(rec[5], rec[1], **TOL)
        elif what == "reward":
            np.testing.assert_allclose(rec[6], rec[2], **TOL)
        elif what == "gh":
            assert float(np.abs(j["gh"]).max()) > 0.0
            # K3 takes gh as a contiguous [ncp, N] operand
            assert t.gh.is_contiguous()
            np.testing.assert_allclose(t.gh.numpy(), j["gh"], atol=1e-5)
            np.testing.assert_array_equal(t.win_stale.numpy(), j["win_stale"])
        else:
            np.testing.assert_array_equal(t.terrain_level.numpy(), j["terrain_level"])
            np.testing.assert_allclose(t.env_origin.numpy(), j["env_origin"], **TOL)
            assert rec[9] == pytest.approx(rec[8])
