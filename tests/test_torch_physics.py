"""Port parity for the physics control step: the port's plain PyTorch
version (``backend.control_step_soa``, the reference of kernel K1) against
the JAX package's ``backend.control_step_soa`` for go2 at N=8, grounded
and airborne (the states of tests/test_soa_backend.py, rebuilt with numpy).
tests/test_torch_physics_pallas.py holds the same step against the Pallas
kernel itself in interpret mode.

Tolerance: the bar the JAX suite sets between its own backends
(tests/test_soa_backend.py): atol 5e-5 / rtol 1e-4 on the state, aux
divided by max(|aux|, 1) within atol 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_kernel_host import (
    AUX_KEYS, STATE_FIELDS, assert_close, env_step, make_inputs, plain_step,
)
from unitree_rl_gym_tpu.envs.base_env import LeggedEnv as JaxEnv
from unitree_rl_gym_tpu.envs.go2 import go2_rough_cfg as jax_go2_cfg
from unitree_rl_gym_tpu.physics import backend as jpb
from unitree_rl_gym_tpu.physics import engine as jeng
from unitree_rl_gym_tpu_torch.envs.base_env import LeggedEnv
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg
from unitree_rl_gym_tpu_torch.physics import cuda_step
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8


@pytest.fixture(scope="module")
def envs():
    cfg = jax_go2_cfg()
    cfg.env.num_envs = N
    jenv = JaxEnv(cfg)
    tcfg = go2_rough_cfg()
    tcfg.env.num_envs = N
    tenv = LeggedEnv(tcfg, device="cpu")

    def jax_step(s, t, f, m):
        return jpb.control_step_soa(
            jenv.robot.dyn, jenv.cparams, jenv.pd, cfg.sim.dt,
            cfg.control.decimation, s, t, f, m, jenv.m_eff_n, jenv.m_eff_t,
        )

    return jenv, tenv, jax.jit(jax_step)


def jax_args(x):
    s = jeng.PhysicsState(**{k: jnp.asarray(x[k]) for k in STATE_FIELDS})
    return (s, jnp.asarray(x["target"]), jnp.asarray(x["friction"]),
            jnp.asarray(x["mass_scale"]))


def jax_flat(state, aux):
    out = {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}
    out.update({k: np.asarray(aux[k]) for k in AUX_KEYS})
    return out


@pytest.mark.parametrize("grounded", [True, False], ids=["grounded", "airborne"])
def test_plain_step_matches_jax_soa(envs, grounded):
    jenv, tenv, jstep = envs
    x = make_inputs(np.asarray(jenv.default_dof_pos), N, grounded, seed=0)
    ref = jax_flat(*jstep(*jax_args(x)))
    got = plain_step(tenv, x)
    assert_close(ref, got, STATE_FIELDS + AUX_KEYS)
    if grounded:
        # the grounded pose must actually produce contact forces
        assert float(np.abs(got["cf_rb"]).max()) > 1.0


@pytest.mark.parametrize("grounded", [True, False], ids=["grounded", "airborne"])
def test_wrapper_on_cpu_runs_plain_version(envs, grounded):
    """The env's control step (``backend.control_step``) on a CPU tensor is
    the plain version and launches nothing."""
    _, tenv, _ = envs
    x = make_inputs(tenv.default_dof_pos.numpy(), N, grounded, seed=1)
    before = cuda_step.LAUNCHES
    ref = plain_step(tenv, x)
    got = env_step(tenv, x)
    assert cuda_step.LAUNCHES == before
    for k in STATE_FIELDS + AUX_KEYS:
        np.testing.assert_array_equal(got[k], ref[k])
