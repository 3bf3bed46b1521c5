"""Port parity for the terrain control step against the TPU kernel itself:
the port's plain control step with per-point ground heights ``gh`` (the
reference of kernel K3) against ``pallas_step.control_step_pallas(...,
gh=gh)`` run in interpret mode, as tests/test_pallas_terrain.py runs it on
the CPU. go2, N=8, decimation 4, standing on the tiny heightfield of that
test; the end-of-step point xy (``p_xy``) included. Tolerance: the JAX
suite's backend bar of tests/test_torch_physics.py (atol 5e-5 / rtol 1e-4
on positions, aux / max(|aux|, 1) within 5e-4)."""

import jax.numpy as jnp
import numpy as np

from tests.test_torch_kernel_host import (  # noqa: F401
    AUX_KEYS, POSITION_KEYS, assert_close, plain_step, terrain_env,
    terrain_inputs,
)
from tests.test_torch_physics import N, envs, jax_args, jax_flat  # noqa: F401
from unitree_rl_gym_tpu.physics import pallas_step
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


def test_plain_terrain_step_matches_pallas_interpret(envs, terrain_env):  # noqa: F811
    jenv, _, _ = envs
    cfg = jenv.cfg
    x = terrain_inputs(terrain_env, N, seed=2)
    gh = x.pop("gh")
    state, aux = pallas_step.control_step_pallas(
        jenv.robot.dyn, jenv.cparams, jenv.pd, cfg.sim.dt,
        cfg.control.decimation, *jax_args(x), jenv.m_eff_n, jenv.m_eff_t,
        interpret=True, gh=jnp.asarray(gh),
    )
    p_xy = np.asarray(aux.pop("p_xy"))
    ref = dict(jax_flat(state, aux), p_xy=p_xy)
    got = plain_step(terrain_env, dict(x, gh=gh))
    # the heights are real: some points stand on ground above z = 0
    assert float(np.abs(gh).max()) > 0.01
    assert float(np.abs(got["cf_rb"]).max()) > 1.0
    assert_close(ref, got, POSITION_KEYS + AUX_KEYS)
