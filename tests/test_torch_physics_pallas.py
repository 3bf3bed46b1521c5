"""Port parity against the TPU kernel itself: the port's plain control step
(the reference of kernel K1) against ``pallas_step.control_step_pallas``
run in interpret mode, as tests/test_contact_stiffness.py runs it on the
CPU. go2, N=8, grounded; the tolerance of tests/test_torch_physics.py."""

import numpy as np

from tests.test_torch_kernel_host import (
    AUX_KEYS, STATE_FIELDS, assert_close, make_inputs, plain_step,
)
from tests.test_torch_physics import N, envs, jax_args, jax_flat  # noqa: F401
from unitree_rl_gym_tpu.physics import pallas_step
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


def test_plain_step_matches_pallas_interpret(envs):  # noqa: F811
    jenv, tenv, _ = envs
    cfg = jenv.cfg
    x = make_inputs(np.asarray(jenv.default_dof_pos), N, grounded=True, seed=2)
    ref = jax_flat(*pallas_step.control_step_pallas(
        jenv.robot.dyn, jenv.cparams, jenv.pd, cfg.sim.dt,
        cfg.control.decimation, *jax_args(x), jenv.m_eff_n, jenv.m_eff_t,
        interpret=True,
    ))
    assert_close(ref, plain_step(tenv, x), STATE_FIELDS + AUX_KEYS)
