"""Port parity for the contact-stiffness control step against the TPU kernel
itself: the port's plain ``backend.control_step_soa(..., cstiff=...)`` (the
reference of kernel K2) against ``pallas_step.control_step_pallas(...,
cstiff=...)`` run in interpret mode, as tests/test_contact_stiffness.py
runs it on the CPU: the go2 handstand's model (79 contact points,
decimation 5), N=8, grounded, per-env stiffnesses 0.25 to 3.0. Tolerance:
the JAX suite's backend bar of tests/test_torch_physics.py (atol 5e-5 /
rtol 1e-4 on the state, aux / max(|aux|, 1) within 5e-4). The Pallas
interpreter's program is compiled once."""

import jax.numpy as jnp

from tests.test_torch_kernel_host import (
    AUX_KEYS, STATE_FIELDS, assert_close, handstand_inputs, plain_step,
)
from tests.test_torch_physics_cstiff import (  # noqa: F401
    N, hs_envs, jax_hs_args, jax_hs_flat,
)
from unitree_rl_gym_tpu.physics import pallas_step
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


def test_plain_cstiff_step_matches_pallas_interpret(hs_envs):  # noqa: F811
    jenv, tenv = hs_envs
    cfg = jenv.cfg
    x = handstand_inputs(tenv, N, seed=2)
    ref = jax_hs_flat(*pallas_step.control_step_pallas(
        jenv.robot.dyn, jenv.cparams, jenv.pd, cfg.sim.dt,
        cfg.control.decimation, *jax_hs_args(x), jenv.m_eff_n, jenv.m_eff_t,
        interpret=True, cstiff=jnp.asarray(x["cstiff"]),
    ))
    assert_close(ref, plain_step(tenv, x), STATE_FIELDS + AUX_KEYS)
