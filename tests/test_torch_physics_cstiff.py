"""Port parity for the contact-stiffness control step (the plain version of
kernel K2): the port's ``backend.control_step_soa(..., cstiff=...)`` against
the JAX package's ``backend.control_step_soa(..., cstiff=...)`` on the go2
handstand's model (79 contact points, 29 report bodies, decimation 5,
torques not clipped) at N=8, grounded at the handstand's crouch, with
per-env stiffnesses 0.25 to 3.0. tests/test_torch_physics_cstiff_pallas.py
holds the same step against the Pallas kernel in interpret mode.

Tolerance: the JAX suite's backend bar (tests/test_torch_physics.py), atol
5e-5 / rtol 1e-4 on the state, aux / max(|aux|, 1) within 5e-4. With
``cstiff`` all ones the port's step is bit-identical to ``cstiff=None``.
The JAX side is the JAX package's robot build of the handstand's model with
the contact and PD constants its env derives from the config (torques not
clipped, as the handstand sets them); the contact preconditioner
``m_eff_n`` / ``m_eff_t``, an operand of the step, is the port's, which
tests/test_torch_env_handstand.py holds equal to the JAX env's. One JAX
program is compiled."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_kernel_host import (
    AUX_KEYS, CSTIFF, STATE_FIELDS, assert_close, handstand_env,
    handstand_inputs, plain_step,
)
from tests.test_torch_model import _contact_bodies
from unitree_rl_gym_tpu import resource as jax_resource
from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu.models.robot import build_robot as jax_build_robot
from unitree_rl_gym_tpu.physics import backend as jpb
from unitree_rl_gym_tpu.physics import contact as jct
from unitree_rl_gym_tpu.physics import engine as jeng
from unitree_rl_gym_tpu_torch.physics import backend as pb
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8


@pytest.fixture(scope="module")
def hs_envs():
    """(JAX side, port env) on the handstand's model, N=8: the JAX side
    carries what the JAX env's control step reads (its base_env.py
    __init__ builds the same robot, contact and PD constants)."""
    tenv = handstand_env(N)
    cfg, _ = jax_registry.get_cfgs("go2_handstand")
    robot = jax_build_robot(
        jax_resource(cfg.asset.file), armature=cfg.asset.armature,
        gravity=tuple(cfg.sim.gravity), contact_bodies=_contact_bodies(cfg))
    kp, kd = robot.pd_gains(cfg.control.stiffness, cfg.control.damping)
    jside = types.SimpleNamespace(
        cfg=cfg, robot=robot,
        cparams=jct.ContactParams(
            iterations=cfg.sim.contact_iterations,
            baumgarte=cfg.sim.contact_baumgarte,
            max_depenetration_velocity=cfg.sim.max_depenetration_velocity,
            terrain_friction=cfg.terrain.static_friction,
            max_angular_velocity=cfg.asset.max_angular_velocity,
            max_linear_velocity=cfg.asset.max_linear_velocity),
        # the handstand's PD: torques not clipped
        pd=jeng.PDParams(kp=np.asarray(kp, np.float32), kd=np.asarray(kd, np.float32),
                         torque_limit=np.asarray(robot.dof_effort, np.float32),
                         clip_torque=False),
        m_eff_n=tenv.m_eff_n, m_eff_t=tenv.m_eff_t)
    return jside, tenv


def jax_hs_args(x):
    s = jeng.PhysicsState(**{k: jnp.asarray(x[k]) for k in STATE_FIELDS})
    return (s, jnp.asarray(x["target"]), jnp.asarray(x["friction"]),
            jnp.asarray(x["mass_scale"]))


def jax_hs_flat(state, aux):
    out = {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}
    out.update({k: np.asarray(aux[k]) for k in AUX_KEYS})
    return out


def test_models_match(hs_envs):
    jenv, tenv = hs_envs
    jm, tm = jpb.soa_model_for(jenv.robot.dyn), pb.soa_model_for(tenv.robot.dyn)
    assert (jm.ncp, jm.nrb, jm.nv) == (tm.ncp, tm.nrb, tm.nv) == (79, 29, 18)
    assert jenv.pd.clip_torque is tenv.pd.clip_torque is False
    assert jenv.cfg.control.decimation == tenv.cfg.control.decimation == 5


@pytest.fixture(scope="module")
def jax_vs_plain(hs_envs):
    jenv, tenv = hs_envs
    cfg = jenv.cfg
    x = handstand_inputs(tenv, N, seed=2)

    @jax.jit
    def jstep(s, t, f, m, cs):
        return jpb.control_step_soa(
            jenv.robot.dyn, jenv.cparams, jenv.pd, cfg.sim.dt,
            cfg.control.decimation, s, t, f, m, jenv.m_eff_n, jenv.m_eff_t,
            cstiff=cs)

    ref = jax_hs_flat(*jstep(*jax_hs_args(x), jnp.asarray(x["cstiff"])))
    return x, ref, plain_step(tenv, x)


@pytest.mark.parametrize("output", STATE_FIELDS + AUX_KEYS)
def test_plain_cstiff_step_matches_jax_soa(jax_vs_plain, output):
    x, ref, got = jax_vs_plain
    assert set(x["cstiff"].tolist()) >= {0.25, 3.0}
    assert float(np.abs(got["cf_rb"]).max()) > 1.0
    assert_close(ref, got, [output])


def test_cstiff_ones_is_bit_identical_to_none(hs_envs):
    _, tenv = hs_envs
    x = handstand_inputs(tenv, N, seed=3)
    x["cstiff"] = np.ones(N, np.float32)
    ones = plain_step(tenv, x)
    x.pop("cstiff")
    none = plain_step(tenv, x)
    for k in STATE_FIELDS + AUX_KEYS:
        np.testing.assert_array_equal(ones[k], none[k], err_msg=k)


def test_stiffer_contact_settles_higher(hs_envs):
    """The JAX suite's monotone check (tests/test_contact_stiffness.py) on
    the port: from the same grounded state, the stiffest env ends the step
    no lower than the softest."""
    _, tenv = hs_envs
    x = handstand_inputs(tenv, N, seed=2)
    x["base_pos"][:] = x["base_pos"][0]
    x["joint_q"][:] = x["joint_q"][0]
    x["v"][:] = 0.0
    x["friction"][:] = 1.0
    x["mass_scale"][:] = 1.0
    z = plain_step(tenv, x)["base_pos"][:, 2]
    assert CSTIFF[0] == 0.25 and CSTIFF[-1] == 3.0
    assert z[-1] > z[0] - 1e-4, z
