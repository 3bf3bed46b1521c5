"""Port parity of the go2 handstand env (``envs/go2_handstand.py``) against
the JAX package's ``GO2HandstandEnv`` at N=8, on the fine-tune recipe's
env config (the DR of scripts/handstand_transfer_r5.py) with noise and
pushes off, before any step (tests/test_torch_env_handstand_step.py holds
the steps):

  * the model build (79 contact points, 29 report bodies): every
    ``DynModel`` and ``SoAModel`` field as tests/test_torch_model.py holds
    them, and the contact preconditioner;
  * the reset's FK tables (mid-transition and balance-corrected hold)
    within 1e-5;
  * the PD target with the rear-leg clamp, on actions large enough to hit
    it, within 1e-6;
  * the reward terms and their scales.

The JAX env builds its tables on the host (~30 s on one CPU core); no JAX
program is compiled."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import finetune_cfgs
from tests.test_torch_model import _same_fields
from unitree_rl_gym_tpu.envs import go2_handstand as jhs
from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu.physics import backend as jpb
from unitree_rl_gym_tpu.physics import dynamics as jdyn
from unitree_rl_gym_tpu.physics import soa as jsoa
from unitree_rl_gym_tpu_torch.envs import go2_handstand as ths
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.physics import backend as pb
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8
# the handstand's reward terms with a nonzero scale, and termination
HS_TERMS = ["orientation", "base_height", "front_feet_contact",
            "hind_feet_no_contact", "pose", "stability", "stay_still",
            "lin_vel_xy", "lin_vel_z", "ang_vel_xy", "torques", "dof_vel",
            "action_rate", "dof_pos_limits", "collision", "front_hip_neutral",
            "front_feet_together", "termination"]


def _cfg(registry):
    """The fine-tune's env cfg (chip_smoke.py's ``finetune_cfgs``: the DR of
    scripts/handstand_transfer_r5.py:172-194) from ``registry``, the JAX
    package's or the port's, at N=8 with noise and pushes off."""
    cfg, _ = finetune_cfgs(registry, N)
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    return cfg


@pytest.fixture(scope="module")
def envs():
    jenv = jhs.GO2HandstandEnv(_cfg(jax_registry))
    tenv = ths.GO2HandstandEnv(_cfg(task_registry), device="cpu")
    return jenv, tenv


def test_model_build_matches(envs):
    jenv, tenv = envs
    jm, tm = jpb.soa_model_for(jenv.robot.dyn), pb.soa_model_for(tenv.robot.dyn)
    assert (tm.ncp, tm.nrb) == (79, 29)
    _same_fields(jdyn.DynModel, jenv.robot.dyn, tenv.robot.dyn)
    _same_fields(jsoa.SoAModel, jm, tm)
    np.testing.assert_allclose(tenv.m_eff_n, jenv.m_eff_n, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tenv.m_eff_t, jenv.m_eff_t, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("table,i", [("mid", 0), ("mid", 1), ("mid", 2),
                                     ("hold", 0), ("hold", 1), ("hold", 2),
                                     ("hold", 3)])
def test_reset_tables_match(envs, table, i):
    jenv, tenv = envs
    j = getattr(jenv, f"_{table}_tables")[i]
    t = getattr(tenv, f"_{table}_tables")[i]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_pd_target_rear_clamp_matches(envs):
    jenv, tenv = envs
    a = (3.0 * np.random.default_rng(0).standard_normal((N, 12))).astype(np.float32)
    j = np.asarray(jenv._compute_target(jnp.asarray(a)))
    t = tenv._compute_target(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    rear = tenv.rear_dof_idx.numpy()
    center = tenv.rear_center.numpy()
    # the clamp binds somewhere, and only the rear joints are clamped
    assert np.isclose(np.abs(t[:, rear] - center), ths.REAR_LIMIT).any()
    assert (np.abs(t[:, rear] - center) <= ths.REAR_LIMIT + 1e-6).all()
    assert not tenv.pd.clip_torque


def test_reward_terms_and_scales_match(envs):
    jenv, tenv = envs
    assert tenv.episode_term_names == jenv.episode_term_names == HS_TERMS
    np.testing.assert_allclose(tenv.reward_scales, jenv.reward_scales, rtol=1e-12)
