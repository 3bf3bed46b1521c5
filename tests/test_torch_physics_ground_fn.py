"""Port parity of the per-substep ``ground_fn`` terrain mode (module 6's
remainder): the plain control step sampling the heightfield at every
substep's own point positions (``backend.control_step_soa(ground_fn=...)``)
against the JAX package's, and ``backend.sample_point_heights`` against
JAX's, on the tiny heightfield of tests/test_pallas_terrain.py at N=8 and
the stock decimation of 4 (the frozen-height terrain parity tests run at
decimation 1, where the two formulations coincide).

Tolerances: the JAX suite's backend bar (atol 5e-5 / rtol 1e-4 on the
state and the end-of-step point xy, aux / max(|aux|, 1) within 5e-4);
heights within 1e-6. On the CPU, ``backend.control_step(ground_fn=...)``
is the plain version's per-substep sampling, bit for bit; the frozen-height
formulation (``gh = sample_point_heights(...)``, the kernels') stays within
the JAX suite's staleness budget of it (tests/test_pallas_terrain.py:101-113:
base_pos atol 5e-3, joint_q atol 2e-2). One JAX program is compiled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernel_host import (
    AUX_KEYS, POSITION_KEYS, STATE_FIELDS, assert_close, terrain_env,  # noqa: F401
    terrain_inputs, tiny_terrain,
)
from unitree_rl_gym_tpu.envs.base_env import LeggedEnv as JaxEnv
from unitree_rl_gym_tpu.envs.go2 import go2_rough_cfg as jax_go2_cfg
from unitree_rl_gym_tpu.physics import backend as jpb
from unitree_rl_gym_tpu.physics import engine as jeng
from unitree_rl_gym_tpu_torch.physics import backend as pb
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.physics import engine as teng
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8
STALE_ATOL = {"base_pos": 5e-3, "joint_q": 2e-2}


@pytest.fixture(scope="module")
def outputs(terrain_env):  # noqa: F811
    """The JAX and the port's per-substep control step, sampled heights and
    the port's other formulations, on the same inputs."""
    jcfg = tiny_terrain(jax_go2_cfg())
    jcfg.env.num_envs = N
    jenv = JaxEnv(jcfg)
    tenv = terrain_env
    np.testing.assert_array_equal(tenv.terrain.height_field_raw,
                                  jenv.terrain.height_field_raw)
    cfg = tenv.cfg
    assert cfg.control.decimation == 4
    x = terrain_inputs(tenv, N, seed=2)
    x.pop("gh")

    def program(s, t, f, m):
        state, aux = jpb.control_step_soa(
            jenv.robot.dyn, jenv.cparams, jenv.pd, jcfg.sim.dt,
            jcfg.control.decimation, s, t, f, m, jenv.m_eff_n, jenv.m_eff_t,
            ground_fn=jenv.ground_fn, want_pxy=True)
        return state, aux, jpb.sample_point_heights(jenv.robot.dyn, s, jenv.ground_fn)

    js = jeng.PhysicsState(**{k: jnp.asarray(x[k]) for k in STATE_FIELDS})
    jstate, jaux, jgh = jax.jit(program)(
        js, jnp.asarray(x["target"]), jnp.asarray(x["friction"]),
        jnp.asarray(x["mass_scale"]))
    ref = {k: np.asarray(getattr(jstate, k)) for k in STATE_FIELDS}
    ref.update({k: np.asarray(jaux[k]) for k in AUX_KEYS + ("p_xy",)})

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ts = teng.PhysicsState(**{k: t[k] for k in STATE_FIELDS})
    args = (tenv.robot.dyn, tenv.cparams, tenv.pd, cfg.sim.dt, cfg.control.decimation,
            ts, t["target"], t["friction"], t["mass_scale"], jenv.m_eff_n, jenv.m_eff_t)
    gf = tenv.grid.height_at

    def flat(state, aux):
        d = {k: getattr(state, k).numpy() for k in STATE_FIELDS}
        d.update({k: aux[k].numpy() for k in AUX_KEYS + ("p_xy",)})
        return d

    gh = pb.sample_point_heights(tenv.robot.dyn, ts, gf)
    launches = cuda_step.LAUNCHES_TERRAIN
    dispatch = flat(*pb.control_step(*args, ground_fn=gf))
    assert cuda_step.LAUNCHES_TERRAIN == launches
    return dict(
        jax=ref, jax_gh=np.asarray(jgh), gh=gh.numpy(),
        soa=flat(*pb.control_step_soa(*args, ground_fn=gf)),
        dispatch=dispatch,
        frozen=flat(*pb.control_step_soa(*args, gh=gh)),
    )


@pytest.mark.parametrize("output", POSITION_KEYS + AUX_KEYS)
def test_per_substep_step_matches_jax(outputs, output):
    assert_close(outputs["jax"], outputs["soa"], [output])
    if output == "cf_rb":
        assert float(np.abs(outputs["soa"]["cf_rb"]).max()) > 1.0


def test_sample_point_heights_matches_jax(outputs):
    gh = outputs["gh"]
    assert gh.shape == outputs["jax_gh"].shape == (outputs["soa"]["p_xy"].shape[0] // 2, N)
    np.testing.assert_allclose(gh, outputs["jax_gh"], atol=1e-6, rtol=0)
    # the envs stand on raised sub-terrain platforms: the heights are real
    assert float(np.abs(gh).max()) > 0.01


def test_control_step_on_cpu_samples_every_substep(outputs):
    """``backend.control_step`` with ``ground_fn`` and no ``gh`` on a CPU
    tensor is the plain version's per-substep sampling, launching nothing."""
    for k in POSITION_KEYS + AUX_KEYS:
        np.testing.assert_array_equal(outputs["dispatch"][k], outputs["soa"][k], err_msg=k)


def test_frozen_heights_within_staleness_budget(outputs):
    """Heights frozen at the step start (the kernels' formulation) stay
    within the JAX suite's staleness budget of the per-substep sampling, and
    differ from it (the per-substep mode is the one that ran)."""
    per, frozen = outputs["soa"], outputs["frozen"]
    for k, atol in STALE_ATOL.items():
        np.testing.assert_allclose(frozen[k], per[k], atol=atol, rtol=0, err_msg=k)
    assert any(not np.array_equal(frozen[k], per[k]) for k in STATE_FIELDS)
