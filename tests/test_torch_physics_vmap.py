"""Port parity of the per-env vmap formulation (module 13):
``backend.control_step_vmap``, ``engine.control_step`` mapped over the env
batch with ``torch.func.vmap``, against the JAX package's
``backend.control_step_vmap`` and against the port's batched plain version
(``backend.control_step_soa``), at N=8, on the states of
tests/test_soa_backend.py rebuilt with numpy: go2 grounded and airborne
(``make_inputs``) and g1 at its spawn pose with small random velocities.
Tolerance: the JAX suite's own bar between these backends
(tests/test_soa_backend.py:55-68): atol 5e-5 / rtol 1e-4 on the state,
aux / max(|aux|, 1) within 5e-4.

The per-env stages of the first substep (``dynamics.bias_forces``,
``mass_matrix``, ``forward_dynamics``, ``contact.contact_solve`` and
``dynamics.integrate``), mapped over the same envs, agree with JAX's:
each output divided by max(|output|, 1) over all its entries (the aux
rule) within 1e-5 (qdd's solve sums its products in an order each library
picks, so its small entries are not held to 1e-5 of themselves). On the tiny heightfield,
``control_step_vmap(ground_fn=...)`` agrees with
``control_step_soa(ground_fn=...)`` (the per-substep sampling of both).

One JAX program is compiled per topology (go2, g1): the vmapped control
step and the vmapped stages together."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernel_host import (
    AUX_KEYS, STATE_FIELDS, assert_close, make_inputs, terrain_env,  # noqa: F401
    terrain_inputs,
)
from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu.physics import backend as jpb
from unitree_rl_gym_tpu.physics import contact as jct
from unitree_rl_gym_tpu.physics import dynamics as jdyn
from unitree_rl_gym_tpu.physics import engine as jeng
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.physics import backend as pb
from unitree_rl_gym_tpu_torch.physics import contact as tct
from unitree_rl_gym_tpu_torch.physics import dynamics as tdyn
from unitree_rl_gym_tpu_torch.physics import engine as teng
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8
STAGES = ("bias", "H", "qdd", "v_contact", "cf_rb", "base_pos", "base_quat",
          "joint_q", "v")
CASES = [("go2", True), ("go2", False), ("g1", True)]


def g1_inputs(env, seed):
    """tests/test_soa_backend.py:73-88 with numpy: g1 at its spawn height,
    identity orientation, the default pose, velocities 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    dd = np.asarray(env.default_dof_pos, np.float32)
    nj = dd.shape[0]
    return dict(
        base_pos=np.tile(np.float32(env.cfg.init_state.pos), (N, 1)),
        base_quat=np.tile(np.float32([0.0, 0.0, 0.0, 1.0]), (N, 1)),
        joint_q=np.tile(dd, (N, 1)),
        v=(0.05 * rng.standard_normal((N, 6 + nj))).astype(np.float32),
        target=np.tile(dd, (N, 1)),
        friction=np.ones(N, np.float32),
        mass_scale=np.ones(N, np.float32),
    )


def jax_stages(model, cparams, pd, dt, m_eff_n, m_eff_t):
    """The first substep's per-env stages of ``engine.control_step``."""

    def one(p, tgt, fric, mass):
        fk_out = jdyn.fk(model, p.base_pos, p.base_quat, p.joint_q, p.v)
        R_w, p_w, (E_up, r_up), _ = fk_out
        no_ext = jnp.zeros((model.nb, 6))
        tau = jnp.clip(pd.kp * (tgt - p.joint_q) - pd.kd * p.v[6:],
                       -pd.torque_limit, pd.torque_limit)
        H = jdyn.mass_matrix(model, fk_out, mass)
        qdd = jdyn.forward_dynamics(model, fk_out, p.v, tau, no_ext, mass)
        v_c, cf = jct.contact_solve(model, cparams, E_up, r_up, R_w, p_w,
                                    jdyn.cholesky_inverse(H), p.v + dt * qdd,
                                    m_eff_n, m_eff_t, fric, dt)
        bp, bq, q, v = jdyn.integrate(model, p.base_pos, p.base_quat,
                                      p.joint_q, p.v, qdd, dt)
        return dict(bias=jdyn.bias_forces(model, fk_out, p.v, no_ext, mass),
                    H=H, qdd=qdd, v_contact=v_c, cf_rb=cf, base_pos=bp,
                    base_quat=bq, joint_q=q, v=v)

    return jax.vmap(one)


def torch_stages(model, cparams, pd, dt, m_eff_n, m_eff_t):
    """The port's counterpart of :func:`jax_stages`."""
    kp, kd, lim = (torch.as_tensor(np.asarray(a, np.float32))
                   for a in (pd.kp, pd.kd, pd.torque_limit))
    men, met = (torch.as_tensor(np.asarray(a, np.float32)) for a in (m_eff_n, m_eff_t))

    def one(bp, bq, q, v, tgt, fric, mass):
        fk_out = tdyn.fk(model, bp, bq, q, v)
        R_w, p_w, (E_up, r_up), _ = fk_out
        no_ext = torch.zeros((model.nb, 6))
        tau = torch.clamp(kp * (tgt - q) - kd * v[6:], -lim, lim)
        H = tdyn.mass_matrix(model, fk_out, mass)
        qdd = tdyn.forward_dynamics(model, fk_out, v, tau, no_ext, mass)
        v_c, cf = tct.contact_solve(model, cparams, E_up, r_up, R_w, p_w,
                                    tdyn.cholesky_inverse(H), v + dt * qdd,
                                    men, met, fric, dt)
        bp2, bq2, q2, v2 = tdyn.integrate(model, bp, bq, q, v, qdd, dt)
        return dict(bias=tdyn.bias_forces(model, fk_out, v, no_ext, mass),
                    H=H, qdd=qdd, v_contact=v_c, cf_rb=cf, base_pos=bp2,
                    base_quat=bq2, joint_q=q2, v=v2)

    return torch.func.vmap(one)


@pytest.fixture(scope="module")
def sides():
    """Per task: the JAX env, the port env and the task's one jitted JAX
    program (control_step_vmap and the stages)."""
    out = {}
    for task in ("go2", "g1"):
        jcfg, _ = jax_registry.get_cfgs(task)
        jcfg.env.num_envs = N
        jenv = jax_registry.get_task_class(task)(jcfg)
        tcfg, _ = task_registry.get_cfgs(task)
        tcfg.env.num_envs = N
        tenv = task_registry.get_task_class(task)(tcfg, device="cpu")
        args = (jenv.robot.dyn, jenv.cparams, jenv.pd, jcfg.sim.dt)
        stages = jax_stages(*args, jenv.m_eff_n, jenv.m_eff_t)

        def program(s, t, f, m, args=args, stages=stages, dec=jcfg.control.decimation,
                    jenv=jenv):
            return (jpb.control_step_vmap(*args, dec, s, t, f, m, jenv.m_eff_n,
                                          jenv.m_eff_t), stages(s, t, f, m))

        out[task] = (jenv, tenv, jax.jit(program))
    return out


def _inputs(sides, task, grounded):
    jenv, tenv, _ = sides[task]
    if task == "g1":
        return g1_inputs(jenv, seed=5)
    return make_inputs(np.asarray(jenv.default_dof_pos), N, grounded, seed=3)


@pytest.fixture(scope="module")
def runs(sides):
    """Per case: the JAX program's outputs and the port's (control_step_vmap,
    control_step_soa, stages), all on the JAX env's m_eff."""
    out = {}
    for task, grounded in CASES:
        jenv, tenv, program = sides[task]
        x = _inputs(sides, task, grounded)
        s = jeng.PhysicsState(**{k: jnp.asarray(x[k]) for k in STATE_FIELDS})
        jx = (s, jnp.asarray(x["target"]), jnp.asarray(x["friction"]),
              jnp.asarray(x["mass_scale"]))
        (jstate, jaux), jst = program(*jx)
        cfg = tenv.cfg
        t = {k: torch.from_numpy(v) for k, v in x.items()}
        ts = teng.PhysicsState(**{k: t[k] for k in STATE_FIELDS})
        args = (tenv.robot.dyn, tenv.cparams, tenv.pd, cfg.sim.dt, cfg.control.decimation,
                ts, t["target"], t["friction"], t["mass_scale"],
                np.asarray(jenv.m_eff_n), np.asarray(jenv.m_eff_t))
        vmap = pb.control_step_vmap(*args)
        soa = pb.control_step_soa(*args)
        tst = torch_stages(tenv.robot.dyn, tenv.cparams, tenv.pd, cfg.sim.dt,
                           jenv.m_eff_n, jenv.m_eff_t)(
            *(t[k] for k in STATE_FIELDS), t["target"], t["friction"], t["mass_scale"])

        def flat(state, aux):
            d = {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}
            d.update({k: np.asarray(aux[k]) for k in AUX_KEYS})
            return d

        out[(task, grounded)] = dict(
            jax=flat(jstate, jaux), vmap=flat(*vmap), soa=flat(*soa),
            jax_stages={k: np.asarray(v) for k, v in jst.items()},
            stages={k: v.numpy() for k, v in tst.items()})
    return out


IDS = [f"{t}-{'grounded' if g else 'airborne'}" for t, g in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_vmap_matches_jax_vmap(runs, case):
    r = runs[case]
    assert_close(r["jax"], r["vmap"], STATE_FIELDS + AUX_KEYS)
    if case == ("go2", True):
        # the grounded pose must actually produce contact forces
        assert float(np.abs(r["vmap"]["cf_rb"]).max()) > 1.0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_vmap_matches_plain_version(runs, case):
    r = runs[case]
    assert_close(r["soa"], r["vmap"], STATE_FIELDS + AUX_KEYS)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_per_env_stage_matches_jax(runs, case, stage):
    r = runs[case]
    ref, got = r["jax_stages"][stage], r["stages"][stage]
    assert got.shape == ref.shape
    mag = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got / mag, ref / mag, atol=1e-5, rtol=0, err_msg=stage)


def test_vmap_ground_fn_matches_plain_version(terrain_env):  # noqa: F811
    """On the tiny heightfield both formulations sample the ground at every
    substep's own point positions."""
    env = terrain_env
    x = terrain_inputs(env, N, seed=2)
    x.pop("gh")
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cfg = env.cfg
    args = (env.robot.dyn, env.cparams, env.pd, cfg.sim.dt, cfg.control.decimation,
            teng.PhysicsState(**{k: t[k] for k in STATE_FIELDS}), t["target"],
            t["friction"], t["mass_scale"], env.m_eff_n, env.m_eff_t)
    vs, va = pb.control_step_vmap(*args, ground_fn=env.grid.height_at)
    ss, sa = pb.control_step_soa(*args, ground_fn=env.grid.height_at)
    flat = {}
    for name, (s, a) in (("vmap", (vs, va)), ("soa", (ss, sa))):
        flat[name] = {k: getattr(s, k).numpy() for k in STATE_FIELDS}
        flat[name].update({k: a[k].numpy() for k in AUX_KEYS})
    assert_close(flat["soa"], flat["vmap"], STATE_FIELDS + AUX_KEYS)
    # the ground is real: contact on the heightfield, not at z = 0
    gh = pb.sample_point_heights(env.robot.dyn, args[5], env.grid.height_at)
    assert float(gh.abs().max()) > 0.01
    assert float(np.abs(flat["vmap"]["cf_rb"]).max()) > 1.0
