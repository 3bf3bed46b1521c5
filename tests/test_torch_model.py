"""Port parity for the model build of go2 (the slice's robot, configured by
the port's own ``envs/go2.py``) and of the humanoids g1, h1 and h1_2 (their
``envs/{g1,h1,h1_2}.py``: the cached ``collision_points.json`` of g1's and
h1_2's mesh collisions, h1's URDF shapes): every ``DynModel`` and
``SoAModel`` field equals the JAX package's build, and so does the PGS
preconditioner ``m_eff_n``/``m_eff_t``. Integers exactly; floats within
1e-6 (absolute and relative: the preconditioner is a float32
Cholesky-inverse chain computed in another operation order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu import resource as jax_resource
from unitree_rl_gym_tpu.envs.registry import task_registry
from unitree_rl_gym_tpu.models.robot import build_robot as jax_build_robot
from unitree_rl_gym_tpu.physics import backend as jpb
from unitree_rl_gym_tpu.physics import contact as jct
from unitree_rl_gym_tpu.physics import dynamics as jdyn
from unitree_rl_gym_tpu.physics import soa as jsoa
from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg
from unitree_rl_gym_tpu_torch.envs.registry import task_registry as port_registry
from unitree_rl_gym_tpu_torch.models.robot import build_robot
from unitree_rl_gym_tpu_torch.physics import backend as pb
from unitree_rl_gym_tpu_torch.physics import contact as ct

INT_FIELDS = {"parent", "rb_dyn_idx", "cp_dyn", "cp_body", "nb", "nj", "nv",
              "ncp", "nrb", "cp_slice", "cp_rb", "cp_perm", "rb_dyn",
              "chol_order"}


def _contact_bodies(cfg):
    return ([cfg.asset.foot_name] + list(cfg.asset.penalize_contacts_on)
            + list(cfg.asset.terminate_after_contacts_on))


def _effective_mass(pkg_ct, dyn, cfg, dd, tensor):
    return pkg_ct.point_effective_mass(
        dyn, tensor(cfg.init_state.rot), tensor(cfg.init_state.pos), tensor(dd)
    )


@pytest.fixture(scope="module")
def cfgs():
    """(JAX, port) go2 configs."""
    return task_registry.get_cfgs("go2")[0], go2_rough_cfg()


def _builds(jcfg, tcfg):
    """(JAX robot, port robot) of one task's cfgs."""
    assert (tcfg.asset.file, tcfg.asset.armature) == (jcfg.asset.file,
                                                      jcfg.asset.armature)
    kw = dict(armature=jcfg.asset.armature, gravity=tuple(jcfg.sim.gravity))
    jr = jax_build_robot(jax_resource(jcfg.asset.file),
                         contact_bodies=_contact_bodies(jcfg), **kw)
    tr = build_robot(resource(tcfg.asset.file),
                     contact_bodies=_contact_bodies(tcfg), **kw)
    return jr, tr


@pytest.fixture(scope="module")
def builds(cfgs):
    return _builds(*cfgs)


def _effective_masses(cfgs, builds):
    """(JAX, port) preconditioners at the nominal pose."""
    (jcfg, tcfg), (jr, tr) = cfgs, builds
    jm = _effective_mass(
        jct, jr.dyn, jcfg, jr.default_dof_pos(jcfg.init_state.default_joint_angles),
        lambda a: jnp.asarray(a, jnp.float32))
    tm = _effective_mass(
        ct, tr.dyn, tcfg, tr.default_dof_pos(tcfg.init_state.default_joint_angles),
        lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32))
    return jm, tm


@pytest.fixture(scope="module")
def effective_masses(cfgs, builds):
    return _effective_masses(cfgs, builds)


def _flat(x):
    """Nested tuples / arrays / tensors -> flat float64 array."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, (tuple, list)):
        parts = [_flat(e) for e in x]
        return np.concatenate(parts) if parts else np.zeros(0)
    return np.asarray(x, np.float64).ravel()


def _same(name, a, b):
    if name in INT_FIELDS:
        if isinstance(a, (tuple, list)) and a and isinstance(a[0], (tuple, list)):
            assert [list(map(int, e)) for e in a] == [list(map(int, e)) for e in b], name
        else:
            np.testing.assert_array_equal(_flat(b), _flat(a), err_msg=name)
    else:
        fa, fb = _flat(a), _flat(b)
        assert fa.shape == fb.shape, name
        np.testing.assert_allclose(fb, fa, rtol=1e-6, atol=1e-6, err_msg=name)


def _same_fields(cls, a, b):
    for f in dataclasses.fields(cls):
        _same(f.name, getattr(a, f.name), getattr(b, f.name))


def test_dyn_model(builds):
    jr, tr = builds
    _same_fields(jdyn.DynModel, jr.dyn, tr.dyn)


def test_soa_model(builds):
    jr, tr = builds
    _same_fields(jsoa.SoAModel, jpb.soa_model_for(jr.dyn),
                 pb.soa_model_for(tr.dyn))


def test_effective_mass(effective_masses):
    jm, tm = effective_masses
    for which, name in enumerate(("m_eff_n", "m_eff_t")):
        np.testing.assert_allclose(tm[which].numpy(), np.asarray(jm[which]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_robot_metadata(builds):
    jr, tr = builds
    assert tr.dof_names == jr.dof_names
    assert tr.body_names == jr.body_names
    for name in ("dof_lower", "dof_upper", "dof_effort", "dof_velocity"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name))


# ---------------------------------------------------------------------------
# the humanoids: g1, h1, h1_2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["g1", "h1", "h1_2"])
def humanoid(request):
    """(cfgs, builds, effective masses) of one humanoid, JAX and port."""
    cfgs = (task_registry.get_cfgs(request.param)[0],
            port_registry.get_cfgs(request.param)[0])
    b = _builds(*cfgs)
    return cfgs, b, _effective_masses(cfgs, b)


def test_humanoid_dyn_model(humanoid):
    _, (jr, tr), _ = humanoid
    _same_fields(jdyn.DynModel, jr.dyn, tr.dyn)


def test_humanoid_soa_model(humanoid):
    _, (jr, tr), _ = humanoid
    _same_fields(jsoa.SoAModel, jpb.soa_model_for(jr.dyn),
                 pb.soa_model_for(tr.dyn))


def test_humanoid_effective_mass(humanoid):
    *_, (jm, tm) = humanoid
    for which, name in enumerate(("m_eff_n", "m_eff_t")):
        np.testing.assert_allclose(tm[which].numpy(), np.asarray(jm[which]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_humanoid_robot_metadata(humanoid):
    (jcfg, tcfg), (jr, tr), _ = humanoid
    test_robot_metadata((jr, tr))
    for a, b in ((jr.default_dof_pos(jcfg.init_state.default_joint_angles),
                  tr.default_dof_pos(tcfg.init_state.default_joint_angles)),
                 (jr.pd_gains(jcfg.control.stiffness, jcfg.control.damping),
                  tr.pd_gains(tcfg.control.stiffness, tcfg.control.damping))):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
