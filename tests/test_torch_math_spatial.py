"""The port's public quaternion and spatial helpers (``utils/math.py``,
``physics/spatial.py``) against the JAX package's on the same seeded
inputs (numpy, batch of 16), within 1e-6. The two random draws take a
``torch.Generator`` where the JAX functions take a PRNG key: their shapes
and ranges are compared, not their draws. No JAX program is compiled (the
JAX functions run op by op)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.physics import spatial as jsp
from unitree_rl_gym_tpu.utils import math as jtm
from unitree_rl_gym_tpu_torch.physics import spatial as tsp
from unitree_rl_gym_tpu_torch.utils import math as ttm
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

B = 16
TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    axis = rng.standard_normal((B, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    E = np.stack([np.asarray(jtm.quat_to_rotmat(jnp.asarray(x))) for x in q])
    return dict(
        q=q, q2=np.roll(q, 1, axis=0),
        v3=rng.standard_normal((B, 3)).astype(np.float32),
        v6=rng.standard_normal((B, 6)).astype(np.float32),
        f6=rng.standard_normal((B, 6)).astype(np.float32),
        E=E.astype(np.float32), E2=np.roll(E, 1, axis=0).astype(np.float32),
        r=rng.standard_normal((B, 3)).astype(np.float32),
        r2=rng.standard_normal((B, 3)).astype(np.float32),
        angle=rng.uniform(-3, 3, B).astype(np.float32), axis=axis,
        rpy=rng.uniform(-3, 3, (B, 3)).astype(np.float32),
    )


# (name, port function, JAX function, argument names)
CASES = [
    ("normalize", ttm.normalize, jtm.normalize, ("v3",)),
    ("quat_mul", ttm.quat_mul, jtm.quat_mul, ("q", "q2")),
    ("quat_integrate", lambda q, w: ttm.quat_integrate(q, w, 0.005),
     lambda q, w: jtm.quat_integrate(q, w, 0.005), ("q", "v3")),
    ("quat_identity", lambda: ttm.quat_identity((B,)),
     lambda: jtm.quat_identity((B,)), ()),
    ("quat_apply", ttm.quat_apply, jtm.quat_apply, ("q", "v3")),
    ("quat_apply_yaw", ttm.quat_apply_yaw, jtm.quat_apply_yaw, ("q", "v3")),
    ("quat_from_angle_axis", ttm.quat_from_angle_axis, jtm.quat_from_angle_axis,
     ("angle", "axis")),
    ("quat_from_euler_xyz", lambda e: ttm.quat_from_euler_xyz(*e.unbind(-1)),
     lambda e: jtm.quat_from_euler_xyz(e[:, 0], e[:, 1], e[:, 2]), ("rpy",)),
    ("xform_compose", tsp.xform_compose, jsp.xform_compose, ("E", "r", "E2", "r2")),
    ("xform_inv", tsp.xform_inv, jsp.xform_inv, ("E", "r")),
    ("xform_motion_inv", tsp.xform_motion_inv, jsp.xform_motion_inv, ("E", "r", "v6")),
    ("xform_force", tsp.xform_force, jsp.xform_force, ("E", "r", "f6")),
    ("crm", tsp.crm, jsp.crm, ("v6",)),
    ("cross_motion", tsp.cross_motion, jsp.cross_motion, ("v6", "f6")),
    ("cross_force", tsp.cross_force, jsp.cross_force, ("v6", "f6")),
    ("rpy_matrix", tsp.rpy_matrix, jsp.rpy_matrix, ("rpy",)),
]


@pytest.mark.parametrize("name,tfn,jfn,argn", CASES, ids=[c[0] for c in CASES])
def test_helper_matches_jax(name, tfn, jfn, argn):
    x = _inputs()
    got = tfn(*(torch.from_numpy(x[a]) for a in argn))
    ref = jfn(*(jnp.asarray(x[a]) for a in argn))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)


@pytest.mark.parametrize("name", ["rand_uniform", "rand_sqrt_uniform"])
def test_random_draws_shape_and_range(name):
    lo, hi, shape = -0.5, 2.0, (64, 3)
    gen = torch.Generator().manual_seed(0)
    got = getattr(ttm, name)(gen, lo, hi, shape).numpy()
    ref = np.asarray(getattr(jtm, name)(jax.random.PRNGKey(0), lo, hi, shape))
    assert got.shape == ref.shape == shape
    assert got.dtype == ref.dtype == np.float32
    for a in (got, ref):
        assert lo <= a.min() and a.max() <= hi
    # the signed-sqrt shape pushes draws toward the ends: its mean
    # |distance from the middle| exceeds the uniform's (2/3 against 1/2 of
    # the half-width in expectation; 192 draws put 0.08 beyond 4 standard
    # errors)
    half, mid = (hi - lo) / 2, (hi + lo) / 2
    spread = {k: float(np.abs(a - mid).mean() / half) for k, a in (("t", got), ("j", ref))}
    expect = 2.0 / 3.0 if name == "rand_sqrt_uniform" else 0.5
    for v in spread.values():
        assert abs(v - expect) < 0.08, spread
    # a generator on the same seed draws the same numbers again
    again = getattr(ttm, name)(torch.Generator().manual_seed(0), lo, hi, shape)
    np.testing.assert_array_equal(again.numpy(), got)
