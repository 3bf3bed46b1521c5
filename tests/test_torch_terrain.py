"""Port parity for the terrain: ``unitree_rl_gym_tpu_torch/utils/terrain.py``
against ``unitree_rl_gym_tpu/utils/terrain.py``.

The heightfield and the spawn origins come from the same numpy generators
seeded with ``RandomState(seed)``, so they must be bit-identical: for the
tiny terrain of tests/test_pallas_terrain.py (2 x 2 sub-terrains of 4 m, a
2 m border) with the curriculum and the randomised layout, and for the
go2_terrain grid (10 x 20 sub-terrains of 8 m, a 25 m border). The lookups
on the device (``window_at``, ``height_in_window_rows``, ``height_at``) are
held to atol 1e-5 on seeded points of the tiny terrain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.utils import terrain as jterrain
from unitree_rl_gym_tpu.utils.config import TerrainCfg as JaxTerrainCfg
from unitree_rl_gym_tpu_torch.utils import terrain as tterrain
from unitree_rl_gym_tpu_torch.utils.config import TerrainCfg
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8
W = 24
ATOL = 1e-5


def tiny(cfg, curriculum=True):
    cfg.mesh_type = "heightfield"
    cfg.num_rows = 2
    cfg.num_cols = 2
    cfg.terrain_length = 4.0
    cfg.terrain_width = 4.0
    cfg.border_size = 2.0
    cfg.curriculum = curriculum
    return cfg


def full(cfg, curriculum=True):
    cfg.mesh_type = "heightfield"
    cfg.curriculum = curriculum
    return cfg


@pytest.mark.parametrize("layout", ["tiny_curriculum", "tiny_random",
                                    "go2_terrain"])
def test_heightfield_and_origins_bit_identical(layout):
    make = full if layout == "go2_terrain" else tiny
    curriculum = layout != "tiny_random"
    jt = jterrain.Terrain(make(JaxTerrainCfg(), curriculum), N, seed=1)
    tt = tterrain.Terrain(make(TerrainCfg(), curriculum), N, seed=1)
    assert tt.height_field_raw.dtype == jt.height_field_raw.dtype
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tt.env_origins, jt.env_origins)
    if layout == "go2_terrain":
        assert tt.height_field_raw.shape == (1300, 2100)


@pytest.fixture(scope="module")
def grids():
    jt = jterrain.Terrain(tiny(JaxTerrainCfg()), N, seed=1)
    tt = tterrain.Terrain(tiny(TerrainCfg()), N, seed=1)
    jg, tg = jt.grid(), tt.grid("cpu")
    np.testing.assert_array_equal(tg.blocks.numpy(), np.asarray(jg.blocks))
    assert (tg.nbx, tg.nby) == (jg.nbx, jg.nby)
    rng = np.random.default_rng(3)
    # bases over the whole map, border included (the window clamps there)
    base = rng.uniform(-2.0, 10.0, (N, 2)).astype(np.float32)
    return jg, tg, base, rng


def test_window_at_matches(grids):
    jg, tg, base, _ = grids
    jwin, jcorner = jg.window_at(jnp.asarray(base), W=W)
    twin, tcorner = tg.window_at(torch.from_numpy(base), W=W)
    np.testing.assert_array_equal(tcorner.numpy(), np.asarray(jcorner))
    np.testing.assert_allclose(twin.numpy(), np.asarray(jwin), atol=ATOL)


def test_height_in_window_rows_matches(grids):
    jg, tg, base, rng = grids
    P = 68
    # points within 0.6 m of their env's base, rows [2P, N] (x then y)
    pts = base[None] + rng.uniform(-0.6, 0.6, (P, N, 2)).astype(np.float32)
    rows = np.concatenate([pts[..., 0], pts[..., 1]], 0)
    jwin, jcorner = jg.window_at(jnp.asarray(base), W=W)
    twin, tcorner = tg.window_at(torch.from_numpy(base), W=W)
    jh = np.asarray(jg.height_in_window_rows(jwin, jcorner, jnp.asarray(rows)))
    th = tg.height_in_window_rows(twin, tcorner, torch.from_numpy(rows)).numpy()
    assert th.shape == (P, N)
    np.testing.assert_allclose(th, jh, atol=ATOL)
    # inside the window the tent contraction is the bilinear lookup
    exact = tg.height_at(torch.from_numpy(np.moveaxis(pts, 0, 1))).numpy().T
    np.testing.assert_allclose(th, exact, atol=ATOL)


def test_height_at_matches(grids):
    jg, tg, _, rng = grids
    xy = rng.uniform(-3.0, 11.0, (N, 40, 2)).astype(np.float32)
    jh = np.asarray(jg.height_at(jnp.asarray(xy)))
    th = tg.height_at(torch.from_numpy(xy)).numpy()
    assert float(np.abs(jh).max()) > 0.0
    np.testing.assert_allclose(th, jh, atol=ATOL)
