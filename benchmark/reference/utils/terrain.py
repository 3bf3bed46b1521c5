"""Heightfield terrain: generation on the host and height lookup on the
device (counterpart of ``unitree_rl_gym_tpu/utils/terrain.py``).

The numpy generators (``SubTerrain``, the sub-terrain functions and
``Terrain``) are a copy of the JAX package's: they draw from
``np.random.RandomState(seed)``, so the heightfield and the spawn origins
come out bit-identical to the reference's. :class:`TerrainGrid` holds the
heightfield as torch tensors on the env's device, with the per-env window
fetch (``window_at``), the tent-weight lookup in those windows
(``height_in_window``, ``height_in_window_rows``) and the plain bilinear
lookup (``height_at``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# ---------------------------------------------------------------------------
# sub-terrain generators (operate on a [L, W] int16 height grid in units of
# vertical_scale, like isaacgym.terrain_utils.SubTerrain)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SubTerrain:
    width: int                 # pixels (x)
    length: int                # pixels (y)
    vertical_scale: float
    horizontal_scale: float

    def __post_init__(self):
        self.height_field_raw = np.zeros((self.width, self.length), np.int16)


def pyramid_sloped_terrain(terrain: SubTerrain, slope: float,
                           platform_size: float = 1.0):
    """Pyramid with given slope; center platform kept flat."""
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = terrain.width // 2, terrain.length // 2
    xx = (cx - np.abs(cx - x))[:, None] / cx
    yy = (cy - np.abs(cy - y))[None, :] / cy
    max_h = int(
        slope * (terrain.horizontal_scale / terrain.vertical_scale)
        * (terrain.width / 2)
    )
    hf = (max_h * xx * yy).astype(np.int16)
    terrain.height_field_raw += hf
    # flat-top the center platform: clip the platform window to the height
    # of its corner (terrain_utils.pyramid_sloped_terrain semantics), so
    # spawn origins sit on a flat pad
    p = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = terrain.width // 2 - p, terrain.width // 2 + p
    y1, y2 = terrain.length // 2 - p, terrain.length // 2 + p
    corner = int(terrain.height_field_raw[x1, y1])
    min_h = min(corner, 0)
    max_hp = max(corner, 0)
    terrain.height_field_raw[x1:x2, y1:y2] = np.clip(
        terrain.height_field_raw[x1:x2, y1:y2], min_h, max_hp
    )
    return terrain


def random_uniform_terrain(terrain: SubTerrain, min_height: float,
                           max_height: float, step: float = 1.0,
                           downsampled_scale: float | None = None,
                           rng: np.random.RandomState | None = None):
    """Uniform noise heights sampled on a coarse grid then upsampled."""
    rng = rng or np.random
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    min_h = int(min_height / terrain.vertical_scale)
    max_h = int(max_height / terrain.vertical_scale)
    step_i = max(int(step / terrain.vertical_scale), 1)
    heights_range = np.arange(min_h, max_h + step_i, step_i)
    dw = int(terrain.width * terrain.horizontal_scale / downsampled_scale)
    dl = int(terrain.length * terrain.horizontal_scale / downsampled_scale)
    coarse = rng.choice(heights_range, (dw, dl))
    # nearest-neighbor upsample
    xi = np.minimum(
        (np.arange(terrain.width) * dw // terrain.width), dw - 1
    )
    yi = np.minimum(
        (np.arange(terrain.length) * dl // terrain.length), dl - 1
    )
    terrain.height_field_raw += coarse[np.ix_(xi, yi)].astype(np.int16)
    return terrain


def pyramid_stairs_terrain(terrain: SubTerrain, step_width: float,
                           step_height: float, platform_size: float = 1.0):
    step_w = int(step_width / terrain.horizontal_scale)
    step_h = int(step_height / terrain.vertical_scale)
    p = int(platform_size / terrain.horizontal_scale)
    height = 0
    x1, x2 = 0, terrain.width
    y1, y2 = 0, terrain.length
    while (x2 - x1) > p and (y2 - y1) > p:
        x1 += step_w
        x2 -= step_w
        y1 += step_w
        y2 -= step_w
        height += step_h
        terrain.height_field_raw[x1:x2, y1:y2] = height
    return terrain


def discrete_obstacles_terrain(terrain: SubTerrain, max_height: float,
                               min_size: float, max_size: float,
                               num_rects: int, platform_size: float = 1.0,
                               rng=None):
    rng = rng or np.random
    h = int(max_height / terrain.vertical_scale)
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / terrain.horizontal_scale)
        l = int(rng.uniform(min_size, max_size) / terrain.horizontal_scale)
        x = rng.randint(0, max(terrain.width - w, 1))
        y = rng.randint(0, max(terrain.length - l, 1))
        terrain.height_field_raw[x:x + w, y:y + l] = rng.choice(
            [-h, -h // 2, h // 2, h]
        )
    p = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = terrain.width // 2 - p, terrain.width // 2 + p
    y1, y2 = terrain.length // 2 - p, terrain.length // 2 + p
    terrain.height_field_raw[x1:x2, y1:y2] = 0
    return terrain


def stepping_stones_terrain(terrain: SubTerrain, stone_size: float,
                            stone_distance: float, max_height: float,
                            platform_size: float = 1.0,
                            depth: float = -10.0, rng=None):
    rng = rng or np.random
    stone_s = max(int(stone_size / terrain.horizontal_scale), 1)
    stone_d = int(stone_distance / terrain.horizontal_scale)
    h = int(max_height / terrain.vertical_scale)
    terrain.height_field_raw[:] = int(depth / terrain.vertical_scale)
    y = 0
    while y < terrain.length:
        x = int(rng.randint(0, stone_s + stone_d)) if stone_d else 0
        while x < terrain.width:
            x2 = min(x + stone_s, terrain.width)
            y2 = min(y + stone_s, terrain.length)
            terrain.height_field_raw[x:x2, y:y2] = (
                rng.randint(-h, h + 1) if h else 0
            )
            x = x2 + stone_d
        y += stone_s + stone_d
    p = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = terrain.width // 2 - p, terrain.width // 2 + p
    y1, y2 = terrain.length // 2 - p, terrain.length // 2 + p
    terrain.height_field_raw[x1:x2, y1:y2] = 0
    return terrain


def gap_terrain(terrain: SubTerrain, gap_size: float,
                platform_size: float = 1.0):
    """Ring-shaped deep gap around a center platform (terrain.py:136-151)."""
    gap = int(gap_size / terrain.horizontal_scale)
    p = int(platform_size / terrain.horizontal_scale)
    cx, cy = terrain.width // 2, terrain.length // 2
    x1 = (terrain.width - p) // 2
    x2 = x1 + gap
    y1 = (terrain.length - p) // 2
    y2 = y1 + gap
    terrain.height_field_raw[cx - x2:cx + x2, cy - y2:cy + y2] = -1000
    terrain.height_field_raw[cx - x1:cx + x1, cy - y1:cy + y1] = 0
    return terrain


def pit_terrain(terrain: SubTerrain, depth: float, platform_size: float = 1.0):
    """Sunken center platform (terrain.py:153-157)."""
    d = int(depth / terrain.vertical_scale)
    p = int(platform_size / terrain.horizontal_scale / 2)
    x1 = terrain.width // 2 - p
    x2 = terrain.width // 2 + p
    y1 = terrain.length // 2 - p
    y2 = terrain.length // 2 + p
    terrain.height_field_raw[x1:x2, y1:y2] = -d
    return terrain


# ---------------------------------------------------------------------------
# terrain map assembly (reference Terrain class semantics)
# ---------------------------------------------------------------------------


class Terrain:
    def __init__(self, cfg, num_robots: int, seed: int = 0):
        self.cfg = cfg
        self.type = cfg.mesh_type
        if self.type in ["none", "plane"]:
            return
        self.rng = np.random.RandomState(seed)
        self.env_length = cfg.terrain_length
        self.env_width = cfg.terrain_width
        self.proportions = [
            np.sum(cfg.terrain_proportions[:i + 1])
            for i in range(len(cfg.terrain_proportions))
        ]
        self.num_sub_terrains = cfg.num_rows * cfg.num_cols
        self.env_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
        self.width_per_env_pixels = int(
            self.env_width / cfg.horizontal_scale
        )
        self.length_per_env_pixels = int(
            self.env_length / cfg.horizontal_scale
        )
        self.border = int(cfg.border_size / cfg.horizontal_scale)
        self.tot_cols = (
            cfg.num_cols * self.width_per_env_pixels + 2 * self.border
        )
        self.tot_rows = (
            cfg.num_rows * self.length_per_env_pixels + 2 * self.border
        )
        self.height_field_raw = np.zeros(
            (self.tot_rows, self.tot_cols), np.int16
        )
        if cfg.curriculum:
            self._curriculum()
        elif cfg.selected:
            self._selected()
        else:
            self._randomized()
        self.heightsamples = self.height_field_raw

    # layouts --------------------------------------------------------------

    def _randomized(self):
        for k in range(self.num_sub_terrains):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            choice = self.rng.uniform(0, 1)
            difficulty = self.rng.choice([0.5, 0.75, 0.9])
            self._add(self._make(choice, difficulty), i, j)

    def _curriculum(self):
        for j in range(self.cfg.num_cols):
            for i in range(self.cfg.num_rows):
                difficulty = i / self.cfg.num_rows
                choice = j / self.cfg.num_cols + 0.001
                self._add(self._make(choice, difficulty), i, j)

    def _selected(self):
        kwargs = dict(self.cfg.terrain_kwargs)
        name = kwargs.pop("type")
        fns = {
            "pyramid_sloped_terrain": pyramid_sloped_terrain,
            "random_uniform_terrain": random_uniform_terrain,
            "pyramid_stairs_terrain": pyramid_stairs_terrain,
            "discrete_obstacles_terrain": discrete_obstacles_terrain,
            "stepping_stones_terrain": stepping_stones_terrain,
            "gap_terrain": gap_terrain,
            "pit_terrain": pit_terrain,
        }
        for k in range(self.num_sub_terrains):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            t = SubTerrain(
                self.width_per_env_pixels, self.width_per_env_pixels,
                self.cfg.vertical_scale, self.cfg.horizontal_scale,
            )
            fns[name](t, **kwargs)
            self._add(t, i, j)

    def _make(self, choice, difficulty):
        """Type dispatch + difficulty parametrization (terrain.py:79-113)."""
        t = SubTerrain(
            self.width_per_env_pixels, self.width_per_env_pixels,
            self.cfg.vertical_scale, self.cfg.horizontal_scale,
        )
        slope = difficulty * 0.4
        step_height = 0.05 + 0.18 * difficulty
        discrete_obstacles_height = 0.05 + difficulty * 0.2
        stepping_stones_size = 1.5 * (1.05 - difficulty)
        stone_distance = 0.05 if difficulty == 0 else 0.1
        gap_size = 1.0 * difficulty
        pit_depth = 1.0 * difficulty
        p = self.proportions
        if choice < p[0]:
            if choice < p[0] / 2:
                slope *= -1
            pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
        elif choice < p[1]:
            pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
            random_uniform_terrain(
                t, min_height=-0.05, max_height=0.05, step=0.005,
                downsampled_scale=0.2, rng=self.rng,
            )
        elif choice < p[3]:
            if choice < p[2]:
                step_height *= -1
            pyramid_stairs_terrain(
                t, step_width=0.31, step_height=step_height, platform_size=3.0
            )
        elif len(p) > 4 and choice < p[4]:
            discrete_obstacles_terrain(
                t, discrete_obstacles_height, 1.0, 2.0, 20,
                platform_size=3.0, rng=self.rng,
            )
        elif len(p) > 5 and choice < p[5]:
            stepping_stones_terrain(
                t, stone_size=stepping_stones_size,
                stone_distance=stone_distance, max_height=0.0,
                platform_size=4.0, rng=self.rng,
            )
        elif len(p) > 6 and choice < p[6]:
            gap_terrain(t, gap_size=gap_size, platform_size=3.0)
        elif len(p) > 4:
            pit_terrain(t, depth=pit_depth, platform_size=4.0)
        else:
            discrete_obstacles_terrain(
                t, discrete_obstacles_height, 1.0, 2.0, 20,
                platform_size=3.0, rng=self.rng,
            )
        return t

    def _add(self, terrain, row, col):
        i, j = row, col
        sx = self.border + i * self.length_per_env_pixels
        ex = sx + self.length_per_env_pixels
        sy = self.border + j * self.width_per_env_pixels
        ey = sy + self.width_per_env_pixels
        self.height_field_raw[sx:ex, sy:ey] = terrain.height_field_raw

        env_origin_x = (i + 0.5) * self.env_length
        env_origin_y = (j + 0.5) * self.env_width
        hs = terrain.horizontal_scale
        x1 = int((self.env_length / 2.0 - 1) / hs)
        x2 = int((self.env_length / 2.0 + 1) / hs)
        y1 = int((self.env_width / 2.0 - 1) / hs)
        y2 = int((self.env_width / 2.0 + 1) / hs)
        env_origin_z = (
            np.max(terrain.height_field_raw[x1:x2, y1:y2])
            * terrain.vertical_scale
        )
        self.env_origins[i, j] = [env_origin_x, env_origin_y, env_origin_z]

    def grid(self, device) -> "TerrainGrid":
        return TerrainGrid.from_terrain(self, device)




BLK = 8  # heightfield block edge (cells) for the block-major window fetch


@dataclasses.dataclass(frozen=True)
class TerrainGrid:
    """Heightfield on the device, for the env's terrain carry."""

    heights: torch.Tensor      # [rows, cols] float32, meters
    horizontal_scale: float
    border_size: float
    blocks: torch.Tensor       # [nbx*nby, BLK*BLK] block-major copy
    nbx: int                   # block-grid shape (rows of blocks)
    nby: int

    @staticmethod
    def from_terrain(t: Terrain, device) -> "TerrainGrid":
        h = t.height_field_raw.astype(np.float32) * t.cfg.vertical_scale
        # block-major copy, edge-padded to BLK multiples: a window is
        # (W/BLK)^2 whole rows of this table
        R, C = h.shape
        Rp = (R + BLK - 1) // BLK * BLK
        Cp = (C + BLK - 1) // BLK * BLK
        hp = np.pad(h, ((0, Rp - R), (0, Cp - C)), mode="edge")
        nbx, nby = Rp // BLK, Cp // BLK
        blocks = (
            hp.reshape(nbx, BLK, nby, BLK)
            .transpose(0, 2, 1, 3)
            .reshape(nbx * nby, BLK * BLK)
        )
        return TerrainGrid(
            heights=torch.as_tensor(h, device=device),
            horizontal_scale=t.cfg.horizontal_scale,
            border_size=t.cfg.border_size,
            blocks=torch.as_tensor(np.ascontiguousarray(blocks), device=device),
            nbx=nbx,
            nby=nby,
        )

    def window_at(self, base_xy, W: int = 24):
        """Per-env WxW heightfield windows around ``base_xy`` [N, 2],
        aligned to the block lattice (W a multiple of BLK).

        Returns (win [N, W, W] float32, corner [N, 2] int32 grid coords of
        win[:, 0, 0]). The robot's block sits centered in the fetched
        (W/BLK)^2 block neighbourhood, so the robot is at least
        ((W/BLK - 1)//2) * BLK cells from the window's edge."""
        assert W % BLK == 0, "window_size must be a multiple of 8"
        nblk = W // BLK
        assert W >= 3 * BLK, (
            f"window_size={W} gives zero guaranteed robot-to-edge margin; "
            f"use >= {3 * BLK}"
        )
        # a window larger than the block grid would clip into negative
        # block indices, which wrap under indexing and fetch wrong blocks
        assert self.nbx >= nblk and self.nby >= nblk, (
            f"terrain block grid {self.nbx}x{self.nby} smaller than the "
            f"{nblk}x{nblk} window"
        )
        g = (base_xy + self.border_size) / self.horizontal_scale
        b = torch.floor(g / BLK).to(torch.int32) - (nblk - 1) // 2
        bx = torch.clamp(b[:, 0], 0, self.nbx - nblk)
        by = torch.clamp(b[:, 1], 0, self.nby - nblk)
        base_id = (bx * self.nby + by).long()
        rows = [
            self.blocks[base_id + dx * self.nby + dy]
            for dx in range(nblk) for dy in range(nblk)
        ]                                              # nblk^2 x [N, 64]
        N = base_xy.shape[0]
        win = (
            torch.stack(rows, dim=1)
            .reshape(N, nblk, nblk, BLK, BLK)
            .permute(0, 1, 3, 2, 4)
            .reshape(N, W, W)
        )
        corner = torch.stack((bx, by), dim=-1) * BLK
        return win, corner

    def _tent(self, g, W):
        """Tent weights [..., W] of grid coordinates ``g`` (clamped to the
        window): bilinear interpolation as a contraction."""
        g = torch.clamp(g, 0.0, W - 1.001)
        ar = torch.arange(W, dtype=torch.float32, device=g.device)
        return torch.clamp(1.0 - torch.abs(ar - g[..., None]), min=0.0)

    def height_in_window(self, win, corner, xy):
        """Bilinear ground heights from per-env windows; xy [N, P, 2] world
        meters -> [N, P]. Equal to :meth:`height_at` for points inside the
        window; points outside clamp to its edge."""
        W = win.shape[-1]
        gx = ((xy[..., 0] + self.border_size) / self.horizontal_scale
              - corner[:, None, 0])
        gy = ((xy[..., 1] + self.border_size) / self.horizontal_scale
              - corner[:, None, 1])
        return torch.einsum("nxy,npx,npy->np", win, self._tent(gx, W),
                            self._tent(gy, W))

    def height_in_window_rows(self, win, corner, pxy_rows):
        """Row-layout :meth:`height_in_window`: ``pxy_rows`` [2*P, N] (x
        rows, then y rows: the control step's ``aux["p_xy"]``) -> gh rows
        [P, N], the control step's input layout."""
        P = pxy_rows.shape[0] // 2
        W = win.shape[-1]
        gx = ((pxy_rows[:P] + self.border_size) / self.horizontal_scale
              - corner[None, :, 0])
        gy = ((pxy_rows[P:] + self.border_size) / self.horizontal_scale
              - corner[None, :, 1])
        return torch.einsum("nxy,pnx,pny->pn", win, self._tent(gx, W),
                            self._tent(gy, W))

    def height_at(self, xy):
        """Bilinear ground height at xy [..., 2] world meters. World (0, 0)
        is the grid's border corner (terrain origin at -border)."""
        h = self.heights
        gx = (xy[..., 0] + self.border_size) / self.horizontal_scale
        gy = (xy[..., 1] + self.border_size) / self.horizontal_scale
        gx = torch.clamp(gx, 0.0, h.shape[0] - 1.001)
        gy = torch.clamp(gy, 0.0, h.shape[1] - 1.001)
        x0 = torch.floor(gx).long()
        y0 = torch.floor(gy).long()
        fx = gx - x0
        fy = gy - y0
        h00 = h[x0, y0]
        h10 = h[x0 + 1, y0]
        h01 = h[x0, y0 + 1]
        h11 = h[x0 + 1, y0 + 1]
        return (
            h00 * (1 - fx) * (1 - fy)
            + h10 * fx * (1 - fy)
            + h01 * (1 - fx) * fy
            + h11 * fx * fy
        )
