"""Mesh collision approximation (numpy, build time; counterpart of
``unitree_rl_gym_tpu/models/mesh_approx.py``).

The H1/G1 URDFs carry STL *mesh* collision shapes. A penalty contact model
wants a small fixed set of contact points instead, so this module derives
per-link point sets from the mesh vertices once, offline, and caches them
as ``collision_points.json`` next to the URDF (:func:`generate_cache`;
``python -m unitree_rl_gym_tpu_torch.scripts.gen_collision_points``).
Runtime never touches mesh files: the URDF parser reads the cache
(:func:`load_cache`) and falls back to :func:`inertia_box_points` for a
mesh link the cache does not cover.

Approximation: the 8 corners of the axis-aligned bounding box of the mesh in
link frame (radius 0). For flat-soled feet this puts 4 points on the sole,
which is what ground contact needs; for hips, knees and the pelvis it is
enough for the contact-force thresholds the rewards and terminations use.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np


def load_stl_vertices(path: str) -> np.ndarray:
    """Read an STL file (binary or ASCII) and return [n, 3] vertices."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a 'solid' header; try ASCII first
        try:
            return _load_ascii(path)
        except Exception:
            pass
    return _load_binary(path)


def _load_binary(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(80)
        (ntri,) = struct.unpack("<I", f.read(4))
        data = np.fromfile(f, dtype=np.uint8, count=ntri * 50)
    rec = data.reshape(ntri, 50)
    floats = rec[:, :48].copy().view(np.float32).reshape(ntri, 12)
    return floats[:, 3:12].reshape(-1, 3).astype(np.float64)


def _load_ascii(path: str) -> np.ndarray:
    verts = []
    with open(path, "r") as f:
        for line in f:
            t = line.split()
            if t and t[0] == "vertex":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    if not verts:
        raise ValueError("no vertices")
    return np.asarray(verts)


def aabb_corner_points(verts: np.ndarray) -> List[dict]:
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    pts = []
    for x in (lo[0], hi[0]):
        for y in (lo[1], hi[1]):
            for z in (lo[2], hi[2]):
                pts.append({"pos": [float(x), float(y), float(z)], "radius": 0.0})
    return pts


def inertia_box_points(mass: float, inertia: np.ndarray, com: np.ndarray) -> List[dict]:
    """Fallback when no mesh/cache is available: corners of the solid box
    whose inertia matches the link's (principal-axis aligned with the link
    frame; good enough for fall/penalty contact detection)."""
    if mass <= 0:
        return []
    d = np.diag(inertia)
    sq = 6.0 / mass * np.array(
        [d[1] + d[2] - d[0], d[0] + d[2] - d[1], d[0] + d[1] - d[2]]
    )
    half = 0.5 * np.sqrt(np.clip(sq, 1e-8, None))
    pts = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                p = com + half * np.array([sx, sy, sz])
                pts.append({"pos": p.tolist(), "radius": 0.0})
    return pts


def load_cache(urdf_path: str) -> Optional[Dict[str, List[dict]]]:
    cache = os.path.join(os.path.dirname(urdf_path), "collision_points.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    return None


def generate_cache(urdf_path: str, mesh_root: Optional[str] = None) -> str:
    """Scan ``urdf_path`` for mesh collisions, approximate each from its STL,
    and write collision_points.json beside the URDF. ``mesh_root`` overrides
    where mesh filenames are resolved (e.g. the upstream robot_description
    checkout when meshes are not vendored)."""
    import xml.etree.ElementTree as ET

    from unitree_rl_gym_tpu_torch.models.urdf import _floats, _rpy_matrix

    root = ET.parse(urdf_path).getroot()
    out: Dict[str, List[dict]] = {}
    urdf_dir = os.path.dirname(urdf_path)
    for link in root.findall("link"):
        pts: List[dict] = []
        for col in link.findall("collision"):
            geom = col.find("geometry")
            mesh = geom.find("mesh") if geom is not None else None
            if mesh is None:
                continue
            fname = mesh.attrib["filename"]
            candidates = [os.path.join(urdf_dir, fname)]
            if mesh_root:
                candidates.insert(0, os.path.join(mesh_root, fname))
            path = next((c for c in candidates if os.path.exists(c)), None)
            if path is None:
                continue
            verts = load_stl_vertices(path)
            scale = _floats(mesh.attrib.get("scale"), (1.0, 1.0, 1.0))
            verts = verts * scale
            origin = col.find("origin")
            pos = _floats(origin.attrib.get("xyz") if origin is not None else None)
            R = _rpy_matrix(
                _floats(origin.attrib.get("rpy") if origin is not None else None)
            )
            for p in aabb_corner_points(verts):
                p["pos"] = (pos + R @ np.asarray(p["pos"])).tolist()
                pts.append(p)
        if pts:
            out[link.attrib["name"]] = pts
    cache = os.path.join(urdf_dir, "collision_points.json")
    with open(cache, "w") as f:
        json.dump(out, f, indent=1)
    return cache
