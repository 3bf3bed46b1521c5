"""Mesh collision points (numpy, build time; counterpart of
``unitree_rl_gym_tpu/models/mesh_approx.py``, the part the reference's URDF
parser reads).

The H1/G1 URDFs carry STL *mesh* collision shapes. A penalty contact model
wants a small fixed set of contact points instead: the URDF parser reads
them from the ``collision_points.json`` cache beside the URDF
(:func:`load_cache`; the corners of each mesh's bounding box in link frame)
and falls back to :func:`inertia_box_points` for a mesh link the cache does
not cover.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


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
