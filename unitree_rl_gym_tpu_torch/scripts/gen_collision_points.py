"""Regenerate collision_points.json caches for robots with mesh collisions
(counterpart of ``unitree_rl_gym_tpu/scripts/gen_collision_points.py``):

    python -m unitree_rl_gym_tpu_torch.scripts.gen_collision_points [--mesh_root DIR]

Writes each robot's ``collision_points.json`` beside its URDF
(``models/mesh_approx.generate_cache``). Only g1's meshes are vendored in
this repo; point ``--mesh_root`` at a robot_description checkout that has
the others (e.g. the upstream unitree_rl_gym resources tree). A URDF whose
meshes are found nowhere gets an empty cache.
"""

import argparse
import os

from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.models.mesh_approx import generate_cache

ROBOTS = [
    "resources/robots/h1/urdf/h1.urdf",
    "resources/robots/g1_description/g1_12dof.urdf",
    "resources/robots/h1_2/h1_2_12dof.urdf",
    "resources/robots/go2/urdf/go2.urdf",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh_root", default=None,
                    help="directory tree holding the robots' mesh files")
    args = ap.parse_args(argv)
    for rel in ROBOTS:
        print(generate_cache(resource(rel), mesh_root=_mesh_dir(args.mesh_root, rel)))


def _mesh_dir(mesh_root, rel):
    """The robot's URDF directory mirrored under ``mesh_root``."""
    if mesh_root is None:
        return None
    return os.path.join(mesh_root, os.path.dirname(rel))


if __name__ == "__main__":
    main()
