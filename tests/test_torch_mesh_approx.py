"""Module 12's STL half of ``models/mesh_approx.py`` and
``scripts/gen_collision_points.py`` against the JAX package's.

``generate_cache`` writes ``collision_points.json`` beside the URDF, so each
package runs on its own copy of the robots' URDFs under a temporary
directory, their mesh directories linked in (no test writes under
``resources/``). Both give the same dicts for g1, h1 and h1_2 (and go2,
whose meshes are not vendored); g1's and h1's are not empty, and h1's is
the shipped file (the shipped g1 file, an older output with one link
fewer, is the reference's fixture and stays as it is). The scripts share
their robot list and ``--mesh_root`` layout, and the port's script gives
the JAX ``generate_cache``'s caches. ``load_stl_vertices`` reads a binary
and an ASCII STL written here as the JAX reader does, and
``aabb_corner_points`` gives the same corners."""

import json
import os
import shutil
import struct

import numpy as np
import pytest

from unitree_rl_gym_tpu.models import mesh_approx as jmesh
from unitree_rl_gym_tpu.scripts import gen_collision_points as jgen
from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.models import mesh_approx
from unitree_rl_gym_tpu_torch.scripts import gen_collision_points as gen
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

URDFS = {"h1": "resources/robots/h1/urdf/h1.urdf",
         "g1": "resources/robots/g1_description/g1_12dof.urdf",
         "h1_2": "resources/robots/h1_2/h1_2_12dof.urdf",
         "go2": "resources/robots/go2/urdf/go2.urdf"}
MESH_DIRS = ("resources/robots/h1/meshes", "resources/robots/g1_description/meshes",
             "resources/robots/h1_2/meshes")


def robots_tree(root, meshes=True):
    """The robots' URDFs copied under ``root`` at their repo paths, and
    (``meshes``) their mesh directories linked in."""
    for rel in URDFS.values():
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        shutil.copy(os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, rel), os.path.join(root, rel))
    if meshes:
        for rel in MESH_DIRS:
            os.symlink(os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, rel), os.path.join(root, rel))
    return str(root)


def read(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """{robot: (JAX dict, port dict)} from generate_cache on two copies."""
    jroot = robots_tree(tmp_path_factory.mktemp("jax"))
    proot = robots_tree(tmp_path_factory.mktemp("port"))
    return {name: (read(jmesh.generate_cache(os.path.join(jroot, rel))),
                   read(mesh_approx.generate_cache(os.path.join(proot, rel))))
            for name, rel in URDFS.items()}


@pytest.mark.parametrize("robot", sorted(URDFS))
def test_generate_cache_matches_jax(caches, robot):
    want, got = caches[robot]
    assert got == want
    if robot in ("g1", "h1"):
        assert got


def test_h1_cache_is_the_shipped_file(caches):
    assert caches["h1"][1] == read(os.path.join(
        UNITREE_RL_GYM_TPU_ROOT_DIR, "resources/robots/h1/urdf/collision_points.json"))


def test_script_matches_jax(caches, tmp_path, monkeypatch, capsys):
    assert gen.ROBOTS == jgen.ROBOTS == list(URDFS.values())
    for rel in gen.ROBOTS:
        assert gen._mesh_dir("/m", rel) == jgen._mesh_dir("/m", rel)
        assert gen._mesh_dir(None, rel) is None
    # the meshes found under --mesh_root, at each robot's repo layout
    root = robots_tree(tmp_path / "tree", meshes=False)
    robots_tree(tmp_path / "meshes")
    monkeypatch.setattr(gen, "resource", lambda rel: os.path.join(root, rel))
    gen.main(["--mesh_root", str(tmp_path / "meshes")])
    written = capsys.readouterr().out.split()
    assert written == [os.path.join(root, os.path.dirname(rel), "collision_points.json")
                       for rel in gen.ROBOTS]
    for name, rel in URDFS.items():
        assert read(os.path.join(root, os.path.dirname(rel), "collision_points.json")) == \
            caches[name][0], name


def _triangles():
    rng = np.random.default_rng(0)
    return rng.standard_normal((5, 3, 3)).astype(np.float32)


def test_load_stl_vertices_binary_and_ascii(tmp_path):
    tri = _triangles()
    binary = tmp_path / "b.stl"
    with open(binary, "wb") as f:
        f.write(b"solid but binary".ljust(80, b" "))
        f.write(struct.pack("<I", len(tri)))
        for t in tri:
            f.write(np.zeros(3, np.float32).tobytes() + t.tobytes() + b"\0\0")
    ascii_ = tmp_path / "a.stl"
    with open(ascii_, "w") as f:
        f.write("solid test\n")
        for t in tri:
            f.write("  facet normal 0 0 0\n    outer loop\n")
            for v in t:
                f.write("      vertex " + " ".join(repr(float(c)) for c in v) + "\n")
            f.write("    endloop\n  endfacet\n")
        f.write("endsolid test\n")
    for path in (binary, ascii_):
        got = mesh_approx.load_stl_vertices(str(path))
        np.testing.assert_array_equal(got, jmesh.load_stl_vertices(str(path)))
        np.testing.assert_array_equal(got, tri.reshape(-1, 3).astype(np.float64))
    verts = tri.reshape(-1, 3).astype(np.float64)
    assert mesh_approx.aabb_corner_points(verts) == jmesh.aabb_corner_points(verts)
