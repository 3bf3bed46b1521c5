"""URDF -> kinematic-tree model parser (numpy, build time only).

Replaces the reference's Isaac Gym asset pipeline
(``gym.load_asset`` + ``get_asset_dof_properties`` etc., used in
``legged_gym/envs/base/legged_robot.py:281-407``) with a self-contained
parser that produces a struct-of-arrays :class:`ParsedRobot` consumed by the
physics core. A numpy-only copy of ``unitree_rl_gym_tpu/models/urdf.py``.

Semantics mirrored from the reference asset options
(``legged_robot_config.py:120-144``):

* ``collapse_fixed_joints=True``: fixed-joint children are merged into their
  parent for *dynamics* (exact — rigid composition of spatial inertia), but
  links marked ``dont_collapse="true"`` (feet, head) are kept as separate
  **report bodies** so that per-body contact forces can be indexed by name,
  matching Isaac Gym's rigid-body tensor semantics
  (``legged_robot.py:384-407``).
* Joint limits (lower/upper/effort/velocity) feed the torque clipping and
  dof-limit rewards (``legged_robot.py:457-464, 671``).
* Collision geometries become contact points for the penalty contact model:
  sphere -> 1 point, box -> 8 corner points, cylinder/capsule -> 2 end
  points carrying the shape radius.

Everything here runs once at environment construction on the host; the
result is frozen into tensors by :mod:`unitree_rl_gym_tpu_torch.models.robot`.
"""

from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np


def _floats(s: Optional[str], default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


@dataclasses.dataclass
class _Geom:
    kind: str          # sphere | box | cylinder | capsule
    pos: np.ndarray    # offset in link frame
    rot: np.ndarray    # 3x3 rotation in link frame
    size: np.ndarray   # sphere: [r]; box: [sx,sy,sz]; cyl: [r, length]


@dataclasses.dataclass
class _Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((3, 3)))
    geoms: List[_Geom] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Joint:
    name: str
    jtype: str
    parent: str
    child: str
    origin_pos: np.ndarray
    origin_rot: np.ndarray     # 3x3
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0
    damping: float = 0.0
    friction: float = 0.0
    dont_collapse: bool = False


@dataclasses.dataclass
class ParsedRobot:
    """Host-side model description (plain numpy). See module docstring."""

    name: str
    # --- dynamic tree (after fixed-joint collapse) ---
    nb: int                     # number of dynamic bodies (incl. base = body 0)
    parent: np.ndarray          # [nb] int, parent dyn body (-1 for base)
    body_names: List[str]       # dyn body names (link that owns the frame)
    joint_names: List[str]      # [nb-1] actuated (revolute) joint names, dof order
    joint_axis: np.ndarray      # [nj, 3]
    Etree: np.ndarray           # [nj, 3, 3] parent->child coord rotation at q=0
    rtree: np.ndarray           # [nj, 3] child origin in parent frame
    mass: np.ndarray            # [nb]
    com: np.ndarray             # [nb, 3] CoM offset in body frame
    inertia: np.ndarray         # [nb, 3, 3] rotational inertia about CoM
    dof_lower: np.ndarray       # [nj]
    dof_upper: np.ndarray
    dof_effort: np.ndarray
    dof_velocity: np.ndarray
    dof_damping: np.ndarray
    dof_friction: np.ndarray
    # --- report bodies (Isaac-Gym-visible rigid body list) ---
    rb_names: List[str]         # report body names, traversal order
    rb_dyn_idx: np.ndarray      # [nrb] dynamic body owning each report body
    rb_rot: np.ndarray          # [nrb, 3, 3] report-frame rotation in dyn frame
    rb_pos: np.ndarray          # [nrb, 3] report-frame origin in dyn frame
    # --- contact points (from collision geoms of report bodies) ---
    cp_body: np.ndarray         # [ncp] report body index
    cp_dyn: np.ndarray          # [ncp] dynamic body index
    cp_pos: np.ndarray          # [ncp, 3] offset in dyn body frame
    cp_radius: np.ndarray       # [ncp]

    def dof_index(self, joint_name: str) -> int:
        return self.joint_names.index(joint_name)

    def rb_index(self, body_name: str) -> int:
        return self.rb_names.index(body_name)

    def match_bodies(self, substrings: List[str]) -> List[int]:
        """Substring body matching, as the reference does for feet /
        penalized / termination bodies (legged_robot.py:346-352)."""
        out = []
        for s in substrings:
            out.extend([i for i, n in enumerate(self.rb_names) if s in n])
        return sorted(set(out))


def _parse_xml(path: str) -> Tuple[str, Dict[str, _Link], List[_Joint]]:
    tree = ET.parse(path)
    robot = tree.getroot()
    links: Dict[str, _Link] = {}
    joints: List[_Joint] = []

    for el in robot.findall("link"):
        link = _Link(name=el.attrib["name"])
        inertial = el.find("inertial")
        if inertial is not None:
            origin = inertial.find("origin")
            pos = _floats(origin.attrib.get("xyz") if origin is not None else None)
            rpy = _floats(origin.attrib.get("rpy") if origin is not None else None)
            R = _rpy_matrix(rpy)
            link.mass = float(inertial.find("mass").attrib["value"])
            ine = inertial.find("inertia").attrib
            I = np.array(
                [
                    [float(ine["ixx"]), float(ine["ixy"]), float(ine["ixz"])],
                    [float(ine["ixy"]), float(ine["iyy"]), float(ine["iyz"])],
                    [float(ine["ixz"]), float(ine["iyz"]), float(ine["izz"])],
                ]
            )
            link.com = pos
            link.inertia = R @ I @ R.T  # rotate inertia into link axes
        for col in el.findall("collision"):
            origin = col.find("origin")
            pos = _floats(origin.attrib.get("xyz") if origin is not None else None)
            rpy = _floats(origin.attrib.get("rpy") if origin is not None else None)
            geom_el = col.find("geometry")
            if geom_el is None:
                continue
            for kind in ("sphere", "box", "cylinder", "capsule", "mesh"):
                g = geom_el.find(kind)
                if g is None:
                    continue
                if kind == "sphere":
                    size = np.array([float(g.attrib["radius"])])
                elif kind == "box":
                    size = _floats(g.attrib["size"])
                elif kind == "mesh":
                    size = np.zeros(1)  # resolved via collision_points cache
                else:
                    size = np.array(
                        [float(g.attrib["radius"]), float(g.attrib["length"])]
                    )
                link.geoms.append(_Geom(kind, pos, _rpy_matrix(rpy), size))
        links[link.name] = link

    for el in robot.findall("joint"):
        jtype = el.attrib["type"]
        origin = el.find("origin")
        pos = _floats(origin.attrib.get("xyz") if origin is not None else None)
        rpy = _floats(origin.attrib.get("rpy") if origin is not None else None)
        axis_el = el.find("axis")
        axis = _floats(axis_el.attrib.get("xyz") if axis_el is not None else None,
                       (1.0, 0.0, 0.0))
        j = _Joint(
            name=el.attrib["name"],
            jtype=jtype,
            parent=el.find("parent").attrib["link"],
            child=el.find("child").attrib["link"],
            origin_pos=pos,
            origin_rot=_rpy_matrix(rpy),
            axis=axis,
            dont_collapse=el.attrib.get("dont_collapse", "false") == "true",
        )
        lim = el.find("limit")
        if lim is not None:
            j.lower = float(lim.attrib.get("lower", 0.0))
            j.upper = float(lim.attrib.get("upper", 0.0))
            j.effort = float(lim.attrib.get("effort", 0.0))
            j.velocity = float(lim.attrib.get("velocity", 0.0))
        dyn = el.find("dynamics")
        if dyn is not None:
            j.damping = float(dyn.attrib.get("damping", 0.0))
            j.friction = float(dyn.attrib.get("friction", 0.0))
        joints.append(j)

    return robot.attrib.get("name", "robot"), links, joints


def parse_urdf(path: str, armature: float = 0.0,
               contact_bodies: Optional[List[str]] = None) -> ParsedRobot:
    """Parse a URDF into a :class:`ParsedRobot`.

    ``armature`` is the per-dof rotor inertia added on the mass-matrix
    diagonal (Isaac Gym ``asset_options.armature``; the reference sets 1e-3
    for H1_2, ``h1_2_config.py:88``) — stored by the caller, not here.

    ``contact_bodies``: optional substring filter — contact points are
    emitted only for links whose name matches (same substring rule as
    :meth:`ParsedRobot.match_bodies`). The env layer passes the union of
    foot/penalized/termination bodies, the only bodies whose contact
    forces any consumer reads; this mirrors the reference's own trimming
    of training collision geometry (legged_gym/envs/h1_2/README.md:3-13
    keeps collision on foot-roll/knee/base only) and bounds the contact
    solver's size/VMEM footprint. ``None`` keeps every collision geom.
    """
    name, links, joints = _parse_xml(path)

    # Identify the root link: a link that is never a joint child (floating
    # joints from a dummy "world" are treated as declaring their child root).
    children = {j.child for j in joints if j.jtype != "floating"}
    parents = {j.parent for j in joints if j.jtype != "floating"}
    roots = [n for n in links if n not in children]
    roots = [r for r in roots if r in parents or not joints]
    if not roots:  # all links are children: root is child of a floating joint
        roots = [j.child for j in joints if j.jtype == "floating"]
    root = roots[0]

    by_parent: Dict[str, List[_Joint]] = {}
    for j in joints:
        if j.jtype == "floating":
            continue
        by_parent.setdefault(j.parent, []).append(j)

    # Depth-first traversal in document order (Isaac Gym asset order).
    dyn_names: List[str] = [root]
    dyn_parent: List[int] = [-1]
    jname: List[str] = []
    jaxis: List[np.ndarray] = []
    Etree: List[np.ndarray] = []
    rtree: List[np.ndarray] = []
    jlim: List[Tuple[float, float, float, float, float, float]] = []

    mass = [links[root].mass]
    com = [links[root].com.copy()]
    inertia = [links[root].inertia.copy()]

    rb_names: List[str] = [root]
    rb_dyn: List[int] = [0]
    rb_rot: List[np.ndarray] = [np.eye(3)]
    rb_pos: List[np.ndarray] = [np.zeros(3)]

    def merge_inertia(dyn_idx, R, p, link: _Link):
        """Add ``link``'s inertia (frame at R,p in dyn body frame) into the
        dyn body's lumped inertia (parallel-axis composition about each CoM)."""
        m2 = link.mass
        if m2 <= 0.0:
            return
        m1 = mass[dyn_idx]
        c1 = com[dyn_idx]
        c2 = p + R @ link.com
        c = (m1 * c1 + m2 * c2) / (m1 + m2) if (m1 + m2) > 0 else c1
        I2 = R @ link.inertia @ R.T

        def shift(I, m, d):
            return I + m * ((d @ d) * np.eye(3) - np.outer(d, d))

        inertia[dyn_idx] = shift(inertia[dyn_idx], m1, c1 - c) + shift(I2, m2, c2 - c)
        mass[dyn_idx] = m1 + m2
        com[dyn_idx] = c

    def visit(link_name: str, dyn_idx: int, R_acc: np.ndarray, p_acc: np.ndarray):
        """Traverse children of ``link_name``; (R_acc, p_acc) locate the link
        frame inside dynamic body ``dyn_idx``."""
        for j in by_parent.get(link_name, []):
            child = links[j.child]
            Rj = R_acc @ j.origin_rot
            pj = p_acc + R_acc @ j.origin_pos
            if j.jtype == "fixed":
                rb_names.append(child.name)
                rb_dyn.append(dyn_idx)
                rb_rot.append(Rj)
                rb_pos.append(pj)
                merge_inertia(dyn_idx, Rj, pj, child)
                _emit_link(dyn_idx, len(rb_names) - 1, Rj, pj, child)
                visit(child.name, dyn_idx, Rj, pj)
            elif j.jtype in ("revolute", "continuous"):
                new_idx = len(dyn_names)
                dyn_names.append(child.name)
                dyn_parent.append(dyn_idx)
                jname.append(j.name)
                jaxis.append(j.axis / np.linalg.norm(j.axis))
                # Featherstone X_tree = (E, r): E takes dyn-parent coords to
                # child(joint) coords at q=0; here the joint frame may sit
                # deeper than the dyn body frame if fixed joints intervened.
                Etree.append(Rj.T)
                rtree.append(pj)
                jlim.append((j.lower, j.upper, j.effort, j.velocity,
                             j.damping, j.friction))
                mass.append(child.mass)
                com.append(child.com.copy())
                inertia.append(child.inertia.copy())
                rb_names.append(child.name)
                rb_dyn.append(new_idx)
                rb_rot.append(np.eye(3))
                rb_pos.append(np.zeros(3))
                _emit_link(new_idx, len(rb_names) - 1, np.eye(3), np.zeros(3), child)
                visit(child.name, new_idx, np.eye(3), np.zeros(3))
            else:
                raise NotImplementedError(f"joint type {j.jtype}")

    cp_body: List[int] = []
    cp_dyn: List[int] = []
    cp_pos: List[np.ndarray] = []
    cp_radius: List[float] = []

    from reference.models.mesh_approx import (
        inertia_box_points,
        load_cache,
    )

    mesh_cache = load_cache(path) or {}

    def _emit_geom(dyn_idx, rb_idx, R, p, g: _Geom):
        """Convert a primitive collision geom into contact points."""
        Rg = R @ g.rot
        pg = p + R @ g.pos
        pts: List[Tuple[np.ndarray, float]] = []
        if g.kind == "sphere":
            pts.append((np.zeros(3), g.size[0]))
        elif g.kind == "box":
            sx, sy, sz = g.size / 2.0
            for ix in (-sx, sx):
                for iy in (-sy, sy):
                    for iz in (-sz, sz):
                        pts.append((np.array([ix, iy, iz]), 0.0))
        else:  # cylinder / capsule along local z
            r, L = g.size
            half = L / 2.0
            pts.append((np.array([0.0, 0.0, -half]), r))
            pts.append((np.array([0.0, 0.0, half]), r))
        for off, rad in pts:
            cp_body.append(rb_idx)
            cp_dyn.append(dyn_idx)
            cp_pos.append(pg + Rg @ off)
            cp_radius.append(rad)

    def _emit_link(dyn_idx, rb_idx, R, p, link: _Link):
        """Emit contact points for all of a link's collision geoms. Mesh
        geoms resolve through the collision_points.json cache (built by
        the JAX package's mesh_approx.generate_cache) or, failing that, an
        inertia-matched box."""
        if contact_bodies is not None and not any(
            s in link.name for s in contact_bodies
        ):
            return
        has_mesh = any(g.kind == "mesh" for g in link.geoms)
        for g in link.geoms:
            if g.kind != "mesh":
                _emit_geom(dyn_idx, rb_idx, R, p, g)
        if has_mesh:
            pts = mesh_cache.get(link.name)
            if pts is None:
                pts = inertia_box_points(link.mass, link.inertia, link.com)
            for d in pts:
                cp_body.append(rb_idx)
                cp_dyn.append(dyn_idx)
                cp_pos.append(p + R @ np.asarray(d["pos"]))
                cp_radius.append(float(d["radius"]))

    _emit_link(0, 0, np.eye(3), np.zeros(3), links[root])
    visit(root, 0, np.eye(3), np.zeros(3))

    jl = np.asarray(jlim) if jlim else np.zeros((0, 6))
    return ParsedRobot(
        name=name,
        nb=len(dyn_names),
        parent=np.asarray(dyn_parent, dtype=np.int32),
        body_names=dyn_names,
        joint_names=jname,
        joint_axis=np.asarray(jaxis) if jaxis else np.zeros((0, 3)),
        Etree=np.asarray(Etree) if Etree else np.zeros((0, 3, 3)),
        rtree=np.asarray(rtree) if rtree else np.zeros((0, 3)),
        mass=np.asarray(mass),
        com=np.asarray(com),
        inertia=np.asarray(inertia),
        dof_lower=jl[:, 0],
        dof_upper=jl[:, 1],
        dof_effort=jl[:, 2],
        dof_velocity=jl[:, 3],
        dof_damping=jl[:, 4],
        dof_friction=jl[:, 5],
        rb_names=rb_names,
        rb_dyn_idx=np.asarray(rb_dyn, dtype=np.int32),
        rb_rot=np.asarray(rb_rot),
        rb_pos=np.asarray(rb_pos),
        cp_body=np.asarray(cp_body, dtype=np.int32),
        cp_dyn=np.asarray(cp_dyn, dtype=np.int32),
        cp_pos=np.asarray(cp_pos) if cp_pos else np.zeros((0, 3)),
        cp_radius=np.asarray(cp_radius),
    )
