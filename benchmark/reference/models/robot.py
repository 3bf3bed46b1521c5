"""Bridge from the host-side URDF parse to the dynamics model (counterpart
of ``unitree_rl_gym_tpu/models/robot.py``): dof ordering, default joint
angles by name, PD gains by substring match, body-group indices."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from reference.models.urdf import ParsedRobot, parse_urdf
from reference.physics import spatial as sp
from reference.physics.dynamics import DynModel


@dataclasses.dataclass(frozen=True, eq=False)
class Robot:
    """Full robot description: dynamics model + env-facing metadata."""

    parsed: ParsedRobot
    dyn: DynModel
    dof_lower: np.ndarray
    dof_upper: np.ndarray
    dof_effort: np.ndarray
    dof_velocity: np.ndarray

    @property
    def num_dof(self) -> int:
        return len(self.parsed.joint_names)

    @property
    def num_bodies(self) -> int:
        return len(self.parsed.rb_names)

    @property
    def dof_names(self) -> List[str]:
        return self.parsed.joint_names

    @property
    def body_names(self) -> List[str]:
        return self.parsed.rb_names

    def default_dof_pos(self, default_joint_angles: Dict[str, float]) -> np.ndarray:
        """Exact-name lookup of default angles."""
        return np.asarray(
            [default_joint_angles[name] for name in self.dof_names], np.float64
        )

    def pd_gains(self, stiffness: Dict[str, float], damping: Dict[str, float]):
        """Substring-matched PD gains; unmatched joints get zero gains."""
        kp = np.zeros(self.num_dof)
        kd = np.zeros(self.num_dof)
        for i, name in enumerate(self.dof_names):
            for key, val in stiffness.items():
                if key in name:
                    kp[i] = val
                    kd[i] = damping[key]
        return kp, kd

    def body_indices(self, substrings: List[str]) -> np.ndarray:
        return np.asarray(self.parsed.match_bodies(substrings), dtype=np.int64)


def build_robot(
    urdf_path: str,
    armature: float = 0.0,
    gravity=(0.0, 0.0, -9.81),
    contact_bodies=None,
) -> Robot:
    """Parse ``urdf_path`` into a float32 :class:`DynModel` on the CPU."""
    p = parse_urdf(urdf_path, contact_bodies=contact_bodies)
    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    # spatial inertias in float32, as the JAX build computes them
    I_sp = sp.spatial_inertia(t(p.mass), t(p.com), t(p.inertia))
    lim_ok = p.dof_upper > p.dof_lower
    dyn = DynModel(
        parent=tuple(int(x) for x in p.parent),
        joint_axis=t(p.joint_axis),
        Etree=t(p.Etree),
        rtree=t(p.rtree),
        I_sp=I_sp,
        base_mass=float(p.mass[0]),
        armature=float(armature),
        dof_damping=t(p.dof_damping),
        dof_friction=t(p.dof_friction),
        dof_vel_limit=t(np.where(p.dof_velocity > 0, p.dof_velocity, np.inf)),
        dof_lower=t(np.where(lim_ok, p.dof_lower, -np.inf)),
        dof_upper=t(np.where(lim_ok, p.dof_upper, np.inf)),
        rb_dyn_idx=t(p.rb_dyn_idx, torch.int64),
        rb_rot=t(p.rb_rot),
        rb_pos=t(p.rb_pos),
        cp_dyn=t(p.cp_dyn, torch.int64),
        cp_body=t(p.cp_body, torch.int64),
        cp_pos=t(p.cp_pos),
        cp_radius=t(p.cp_radius),
        gravity=t(gravity),
    )
    return Robot(
        parsed=p,
        dyn=dyn,
        dof_lower=p.dof_lower,
        dof_upper=p.dof_upper,
        dof_effort=p.dof_effort,
        dof_velocity=p.dof_velocity,
    )
