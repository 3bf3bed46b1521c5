"""Reward terms over a per-step context (counterpart of
``unitree_rl_gym_tpu/envs/rewards.py``): the base LeggedRobot terms
(legged_robot.py:843-939) and the go2 handstand's
(go2_handstand_env.py:224-383), each batched over envs ([N] outputs). The
env selects and scales them from ``cfg.rewards.scales`` at build time
(zero scales pruned, the rest multiplied by the control dt) through its
``_reward_registry``. The humanoid terms (g1_env.py:144-180, shared by
h1 and h1_2) complete the base set for envs/humanoid.py.
"""

from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# base LeggedRobot terms (legged_robot.py:843-939)
# ---------------------------------------------------------------------------


def lin_vel_z(ctx):
    return torch.square(ctx.base_lin_vel[:, 2])


def ang_vel_xy(ctx):
    return torch.sum(torch.square(ctx.base_ang_vel[:, :2]), dim=1)


def orientation(ctx):
    return torch.sum(torch.square(ctx.projected_gravity[:, :2]), dim=1)


def base_height(ctx):
    return torch.square(ctx.base_pos[:, 2] - ctx.cfg.rewards.base_height_target)


def torques(ctx):
    return torch.sum(torch.square(ctx.torques), dim=1)


def dof_vel(ctx):
    return torch.sum(torch.square(ctx.dof_vel), dim=1)


def dof_acc(ctx):
    return torch.sum(torch.square((ctx.last_dof_vel - ctx.dof_vel) / ctx.dt), dim=1)


def action_rate(ctx):
    return torch.sum(torch.square(ctx.last_actions - ctx.actions), dim=1)


def collision(ctx):
    force = torch.linalg.vector_norm(
        ctx.contact_forces[:, ctx.penalised_contact_indices, :], dim=-1
    )
    return torch.sum(1.0 * (force > 0.1), dim=1)


def termination(ctx):
    return (ctx.reset_buf & ~ctx.time_out_buf).to(torch.float32)


def dof_pos_limits(ctx):
    out = -torch.clamp(ctx.dof_pos - ctx.dof_pos_soft_lo, max=0.0)
    out = out + torch.clamp(ctx.dof_pos - ctx.dof_pos_soft_hi, min=0.0)
    return torch.sum(out, dim=1)


def dof_vel_limits(ctx):
    lim = ctx.dof_vel_limits * ctx.cfg.rewards.soft_dof_vel_limit
    return torch.sum(torch.clamp(torch.abs(ctx.dof_vel) - lim, 0.0, 1.0), dim=1)


def torque_limits(ctx):
    lim = ctx.torque_limits * ctx.cfg.rewards.soft_torque_limit
    return torch.sum(torch.clamp(torch.abs(ctx.torques) - lim, min=0.0), dim=1)


def tracking_lin_vel(ctx):
    err = torch.sum(
        torch.square(ctx.commands[:, :2] - ctx.base_lin_vel[:, :2]), dim=1
    )
    return torch.exp(-err / ctx.cfg.rewards.tracking_sigma)


def tracking_ang_vel(ctx):
    err = torch.square(ctx.commands[:, 2] - ctx.base_ang_vel[:, 2])
    return torch.exp(-err / ctx.cfg.rewards.tracking_sigma)


def feet_air_time(ctx):
    """Reward long steps; ctx supplies first_contact / feet_air_time."""
    rew = torch.sum((ctx.feet_air_time - 0.5) * ctx.first_contact, dim=1)
    return rew * (torch.linalg.vector_norm(ctx.commands[:, :2], dim=1) > 0.1)


def feet_stumble(ctx):
    fxy = torch.linalg.vector_norm(
        ctx.contact_forces[:, ctx.feet_indices, :2], dim=2)
    fz = torch.abs(ctx.contact_forces[:, ctx.feet_indices, 2])
    return torch.any(fxy > 5.0 * fz, dim=1).to(torch.float32)


def stand_still(ctx):
    return torch.sum(torch.abs(ctx.dof_pos - ctx.default_dof_pos), dim=1) * (
        torch.linalg.vector_norm(ctx.commands[:, :2], dim=1) < 0.1)


def feet_contact_forces(ctx):
    f = torch.linalg.vector_norm(ctx.contact_forces[:, ctx.feet_indices, :], dim=-1)
    return torch.sum(
        torch.clamp(f - ctx.cfg.rewards.max_contact_force, min=0.0), dim=1)


def stumble(ctx):  # the name the handstand cfg scales (go2_handstand_config.py:131)
    return feet_stumble(ctx)


# ---------------------------------------------------------------------------
# humanoid terms (g1_env.py:144-180, shared by h1 and h1_2)
# ---------------------------------------------------------------------------


def contact(ctx):
    """Phase-contact match: stance iff leg phase < 0.55 (g1_env.py:144-152)."""
    is_stance = ctx.leg_phase < 0.55                              # [N, 2]
    in_contact = ctx.contact_forces[:, ctx.feet_indices, 2] > 1.0
    match = ~(in_contact ^ is_stance)
    return torch.sum(match.to(torch.float32), dim=1)


def _feet_in_contact(ctx):
    return torch.linalg.vector_norm(
        ctx.contact_forces[:, ctx.feet_indices, :3], dim=2) > 1.0


def feet_swing_height(ctx):
    err = torch.square(ctx.feet_pos[:, :, 2] - 0.08) * (~_feet_in_contact(ctx))
    return torch.sum(err, dim=1)


def alive(ctx):
    return torch.ones(ctx.num_envs, device=ctx.base_pos.device)


def contact_no_vel(ctx):
    v = ctx.feet_vel * _feet_in_contact(ctx)[..., None]
    return torch.sum(torch.square(v), dim=(1, 2))


def hip_pos(ctx):
    return torch.sum(torch.square(ctx.dof_pos[:, ctx.hip_indices]), dim=1)


# ---------------------------------------------------------------------------
# go2 handstand terms (go2_handstand_env.py:224-383)
# ---------------------------------------------------------------------------


def hs_orientation(ctx):
    g_z = torch.clamp(ctx.projected_gravity[:, 2], -1.0, 1.0)
    err = 1.0 - g_z
    return torch.exp(-3.0 * err * err)


def hs_base_height(ctx):
    err = torch.clamp(
        ctx.cfg.rewards.base_height_target - ctx.base_pos[:, 2], min=0.0)
    return torch.exp(-8.0 * err * err)


def inversion_height(ctx):
    """Training-time shaping (scale 0 in the stock config): the product of
    the inverted-orientation bell and the base-height bell, so inversion
    pays only when achieved high."""
    return hs_orientation(ctx) * hs_base_height(ctx)


def entry_lean(ctx):
    """Training-time shaping (scale 0 in the stock config): a monotone
    planted-pivot ramp for the kick-up entry,
    ``sqrt(th / 110 deg) * front_planted * height_gate`` with th the tilt
    off vertical, the front feet's share of load and a sigmoid gate at a
    base height of 0.235 m."""
    gz = torch.clamp(ctx.projected_gravity[:, 2], -1.0, 1.0)
    th = torch.arccos(-gz)
    ramp = torch.sqrt(torch.clamp(th / math.radians(110.0), 0.0, 1.0))
    front = ctx.contact_forces[:, ctx.front_feet_indices, 2] > 5.0
    planted = torch.mean(front.to(torch.float32), dim=1)
    hgate = torch.sigmoid((ctx.base_pos[:, 2] - 0.235) / 0.015)
    return ramp * planted * hgate


def pre_inversion_crouch(ctx):
    """Penalty shaping, for a negative scale (0 in the stock config): the
    depth of the base below 0.235 m inside the transition region
    (-0.8 < g_z < 0.15, a two-sided sigmoid gate)."""
    gz = ctx.projected_gravity[:, 2]
    depth = torch.clamp(0.235 - ctx.base_pos[:, 2], min=0.0)
    gate = torch.sigmoid((0.15 - gz) / 0.05) * torch.sigmoid((gz + 0.8) / 0.05)
    return depth * gate


def front_feet_contact(ctx):
    c = (ctx.contact_forces[:, ctx.front_feet_indices, 2] > 5.0).to(torch.float32)
    return torch.mean(c, dim=1)


def hind_feet_no_contact(ctx):
    c = (ctx.contact_forces[:, ctx.hind_feet_indices, 2] > 5.0).to(torch.float32)
    return 1.0 - torch.mean(c, dim=1)


def pose(ctx):
    err = ctx.dof_pos - ctx.pose_targets
    sq = torch.sum(torch.square(err[:, ctx.front_dof_idx]), dim=1) + 0.3 * torch.sum(
        torch.square(err[:, ctx.rear_dof_idx]), dim=1)
    return torch.exp(-4.0 * sq)


def stability(ctx):
    lin = torch.linalg.vector_norm(ctx.base_lin_vel[:, :2], dim=1)
    ang = torch.linalg.vector_norm(ctx.base_ang_vel[:, :2], dim=1)
    return torch.exp(-2.0 * (lin + 0.5 * ang))


def energy(ctx):
    return torch.sum(torch.abs(ctx.torques) * torch.abs(ctx.dof_vel), dim=1)


def front_hip_neutral(ctx):
    hip = ctx.dof_pos[:, ctx.front_hip_idx]
    return torch.exp(-4.0 * torch.sum(torch.square(hip), dim=1))


def front_feet_together(ctx):
    fl = ctx.feet_pos[:, 0, :2]
    fr = ctx.feet_pos[:, 1, :2]
    dist = torch.linalg.vector_norm(fl - fr, dim=1)
    err = torch.clamp(dist - 0.12, min=0.0)
    return torch.exp(-20.0 * err * err)


def stay_still(ctx):
    lin = torch.linalg.vector_norm(ctx.base_lin_vel[:, :2], dim=1)
    yaw = torch.abs(ctx.base_ang_vel[:, 2])
    return torch.exp(-((lin / 0.05) ** 2) - (yaw / 0.2) ** 2)


def lin_vel_xy(ctx):
    return torch.linalg.vector_norm(ctx.base_lin_vel[:, :2], dim=1)


# term name -> fn registries per env family
BASE_REWARDS = dict(
    lin_vel_z=lin_vel_z,
    ang_vel_xy=ang_vel_xy,
    orientation=orientation,
    base_height=base_height,
    torques=torques,
    dof_vel=dof_vel,
    dof_acc=dof_acc,
    action_rate=action_rate,
    collision=collision,
    termination=termination,
    dof_pos_limits=dof_pos_limits,
    dof_vel_limits=dof_vel_limits,
    torque_limits=torque_limits,
    tracking_lin_vel=tracking_lin_vel,
    tracking_ang_vel=tracking_ang_vel,
    feet_air_time=feet_air_time,
    feet_stumble=feet_stumble,
    stumble=stumble,
    stand_still=stand_still,
    feet_contact_forces=feet_contact_forces,
)

HUMANOID_REWARDS = dict(
    BASE_REWARDS,
    contact=contact,
    feet_swing_height=feet_swing_height,
    alive=alive,
    contact_no_vel=contact_no_vel,
    hip_pos=hip_pos,
)

HANDSTAND_REWARDS = dict(
    BASE_REWARDS,
    # the handstand overrides orientation/base_height with exp-shaped terms
    orientation=hs_orientation,
    base_height=hs_base_height,
    inversion_height=inversion_height,
    entry_lean=entry_lean,
    pre_inversion_crouch=pre_inversion_crouch,
    front_feet_contact=front_feet_contact,
    hind_feet_no_contact=hind_feet_no_contact,
    pose=pose,
    stability=stability,
    energy=energy,
    front_hip_neutral=front_hip_neutral,
    front_feet_together=front_feet_together,
    stay_still=stay_still,
    lin_vel_xy=lin_vel_xy,
)
