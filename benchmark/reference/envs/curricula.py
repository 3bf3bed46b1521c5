"""Terrain and command curricula and random pushes (counterpart of
``unitree_rl_gym_tpu/envs/curricula.py``: ``terrain_curriculum_at_reset``,
``command_curriculum_at_reset`` and ``push_robots``). Mask-driven:
evaluated every step, applied with ``torch.where``; the random draws come
from the caller's generator."""

from __future__ import annotations

import torch

from reference.utils import math as tm


def terrain_curriculum_at_reset(tcfg, terrain_origins, max_episode_length_s,
                                rand_level, reset_mask, base_pos, commands,
                                terrain_level, terrain_type, env_origin):
    """New (terrain_level, env_origin) for envs being reset: promote envs
    that walked past half a sub-terrain, demote those that walked less than
    half of what their command asked for; graduates of the last row get
    ``rand_level`` [N] (drawn in [0, num_rows))."""
    dist = torch.linalg.vector_norm(base_pos[:, :2] - env_origin[:, :2], dim=1)
    move_up = dist > tcfg.terrain_length / 2.0
    move_down = (
        dist < torch.linalg.vector_norm(commands[:, :2], dim=1)
        * max_episode_length_s * 0.5
    ) & ~move_up
    new_level = terrain_level + move_up.to(torch.int32) - move_down.to(torch.int32)
    new_level = torch.where(new_level >= tcfg.num_rows,
                            rand_level.to(new_level.dtype),
                            torch.clamp(new_level, min=0))
    terrain_level = torch.where(reset_mask, new_level, terrain_level)
    env_origin = torch.where(
        reset_mask[:, None],
        terrain_origins[terrain_level.long(), terrain_type.long()],
        env_origin,
    )
    return terrain_level, env_origin


def command_curriculum_at_reset(max_curriculum, tracking_scale,
                                max_episode_length, reset_mask, tracking_sums,
                                cmd_vx_range, reduce=None):
    """Widened lin_vel_x command range when reset envs track well.
    ``reduce`` (env data parallelism: ``parallel.mesh.all_reduce_sum``)
    sums the count of reset envs and their tracking sum over all ranks, so
    that every rank decides from the global mean and keeps the same
    range."""
    n_reset = torch.sum(reset_mask)
    track_sum = torch.sum(torch.where(reset_mask, tracking_sums, 0.0))
    if reduce is not None:
        n_reset, track_sum = reduce(torch.stack(
            (n_reset.to(track_sum.dtype), track_sum))).unbind()
    count = torch.clamp(n_reset, min=1)
    mean_track = (track_sum / count) / max_episode_length
    grow = (mean_track > 0.8 * tracking_scale) & (n_reset > 0)
    widened = torch.stack((
        torch.clamp(cmd_vx_range[0] - 0.5, -max_curriculum, 0.0),
        torch.clamp(cmd_vx_range[1] + 0.5, 0.0, max_curriculum),
    ))
    return torch.where(grow, widened, cmd_vx_range)


def push_robots(push_vxy, push_interval, episode_length, phys):
    """Overwrite the world-frame xy base velocity of envs whose episode clock
    hits the push interval with ``push_vxy`` [N, 2] (drawn by the caller
    from the env's generator); returns the updated physics state."""
    push_mask = (episode_length % push_interval) == 0
    R0 = tm.quat_to_rotmat(phys.base_quat)
    v_lin_w = torch.einsum("nij,nj->ni", R0, phys.v[:, 3:6])
    v_xy = torch.where(push_mask[:, None], push_vxy, v_lin_w[:, :2])
    v_lin_w = torch.cat((v_xy, v_lin_w[:, 2:]), dim=1)
    v_lin_b = torch.einsum("nji,nj->ni", R0, v_lin_w)
    return phys.replace(v=torch.cat((phys.v[:, :3], v_lin_b, phys.v[:, 6:]), dim=1))
