"""Humanoid envs (G1 / H1 / H1_2): the gait-phase extension of LeggedEnv
(counterpart of ``unitree_rl_gym_tpu/envs/humanoid.py``; reference
g1_env.py / h1_env.py / h1_2_env.py).

A 0.8 s gait clock with a 0.5 offset between the legs (g1_env.py:86-95),
set on the step's context by ``_callback`` after the heading controller;
sin/cos of the phase in the observation (g1_env.py:108-141); a privileged
critic observation that prepends the base linear velocity; and the five
humanoid reward terms (``rewards.HUMANOID_REWARDS``). The observation
context copies the step's context, so an env reset in this step observes
the phase computed before its reset, as in the JAX step.

Subclasses differ only in the hip dof indices that ``hip_pos`` penalises
(g1_env.py:180 / h1_env.py:123 / h1_2_env.py:123).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from reference.envs import rewards as R
from reference.envs.base_env import EnvState, LeggedEnv


class HumanoidEnv(LeggedEnv):
    HIP_IDX: Tuple[int, ...] = ()
    PHASE_PERIOD = 0.8       # g1_env.py:88
    PHASE_OFFSET = 0.5       # g1_env.py:89

    def __init__(self, cfg, robot=None, device=None, block=None):
        super().__init__(cfg, robot, device, block)
        self.hip_indices = torch.as_tensor(self.HIP_IDX, device=self.device)

    def _reward_registry(self):
        return R.HUMANOID_REWARDS

    def _noise_scale_vec(self) -> np.ndarray:
        """Humanoid layout: ang_vel, gravity, cmd, q, qd, a, sin/cos phase
        (g1_env.py:10-32); commands, actions and phase carry no noise."""
        cfg = self.cfg
        na = self.num_actions
        ns = cfg.noise.noise_scales
        osc = cfg.normalization.obs_scales
        lvl = cfg.noise.noise_level
        vec = np.zeros(self.num_obs, np.float32)
        vec[0:3] = ns["ang_vel"] * lvl * osc["ang_vel"]
        vec[3:6] = ns["gravity"] * lvl
        vec[9:9 + na] = ns["dof_pos"] * lvl * osc["dof_pos"]
        vec[9 + na:9 + 2 * na] = ns["dof_vel"] * lvl * osc["dof_vel"]
        return vec

    def _phase(self, episode_length):
        """Gait clock (g1_env.py:91-95): the phase in [0, 1) and the legs'
        phases [N, 2]."""
        t = episode_length.to(torch.float32) * self.dt
        phase = torch.remainder(t, self.PHASE_PERIOD) / self.PHASE_PERIOD
        phase_right = torch.remainder(phase + self.PHASE_OFFSET, 1.0)
        return phase, torch.stack((phase, phase_right), dim=1)

    def _callback(self, ctx, state: EnvState) -> EnvState:
        ctx.phase, ctx.leg_phase = self._phase(ctx.episode_length)
        return state

    def _extra_ctx(self, ctx, state: EnvState):
        ctx.hip_indices = self.hip_indices
        return ctx

    def _build_obs(self, ctx):
        """47 (h1: 41) obs and 50 (44) privileged obs (g1_env.py:108-141)."""
        osc = self.cfg.normalization.obs_scales
        sin_phase = torch.sin(2 * math.pi * ctx.phase)[:, None]
        cos_phase = torch.cos(2 * math.pi * ctx.phase)[:, None]
        common = (
            ctx.base_ang_vel * osc["ang_vel"],
            ctx.projected_gravity,
            ctx.commands[:, :3] * self.commands_scale,
            (ctx.dof_pos - self.default_dof_pos) * osc["dof_pos"],
            ctx.dof_vel * osc["dof_vel"],
            ctx.actions,
            sin_phase,
            cos_phase,
        )
        obs = torch.cat(common, dim=-1)
        priv = torch.cat((ctx.base_lin_vel * osc["lin_vel"],) + common, dim=-1)
        return obs, priv


class G1Env(HumanoidEnv):
    HIP_IDX = (1, 2, 7, 8)       # g1_env.py:180 (hip roll/yaw both legs)


class H1Env(HumanoidEnv):
    HIP_IDX = (0, 1, 5, 6)       # h1_env.py:123


class H1_2Env(HumanoidEnv):
    HIP_IDX = (0, 2, 6, 8)       # h1_2_env.py:123
