"""Go2 handstand task (counterpart of ``unitree_rl_gym_tpu/envs/
go2_handstand.py``; reference: go2_handstand_env.py + config).

Front feet support, hind feet airborne, base inverted. The env overrides
the observations (46-dim with contact flags, and the flags' bit-flip noise),
the termination (illegal contact with an optional grace, the sideways
"fallen" band after a grace, timeout), the PD target (rear-leg targets
clamped to +-0.15 rad around the handstand pose; torques not clipped to the
URDF limits), the reset (reference-state initialisation: planted handstand
holds and mid-transition states from host-side FK tables), and brings the
handstand reward terms. ``ppo_state_class_fn`` and ``ppo_anchor_mask_fn``
feed PPO's class re-weighting and anchor KL.

Randomness comes from the env's generator (envs/base_env.py); the tables
are built once on the CPU at env build, as the JAX package builds them on
the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from unitree_rl_gym_tpu_torch.envs import rewards as R
from unitree_rl_gym_tpu_torch.envs.base_env import EnvState, LeggedEnv
from unitree_rl_gym_tpu_torch.physics import dynamics as dyn
from unitree_rl_gym_tpu_torch.physics import engine as eng
from unitree_rl_gym_tpu_torch.utils import math as tm
from unitree_rl_gym_tpu_torch.utils.config import LeggedRobotCfg, TrainCfg

FRONT_JOINTS = ["FL_hip_joint", "FL_thigh_joint", "FL_calf_joint",
                "FR_hip_joint", "FR_thigh_joint", "FR_calf_joint"]
REAR_JOINTS = ["RL_hip_joint", "RL_thigh_joint", "RL_calf_joint",
               "RR_hip_joint", "RR_thigh_joint", "RR_calf_joint"]

# handstand keyframe (go2_handstand_config.py:157-176)
HANDSTAND_POSE = {
    "FL_hip_joint": 0.0, "FL_thigh_joint": -0.89, "FL_calf_joint": -1.5,
    "FR_hip_joint": 0.0, "FR_thigh_joint": -0.89, "FR_calf_joint": -1.5,
    "RL_hip_joint": 0.0, "RL_thigh_joint": 1.7, "RL_calf_joint": -1.853,
    "RR_hip_joint": 0.0, "RR_thigh_joint": 1.7, "RR_calf_joint": -1.853,
}

# footstand keyframe kept for the follow-up task
# (go2_handstand_config.py:183-198)
FOOTSTAND_POSE = {
    "FL_hip_joint": 0.0, "FL_thigh_joint": 0.82, "FL_calf_joint": -1.6,
    "FR_hip_joint": 0.0, "FR_thigh_joint": 0.82, "FR_calf_joint": -1.68,
    "RL_hip_joint": 0.0, "RL_thigh_joint": 1.82, "RL_calf_joint": -1.16,
    "RR_hip_joint": 0.0, "RR_thigh_joint": 1.82, "RR_calf_joint": -1.16,
}

REAR_LIMIT = 0.15        # +-rad around the handstand pose (go2_handstand_env.py:46)
CONTACT_FLIP_P = 0.01    # sensor-dropout bit-flip prob (go2_handstand_env.py:163)
FOOT_RADIUS = 0.022      # go2 foot sphere radius


def _interp(x, xp, fp):
    """``jnp.interp`` on tensors: linear in [xp[0], xp[-1]], clamped to the
    end values outside it (``xp`` increasing)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    w = (x - x0) / (x1 - x0)
    out = f0 + w * (f1 - f0)
    out = torch.where(x <= xp[0], fp[0], out)
    return torch.where(x >= xp[-1], fp[-1], out)


class GO2HandstandEnv(LeggedEnv):
    def __init__(self, cfg, robot=None, device=None, block=None):
        super().__init__(cfg, robot, device, block)
        dev = self.device
        # torques are not clipped in the handstand override
        self.pd = dataclasses.replace(self.pd, clip_torque=False)
        didx = {n: i for i, n in enumerate(self.robot.dof_names)}

        def idx(names):
            return torch.as_tensor([didx[n] for n in names], device=dev)

        self.front_dof_idx = idx(FRONT_JOINTS)
        self.rear_dof_idx = idx(REAR_JOINTS)
        self.front_hip_idx = idx(["FL_hip_joint", "FR_hip_joint"])
        self.front_thigh_idx = idx(["FL_thigh_joint", "FR_thigh_joint"])
        pose = self.default_dof_pos.cpu().numpy().copy()
        for n, a in cfg.handstand_pose_joint_angles.items():
            pose[didx[n]] = a
        self.pose_targets = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        self.rear_center = self.pose_targets[self.rear_dof_idx]
        # feet_indices order is FL, FR, RL, RR (traversal order)
        self.front_feet_indices = self.feet_indices[:2]
        self.hind_feet_indices = self.feet_indices[2:4]
        self._mid_tables = tuple(t.to(dev) for t in self._build_mid_tables())
        self._hold_tables = tuple(t.to(dev) for t in self._build_hold_tables())

    def _reward_registry(self):
        return R.HANDSTAND_REWARDS

    def _compute_target(self, actions):
        """Rear-leg targets clamped near the handstand pose
        (go2_handstand_env.py:326-350)."""
        targets = self.default_dof_pos + self.cfg.control.action_scale * actions
        lo = self.rear_center - REAR_LIMIT
        hi = self.rear_center + REAR_LIMIT
        rear = torch.clamp(targets[:, self.rear_dof_idx], lo, hi)
        targets = targets.clone()
        targets[:, self.rear_dof_idx] = rear
        return targets

    def _extra_ctx(self, ctx, state: EnvState):
        ctx.pose_targets = self.pose_targets
        ctx.front_dof_idx = self.front_dof_idx
        ctx.rear_dof_idx = self.rear_dof_idx
        ctx.front_hip_idx = self.front_hip_idx
        ctx.front_feet_indices = self.front_feet_indices
        ctx.hind_feet_indices = self.hind_feet_indices
        return ctx

    def _check_termination(self, ctx):
        """illegal contact | not-inverted | timeout
        (go2_handstand_env.py:178-219), staged as the JAX package stages
        it: the sideways band -0.2 < g_z < 0.2 terminates only after
        ``cfg.env.fallen_grace_s`` (default 1 s), so a kick-up can cross
        it; illegal contact terminates only after
        ``cfg.env.illegal_contact_grace_s`` (default 0, the reference's
        behaviour)."""
        cf = ctx.contact_forces[:, self.termination_contact_indices, :]
        illegal = torch.any(torch.linalg.vector_norm(cf, dim=-1) > 1.0, dim=1)
        ig_s = float(getattr(self.cfg.env, "illegal_contact_grace_s", 0.0))
        if ig_s > 0.0:
            illegal = illegal & (ctx.episode_length > int(round(ig_s / self.dt)))
        cos_up = ctx.projected_gravity[:, 2]
        fallen = (cos_up > -0.2) & (cos_up < 0.2)
        grace_s = getattr(self.cfg.env, "fallen_grace_s", 1.0)
        grace_steps = int(round(grace_s / self.dt))
        fallen = fallen & (ctx.episode_length > grace_steps)
        time_out = ctx.episode_length > self.max_episode_length
        return illegal | fallen | time_out, time_out

    def _noise_scale_vec(self) -> np.ndarray:
        """46-dim layout: gyro, gravity, q, qd, actions, contact flags
        (go2_handstand_env.py:386-423). The flags get bit-flip noise in
        :meth:`step` instead of additive noise."""
        cfg = self.cfg
        na = self.num_actions
        ns = cfg.noise.noise_scales
        osc = cfg.normalization.obs_scales
        lvl = cfg.noise.noise_level
        vec = np.zeros(self.num_obs, np.float32)
        i = 0
        vec[i:i + 3] = lvl * ns["gyro"] * osc["ang_vel"]
        i += 3
        vec[i:i + 3] = lvl * ns["gravity"]
        i += 3
        vec[i:i + na] = lvl * ns["dof_pos"] * osc["dof_pos"]
        i += na
        vec[i:i + na] = lvl * ns["dof_vel"] * osc["dof_vel"]
        return vec

    def _build_obs(self, ctx):
        """46-dim obs (go2_handstand_env.py:140-173); the privileged obs is
        the same tensor."""
        osc = self.cfg.normalization.obs_scales
        front = (ctx.contact_forces[:, self.front_feet_indices, 2] > 5.0).to(torch.float32)
        hind = (ctx.contact_forces[:, self.hind_feet_indices, 2] > 5.0).to(torch.float32)
        obs = torch.cat(
            (
                ctx.base_ang_vel * osc["ang_vel"],
                ctx.projected_gravity,
                (ctx.dof_pos - self.default_dof_pos) * osc["dof_pos"],
                ctx.dof_vel * osc["dof_vel"],
                ctx.actions,
                front,
                hind,
            ),
            dim=-1,
        )
        return obs, obs

    def ppo_state_class_fn(self, obs):
        """Task-critical-state classifier for PPO's class re-weighting
        (``AlgorithmCfg.class_target_frac``): 1 where g_z (column 5 of the
        46-dim obs) is above ``cfg.init_state.handstand_class_gz_threshold``
        (default 0, the inverted hemisphere)."""
        th = float(getattr(self.cfg.init_state, "handstand_class_gz_threshold", 0.0))
        return (obs[..., 5] > th).to(torch.float32)

    def ppo_anchor_mask_fn(self, obs):
        """Anchor-KL mask (``AlgorithmCfg.anchor_kl_coef``): always the
        inverted hemisphere g_z > 0, where the hold skill lives."""
        return (obs[..., 5] > 0.0).to(torch.float32)

    # ------------------------------------------------------------------
    # host-side FK tables of the reset (CPU float32, built once)
    # ------------------------------------------------------------------

    def _feet_world(self, th, joints):
        """World positions [4, 3] of the feet and the world R, p of every
        dyn body at pitch ``th`` about +y (base at the origin) with
        ``joints``."""
        model = self.robot.dyn
        quat = torch.tensor(np.array([0.0, np.sin(th / 2), 0.0, np.cos(th / 2)],
                                     np.float32))
        R_w, p_w, _, _ = dyn.fk(
            model, torch.zeros(3), quat,
            torch.as_tensor(np.asarray(joints, np.float32)),
            torch.zeros(6 + self.robot.num_dof),
        )
        b = model.rb_dyn_idx
        rb_pos = p_w[b] + torch.einsum("rij,rj->ri", R_w[b], model.rb_pos)
        return rb_pos, R_w, p_w, quat

    def _fk_table(self, ths, pose_fn):
        """Host FK table over the kick-up pitch th: (th, the base height
        with the lowest front foot on the ground, the body-frame offset
        base -> front-feet midpoint [3]) for ``joints = pose_fn(th)``."""
        front = self.front_feet_indices.cpu().numpy()
        heights, r_body = [], []
        for th in ths:
            rb_pos, _, _, quat = self._feet_world(th, pose_fn(th))
            feet = rb_pos.numpy()[front]                # [2, 3]
            heights.append(FOOT_RADIUS - float(feet[:, 2].min()))
            mid = feet.mean(axis=0)
            R0 = tm.quat_to_rotmat(quat).numpy()
            r_body.append(R0.T @ mid)
        return (
            torch.as_tensor(np.asarray(ths, np.float32)),
            torch.as_tensor(np.asarray(heights, np.float32)),
            torch.as_tensor(np.asarray(r_body, np.float32)),
        )

    def _build_mid_tables(self):
        """Mid-transition table: the pose lerped from the upright crouch
        toward the keyframe along the kick-up (th 0..210 deg in 7.5 deg
        steps; the default crouch below 30 deg)."""
        d0 = self.default_dof_pos.cpu().numpy()
        hs = self.pose_targets.cpu().numpy()

        def lerp_pose(th):
            alpha = float(np.clip((th - np.deg2rad(30.0)) / np.deg2rad(120.0),
                                  0.0, 1.0))
            return d0 + alpha * (hs - d0)

        ths = np.deg2rad(np.linspace(0.0, 210.0, 29)).astype(np.float32)
        return self._fk_table(ths, lerp_pose)

    def _com_feet_offset(self, th, joints):
        """World-x offset from the front-feet midpoint to the total CoM at
        pitch th with ``joints`` (> 0: the CoM is ahead of the support
        line)."""
        m = self.robot.dyn
        rb_pos, R_w, p_w, _ = self._feet_world(th, joints)
        R_w, p_w = R_w.numpy(), p_w.numpy()
        Isp = m.I_sp.numpy()
        masses = Isp[:, 5, 5]
        S = Isp[:, 0:3, 3:6] / np.maximum(masses, 1e-9)[:, None, None]
        coms_b = np.stack((S[:, 2, 1], S[:, 0, 2], S[:, 1, 0]), axis=-1)
        com_w = (R_w @ coms_b[..., None])[..., 0] + p_w
        com_x = (masses * com_w[:, 0]).sum() / masses.sum()
        feet_x = rb_pos.numpy()[self.front_feet_indices.cpu().numpy(), 0]
        return com_x - feet_x.mean()

    def _build_hold_tables(self):
        """Hold table over th 95..125 deg with balance-corrected keyframe
        poses: the front thighs flexed by the per-th delta (bisection) that
        puts the front-feet support line under the total CoM. Returns
        (th grid, planted heights, body-frame base -> feet-mid offsets [3],
        front-thigh deltas)."""
        hs = self.pose_targets.cpu().numpy()
        th_idx = self.front_thigh_idx.cpu().numpy()
        ths = np.deg2rad(np.linspace(95.0, 125.0, 7)).astype(np.float32)

        def balanced_pose(th):
            def off(d):
                p = hs.copy()
                p[th_idx] += d
                return self._com_feet_offset(th, p)

            lo, hi = -0.9, 0.9
            olo, ohi = off(lo), off(hi)
            if olo * ohi > 0:          # no zero in range: nearest end
                d = lo if abs(olo) < abs(ohi) else hi
            else:
                for _ in range(14):
                    mid = 0.5 * (lo + hi)
                    if off(mid) * olo <= 0:
                        hi = mid
                    else:
                        lo, olo = mid, off(mid)
                d = 0.5 * (lo + hi)
            p = hs.copy()
            p[th_idx] += d
            return p, d

        deltas, poses = [], {}
        for th in ths:
            p, d = balanced_pose(th)
            poses[float(th)] = p
            deltas.append(d)
        tab = self._fk_table(ths, lambda th: poses[float(th)])
        return tab + (torch.as_tensor(np.asarray(deltas, np.float32)),)

    # ------------------------------------------------------------------
    # reset: reference-state initialisation (RSI)
    # ------------------------------------------------------------------

    def _init_task_state(self):
        """``EnvState.task_state``: the live RSI probability."""
        p0 = float(getattr(self.cfg.init_state, "handstand_init_prob", 0.0))
        return torch.tensor(p0, dtype=torch.float32, device=self.device)

    def _sample_reset(self, n, origins, vx_range=None, task_state=None):
        """With probability ``task_state`` an env resets in a handstand
        instead of upright: trunk pitched th about +y (nose down), front feet
        planted (base height from the FK tables), joints at the
        balance-corrected keyframe for hold states (th in
        ``handstand_hold_th_deg``, a small +-w pitch rate), or lerped along
        the kick-up for the ``handstand_mid_frac`` share of mid-transition
        states (th in ``handstand_mid_th_deg``, pitch rate toward inversion
        in ``handstand_mid_w``); base velocity consistent with rotating
        about the planted feet."""
        phys, commands = super()._sample_reset(n, origins, vx_range)
        p_inv = task_state if task_state is not None else self._init_task_state()
        ist = self.cfg.init_state
        rand = self._rand
        inv = rand(n) < p_inv
        mid_frac = float(getattr(ist, "handstand_mid_frac", 0.5))
        mid = inv & (rand(n) < mid_frac)
        th_lo, th_hi = getattr(ist, "handstand_hold_th_deg", (100.0, 120.0))
        th_hold = rand(n, lo=math.radians(th_lo), hi=math.radians(th_hi))
        mid_lo, mid_hi = getattr(ist, "handstand_mid_th_deg", (40.0, 140.0))
        th_mid = rand(n, lo=math.radians(mid_lo), hi=math.radians(mid_hi))
        th = torch.where(mid, th_mid, th_hold)
        yaw = rand(n, lo=-math.pi, hi=math.pi)
        half_t, half_y = th * 0.5, yaw * 0.5
        # quat = rot_z(yaw) * rot_y(th), xyzw
        cy, sy = torch.cos(half_y), torch.sin(half_y)
        ct, st = torch.cos(half_t), torch.sin(half_t)
        q_inv = torch.stack((-sy * st, cy * st, sy * ct, cy * ct), dim=-1)
        th_gh, h_gh, r_gh, d_gh = self._hold_tables
        alpha = torch.clamp((th - math.radians(30.0)) / math.radians(120.0),
                            0.0, 1.0)[:, None]
        pose_lerp = self.default_dof_pos + alpha * (self.pose_targets
                                                    - self.default_dof_pos)
        dthigh = _interp(th, th_gh, d_gh)
        pose_hold = self.pose_targets.expand(n, self.robot.num_dof).clone()
        pose_hold[:, self.front_thigh_idx] += dthigh[:, None]
        pose_sel = torch.where(mid[:, None], pose_lerp, pose_hold)
        joints = pose_sel + rand(n, self.robot.num_dof, lo=-0.05, hi=0.05)
        th_g, h_g, r_g = self._mid_tables
        h_feet = torch.where(mid, _interp(th, th_g, h_g), _interp(th, th_gh, h_gh))
        height = h_feet + rand(n, lo=0.0, hi=0.02)
        w_lo, w_hi = getattr(ist, "handstand_mid_w", (1.5, 6.0))
        w_hold = getattr(ist, "handstand_hold_w", 0.3)
        w_pitch = torch.where(mid, rand(n, lo=w_lo, hi=w_hi),
                              rand(n, lo=-w_hold, hi=w_hold))
        # v_b = -omega_b x r_b with omega_b = (0, w, 0): (-w rz, 0, w rx)
        rx = torch.where(mid, _interp(th, th_g, r_g[:, 0]),
                         _interp(th, th_gh, r_gh[:, 0]))
        rz = torch.where(mid, _interp(th, th_g, r_g[:, 2]),
                         _interp(th, th_gh, r_gh[:, 2]))
        base_pos = phys.base_pos.clone()
        base_pos[:, 2] = torch.where(inv, height, phys.base_pos[:, 2])
        v_rsi = torch.zeros_like(phys.v)
        v_rsi[:, 1] = w_pitch
        v_rsi[:, 3] = -w_pitch * rz
        v_rsi[:, 5] = w_pitch * rx
        m = inv[:, None]
        phys = eng.PhysicsState(
            base_pos=base_pos,
            base_quat=torch.where(m, q_inv, phys.base_quat),
            joint_q=torch.where(m, joints, phys.joint_q),
            v=torch.where(m, v_rsi, phys.v),
        )
        return phys, commands

    def step(self, state, actions, refresh_terrain: bool = True):
        """The base step, then (a) the contact-flag bit-flip
        (go2_handstand_env.py:160-169): with noise on, each of the last 4
        obs dims flips with probability 0.01; (b) the RSI-probability
        anneal: ``task_state`` decays linearly from
        ``init_state.handstand_init_prob`` to ``handstand_init_prob_final``
        over ``handstand_anneal_steps`` control steps."""
        state, obs, priv, rew, reset, extras = super().step(
            state, actions, refresh_terrain)
        if self.cfg.noise.add_noise and CONTACT_FLIP_P > 0:
            flips = self._rand(self.num_envs, 4) < CONTACT_FLIP_P
            flags = obs[:, -4:] > 0.5
            obs = torch.cat((obs[:, :-4], (flags ^ flips).to(obs.dtype)), dim=1)
            state = state.replace(obs=obs)
        ist = self.cfg.init_state
        p0 = float(getattr(ist, "handstand_init_prob", 0.0))
        p1 = float(getattr(ist, "handstand_init_prob_final", p0))
        steps = float(getattr(ist, "handstand_anneal_steps", 0.0))
        if steps > 0 and p1 < p0:
            p = torch.clamp(state.task_state - (p0 - p1) / steps, min=p1)
            state = state.replace(task_state=p)
        extras["episode"]["hs_init_prob"] = state.task_state
        return state, obs, priv, rew, reset, extras


def go2_handstand_cfg() -> LeggedRobotCfg:
    cfg = LeggedRobotCfg()
    # env (go2_handstand_config.py:6-11)
    cfg.env.num_observations = 46
    cfg.env.num_privileged_obs = 46
    cfg.env.num_actions = 12
    # init_state (go2_handstand_config.py:13-31)
    cfg.init_state.pos = [0.0, 0.0, 0.28]
    # RSI: every episode starts planted in the balanceable band
    cfg.init_state.handstand_init_prob = 1.0
    cfg.init_state.handstand_init_prob_final = 1.0
    cfg.init_state.handstand_anneal_steps = 0
    cfg.init_state.handstand_mid_frac = 0.0
    # fallen-band termination grace (see _check_termination)
    cfg.env.fallen_grace_s = 1.5
    # contact-stiffness DR stays off in the shipped recipe
    # (DomainRandCfg.randomize_contact_stiffness; the robustness fine-tune
    # turns it on). Hold band: g_z 0.24-0.44, outside the fallen band
    cfg.init_state.handstand_hold_th_deg = (104.0, 116.0)
    cfg.init_state.handstand_mid_th_deg = (40.0, 120.0)
    cfg.init_state.default_joint_angles = {
        "FL_hip_joint": 0.3, "FR_hip_joint": -0.3,
        "FL_thigh_joint": 1.2, "FR_thigh_joint": 1.2,
        "FL_calf_joint": -2.0, "FR_calf_joint": -2.0,
        "RL_hip_joint": 0.1, "RR_hip_joint": -0.1,
        "RL_thigh_joint": 0.3, "RR_thigh_joint": 0.3,
        "RL_calf_joint": -1.4, "RR_calf_joint": -1.4,
    }
    # control (go2_handstand_config.py:33-38)
    cfg.control.control_type = "P"
    cfg.control.stiffness = {"joint": 35.0}
    cfg.control.damping = {"joint": 0.5}
    cfg.control.action_scale = 0.3
    cfg.control.decimation = 5
    # asset (go2_handstand_config.py:40-46)
    cfg.asset.file = "resources/robots/go2/urdf/go2.urdf"
    cfg.asset.name = "go2"
    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on = ["thigh", "calf", "hip"]
    cfg.asset.terminate_after_contacts_on = [
        "base", "thigh", "calf", "hip", "Head_lower", "Head_upper",
    ]
    cfg.asset.self_collisions = 1
    # noise (go2_handstand_config.py:48-58)
    cfg.noise.add_noise = True
    cfg.noise.noise_level = 1.0
    cfg.noise.noise_scales.update(
        gyro=0.2, gravity=0.05, dof_pos=0.01, dof_vel=1.5,
        lin_vel=0.1, actions=0.0,
    )
    # rewards (go2_handstand_config.py:60-133)
    cfg.rewards.only_positive_rewards = False
    cfg.rewards.base_height_target = 0.65
    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.scales = dict(
        orientation=5.0,
        base_height=2.0,
        front_feet_contact=3.0,
        hind_feet_no_contact=3.0,
        pose=10.0,
        stability=1.0,
        stay_still=2.0,
        lin_vel_xy=-3.0,
        lin_vel_z=-0.001,
        ang_vel_xy=-0.005,
        torques=-2e-4,
        dof_vel=-1e-5,
        dof_acc=0.0,
        action_rate=-0.006,
        dof_pos_limits=-1.0,
        dof_vel_limits=0.0,
        torque_limits=0.0,
        collision=-2.0,
        front_hip_neutral=2.0,
        front_feet_together=1.5,
        feet_contact_forces=0.0,
        inversion_height=0.0,      # training-time shaping; campaign recipes only
        entry_lean=0.0,            # training-time shaping; campaign recipes only
        pre_inversion_crouch=0.0,  # training-time shaping (negative scale)
        termination=-5.0,
        tracking_lin_vel=0.0,
        tracking_ang_vel=0.0,
        feet_air_time=0.0,
        stumble=0.0,
        energy=0.0,
    )
    cfg.handstand_pose_joint_angles = dict(HANDSTAND_POSE)
    cfg.footstand_pose_joint_angles = dict(FOOTSTAND_POSE)
    return cfg


def go2_handstand_train_cfg() -> TrainCfg:
    t = TrainCfg()
    # lower exploration noise and entropy than the locomotion tasks: the
    # hold is an unstable equilibrium
    t.policy.init_noise_std = 0.5
    t.algorithm.entropy_coef = 0.005
    t.runner.experiment_name = "go2_handstand"
    t.runner.max_iterations = 5000
    return t
