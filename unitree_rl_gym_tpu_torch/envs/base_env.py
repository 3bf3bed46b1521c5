"""LeggedEnv — batched legged-robot environment on tensors (counterpart of
``unitree_rl_gym_tpu/envs/base_env.py``: ``EnvState`` and ``LeggedEnv``).

The per-control-step pipeline keeps the JAX package's order (its module
docstring, after the reference's ``post_physics_step``): clip actions -> PD
target -> decimated physics (kernel K1 on flat ground and K3 on terrain on
CUDA, their plain version on CPU) -> resample commands *before* rewards,
heading controller -> termination -> feet air time -> rewards -> curricula
-> resets *after* rewards -> terrain height carry -> pushes *after* resets
-> observations last.

Terrain (``mesh_type="heightfield"`` or ``"trimesh"``, both a sampled
heightfield) follows the JAX package's kernel formulation on every device:
``EnvState.gh`` holds the ground height under every contact point at the
start of the step (rows [ncp, N]), frozen across the substeps; the control
step returns the end-of-step point xy, and the next ``gh`` is looked up in
per-env heightfield windows (``win``, re-centered by
:meth:`LeggedEnv.refresh_terrain`). Envs reset since the last refresh
stand on their spawn platform height until the next one.

Domain randomisation drawn once per env in ``reset_all`` (never per
episode, as the JAX package): the 64 friction buckets, the base mass, the
contact stiffness ``cstiff`` (the control step's K2 operand), the PD-gain
scale ``pd_gain`` and the one-step actuation delay ``act_delay``. A delayed
env actuates the previous step's action (obs and rewards keep the commanded
one); the gain scale is a target transform ``q + g (target - q)`` at the
step-start ``q`` (``base_env.py:611-640`` of the JAX package).

Tasks override the hooks of the JAX package's ``LeggedEnv``:
``_reward_registry``, ``_noise_scale_vec``, ``_build_obs(ctx)``,
``_callback``, ``_extra_ctx``, ``_compute_target``, ``_check_termination``,
``_init_task_state`` and ``_sample_reset(..., task_state)``
(envs/go2_handstand.py, envs/humanoid.py); a task that adds to the whole
step overrides ``_step``, the body of ``step`` inside its ``env_step`` span.

Randomness comes from one ``torch.Generator`` held by the env on its device
and seeded from ``cfg.seed`` (``--seed``). It cannot reproduce the JAX
package's PRNG draws; parity tests start both packages from one state
(:meth:`EnvState.from_numpy`, which takes the DR draws too) with in-step
randomness off.

Env data parallelism (``block``, a ``parallel.mesh.EnvBlock``): the env
holds one rank's contiguous block of the ``cfg.env.num_envs`` global envs
(``num_envs`` is the block's size, ``num_envs_global`` the global count).
Every per-env draw is made at the global shape from a generator seeded as
in one process, and the rank keeps its rows, so each env draws what it
would draw in a one-process run; terrain types stripe by the global env
id; every rank builds the same terrain; the control step is the rank's
launch on its block (K4); the command curriculum decides from the mean
over all ranks' reset envs. The logging sums of ``extras`` stay this
rank's (the PPO rollout reduces them once per iteration), and
``terrain_level_mean`` is this rank's share of the global mean. Without a
block the env holds the one block of one rank, which makes no collective:
it is exactly the one-process env.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Optional

import numpy as np
import torch

from unitree_rl_gym_tpu_torch import resolve_device, resource
from unitree_rl_gym_tpu_torch.envs import curricula
from unitree_rl_gym_tpu_torch.envs import rewards as R
from unitree_rl_gym_tpu_torch.models.robot import Robot, build_robot
from unitree_rl_gym_tpu_torch.parallel.mesh import all_reduce_sum, env_block
from unitree_rl_gym_tpu_torch.physics import backend as pback
from unitree_rl_gym_tpu_torch.physics import contact as ct
from unitree_rl_gym_tpu_torch.physics import dynamics as dyn
from unitree_rl_gym_tpu_torch.physics import engine as eng
from unitree_rl_gym_tpu_torch.utils import math as tm
from unitree_rl_gym_tpu_torch.utils.config import LeggedRobotCfg
from unitree_rl_gym_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class EnvState:
    """Complete batched environment state (everything that evolves)."""

    phys: eng.PhysicsState          # [N, ...]
    episode_length: torch.Tensor    # [N] int32
    commands: torch.Tensor          # [N, 4]
    actions: torch.Tensor           # [N, na]
    last_actions: torch.Tensor      # [N, na]
    last_dof_vel: torch.Tensor      # [N, nj]
    feet_air_time: torch.Tensor     # [N, nf]
    last_contacts: torch.Tensor     # [N, nf] bool
    friction: torch.Tensor          # [N] DR shape friction
    mass_scale: torch.Tensor        # [N] DR base-mass factor
    episode_sums: torch.Tensor      # [N, n_terms]
    env_origin: torch.Tensor        # [N, 3]
    terrain_level: torch.Tensor     # [N] int32 (0 on the plane)
    terrain_type: torch.Tensor      # [N] int32 (0 on the plane)
    cmd_vx_range: torch.Tensor      # [2] live lin_vel_x range
    obs: torch.Tensor               # [N, num_obs]
    priv_obs: Optional[torch.Tensor] = None
    # terrain only (None on the plane): step-start ground height under
    # every contact point, rows [ncp, N]; per-env heightfield windows
    # [N, W, W] with their grid corners [N, 2] int32; envs reset since the
    # last window refresh [N] bool
    gh: Optional[torch.Tensor] = None
    win: Optional[torch.Tensor] = None
    win_corner: Optional[torch.Tensor] = None
    win_stale: Optional[torch.Tensor] = None
    # task-specific evolving state (None for base tasks; the handstand's
    # live RSI probability, a 0-d tensor)
    task_state: Optional[torch.Tensor] = None
    # per-env DR fixed at reset_all (None when off): contact-stiffness scale
    # [N], PD proportional-gain scale [N], one-step actuation delay [N] bool
    cstiff: Optional[torch.Tensor] = None
    pd_gain: Optional[torch.Tensor] = None
    act_delay: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_numpy(cls, d, device) -> "EnvState":
        """Build the port's state from the numpy leaves of a JAX ``EnvState``:
        ``d`` maps field names to arrays, with ``d["phys"]`` mapping
        ``base_pos``/``base_quat``/``joint_q``/``v``. The PRNG ``key`` is
        ignored (the port draws from the env's generator)."""

        def t(a):
            return torch.as_tensor(np.array(a), device=device)

        phys = eng.PhysicsState(**{k: t(d["phys"][k]) for k in
                                   ("base_pos", "base_quat", "joint_q", "v")})
        kw = {
            f.name: t(d[f.name]) if d.get(f.name) is not None else None
            for f in dataclasses.fields(cls) if f.name != "phys"
        }
        return cls(phys=phys, **kw)


class LeggedEnv:
    """Static task description + step/reset over batched tensors."""

    def __init__(self, cfg: LeggedRobotCfg, robot: Optional[Robot] = None,
                 device=None, block=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dr = cfg.domain_rand
        if block is None:
            block = env_block(cfg.env.num_envs, 0, 1)
        elif block.n_global != cfg.env.num_envs:
            raise ValueError(f"env block of {block.n_global} envs for a cfg "
                             f"of {cfg.env.num_envs}")
        self.block = block
        # more than one rank: the cross-env sums are all-reduced
        self.distributed = block.world_size > 1

        contact_bodies = None
        if cfg.asset.prune_contact_bodies:
            contact_bodies = (
                [cfg.asset.foot_name]
                + list(cfg.asset.penalize_contacts_on)
                + list(cfg.asset.terminate_after_contacts_on)
            )
        self.robot = robot or build_robot(
            resource(cfg.asset.file), armature=cfg.asset.armature,
            gravity=tuple(cfg.sim.gravity), contact_bodies=contact_bodies,
        )
        r = self.robot
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(cfg.seed))

        self.num_envs_global = cfg.env.num_envs
        self.num_envs = block.n_local
        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.num_actions = cfg.env.num_actions
        self.dt = cfg.control.decimation * cfg.sim.dt
        self.max_episode_length_s = cfg.env.episode_length_s
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))
        self.push_interval = int(np.ceil(dr.push_interval_s / self.dt))
        self.resample_interval = int(cfg.commands.resampling_time / self.dt)

        default_dof_pos = r.default_dof_pos(cfg.init_state.default_joint_angles)
        self.default_dof_pos = torch.as_tensor(default_dof_pos, **f32)
        kp, kd = r.pd_gains(cfg.control.stiffness, cfg.control.damping)
        for i, name in enumerate(r.dof_names):
            if kp[i] == 0:
                print(f"PD gain of joint {name} were not defined, setting them to zero")
        self.pd = eng.PDParams(
            kp=np.asarray(kp, np.float32),
            kd=np.asarray(kd, np.float32),
            torque_limit=np.asarray(r.dof_effort, np.float32),
            clip_torque=True,
        )
        self.cparams = ct.ContactParams(
            iterations=cfg.sim.contact_iterations,
            baumgarte=cfg.sim.contact_baumgarte,
            max_depenetration_velocity=cfg.sim.max_depenetration_velocity,
            terrain_friction=cfg.terrain.static_friction,
            max_angular_velocity=cfg.asset.max_angular_velocity,
            max_linear_velocity=cfg.asset.max_linear_velocity,
        )
        mid = (r.dof_lower + r.dof_upper) / 2
        rng = r.dof_upper - r.dof_lower
        soft = cfg.rewards.soft_dof_pos_limit
        self.dof_pos_soft_lo = torch.as_tensor(
            np.asarray(mid - 0.5 * rng * soft, np.float32), device=dev)
        self.dof_pos_soft_hi = torch.as_tensor(
            np.asarray(mid + 0.5 * rng * soft, np.float32), device=dev)
        self.dof_vel_limits = torch.as_tensor(
            np.asarray(r.dof_velocity, np.float32), device=dev)
        self.torque_limits = torch.as_tensor(
            np.asarray(r.dof_effort, np.float32), device=dev)

        self.feet_indices = torch.as_tensor(
            r.body_indices([cfg.asset.foot_name]), device=dev)
        self.penalised_contact_indices = torch.as_tensor(
            r.body_indices(cfg.asset.penalize_contacts_on), device=dev)
        self.termination_contact_indices = torch.as_tensor(
            r.body_indices(cfg.asset.terminate_after_contacts_on), device=dev)
        self.num_feet = int(self.feet_indices.shape[0])

        osc = cfg.normalization.obs_scales
        self.commands_scale = torch.tensor(
            [osc["lin_vel"], osc["lin_vel"], osc["ang_vel"]], **f32)
        self.base_init_pos = torch.tensor(cfg.init_state.pos, **f32)
        self.base_init_quat = torch.tensor(cfg.init_state.rot, **f32)

        # terrain: the heightfield and spawn origins (numpy, from cfg.seed),
        # then the grid on the device
        self.terrain = None
        if cfg.terrain.mesh_type in ("heightfield", "trimesh"):
            from unitree_rl_gym_tpu_torch.utils.terrain import Terrain

            self.terrain = Terrain(cfg.terrain, self.num_envs_global,
                                   seed=cfg.seed)
            self.grid = self.terrain.grid(dev)
            self.terrain_origins = torch.as_tensor(
                self.terrain.env_origins, **f32)
            self.cp_xy0 = self._default_pose_point_xy().to(dev)

        # contact-solver preconditioner at the nominal pose (CPU, build time)
        m_eff_n, m_eff_t = ct.point_effective_mass(
            r.dyn, self.base_init_quat.cpu(), self.base_init_pos.cpu(),
            torch.as_tensor(default_dof_pos, dtype=torch.float32),
        )
        self.m_eff_n = m_eff_n.numpy().astype(np.float32)
        self.m_eff_t = m_eff_t.numpy().astype(np.float32)

        # reward machinery: prune zero scales, multiply by dt
        self.reward_fns = self._reward_registry()
        self.reward_names, self.reward_scales = [], []
        for name, scale in cfg.rewards.scales.items():
            if scale == 0 or name == "termination":
                continue
            if name not in self.reward_fns:
                raise KeyError(f"no reward function for scale '{name}'")
            self.reward_names.append(name)
            self.reward_scales.append(scale * self.dt)
        self.termination_scale = cfg.rewards.scales.get("termination", 0.0) * self.dt
        self.episode_term_names = list(self.reward_names) + (
            ["termination"] if self.termination_scale != 0 else []
        )
        self.noise_scale_vec = torch.as_tensor(self._noise_scale_vec(), device=dev)

    # ------------------------------------------------------------------
    # overridable hooks (per-task subclasses)
    # ------------------------------------------------------------------

    def _reward_registry(self):
        return R.BASE_REWARDS

    def _noise_scale_vec(self) -> np.ndarray:
        """Base 48-dim noise layout (legged_robot.py:188-219)."""
        cfg = self.cfg
        na = self.num_actions
        ns = cfg.noise.noise_scales
        osc = cfg.normalization.obs_scales
        lvl = cfg.noise.noise_level
        vec = np.zeros(self.num_obs, np.float32)
        vec[0:3] = ns["lin_vel"] * lvl * osc["lin_vel"]
        vec[3:6] = ns["ang_vel"] * lvl * osc["ang_vel"]
        vec[6:9] = ns["gravity"] * lvl
        vec[12:12 + na] = ns["dof_pos"] * lvl * osc["dof_pos"]
        vec[12 + na:12 + 2 * na] = ns["dof_vel"] * lvl * osc["dof_vel"]
        return vec

    def _env_draw(self, draw, n, *rest):
        """``draw(shape)`` for the ``n`` envs of this block: the draw over
        all envs and this block's rows of it."""
        if n != self.num_envs:
            raise ValueError(f"a draw for {n} envs on a block of {self.num_envs}")
        return self.block.rows(draw((self.num_envs_global,) + rest))

    def _rand(self, n, *rest, lo=0.0, hi=1.0):
        """Uniform draws in [lo, hi) of shape (n, *rest) for ``n`` envs."""
        u = self._env_draw(lambda s: torch.rand(
            s, generator=self.gen, device=self.device), n, *rest)
        return lo + (hi - lo) * u

    def _randint(self, high, n):
        """Integers in [0, high) for ``n`` envs, int64."""
        return self._env_draw(lambda s: torch.randint(
            0, high, s, generator=self.gen, device=self.device), n)

    def _projected_gravity(self, quat):
        g = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand_as(quat[:, :3])
        return tm.quat_rotate_inverse(quat, g)

    def _build_obs(self, ctx):
        """Base 48-dim observation (legged_robot.py:789-807); returns
        (obs, privileged obs or None)."""
        osc = self.cfg.normalization.obs_scales
        obs = torch.cat(
            (
                ctx.base_lin_vel * osc["lin_vel"],
                ctx.base_ang_vel * osc["ang_vel"],
                ctx.projected_gravity,
                ctx.commands[:, :3] * self.commands_scale,
                (ctx.dof_pos - self.default_dof_pos) * osc["dof_pos"],
                ctx.dof_vel * osc["dof_vel"],
                ctx.actions,
            ),
            dim=-1,
        )
        return obs, None

    def _callback(self, ctx, state: EnvState) -> EnvState:
        """Post-physics, pre-termination hook, after the heading controller
        (the humanoids' gait phase, envs/humanoid.py). Base: no-op."""
        return state

    def _extra_ctx(self, ctx, state: EnvState):
        """Attach task-specific fields to the reward/obs context."""
        return ctx

    def _init_task_state(self):
        """Initial value of ``EnvState.task_state`` (None for base tasks)."""
        return None

    def _compute_target(self, actions):
        """action -> PD position target (legged_robot.py:661-664)."""
        return actions * self.cfg.control.action_scale + self.default_dof_pos

    def _check_termination(self, ctx):
        """illegal contact ∪ tip-over ∪ timeout (legged_robot.py:711-721)."""
        cf = ctx.contact_forces[:, self.termination_contact_indices, :]
        illegal = torch.any(torch.linalg.vector_norm(cf, dim=-1) > 1.0, dim=1)
        tipped = (torch.abs(ctx.rpy[:, 1]) > 1.0) | (torch.abs(ctx.rpy[:, 0]) > 0.8)
        time_out = ctx.episode_length > self.max_episode_length
        return illegal | tipped | time_out, time_out

    def _sample_commands(self, n, vx_range=None):
        cr = self.cfg.commands.ranges
        if vx_range is None:
            vx_lo, vx_hi = cr["lin_vel_x"]
        else:
            vx_lo, vx_hi = vx_range[0], vx_range[1]
        cmd = torch.zeros((n, 4), device=self.device)
        cmd[:, 0] = vx_lo + (vx_hi - vx_lo) * self._rand(n)
        cmd[:, 1] = self._rand(n, lo=cr["lin_vel_y"][0], hi=cr["lin_vel_y"][1])
        if self.cfg.commands.heading_command:
            cmd[:, 3] = self._rand(n, lo=cr["heading"][0], hi=cr["heading"][1])
        else:
            cmd[:, 2] = self._rand(n, lo=cr["ang_vel_yaw"][0], hi=cr["ang_vel_yaw"][1])
        # set small commands to zero (legged_robot.py:538)
        keep = torch.linalg.vector_norm(cmd[:, :2], dim=1) > 0.2
        cmd[:, :2] *= keep[:, None]
        return cmd

    # ------------------------------------------------------------------
    # terrain height carry
    # ------------------------------------------------------------------

    def _default_pose_point_xy(self):
        """World xy [ncp, 2] of every contact point relative to the base
        origin at the default pose and init orientation, in the control
        step's (sorted) point order; computed once on the CPU."""
        model = self.robot.dyn
        R_w, p_w, _, v_b = dyn.fk(
            model, torch.zeros(3), self.base_init_quat.cpu(),
            self.default_dof_pos.cpu(), torch.zeros(6 + self.robot.num_dof),
        )
        x, _ = ct.point_kinematics(model, R_w, p_w, v_b)
        perm = torch.as_tensor(pback.soa_model_for(model).cp_perm)
        return x[:, :2][perm]

    def _reset_gh(self, base_pos):
        """gh rows [ncp, N] under the default-pose points at ``base_pos``
        (exact lookup; reset_all only)."""
        return self.grid.height_at(
            base_pos[:, None, :2] + self.cp_xy0[None]).T.contiguous()

    def refresh_terrain(self, state: EnvState) -> EnvState:
        """Re-center every env's heightfield window on its base and clear
        staleness: every step by default (``step(refresh_terrain=True)``),
        every ``terrain.window_refresh_steps`` steps in the PPO rollout.
        No-op on the plane."""
        if self.terrain is None:
            return state
        with span("env_refresh_terrain"):
            win, corner = self.grid.window_at(
                state.phys.base_pos[:, :2], W=self.cfg.terrain.window_size)
            return state.replace(
                win=win, win_corner=corner,
                win_stale=torch.zeros((self.num_envs,), dtype=torch.bool,
                                      device=self.device),
            )

    def _sample_reset(self, n, origins, vx_range=None, task_state=None):
        """Fresh physics state + commands for ``n`` envs
        (legged_robot.py:557-594, 519-538). On terrain the base spawns at
        its sub-terrain origin with +-1 m of xy jitter. ``task_state`` is
        the live ``EnvState.task_state``, for tasks whose reset distribution
        evolves over training (the handstand's RSI)."""
        nj = self.robot.num_dof
        dof_pos = self.default_dof_pos * self._rand(n, nj, lo=0.5, hi=1.5)
        base_vel = self._rand(n, 6, lo=-0.5, hi=0.5)
        # reference order [lin, ang] (world); v is [ang; lin] (body) and the
        # init rotation is the identity
        v = torch.cat(
            (base_vel[:, 3:6], base_vel[:, 0:3],
             torch.zeros((n, nj), device=self.device)), dim=1)
        base_pos = self.base_init_pos.expand(n, 3) + origins
        if self.terrain is not None:
            jitter = self._rand(n, 2, lo=-1.0, hi=1.0)
            base_pos = torch.cat((base_pos[:, :2] + jitter, base_pos[:, 2:]), 1)
        phys = eng.PhysicsState(
            base_pos=base_pos,
            base_quat=self.base_init_quat.expand(n, 4).contiguous(),
            joint_q=dof_pos,
            v=v,
        )
        return phys, self._sample_commands(n, vx_range)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def reset_all(self, init_at_random_ep_len: bool = False):
        """Reset every env and take one zero-action step; returns
        (state, obs) (BaseTask.reset semantics)."""
        N, nj, dev = self.num_envs, self.robot.num_dof, self.device
        dr = self.cfg.domain_rand
        tcfg = self.cfg.terrain
        if self.terrain is not None:
            # start rows <= max_init_terrain_level under the curriculum,
            # types striped across the columns
            max_lvl = (min(tcfg.max_init_terrain_level + 1, tcfg.num_rows)
                       if tcfg.curriculum else tcfg.num_rows)
            terrain_level = self._randint(max_lvl, N).to(torch.int32)
            # by global env id: env i of the N_global is on column
            # i * num_cols // N_global whatever the rank holding it
            terrain_type = ((self.block.offset + torch.arange(N, device=dev))
                            * tcfg.num_cols
                            // self.num_envs_global).to(torch.int32)
            env_origin = self.terrain_origins[terrain_level.long(),
                                              terrain_type.long()]
        else:
            terrain_level = torch.zeros((N,), dtype=torch.int32, device=dev)
            terrain_type = torch.zeros((N,), dtype=torch.int32, device=dev)
            env_origin = torch.zeros((N, 3), device=dev)
        cmd_vx_range = torch.tensor(
            self.cfg.commands.ranges["lin_vel_x"], dtype=torch.float32, device=dev)
        vx_range = cmd_vx_range if self.cfg.commands.curriculum else None
        task_state = self._init_task_state()
        phys, commands = self._sample_reset(N, env_origin, vx_range,
                                            task_state=task_state)
        if dr.randomize_friction:
            # 64 friction buckets (legged_robot.py:432-436)
            # (the buckets are shared by all envs: not an env-batched draw)
            lo, hi = dr.friction_range
            buckets = lo + (hi - lo) * torch.rand(
                (64,), generator=self.gen, device=dev)
            friction = buckets[self._randint(64, N)]
        else:
            friction = torch.full((N,), self.cfg.terrain.static_friction, device=dev)
        if dr.randomize_base_mass:
            added = self._rand(N, lo=dr.added_mass_range[0], hi=dr.added_mass_range[1])
            mass_scale = 1.0 + added / self.robot.dyn.base_mass
        else:
            mass_scale = torch.ones((N,), device=dev)
        # actuation-loop and contact DR, fixed per env for its lifetime
        cstiff = pd_gain = act_delay = None
        if dr.randomize_contact_stiffness:
            lo, hi = dr.contact_stiffness_range
            cstiff = self._rand(N, lo=lo, hi=hi)
        if dr.randomize_pd_gain:
            lo, hi = dr.pd_gain_range
            pd_gain = self._rand(N, lo=lo, hi=hi)
        if dr.action_delay_prob > 0.0:
            act_delay = self._rand(N) < dr.action_delay_prob
        if init_at_random_ep_len:
            episode_length = self._randint(self.max_episode_length,
                                           N).to(torch.int32)
        else:
            episode_length = torch.zeros((N,), dtype=torch.int32, device=dev)

        def zeros(*shape):
            return torch.zeros(shape, device=dev)

        state = EnvState(
            phys=phys,
            episode_length=episode_length,
            commands=commands,
            actions=zeros(N, self.num_actions),
            last_actions=zeros(N, self.num_actions),
            last_dof_vel=zeros(N, nj),
            feet_air_time=zeros(N, self.num_feet),
            last_contacts=torch.zeros((N, self.num_feet), dtype=torch.bool, device=dev),
            friction=friction,
            mass_scale=mass_scale,
            episode_sums=zeros(N, len(self.episode_term_names)),
            env_origin=env_origin,
            terrain_level=terrain_level,
            terrain_type=terrain_type,
            cmd_vx_range=cmd_vx_range,
            obs=zeros(N, self.num_obs),
            priv_obs=zeros(N, self.num_privileged_obs) if self.num_privileged_obs else None,
            gh=self._reset_gh(phys.base_pos) if self.terrain is not None else None,
            task_state=task_state,
            cstiff=cstiff,
            pd_gain=pd_gain,
            act_delay=act_delay,
        )
        state = self.refresh_terrain(state)
        state, obs, *_ = self.step(state, zeros(N, self.num_actions))
        return state, obs

    def step(self, state: EnvState, actions, refresh_terrain: bool = True):
        """One control step for all envs; returns
        (state, obs, priv_obs, rew, reset_buf, extras).

        ``refresh_terrain`` re-centers the heightfield windows first (eval
        loops); the PPO rollout passes False and refreshes every
        ``terrain.window_refresh_steps`` steps itself. The step runs as the
        ``env_step`` span, its parts as ``env_physics``, ``env_rewards``,
        ``env_reset``, ``terrain_window_contraction`` and ``env_obs``."""
        with span("env_step"):
            return self._step(state, actions, refresh_terrain)

    def _step(self, state: EnvState, actions, refresh_terrain: bool):
        """The body of :meth:`step`; a task that adds to the step overrides
        this, so that its additions run inside the ``env_step`` span."""
        cfg = self.cfg
        N = self.num_envs
        if refresh_terrain:
            state = self.refresh_terrain(state)
        clip_a = cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)

        # ---- actuation-delay DR: delayed envs actuate the previous step's
        #      action (state.actions still holds it); obs and rewards keep
        #      the commanded one ----
        phys_actions = actions
        if state.act_delay is not None:
            phys_actions = torch.where(state.act_delay[:, None], state.actions,
                                       actions)
        target = self._compute_target(phys_actions)
        if state.pd_gain is not None:
            # per-env proportional-gain scale as a target transform at the
            # step-start q: kp ((q + g (t - q)) - q) = g kp (t - q)
            q0 = state.phys.joint_q
            target = q0 + state.pd_gain[:, None] * (target - q0)

        # ---- physics: K1 (plane), K3 (terrain) or K2 (contact-stiffness
        #      DR) on CUDA tensors, the plain version on CPU ----
        with span("env_physics"):
            phys, aux = pback.control_step(
                self.robot.dyn, self.cparams, self.pd, cfg.sim.dt,
                cfg.control.decimation, state.phys, target, state.friction,
                state.mass_scale, self.m_eff_n, self.m_eff_t, state.gh,
                cstiff=state.cstiff, block=self.block,
            )
        episode_length = state.episode_length + 1
        state = state.replace(phys=phys, actions=actions,
                              episode_length=episode_length)

        base_quat = phys.base_quat
        ctx = types.SimpleNamespace(
            cfg=cfg,
            num_envs=N,
            dt=self.dt,
            base_pos=phys.base_pos,
            base_quat=base_quat,
            rpy=tm.get_euler_xyz(base_quat),
            base_ang_vel=phys.v[:, 0:3],
            base_lin_vel=phys.v[:, 3:6],
            projected_gravity=self._projected_gravity(base_quat),
            dof_pos=phys.joint_q,
            dof_vel=phys.v[:, 6:],
            last_dof_vel=state.last_dof_vel,
            torques=aux["torques"],
            contact_forces=aux["cf_rb"],
            rb_pos_w=aux["rb_pos_w"],
            rb_vel_w=aux["rb_vel_w"],
            feet_pos=aux["rb_pos_w"][:, self.feet_indices, :],
            feet_vel=aux["rb_vel_w"][:, self.feet_indices, :],
            actions=actions,
            last_actions=state.last_actions,
            episode_length=episode_length,
            feet_indices=self.feet_indices,
            penalised_contact_indices=self.penalised_contact_indices,
            default_dof_pos=self.default_dof_pos,
            dof_pos_soft_lo=self.dof_pos_soft_lo,
            dof_pos_soft_hi=self.dof_pos_soft_hi,
            dof_vel_limits=self.dof_vel_limits,
            torque_limits=self.torque_limits,
            commands=state.commands,
        )
        ctx = self._extra_ctx(ctx, state)

        # ---- command resample + heading controller (legged_robot.py:488-517)
        vx_range = state.cmd_vx_range if cfg.commands.curriculum else None
        resample_mask = (episode_length % self.resample_interval) == 0
        new_cmds = self._sample_commands(N, vx_range)
        commands = torch.where(resample_mask[:, None], new_cmds, state.commands)
        if cfg.commands.heading_command:
            fwd = tm.quat_rotate(
                base_quat,
                torch.tensor([1.0, 0.0, 0.0], device=self.device).expand(N, 3),
            )
            heading = torch.atan2(fwd[:, 1], fwd[:, 0])
            yaw_cmd = torch.clamp(
                0.5 * tm.wrap_to_pi(commands[:, 3] - heading), -1.0, 1.0)
            commands = torch.cat(
                (commands[:, :2], yaw_cmd[:, None], commands[:, 3:]), dim=1)
        state = state.replace(commands=commands)
        ctx.commands = commands
        state = self._callback(ctx, state)

        # ---- termination (legged_robot.py:711-721) ----
        reset_buf, time_out_buf = self._check_termination(ctx)
        ctx.reset_buf = reset_buf
        ctx.time_out_buf = time_out_buf

        # ---- feet air time bookkeeping (legged_robot.py:912-923) ----
        contact = ctx.contact_forces[:, self.feet_indices, 2] > 1.0
        contact_filt = contact | state.last_contacts
        ctx.first_contact = (state.feet_air_time > 0.0) * contact_filt
        ctx.feet_air_time = state.feet_air_time + self.dt
        state = state.replace(
            last_contacts=contact,
            feet_air_time=ctx.feet_air_time * (~contact_filt),
        )

        # ---- rewards (legged_robot.py:770-787) ----
        with span("env_rewards"):
            rew = torch.zeros(N, device=self.device)
            term_rews = []
            for name, scale in zip(self.reward_names, self.reward_scales):
                r_i = self.reward_fns[name](ctx) * scale
                rew = rew + r_i
                term_rews.append(r_i)
            if cfg.rewards.only_positive_rewards:
                rew = torch.clamp(rew, min=0.0)
            if self.termination_scale != 0.0:
                r_t = R.termination(ctx) * self.termination_scale
                rew = rew + r_t
                term_rews.append(r_t)
            episode_sums = state.episode_sums + torch.stack(term_rews, dim=1)

        # ---- curricula, evaluated at reset time ----
        with span("env_reset"):
            m = reset_buf
            mb = m[:, None]
            terrain_level, env_origin = state.terrain_level, state.env_origin
            if self.terrain is not None and cfg.terrain.curriculum:
                rand_level = self._randint(cfg.terrain.num_rows, N)
                terrain_level, env_origin = curricula.terrain_curriculum_at_reset(
                    cfg.terrain, self.terrain_origins, self.max_episode_length_s,
                    rand_level, m, phys.base_pos, commands, terrain_level,
                    state.terrain_type, env_origin,
                )
            cmd_vx_range = state.cmd_vx_range
            if cfg.commands.curriculum:
                idx = self.reward_names.index("tracking_lin_vel")
                cmd_vx_range = curricula.command_curriculum_at_reset(
                    cfg.commands.max_curriculum, self.reward_scales[idx],
                    self.max_episode_length, m, episode_sums[:, idx], cmd_vx_range,
                    reduce=all_reduce_sum if self.distributed else None,
                )

            # ---- fused reset (legged_robot.py:723-768) ----
            reset_phys, reset_cmds = self._sample_reset(
                N, env_origin,
                vx_range=cmd_vx_range if cfg.commands.curriculum else None,
                task_state=state.task_state,
            )

            def sel(new, old):
                return torch.where(m.reshape((N,) + (1,) * (old.ndim - 1)), new, old)

            phys = eng.PhysicsState(
                base_pos=sel(reset_phys.base_pos, phys.base_pos),
                base_quat=sel(reset_phys.base_quat, phys.base_quat),
                joint_q=sel(reset_phys.joint_q, phys.joint_q),
                v=sel(reset_phys.v, phys.v),
            )
            reset_count = torch.sum(m)
            ep_sums_at_reset = torch.sum(torch.where(mb, episode_sums, 0.0), dim=0)
            ep_len_at_reset = torch.sum(torch.where(m, episode_length, 0))
            state = state.replace(
                phys=phys,
                commands=torch.where(mb, reset_cmds, commands),
                actions=torch.where(mb, 0.0, actions),
                last_actions=torch.where(mb, 0.0, state.last_actions),
                last_dof_vel=torch.where(mb, 0.0, state.last_dof_vel),
                feet_air_time=torch.where(mb, 0.0, state.feet_air_time),
                last_contacts=state.last_contacts & ~mb,
                episode_length=torch.where(m, 0, episode_length).to(torch.int32),
                episode_sums=torch.where(mb, 0.0, episode_sums),
                terrain_level=terrain_level,
                env_origin=env_origin,
                cmd_vx_range=cmd_vx_range,
            )

        # ---- terrain height carry for the next step: the end-of-step point
        #      xy are the next step's start positions; envs reset since the
        #      last window refresh are outside their window and stand on
        #      their spawn platform (env_origin z) until the next refresh ----
        if self.terrain is not None:
            with span("terrain_window_contraction"):
                gh_live = self.grid.height_in_window_rows(
                    state.win, state.win_corner, aux["p_xy"])
            stale = state.win_stale | m
            state = state.replace(
                gh=torch.where(stale[None, :], env_origin[None, :, 2],
                               gh_live).contiguous(),
                win_stale=stale,
            )

        # ---- pushes (legged_robot.py:540-555): overwrite world vxy ----
        if cfg.domain_rand.push_robots:
            mx = cfg.domain_rand.max_push_vel_xy
            state = state.replace(phys=curricula.push_robots(
                self._rand(N, 2, lo=-mx, hi=mx), self.push_interval,
                state.episode_length, state.phys,
            ))

        # ---- observations (legged_robot.py:789-811) ----
        with span("env_obs"):
            obs, priv_obs = self._build_obs(self._obs_ctx(state, ctx))
            if cfg.noise.add_noise:
                obs = obs + (2.0 * self._rand(*obs.shape) - 1.0) * self.noise_scale_vec
            clip_o = cfg.normalization.clip_observations
            obs = torch.clamp(obs, -clip_o, clip_o)
            if priv_obs is not None:
                priv_obs = torch.clamp(priv_obs, -clip_o, clip_o)

        # ---- cache last_* (legged_robot.py:707-709) ----
        state = state.replace(
            last_actions=state.actions,
            last_dof_vel=state.phys.v[:, 6:],
            obs=obs,
            priv_obs=priv_obs,
        )
        extras = {
            "episode_sums_at_reset": ep_sums_at_reset,
            "episode_reset_count": reset_count,
            "episode_length_at_reset": ep_len_at_reset,
            "episode": {
                "rew_" + name: ep_sums_at_reset[i]
                / torch.clamp(reset_count, min=1) / self.max_episode_length_s
                for i, name in enumerate(self.episode_term_names)
            },
        }
        if self.terrain is not None and cfg.terrain.curriculum:
            lvl = terrain_level.to(torch.float32)
            extras["episode"]["terrain_level"] = (
                torch.sum(lvl) / self.num_envs_global if self.distributed
                else torch.mean(lvl))
            extras["terrain_level_mean"] = extras["episode"]["terrain_level"]
        if cfg.commands.curriculum:
            extras["episode"]["max_command_x"] = cmd_vx_range[1]
            extras["max_command_x"] = cmd_vx_range[1]
        if cfg.env.send_timeouts:
            extras["time_outs"] = time_out_buf
        return state, obs, priv_obs, rew, reset_buf, extras

    def _obs_ctx(self, state: EnvState, ctx):
        """The observation context: the reward context with the
        post-reset, post-push state (the reference recomputes obs from
        refreshed tensors). What ``_callback`` put in the context (the
        humanoids' phase) stays as computed before the resets, as in the
        JAX step."""
        phys = state.phys
        new = types.SimpleNamespace(**vars(ctx))
        new.base_pos = phys.base_pos
        new.base_quat = phys.base_quat
        new.base_ang_vel = phys.v[:, 0:3]
        new.base_lin_vel = phys.v[:, 3:6]
        new.projected_gravity = self._projected_gravity(phys.base_quat)
        new.dof_pos = phys.joint_q
        new.dof_vel = phys.v[:, 6:]
        new.actions = state.actions
        new.commands = state.commands
        new.episode_length = state.episode_length
        return new
