"""Evaluate a policy in the port and export it: actor inference followed
by ``LeggedEnv.step``, on the GPU unless ``--device=cpu``.

    python -m unitree_rl_gym_tpu_torch.scripts.play --task=go2 --num_envs=4096
    python -m unitree_rl_gym_tpu_torch.scripts.play --task=g1 --resume

Counterpart of ``unitree_rl_gym_tpu/scripts/play.py``: a small eval env
(noise, friction DR and pushes off; ``--num_envs`` overrides the cap of
100), an inference loop and aggregate stats. With ``--resume``,
``--load_run`` or ``--checkpoint`` it builds the runner
(``task_registry.make_alg_runner``), loads the newest (or the named)
checkpoint under ``logs/<experiment_name>/`` (the port's ``.pt`` or the JAX
package's ``.ckpt``), plays its float32 inference copy and exports it to
``logs/<experiment_name>/exported/policies`` (``EXPORT_POLICY``;
``export/export.py``). Otherwise it plays the flat-weight policy of
``--load_flat`` (default ``resources/pre_train/<task>``; an MLP, or the
humanoids' LSTM) and exports nothing. ``--view`` replays env 0 in MuJoCo
(``utils/viz.py``). The loop keeps its statistics on the device and reads
them once at the end, so it never waits on the card (``--view`` reads the
state back every step).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR, resolve_device
from unitree_rl_gym_tpu_torch.export.export import export_policy
from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
from unitree_rl_gym_tpu_torch.utils import helpers
from unitree_rl_gym_tpu_torch.utils.logger import Logger

EXPORT_POLICY = True
NUM_STEPS = 500


def make_play_env(args, device):
    """The eval env of play.py:27-33 (noise/DR/pushes off)."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    env_cfg, _ = task_registry.get_cfgs(name=args.task)
    env_cfg.env.num_envs = min(env_cfg.env.num_envs, 100)
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.domain_rand.randomize_contact_stiffness = False
    env_cfg.env.test = True
    env, _ = task_registry.make_env(
        name=args.task, args=args, env_cfg=env_cfg, device=device
    )
    return env


def policy_dir(args) -> str:
    return args.load_flat or os.path.join(
        UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train", args.task
    )


def resumes(args) -> bool:
    """Play a checkpoint (and export it) rather than a flat-weight policy."""
    return bool(args.resume) or args.load_run is not None or args.checkpoint is not None


def resume_runner(args, env):
    """The runner of ``args.task`` on ``env`` with its newest (or the named)
    checkpoint loaded (play.py:36-39)."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    _, train_cfg = task_registry.get_cfgs(name=args.task)
    train_cfg.runner.resume = True
    runner, _ = task_registry.make_alg_runner(
        env=env, name=args.task, args=args, train_cfg=train_cfg)
    return runner


@torch.no_grad()
def rollout(env, policy, state, obs, num_steps: int, settle: int, viewer=None):
    """``num_steps`` control steps of policy inference + ``env.step`` from
    (state, obs). ``policy`` has ``is_recurrent`` and ``act``: ``act(obs)``
    -> actions, or for an LSTM ``act(obs, carry)`` -> (actions, carry) and
    ``initial_carry(n)``; the carry starts at zero and runs through every
    step with no per-env reset, as the JAX package's play does. Tracking
    errors and non-timeout terminations count at the steps ``i > settle``
    (the JAX play's settle-in window, ``i > NUM_STEPS // 5``), and the
    mean errors are over the steps logged, also when a viewer ends the
    loop early.
    ``viewer`` (``utils.viz.RolloutViewer``) shows each step and ends the
    loop when its window closes. Returns (state, obs, stats) with host
    numbers in ``stats``; without a viewer the loop never waits on the
    device."""
    dev = env.device
    n_terms = len(env.episode_term_names)
    ep_sums = torch.zeros(n_terms, device=dev)
    n_resets = torch.zeros((), dtype=torch.int64, device=dev)
    errs = torch.zeros(4, device=dev)       # |vx|, |vy|, |yaw rate| errors, height
    falls = torch.zeros((), dtype=torch.int64, device=dev)
    carry = policy.initial_carry(env.num_envs) if policy.is_recurrent else None
    n_logged = 0
    for i in range(num_steps):
        if carry is None:
            actions = policy.act(obs)
        else:
            actions, carry = policy.act(obs, carry)
        state, obs, _, rew, done, extras = env.step(state, actions)
        if viewer is not None and not viewer.update(state):
            break
        ep_sums += extras["episode_sums_at_reset"]
        n_resets += extras["episode_reset_count"]
        if i > settle:
            n_logged += 1
            v, cmd = state.phys.v, state.commands
            errs += torch.stack((
                (v[:, 3] - cmd[:, 0]).abs().mean(),
                (v[:, 4] - cmd[:, 1]).abs().mean(),
                (v[:, 2] - cmd[:, 2]).abs().mean(),
                state.phys.base_pos[:, 2].mean(),
            ))
            falls += (done & ~extras["time_outs"]).sum()
    errs = (errs / max(n_logged, 1)).tolist()
    stats = {
        "abs_vx_tracking_err": errs[0],
        "abs_vy_tracking_err": errs[1],
        "abs_yaw_rate_err": errs[2],
        "base_height": errs[3],
        "falls": int(falls),
        "episodes": int(n_resets),
        "episode_sums": dict(zip(env.episode_term_names, ep_sums.tolist())),
    }
    return state, obs, stats


def play(args, num_steps: int = NUM_STEPS):
    """Play (and, resuming a checkpoint, export) as the module docstring
    says. Returns a dict: ``stats`` of :func:`rollout`, the ``env``, the
    ``policy`` played, the final ``obs``, the ``export_dir`` (None where
    nothing was exported) and the rollout's wall seconds ``rollout_s``."""
    device = resolve_device(args.device)
    env = make_play_env(args, device)
    out_dir = None
    if resumes(args):
        runner = resume_runner(args, env)
        policy = runner.net.inference_copy()
        if EXPORT_POLICY:
            out_dir = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "logs",
                                   runner.cfg.runner.experiment_name, "exported", "policies")
            export_policy(runner, out_dir)
            print("Exported policy to:", out_dir)
    else:
        policy = load_flat_policy(policy_dir(args), device)
    viewer = None
    if args.view:
        from unitree_rl_gym_tpu_torch.utils.viz import RolloutViewer

        viewer = RolloutViewer(args.task, env, realtime=env.cfg.env.test)
    state, obs = env.reset_all()
    t0 = time.perf_counter()
    try:
        _, obs, stats = rollout(env, policy, state, obs, num_steps,
                                settle=num_steps // 5, viewer=viewer)
    finally:
        if viewer is not None:
            viewer.close()
    rollout_s = time.perf_counter() - t0   # rollout read its stats: synced

    logger = Logger(env.dt)
    if stats["episodes"]:
        logger.log_rewards(
            {f"rew_{n}": np.asarray(s / stats["episodes"])
             for n, s in stats["episode_sums"].items()},
            stats["episodes"],
        )
    logger.log_states({k: stats[k] for k in (
        "abs_vx_tracking_err", "abs_vy_tracking_err", "abs_yaw_rate_err",
        "base_height")})
    logger.print_rewards()
    logger.print_states()
    print(f"Non-timeout terminations: {stats['falls']}")
    return {"stats": stats, "env": env, "policy": policy, "obs": obs,
            "export_dir": out_dir, "rollout_s": rollout_s}


if __name__ == "__main__":
    play(helpers.get_args())
