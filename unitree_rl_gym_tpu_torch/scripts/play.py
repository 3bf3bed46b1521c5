"""Evaluate a policy in the port: actor inference followed by
``LeggedEnv.step``, on the GPU unless ``--device=cpu``.

    python -m unitree_rl_gym_tpu_torch.scripts.play --task=go2 --num_envs=4096

Counterpart of ``unitree_rl_gym_tpu/scripts/play.py``: a small eval env
(noise, friction DR and pushes off; ``--num_envs`` overrides the cap of
100), the flat-weight policy of ``--load_flat`` (default
``resources/pre_train/<task>``; an MLP, or the humanoids' LSTM), an
inference loop and aggregate stats.
The runner, its checkpoints and export come with the training slice, so
this script exports nothing yet. The loop keeps its statistics on the
device and reads them once at the end, so it never waits on the card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR, resolve_device
from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
from unitree_rl_gym_tpu_torch.utils import helpers
from unitree_rl_gym_tpu_torch.utils.logger import Logger

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


@torch.no_grad()
def rollout(env, policy, state, obs, num_steps: int, settle: int):
    """``num_steps`` control steps of policy inference + ``env.step`` from
    (state, obs). An LSTM policy starts from a zero carry and carries it
    through every step with no per-env reset, as the JAX package's play
    does. Tracking errors and non-timeout terminations count after step
    ``settle``. Returns (state, obs, stats) with host numbers in
    ``stats``; the loop itself never waits on the device."""
    dev = env.device
    n_terms = len(env.episode_term_names)
    ep_sums = torch.zeros(n_terms, device=dev)
    n_resets = torch.zeros((), dtype=torch.int64, device=dev)
    errs = torch.zeros(4, device=dev)       # |vx|, |vy|, |yaw rate| errors, height
    falls = torch.zeros((), dtype=torch.int64, device=dev)
    carry = policy.initial_carry(env.num_envs) if policy.is_recurrent else None
    for i in range(num_steps):
        if carry is None:
            actions = policy.act(obs)
        else:
            actions, carry = policy.act(obs, carry)
        state, obs, _, rew, done, extras = env.step(state, actions)
        ep_sums += extras["episode_sums_at_reset"]
        n_resets += extras["episode_reset_count"]
        if i >= settle:
            v, cmd = state.phys.v, state.commands
            errs += torch.stack((
                (v[:, 3] - cmd[:, 0]).abs().mean(),
                (v[:, 4] - cmd[:, 1]).abs().mean(),
                (v[:, 2] - cmd[:, 2]).abs().mean(),
                state.phys.base_pos[:, 2].mean(),
            ))
            falls += (done & ~extras["time_outs"]).sum()
    n_logged = max(num_steps - settle, 1)
    errs = (errs / n_logged).tolist()
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
    device = resolve_device(args.device)
    env = make_play_env(args, device)
    policy = load_flat_policy(policy_dir(args), device)
    state, obs = env.reset_all()
    _, obs, stats = rollout(env, policy, state, obs, num_steps,
                            settle=num_steps // 5)

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
    return stats


if __name__ == "__main__":
    play(helpers.get_args())
