"""Decompose a training iteration of the port at the flagship point into
its parts (counterpart of ``unitree_rl_gym_tpu/scripts/profile_residue.py``).
Measures five programs, each on the same inputs every call:

  A  full train iteration            (``PPO.train_iteration``, bench_torch's)
  B  rollout only                    (``PPO.rollout``: 24 steps, policy + env)
  C  env, zero actions               (24 x ``env.step``, no policy)
  D  env, zero actions, noise off    (C minus the obs-noise draws)
  E  kernel only                     (24 x ``backend.control_step``: K1 on
                                      flat ground, 24 launches a call)

policy cost   = B - C
obs-noise RNG = C - D
env residue   = D - E   (obs build, rewards, resets, commands)
update+GAE    = A - B

Prints one JSON object with the JAX script's keys. Each program runs once,
then ``--iters`` times between two ``torch.cuda.synchronize()`` calls:

    python -m unitree_rl_gym_tpu_torch.scripts.profile_residue [--task go2] \\
        [--num_envs 4096] [--iters 20] [--device cpu]
"""

import argparse
import json
import time

import torch

from unitree_rl_gym_tpu_torch import resolve_device
from unitree_rl_gym_tpu_torch.scripts import profile_train as ptrain


def timeit(fn, iters, device):
    """ms per call of ``fn()`` after one warm-up call, the device
    synchronised before and after the timed calls."""
    fn()
    ptrain.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ptrain.sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def env_for(task, num_envs, device, add_noise=True):
    """bench_torch's env of ``task`` (``_terrain``: heightfield and the
    terrain curriculum), with the obs noise on or off."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    name = task.removesuffix("_terrain")
    cfg, _ = task_registry.get_cfgs(name)
    cfg.env.num_envs = num_envs
    if task.endswith("_terrain"):
        cfg.terrain.mesh_type = "heightfield"
        cfg.terrain.curriculum = True
    cfg.noise.add_noise = add_noise
    return task_registry.get_task_class(name)(cfg, device=device)


def programs(task, num_envs, device):
    """The five programs as argument-free callables, {"A": ..., "E": ...},
    and the env-steps of one iteration."""
    from unitree_rl_gym_tpu_torch.physics import backend as pback

    alg, env, carry, spi = ptrain.build(task, num_envs, device)
    T = alg.num_steps
    zeros = torch.zeros((num_envs, env.num_actions), device=env.device)
    env_nn = env_for(task, num_envs, device, add_noise=False)
    start_nn = env_nn.reset_all()

    def full():
        return alg.train_iteration(env, *carry)

    def rollout():
        return alg.rollout(env, *carry)

    def env_only(e, state):
        for _ in range(T):
            state, *_ = e.step(state, zeros, refresh_terrain=False)
        return state

    state0 = carry[0]
    cfg = env.cfg
    # the JAX script's operands: the default pose as the target, unit
    # friction and mass scale, flat ground (K1 whatever the task)
    tgt = env.default_dof_pos.expand(num_envs, -1).contiguous()
    ones = torch.ones((num_envs,), device=env.device)

    def kernel_only():
        phys = state0.phys
        for _ in range(T):
            phys, _ = pback.control_step(
                env.robot.dyn, env.cparams, env.pd, cfg.sim.dt,
                cfg.control.decimation, phys, tgt, ones, ones,
                env.m_eff_n, env.m_eff_t)
        return phys

    return {
        "A": full,
        "B": rollout,
        "C": lambda: env_only(env, state0),
        "D": lambda: env_only(env_nn, start_nn[0]),
        "E": kernel_only,
    }, spi


def residue(ms, task, num_envs, spi):
    """The JAX script's JSON object from the five programs' ms."""
    return {
        "task": task,
        "num_envs": num_envs,
        "A_full_iter_ms": round(ms["A"], 2),
        "B_rollout_ms": round(ms["B"], 2),
        "C_env_scan_ms": round(ms["C"], 2),
        "D_env_scan_no_noise_ms": round(ms["D"], 2),
        "E_kernel_scan_ms": round(ms["E"], 2),
        "policy_ms": round(ms["B"] - ms["C"], 2),
        "obs_noise_rng_ms": round(ms["C"] - ms["D"], 2),
        "env_residue_ms": round(ms["D"] - ms["E"], 2),
        "update_gae_ms": round(ms["A"] - ms["B"], 2),
        "env_steps_per_s": round(spi / ms["A"] * 1e3, 0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="go2")
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    progs, spi = programs(args.task, args.num_envs, device)
    ms = {k: timeit(fn, args.iters, device) for k, fn in progs.items()}
    print(json.dumps(residue(ms, args.task, args.num_envs, spi)))


if __name__ == "__main__":
    main()
