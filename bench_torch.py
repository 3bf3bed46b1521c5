"""Benchmark of the PyTorch/CUDA port: end-to-end PPO training throughput
across bench.py's configs, with the port alone (no JAX):

    python bench_torch.py                    # on the GPU
    BENCH_NUM_ENVS=8 BENCH_ITERS=1 BENCH_CONFIGS=go2,g1 \\
        python bench_torch.py --device=cpu   # a CPU check

Per config: the cfgs from the port's ``task_registry`` (a ``_terrain``
config sets ``terrain.mesh_type = "heightfield"`` and
``terrain.curriculum = True``, as bench.py does), ``build_network`` and
``PPO`` from the seed-0 init, ``reset_all``, one warm-up
``PPO.train_iteration`` (24-step rollout, GAE, 5 x 4 minibatch updates),
then ``BENCH_ITERS`` timed iterations with the device synchronised; the
rate is env-steps per second of wall time.

The configs (bench.py's): go2 (the flagship: 4096 envs, MLP [512, 256,
128]), g1, h1 and h1_2 (the LSTM-64 actor-critic and recurrent PPO; h1_2 at
decimation 8), go2_terrain, h1_2_terrain and g1_terrain.

Prints ONE JSON line in bench.py's shape: ``metric`` (the flagship's
``go2_train_env_steps_per_s``), ``value``, ``unit``, ``vs_baseline``
(against bench.py's 100k env-steps/s reference) and ``extra`` with the
other configs' rates. A config that fails, or is skipped once the budget
is spent, is reported on stderr and makes the exit code nonzero.

Env knobs: BENCH_NUM_ENVS (4096), BENCH_ITERS (20), BENCH_CONFIGS (comma
list), BENCH_BUDGET_S (soft wall-clock budget, 2400). ``--device=cpu`` runs
on the CPU; without it the bench runs on the card and raises where there
is none.
"""

import argparse
import json
import os
import sys
import time

BASELINE = 100_000.0  # bench.py's reference, env-steps/s
CONFIGS = "go2,g1,h1,h1_2,go2_terrain,h1_2_terrain,g1_terrain"


def build(task, num_envs, device):
    """(alg, env, initial state, obs, critic obs, carry, env-steps per
    iteration) of one config."""
    import torch

    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.models import networks as nets
    from unitree_rl_gym_tpu_torch.rl.ppo import PPO

    name = task.removesuffix("_terrain")
    cfg, tcfg = task_registry.get_cfgs(name)
    cfg.env.num_envs = num_envs
    if task.endswith("_terrain"):
        cfg.terrain.mesh_type = "heightfield"
        cfg.terrain.curriculum = True
    env = task_registry.get_task_class(name)(cfg, device=device)
    pc = tcfg.policy
    pc._class_name = tcfg.runner.policy_class_name
    net = nets.build_network(pc, env.num_obs, env.num_actions,
                             num_critic_obs=env.num_privileged_obs,
                             generator=torch.Generator().manual_seed(0)).to(env.device)
    alg = PPO(net, tcfg.algorithm, num_steps=tcfg.runner.num_steps_per_env,
              num_envs=num_envs, device=env.device,
              share_critic_obs=env.num_privileged_obs is None, seed=0)
    state, obs = env.reset_all()
    cobs = state.priv_obs if state.priv_obs is not None else obs
    carry = net.initial_carry(num_envs) if net.is_recurrent else None
    return alg, env, (state, obs, cobs, carry), num_envs * tcfg.runner.num_steps_per_env


def measure(task, num_envs, iters, device):
    """Training env-steps/s of ``task`` over ``iters`` iterations after one
    warm-up iteration."""
    import torch

    alg, env, carry, steps_per_iter = build(task, num_envs, device)
    sync = (torch.cuda.synchronize if env.device.type == "cuda"
            else (lambda: None))
    *carry, _ = alg.train_iteration(env, *carry)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        *carry, _ = alg.train_iteration(env, *carry)
    sync()
    return iters * steps_per_iter / (time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from unitree_rl_gym_tpu_torch import resolve_device

    device = resolve_device(args.device)
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 4096))
    iters = int(os.environ.get("BENCH_ITERS", 20))
    configs = os.environ.get("BENCH_CONFIGS", CONFIGS).split(",")
    budget = float(os.environ.get("BENCH_BUDGET_S", 2400))

    t_start = time.time()
    results, missing = {}, []
    for task in configs:
        if results and time.time() - t_start > budget:
            print(f"[bench] budget of {budget:.0f} s spent, {task} not measured",
                  file=sys.stderr)
            missing.append(task)
            continue
        try:
            results[task] = measure(task, num_envs, iters, device)
            print(f"[bench] {task}: {results[task]:.1f} env-steps/s",
                  file=sys.stderr)
        except Exception as e:
            print(f"[bench] {task} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            missing.append(task)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if results:
        main_task = "go2" if "go2" in results else next(iter(results))
        v = results[main_task]
        print(json.dumps({
            "metric": f"{main_task}_train_env_steps_per_s",
            "value": v,
            "unit": "env_steps/s",
            "vs_baseline": v / BASELINE,
            "extra": {f"{t}_train_env_steps_per_s": r
                      for t, r in results.items() if t != main_task},
        }), flush=True)
    if missing:
        print(f"[bench] {len(missing)} of {len(configs)} configs not measured: "
              f"{','.join(missing)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
