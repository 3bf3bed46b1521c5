"""Multi-rank dryrun of the flagship, and the replica check that
chip_smoke.py and the tests share with it (:func:`replica_state`).

The dryrun is the counterpart of the go2-flat-mlp class of
``__graft_entry__.py::dryrun_multichip``: one full PPO training iteration
(a 4-step rollout, GAE, 2 epochs x 2 minibatches) of go2 flat with the MLP
policy, its env batch split over ``world_size`` ranks, at tiny shapes (4
envs per rank). Each rank checks that its parameters, Adam state and
learning rate end identical to rank 0's, and rank 0 prints the line the
JAX dryrun prints::

    python -m unitree_rl_gym_tpu_torch.parallel.dryrun --world_size 2

It runs on the CPU over gloo by default; ``--device=cuda`` puts every rank
on the card(s) (``--dist_backend=gloo`` when they share one). The JAX
dryrun's second class, g1 on terrain with the LSTM policy, waits for the
humanoids and the recurrent policy."""

from __future__ import annotations

import argparse

import torch


def replica_state(runner):
    """One flat float64 vector of a runner's parameters, Adam moments and
    step counts, and learning rate (the state every replica must share)."""
    parts = [p.detach().reshape(-1).double() for p in runner.net.parameters()]
    for st in runner.alg.optimizer.state.values():
        parts += [st[k].detach().reshape(-1).double()
                  for k in ("exp_avg", "exp_avg_sq", "step")]
    parts.append(torch.tensor([runner.alg.lr], dtype=torch.float64,
                              device=parts[0].device))
    return torch.cat([p.to(parts[0].device) for p in parts])


def dryrun_rank(device: str = "cpu", backend=None, envs_per_rank: int = 4):
    """One rank of the dryrun (started by :func:`main` through
    ``mesh.spawn_ranks``, or by torchrun)."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    dev = pmesh.init_process_group(device, backend=backend)
    world = torch.distributed.get_world_size()
    n_global = envs_per_rank * world
    cfg, tcfg = task_registry.get_cfgs("go2")
    cfg.env.num_envs = n_global
    tcfg.runner.num_steps_per_env = 4
    tcfg.algorithm.num_mini_batches = 2
    tcfg.algorithm.num_learning_epochs = 2
    block = pmesh.env_block(n_global)
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device=dev, block=block)
    runner = OnPolicyRunner(env, tcfg, None)
    row = runner.learn(1)[0]
    mine = replica_state(runner)
    ref = mine.clone()
    pmesh.broadcast_([ref])
    if not torch.equal(mine, ref):
        raise RuntimeError(f"rank {block.rank}'s replica differs from rank 0's "
                           f"in {int((mine != ref).sum())} values")
    if block.rank == 0:
        print(
            f"[dryrun_multichip] go2-flat-mlp: n_devices={world} "
            f"num_envs={n_global} OK  "
            f"value_loss={row['value_loss']:.4f} kl={row['kl']:.5f}",
            flush=True,
        )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world_size", type=int, default=2)
    p.add_argument("--device", type=str, default="cpu")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    from unitree_rl_gym_tpu_torch.parallel.mesh import spawn_ranks

    spawn_ranks(dryrun_rank, args.world_size,
                (args.device, args.dist_backend))


if __name__ == "__main__":
    main()
