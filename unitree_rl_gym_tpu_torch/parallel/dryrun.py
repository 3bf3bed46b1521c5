"""Multi-rank dryrun of the two operating classes, and the replica check that
chip_smoke.py and the tests share with it (:func:`replica_state`).

The dryrun is the counterpart of ``__graft_entry__.py::dryrun_multichip``:
for each class, one full PPO training iteration (a 4-step rollout, GAE, 2
epochs x 2 minibatches) with the env batch split over ``world_size``
ranks, at tiny shapes (4 envs per rank):

  * ``go2-flat-mlp``: go2 flat with the MLP policy (the flagship);
  * ``g1-terrain-lstm``: g1 on the heightfield (a 2 x 2 grid of 4 m
    sub-terrains) with the terrain curriculum and the LSTM policy, which
    runs the recurrent update's replay over each rank's env columns and the
    terrain height carry under the same sharded iteration.

Each rank checks that its parameters, Adam state and learning rate end
identical to rank 0's, and rank 0 prints the line the JAX dryrun prints
for the class::

    python -m unitree_rl_gym_tpu_torch.parallel.dryrun --world_size 2

It runs on the card(s) by default, NCCL with a card per rank
(``--dist_backend=gloo`` when ranks share one, as ``init_process_group``
rules); without CUDA it raises. ``--device=cpu`` runs every rank on the
CPU over gloo."""

from __future__ import annotations

import argparse

import torch

# the JAX dryrun's classes, in its order
CLASSES = ("go2-flat-mlp", "g1-terrain-lstm")


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


def class_cfgs(label: str, n_global: int):
    """(task, env cfg, train cfg) of a dryrun class at ``n_global`` envs,
    with the dryrun's PPO shapes (``__graft_entry__.py``: T = 4, 2 epochs x
    2 minibatches)."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    task = {"go2-flat-mlp": "go2", "g1-terrain-lstm": "g1"}[label]
    cfg, tcfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = n_global
    if task == "g1":
        cfg.terrain.mesh_type = "heightfield"
        cfg.terrain.curriculum = True
        # a tiny grid, so that the terrain builds fast; semantics unchanged
        cfg.terrain.num_rows = 2
        cfg.terrain.num_cols = 2
        cfg.terrain.terrain_length = 4.0
        cfg.terrain.terrain_width = 4.0
    tcfg.runner.num_steps_per_env = 4
    tcfg.algorithm.num_mini_batches = 2
    tcfg.algorithm.num_learning_epochs = 2
    return task, cfg, tcfg


def dryrun_class(label: str, dev, envs_per_rank: int = 4) -> dict:
    """One class of the dryrun on this rank, in a process group already
    joined: one iteration on the rank's block of ``envs_per_rank`` x world
    envs, the replicas checked against rank 0's (raises where they differ),
    rank 0's line printed. Returns the iteration's metric row."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    world = torch.distributed.get_world_size()
    n_global = envs_per_rank * world
    task, cfg, tcfg = class_cfgs(label, n_global)
    block = pmesh.env_block(n_global)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev, block=block)
    runner = OnPolicyRunner(env, tcfg, None)
    row = runner.learn(1)[0]
    mine = replica_state(runner)
    ref = mine.clone()
    pmesh.broadcast_([ref])
    if not torch.equal(mine, ref):
        raise RuntimeError(f"{label}: rank {block.rank}'s replica differs from "
                           f"rank 0's in {int((mine != ref).sum())} values")
    if block.rank == 0:
        print(
            f"[dryrun_multichip] {label}: n_devices={world} "
            f"num_envs={n_global} OK  "
            f"value_loss={row['value_loss']:.4f} kl={row['kl']:.5f}",
            flush=True,
        )
    return row


def dryrun_rank(device=None, backend=None, envs_per_rank: int = 4):
    """One rank of the dryrun (started by :func:`main` through
    ``mesh.spawn_ranks``, or by torchrun): every class in turn; ``device``
    None is the card, and raises without one."""
    from unitree_rl_gym_tpu_torch import resolve_device
    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh

    dev = pmesh.init_process_group(resolve_device(device).type, backend=backend)
    for label in CLASSES:
        dryrun_class(label, dev, envs_per_rank)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world_size", type=int, default=2)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    from unitree_rl_gym_tpu_torch import resolve_device
    from unitree_rl_gym_tpu_torch.parallel.mesh import spawn_ranks

    device = resolve_device(args.device).type
    spawn_ranks(dryrun_rank, args.world_size, (device, args.dist_backend))


if __name__ == "__main__":
    main()
