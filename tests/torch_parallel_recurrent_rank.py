"""What tests/test_torch_parallel_recurrent.py runs in each process: one
recurrent PPO iteration of g1 (the LSTM actor-critic) at N_GLOBAL envs on
the CPU, in one process or as one rank of ``parallel.mesh.spawn_ranks``'s
gloo job, and the rank's part of the dryrun's g1-terrain-LSTM class.
Imports torch and the port only.

The env is g1's flat task with pushes off and the dryrun's PPO shapes (T =
4, 2 epochs x 2 minibatches), so each minibatch holds 4 of the 8 envs'
columns; the policy is held in float64 (``chip_smoke.hold_in_float64``),
so that the update's sums over samples carry no float32 rounding that
depends on how the envs are split over ranks."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

N_GLOBAL = 8
# "perm": the update's env permutation drawn from the PPO generator, as in
# training; "blocks": the identity, so that each minibatch's envs all lie
# on one rank and the other rank holds none of them
CASES = ("perm", "blocks")
# what the rollout stores, compared bit for bit with the one process's rows
ROLLOUT_FIELDS = ("obs", "critic_obs", "actions", "log_probs", "values", "mu",
                  "std", "dones", "returns")


def build_runner(block=None):
    """g1 at N_GLOBAL global envs on ``block`` (None: one process), pushes
    off, its runner from the train cfg's seed with the policy in float64."""
    from chip_smoke import hold_in_float64
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    cfg, tcfg = task_registry.get_cfgs("g1")
    cfg.env.num_envs = N_GLOBAL
    cfg.domain_rand.push_robots = False
    tcfg.policy.dtype = "float32"
    tcfg.runner.num_steps_per_env = 4
    tcfg.algorithm.num_mini_batches = 2
    tcfg.algorithm.num_learning_epochs = 2
    env, _ = task_registry.make_env("g1", env_cfg=cfg, device="cpu", block=block)
    runner = OnPolicyRunner(env, tcfg, None)
    hold_in_float64(runner.net)
    return runner


def run_case(case, block=None):
    """One iteration from the seed: the replica state, the learning rate,
    what the update took (the rollout's fields with advantages and
    returns, the carry at the rollout's start) and how many env columns of
    each minibatch this process held."""
    from unitree_rl_gym_tpu_torch.parallel.dryrun import replica_state

    runner = build_runner(block)
    alg = runner.alg
    seen = {}
    minibatches, update = alg.minibatches, alg.update

    def record(transitions, perm):
        seen["transitions"] = transitions
        seen["perm"] = perm.clone()
        mbs, mb = minibatches(transitions, perm)
        seen["columns"] = [int(b.obs.shape[1]) for b in mbs]
        return mbs, mb

    def update_blocks(transitions, advantages, returns, perm=None):
        return update(transitions, advantages, returns,
                      perm=torch.arange(N_GLOBAL))

    alg.minibatches = record
    if case == "blocks":
        alg.update = update_blocks
    row = runner.learn(1, init_at_random_ep_len=True)[0]
    tr = seen["transitions"]
    return {"runner": runner, "state": replica_state(runner), "lr": alg.lr, "row": row,
            "rollout": {k: getattr(tr, k).clone() for k in ROLLOUT_FIELDS},
            "advantages": tr.advantages.clone(), "carry0": tr.carry0.clone(),
            "perm": seen["perm"], "columns": seen["columns"],
            "update_inputs": (tr, seen["perm"])}


def teacher_forced(update_inputs, block=None):
    """The update alone, from the seed's parameters, on the one process's
    inputs (``update_inputs``: its transitions with advantages and returns,
    and its permutation; a rank takes its env columns): the replica state
    after it."""
    from unitree_rl_gym_tpu_torch.parallel.dryrun import replica_state

    full, perm = update_inputs
    if block is not None:
        # [T, N, ...] fields on axis 1, the start carry [2, L, 2, N, H] on 3
        full = type(full)(*(None if x is None else block.rows(x, 1)
                            for x in full[:-1]), block.rows(full.carry0, 3))
    runner = build_runner(block)
    runner.alg.update(full, full.advantages, full.returns, perm=perm)
    return replica_state(runner)


def rank_main(out_dir):
    """One rank: every case, the update of each case teacher-forced with
    the one process's inputs (``<out_dir>/reference.pt``), then the
    dryrun's g1-terrain-LSTM class; writes ``<out_dir>/rank<r>.pt``."""
    from unitree_rl_gym_tpu_torch.parallel import dryrun
    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh

    from unitree_rl_gym_tpu_torch.parallel.dryrun import replica_state

    dev = pmesh.init_process_group("cpu")
    block = pmesh.env_block(N_GLOBAL)
    out = {"block": (block.offset, block.n_local)}
    for case in CASES:
        out[case] = run_case(case, block)
        del out[case]["update_inputs"]
    # rank 0 alone saves; every rank loads the checkpoint back
    runner = out["perm"].pop("runner")
    out["blocks"].pop("runner")
    path = os.path.join(out_dir, "model_1.pt")
    if block.rank == 0:
        runner.save(path)
    torch.distributed.barrier()
    fresh = build_runner(block)
    fresh.load(path)
    out["checkpoint_loads_back"] = torch.equal(replica_state(fresh),
                                               replica_state(runner))
    ref = torch.load(os.path.join(out_dir, "reference.pt"), weights_only=False)
    out["teacher_forced"] = {case: teacher_forced(ref[case], block)
                             for case in CASES}
    out["dryrun"] = dryrun.dryrun_class("g1-terrain-lstm", dev)
    torch.save(out, os.path.join(out_dir, f"rank{block.rank}.pt"))
