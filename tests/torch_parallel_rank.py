"""One rank of a data-parallel PPO iteration of the PyTorch port on the CPU
(gloo), run by tests/test_torch_parallel_train.py. Imports torch and
the port only.

    RANK=<r> WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> \\
    python tests/torch_parallel_rank.py <case> <reference.pt> <out_dir>

The rank builds the case's env on its block of the N_GLOBAL envs and its
runner, trains one iteration (end to end, from the seed), then gives the
update's gradient the reference's inputs (teacher forcing): the rank's
block of the one-process run's transitions and permutation, and before
each minibatch the one-process run's parameters, and records the
all-reduced gradient, loss terms, KL, gradient norm and nan-guard decision
of every minibatch; with the nan guard on, it then steps a minibatch made
not finite on rank 1 alone. It writes ``<out_dir>/rank<r>.pt``.

The policy (and its anchor) is held and computed in float64, its outputs
float32 as always (``chip_smoke.hold_in_float64``): the env, the physics, the
rollout's storage and the loss's per-sample terms stay float32, but the
update's sums over samples (the weight gradients) carry no float32
rounding, which depends on how the samples are split over ranks. In
float32 that rounding is ~5e-7 on gradient entries of ~1e-3 (the
one-process gradient is as far from the float64 one as the 2 ranks' is),
and Adam's first step moves an entry whose gradient sits within that noise
of zero by ~lr either way, so two float32 runs that sum in different
orders end ~5e-5 apart whatever the reduction."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

N_GLOBAL = 8
CASES = ("go2", "go2_terrain", "handstand")


def build_runner(case, block=None):
    """The case's env (go2 flat; go2 on the tiny heightfield with the
    terrain and command curricula; the handstand fine-tune with its DR, the
    shipped policy and its anchor) at N_GLOBAL global envs, on ``block``,
    and its runner: the policy held in float64 (``hold_in_float64``),
    the dryrun's shapes (T = 4, 2 epochs x 2 minibatches)."""
    from chip_smoke import finetune_cfgs, hold_in_float64
    from tests.test_torch_kernel_host import tiny_terrain
    from unitree_rl_gym_tpu_torch import resource
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.models.networks import load_flat_params
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    task = "go2_handstand" if case == "handstand" else "go2"
    if case == "handstand":
        cfg, tcfg = finetune_cfgs(task_registry, N_GLOBAL)
        # g_z above 0.33 is ~30% of these samples, below class_target_frac
        # 0.5, so the class re-weighting (and its global share) acts
        cfg.init_state.handstand_class_gz_threshold = 0.33
    else:
        cfg, tcfg = task_registry.get_cfgs(task)
        cfg.env.num_envs = N_GLOBAL
    if case == "go2_terrain":
        tiny_terrain(cfg)
        cfg.commands.curriculum = True
    tcfg.policy.dtype = "float32"
    tcfg.runner.num_steps_per_env = 4
    tcfg.algorithm.num_mini_batches = 2
    tcfg.algorithm.num_learning_epochs = 2
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu", block=block)
    runner = OnPolicyRunner(env, tcfg, None)
    if case == "handstand":
        load_flat_params(runner.net, resource("resources/pre_train/go2_handstand"))
        runner.set_anchor()
    for net in (runner.net, runner.alg.anchor):
        if net is not None:
            hold_in_float64(net)
    return runner


def flat_grad(net):
    return torch.cat([p.grad.reshape(-1) for p in net.parameters()])


def minibatch_record(alg, loss, stats):
    """What one minibatch gives the optimizer: the gradient, the loss and
    its terms, the KL, the gradient norm and the nan-guard decision."""
    norm = alg._grad_norm()
    ok = bool(torch.isfinite(loss) & torch.isfinite(norm)
              & torch.isfinite(stats[2]))
    return {"grad": flat_grad(alg.net).clone(), "loss": float(loss.detach()),
            "stats": [float(s) for s in stats], "norm": float(norm), "ok": ok}


def main(case, ref_path, out_dir):
    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
    from unitree_rl_gym_tpu_torch.parallel.dryrun import replica_state

    pmesh.init_process_group("cpu")
    block = pmesh.env_block(N_GLOBAL)
    runner = build_runner(case, block)
    rows = runner.learn(1, init_at_random_ep_len=True)
    out = {"state": replica_state(runner), "lr": runner.alg.lr,
           "params": [p.detach().clone() for p in runner.net.parameters()],
           "rows": rows}

    ref = torch.load(ref_path, weights_only=False)
    full = ref["transitions"]
    local = type(full)(*(None if x is None else block.rows(x, 1) for x in full))
    alg = runner.alg
    mbs, mb = alg.minibatches(local, ref["perm"])
    records = []
    for i, params in enumerate(ref["params"]):
        with torch.no_grad():
            for p, q in zip(alg.net.parameters(), params):
                p.copy_(q)
        loss, stats = alg.minibatch_grads(mbs[i % len(mbs)], mb)
        records.append(minibatch_record(alg, loss, stats))
    out["minibatches"] = records
    out["local_sizes"] = [int(b.obs.shape[0]) for b in mbs]
    if alg.cfg.nan_guard:
        # a minibatch that is not finite on rank 1 alone: every rank must
        # skip it, and meet the other in the next collective
        b = mbs[0]
        if block.rank == 1:
            b = b._replace(advantages=torch.full_like(b.advantages, torch.nan))
        _, out["nan_step_skipped"] = alg.minibatch_step(b, mb)
        out["after_nan_state"] = replica_state(runner)
        pmesh.all_reduce_sum(torch.ones(1))
    torch.save(out, os.path.join(out_dir, f"rank{block.rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:4])
