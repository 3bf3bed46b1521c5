"""Env data parallelism of the port, port against port: one PPO iteration of
N=8 global envs over 2 gloo ranks on the CPU (tests/torch_parallel_rank.py,
two subprocesses on a free localhost port) against one process on the same
8 envs, T = 4, 2 epochs x 2 minibatches (the dryrun's shapes,
``__graft_entry__.py:57-59``), for go2 flat, go2 on the tiny heightfield
with the terrain and command curricula (the row-layout carry, the global
terrain ids, the reduced curriculum), and the handstand fine-tune (DR, the
shipped policy, class weights and the anchor KL with their global
denominators, the nan guard).

The policy is held in float64 with float32 outputs
(``chip_smoke.hold_in_float64``; the env, the physics and the rollout stay
float32), so that what is compared is the algorithm and not float32
summation order: in float32 the one-process and 2-rank gradients differ by
up to ~5e-7 on entries of ~1e-3, each as far from the float64 gradient as
the other, and Adam's first step turns such an entry's sign noise into ~lr.

  * teacher-forced: given the one-process run's transitions, permutation
    and, before each minibatch, its parameters, the 2 ranks' all-reduced
    gradient (divided by max(|g|, 1)), loss terms, KL and gradient norm
    match the one-process ones within rtol 1e-5 / atol 1e-7, and the
    nan-guard decision is the same (this tells summation-order noise from
    a wrong reduction);
  * end to end, after one iteration from the seed: the 2 ranks'
    parameters, Adam moments and step counts, and learning rate are bit
    for bit the same; the learning rate equals the one-process run's; the
    parameters are within 1e-5 of it (ROADMAP module 11);
  * with the nan guard on, a minibatch that is not finite on one rank
    only is skipped by both ranks, which then meet in the next collective
    (a rank that took the other branch would deadlock it).

No JAX program is compiled."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_parallel_rank import CASES, build_runner, minibatch_record
from unitree_rl_gym_tpu_torch.parallel.dryrun import replica_state
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

RANK_SCRIPT = os.path.join(os.path.dirname(__file__), "torch_parallel_rank.py")
WORLD = 2
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reference(case, path):
    """The one-process iteration; saves what the ranks' teacher-forced
    gradients take (transitions, permutation, parameters before each
    minibatch) and returns its records."""
    runner = build_runner(case)
    alg = runner.alg
    seen = {"params": [], "records": []}
    minibatches, minibatch_grads = alg.minibatches, alg.minibatch_grads

    def record_minibatches(transitions, perm):
        seen["transitions"], seen["perm"] = transitions, perm.clone()
        return minibatches(transitions, perm)

    def record_grads(b, count=None):
        seen["params"].append([p.detach().clone() for p in alg.net.parameters()])
        loss, stats = minibatch_grads(b, count)
        seen["records"].append(minibatch_record(alg, loss, stats))
        return loss, stats

    alg.minibatches, alg.minibatch_grads = record_minibatches, record_grads
    runner.learn(1, init_at_random_ep_len=True)
    torch.save({k: seen[k] for k in ("transitions", "perm", "params")}, path)
    return {"state": replica_state(runner), "lr": alg.lr,
            "params": [p.detach().clone() for p in runner.net.parameters()],
            "minibatches": seen["records"]}


# each case's runs, by case: the nan test's indirect parametrization sets
# the fixture up again, and it must not spawn the ranks a second time
_RUNS = {}


@pytest.fixture(scope="module", params=CASES)
def runs(request, tmp_path_factory):
    case = request.param
    if case not in _RUNS:
        _RUNS[case] = _run(case, tmp_path_factory.mktemp(f"dp_{case}"))
    return _RUNS[case]


def _run(case, tmp):
    """The one-process reference and the 2 ranks' runs of ``case`` in
    ``tmp``: (case, reference records, the ranks' records)."""
    ref_path = str(tmp / "reference.pt")
    ref = reference(case, ref_path)
    port = _free_port()
    root = os.path.join(os.path.dirname(__file__), "..")
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.path.abspath(root))
        procs.append(subprocess.Popen(
            [sys.executable, RANK_SCRIPT, case, ref_path, str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    ranks = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return case, ref, ranks


def test_ranks_are_bit_identical(runs):
    _, _, ranks = runs
    assert torch.equal(ranks[0]["state"], ranks[1]["state"])
    assert ranks[0]["lr"] == ranks[1]["lr"]


def test_end_to_end_matches_one_process(runs):
    _, ref, ranks = runs
    assert ranks[0]["lr"] == ref["lr"]
    for a, b in zip(ranks[0]["params"], ref["params"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_teacher_forced_gradients_match_one_process(runs):
    case, ref, ranks = runs
    assert len(ranks[0]["minibatches"]) == len(ref["minibatches"]) == 4
    # the blocks' shares of each global minibatch add up to it
    assert [a + b for a, b in zip(ranks[0]["local_sizes"],
                                  ranks[1]["local_sizes"])] == [16, 16]
    for i, (got, want) in enumerate(zip(ranks[0]["minibatches"],
                                        ref["minibatches"])):
        other = ranks[1]["minibatches"][i]
        assert torch.equal(got["grad"], other["grad"]), i
        assert got["ok"] == want["ok"] == other["ok"], i
        # divided by max(|g|, 1), as the physics tests' aux: the handstand's
        # gradients reach ~1e4, and float64 sums of its per-sample terms
        # leave ~6e-7 on entries of ~1e-3 whatever the order of the ranks
        mag = max(float(want["grad"].abs().max()), 1.0)
        np.testing.assert_allclose(got["grad"].numpy() / mag,
                                   want["grad"].numpy() / mag,
                                   err_msg=f"{case} minibatch {i}", **GRAD_TOL)
        np.testing.assert_allclose(
            [got["loss"], got["norm"], *got["stats"]],
            [want["loss"], want["norm"], *want["stats"]],
            err_msg=f"{case} minibatch {i}: loss, norm, surrogate, value, "
                    "kl, anchor", **GRAD_TOL)
    if case == "handstand":
        assert any(r["stats"][3] > 0 for r in ref["minibatches"]), \
            "the anchor KL was not exercised"


@pytest.mark.parametrize("runs", ["handstand"], indirect=True)
def test_nan_on_one_rank_is_skipped_by_every_rank(runs):
    _, _, ranks = runs
    assert [r["nan_step_skipped"] for r in ranks] == [True, True]
    assert torch.equal(ranks[0]["after_nan_state"], ranks[1]["after_nan_state"])
