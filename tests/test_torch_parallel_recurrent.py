"""Recurrent PPO over ranks, port against port: one iteration of g1 with the
LSTM actor-critic at N=8 global envs over 2 gloo ranks on the CPU (one
``parallel.mesh.spawn_ranks`` for every case;
tests/torch_parallel_recurrent_rank.py) against one process on the same
8 envs, T = 4, 2 epochs x 2 minibatches of 4 env columns (the dryrun's
shapes). The one-process run is the one that
tests/test_torch_ppo_update_recurrent.py and
tests/test_torch_train_humanoid.py hold against the JAX package. Gated
as the MLP's data parallelism (tests/test_torch_parallel_train.py): pushes
off, the policy held in float64 (``chip_smoke.hold_in_float64``).

Two cases: ``perm`` (the update's env permutation drawn from the PPO
generator, as in training) and ``blocks`` (``PPO.update(perm=)`` the
identity: each minibatch's envs all lie on one rank, and the other rank
replays no column of it yet joins its all-reduce).

  * each rank's rollout (obs, critic obs, actions, log-probs, values,
    means, stds, dones, returns, the start carry) is its rows of the one
    process's, bit for bit; the advantages, normalised with the global
    mean and std (float32 sums over ranks), within rtol 1e-6 / atol 1e-6;
  * after the iteration both ranks' parameters, Adam moments and step
    counts, and learning rate (``dryrun.replica_state``) are bit for bit
    the same, and within ``STATE_ATOL`` (1e-5, as the MLP's end to end) of
    the one process's, with the same learning rate;
  * teacher-forced: the update alone, from the seed's parameters, given
    the one process's transitions, advantages, returns and permutation
    (a rank its env columns), leaves both ranks bit for bit the same and
    within ``UPDATE_ATOL`` (1e-10) of the one process's update;
  * in ``blocks`` each rank held all 4 columns of one minibatch and none
    of the other;
  * rank 0's checkpoint of the ``perm`` case (LSTM included) loads back
    on every rank to its own state, bit for bit;
  * the dryrun's g1-terrain-LSTM class (g1 on the 2 x 2 heightfield with
    its curriculum, the LSTM, 4 envs a rank) ran in the same ranks, its
    replicas checked identical and its losses finite;
  * ``scripts/train.py --task=g1`` under torchrun with 2 gloo ranks (the
    file's second spawn) trains, and rank 0's checkpoint loads into one
    process.

No JAX program is compiled."""

import math
import os
import subprocess
import sys

import pytest
import torch

from tests.torch_parallel_recurrent_rank import (CASES, ROLLOUT_FIELDS,
                                                 build_runner, rank_main,
                                                 run_case, teacher_forced)
from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
from unitree_rl_gym_tpu_torch.parallel.dryrun import replica_state
from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

WORLD = 2
# the update alone on the one process's inputs: float64 parameters and
# Adam state after 4 minibatch steps, the sums over samples in another
# order (measured: see CHANGES.md)
UPDATE_ATOL = 1e-10
# end to end, from the seed: the float32 GAE normalisation (its mean and
# std summed over ranks in another order) moves advantages by ~1 ulp, and
# Adam's later steps amplify that on entries whose per-sample terms cancel
STATE_ATOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_recurrent")
    ref = {case: run_case(case) for case in CASES}
    for case in CASES:
        del ref[case]["runner"]
    torch.save({case: ref[case]["update_inputs"] for case in CASES},
               str(tmp / "reference.pt"))
    for case in CASES:
        ref[case]["teacher_forced"] = teacher_forced(ref[case]["update_inputs"])
    pmesh.spawn_ranks(rank_main, WORLD, (str(tmp),), timeout_s=600)
    ranks = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return ref, ranks


@pytest.mark.parametrize("case", CASES)
def test_rollout_rows_match_one_process(runs, case):
    ref, ranks = runs
    for rank in ranks:
        off, n = rank["block"]
        got = rank[case]
        for k in ROLLOUT_FIELDS:
            want = ref[case]["rollout"][k][:, off:off + n]
            assert torch.equal(got["rollout"][k], want), (case, off, k)
        assert torch.equal(got["carry0"], ref[case]["carry0"][:, :, :, off:off + n])
        torch.testing.assert_close(
            got["advantages"], ref[case]["advantages"][:, off:off + n],
            rtol=1e-6, atol=1e-6)
        assert torch.equal(got["perm"], ref[case]["perm"])


@pytest.mark.parametrize("case", CASES)
def test_replicas_are_bit_identical(runs, case):
    _, ranks = runs
    assert torch.equal(ranks[0][case]["state"], ranks[1][case]["state"])
    assert ranks[0][case]["lr"] == ranks[1][case]["lr"]


@pytest.mark.parametrize("case", CASES)
def test_update_matches_one_process(runs, case):
    ref, ranks = runs
    want = ref[case]["teacher_forced"]
    assert torch.equal(ranks[0]["teacher_forced"][case],
                       ranks[1]["teacher_forced"][case])
    got = ranks[0]["teacher_forced"][case]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= UPDATE_ATOL
    # the update moved the parameters far beyond the tolerance
    seed = replica_state(build_runner())[:-1]
    assert float((want[:seed.numel()] - seed).abs().max()) > 1e-4


@pytest.mark.parametrize("case", CASES)
def test_end_to_end_matches_one_process(runs, case):
    ref, ranks = runs
    got, want = ranks[0][case], ref[case]
    assert got["lr"] == want["lr"]
    assert float((got["state"] - want["state"]).abs().max()) <= STATE_ATOL


def test_empty_block_minibatches(runs):
    ref, ranks = runs
    assert ref["blocks"]["columns"] == [4, 4]
    assert [r["blocks"]["columns"] for r in ranks] == [[4, 0], [0, 4]]
    # the drawn permutation splits the minibatches over both ranks alike
    assert [sum(c) for c in zip(*(r["perm"]["columns"] for r in ranks))] == [4, 4]


def test_checkpoint_loads_back_on_every_rank(runs):
    _, ranks = runs
    assert [r["checkpoint_loads_back"] for r in ranks] == [True, True]


def test_torchrun_train_g1_two_ranks(tmp_path):
    """``scripts/train.py --task=g1`` under torchrun with 2 ranks (gloo on
    the CPU) trains the LSTM over the ranks; rank 0 alone writes the run,
    and its checkpoint loads into a one-process runner."""
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "unitree_rl_gym_tpu_torch.scripts.train",
         "--task=g1", "--num_envs=8", "--device=cpu", "--max_iterations=1",
         "--dist_backend=gloo", "--headless", f"--experiment_name={tmp_path}"],
        cwd=UNITREE_RL_GYM_TPU_ROOT_DIR, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=UNITREE_RL_GYM_TPU_ROOT_DIR))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert sum(line.startswith("it ") for line in res.stdout.splitlines()) == 1
    (run,) = os.listdir(str(tmp_path))
    assert {"model_1.pt", "model_1.pt.json", "curves.json"} == set(
        os.listdir(os.path.join(str(tmp_path), run)))
    cfg, tcfg = task_registry.get_cfgs("g1")
    cfg.env.num_envs = 8
    env, _ = task_registry.make_env("g1", env_cfg=cfg, device="cpu")
    runner = OnPolicyRunner(env, tcfg, None)
    payload = runner.load(os.path.join(str(tmp_path), run, "model_1.pt"))
    assert runner.net.is_recurrent and runner.current_learning_iteration == 1
    for p, (name, q) in zip(runner.net.parameters(), payload["model"].items()):
        assert torch.equal(p.detach(), q), name


def test_dryrun_g1_terrain_lstm_class(runs):
    _, ranks = runs
    for rank in ranks:
        row = rank["dryrun"]
        for k in ("value_loss", "surrogate_loss", "kl"):
            assert math.isfinite(row[k]), k
        assert 1e-5 <= row["lr"] <= 1e-2
        assert "terrain_level" in row
    assert ranks[0]["dryrun"]["value_loss"] == ranks[1]["dryrun"]["value_loss"]
