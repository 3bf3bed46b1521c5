"""The port's data-parallel entry points on the CPU: the train script under
torchrun with 2 ranks (gloo), the backend rule of
``parallel.mesh.init_process_group``, and the env blocks.

  * ``python -m torch.distributed.run --standalone --nproc_per_node=2 -m
    unitree_rl_gym_tpu_torch.scripts.train --task=go2 --num_envs=8
    --device=cpu --max_iterations=1`` exits 0, rank 0 alone writes the
    run's directory with ``model_1.pt``, and the checkpoint loads into a
    one-process runner of the same 8 (global) envs;
  * ranks that would share a CUDA device raise unless gloo is named
    (the device count is mocked; no GPU is needed);
  * one process is the block of one rank: its minibatches are the
    permuted samples, sliced, as they were before the blocks.

The multi-rank dryrun's OK line is checked by
``tests/test_torch_isolation.py::test_parallel_ranks_run_without_jax``,
which runs it with the JAX packages refused."""

import os
import subprocess
import sys

import pytest
import torch

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
from unitree_rl_gym_tpu_torch.rl.ppo import PPO, Batch
from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
from unitree_rl_gym_tpu_torch.utils.config import TrainCfg
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


def _run(args, timeout=300):
    res = subprocess.run(
        [sys.executable, "-m", *args], cwd=UNITREE_RL_GYM_TPU_ROOT_DIR,
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=UNITREE_RL_GYM_TPU_ROOT_DIR))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def test_torchrun_train_two_ranks(tmp_path):
    out = _run([
        "torch.distributed.run", "--standalone", "--nproc_per_node=2",
        "-m", "unitree_rl_gym_tpu_torch.scripts.train", "--task=go2",
        "--num_envs=8", "--device=cpu", "--max_iterations=1",
        f"--experiment_name={tmp_path}"])
    # one log line: rank 0 alone prints
    assert sum(line.startswith("it ") for line in out.splitlines()) == 1
    runs = os.listdir(str(tmp_path))
    assert len(runs) == 1, runs
    files = set(os.listdir(os.path.join(str(tmp_path), runs[0])))
    # rank 0 alone writes TensorBoard's one event file
    events = {f for f in files if f.startswith("events.out.tfevents.")}
    assert len(events) == 1
    assert {"model_1.pt", "model_1.pt.json", "curves.json"} == files - events
    cfg, tcfg = task_registry.get_cfgs("go2")
    cfg.env.num_envs = 8
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device="cpu")
    runner = OnPolicyRunner(env, tcfg, None)
    payload = runner.load(os.path.join(str(tmp_path), runs[0], "model_1.pt"))
    assert runner.current_learning_iteration == 1
    for p, (name, q) in zip(runner.net.parameters(), payload["model"].items()):
        assert torch.equal(p.detach(), q), name


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_ranks_sharing_a_card_raise_without_gloo(monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="share a card|a card per rank"):
        pmesh.init_process_group("cuda", backend=backend)
    assert not torch.distributed.is_initialized()


def test_env_block_split():
    blocks = [pmesh.env_block(4096, r, 2) for r in range(2)]
    assert [(b.offset, b.n_local, b.n_global) for b in blocks] == [
        (0, 2048, 4096), (2048, 2048, 4096)]
    with pytest.raises(ValueError, match="split evenly"):
        pmesh.env_block(10, 0, 4)


def test_one_rank_minibatches_are_the_permuted_rows():
    T, N, nmb = 3, 4, 2
    tcfg = TrainCfg()
    tcfg.algorithm.num_mini_batches = nmb
    alg = PPO(nets.ActorCritic(5, 2), tcfg.algorithm, T, N, "cpu")
    assert alg.block == pmesh.env_block(N, 0, 1) and not alg.distributed
    gen = torch.Generator().manual_seed(0)

    def field(*shape):
        return torch.randn((T, N) + shape, generator=gen)

    tr = Batch(obs=field(5), critic_obs=None, actions=field(2),
               log_probs=field(), values=field(), advantages=field(),
               returns=field(), mu=field(2), std=field(2))
    perm = torch.randperm(T * N, generator=gen)
    mbs, mb = alg.minibatches(tr, perm)
    assert mb == T * N // nmb and len(mbs) == nmb
    for i, b in enumerate(mbs):
        rows = perm[i * mb:(i + 1) * mb]
        for name, got, x in zip(Batch._fields, b, tr):
            if x is None:
                assert got is None, name
            else:
                assert torch.equal(got, x.reshape((T * N,) + x.shape[2:])[rows]), name
