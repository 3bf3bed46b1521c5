"""CPU smoke runs of the port's humanoid entry points (the plain physics
version; no kernel launches):

  * two iterations of ``scripts/train.py --task=g1 --num_envs=8
    --device=cpu``: the LSTM actor-critic and recurrent PPO, finite
    metrics with the learning rate in its float32 bounds, the checkpoint
    files written, and the last checkpoint, LSTM weights included, loaded
    into a fresh runner bit for bit;
  * a few steps of ``scripts/play.py``'s loop for h1_2 with its shipped
    LSTM policy (``resources/pre_train/h1_2``);
  * the runner's inference policy holds its LSTM carry from call to call,
    and ``reset_memory`` zeroes it."""

import os

import pytest
import torch

from tests.test_torch_train import check_rows
from unitree_rl_gym_tpu_torch import resolve_device
from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
from unitree_rl_gym_tpu_torch.scripts import play
from unitree_rl_gym_tpu_torch.scripts import train as train_script
from unitree_rl_gym_tpu_torch.utils import helpers
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def g1_run(tmp_path_factory):
    """(rows, the trained runner, its log dir) of two CPU iterations."""
    tmp = tmp_path_factory.mktemp("g1_train")
    trained = {}
    learn = OnPolicyRunner.learn

    def recording_learn(self, *a, **kw):
        trained["runner"] = self
        return learn(self, *a, **kw)

    OnPolicyRunner.learn = recording_learn
    before = cuda_step.LAUNCHES
    try:
        rows = train_script.train(helpers.get_args([
            "--task=g1", "--num_envs=8", "--device=cpu", "--max_iterations=2",
            f"--experiment_name={tmp}"]))
    finally:
        OnPolicyRunner.learn = learn
    assert cuda_step.LAUNCHES == before
    (run,) = os.listdir(str(tmp))
    return rows, trained["runner"], os.path.join(str(tmp), run)


def test_g1_trains_two_iterations_on_cpu(g1_run):
    rows, runner, log_dir = g1_run
    check_rows(rows, terrain=False)
    assert runner.net.is_recurrent
    assert tuple(runner._carry.shape) == (2, 1, 2, 8, 64)
    assert torch.isfinite(runner._carry).all() and runner._carry.abs().max() > 0
    assert {"model_2.pt", "model_2.pt.json", "curves.json"} <= set(os.listdir(log_dir))


def test_g1_lstm_checkpoint_round_trip(g1_run):
    _, runner, log_dir = g1_run
    fresh = OnPolicyRunner(runner.env, runner.cfg, None)
    fresh.load(os.path.join(log_dir, "model_2.pt"))
    sd, fsd = runner.net.state_dict(), fresh.net.state_dict()
    assert any(k.startswith("memory_a.") for k in sd)
    assert any(k.startswith("memory_c.") for k in sd)
    assert sd.keys() == fsd.keys()
    for k in sd:
        assert torch.equal(sd[k], fsd[k]), k
    assert fresh.alg.lr == runner.alg.lr
    assert fresh.current_learning_iteration == 2


def test_inference_policy_holds_the_carry(g1_run):
    """Each call advances the carry (the same obs gives another action);
    ``reset_memory`` starts again from a zero carry."""
    _, runner, _ = g1_run
    policy = runner.get_inference_policy()
    obs = torch.randn(3, runner.env.num_obs, generator=torch.Generator().manual_seed(0))
    first = policy(obs)
    second = policy(obs)
    assert not torch.equal(first, second)
    policy.reset_memory()
    assert torch.equal(policy(obs), first)


def test_h1_2_play_on_cpu():
    args = helpers.get_args(["--task=h1_2", "--num_envs=8", "--device=cpu"])
    env = play.make_play_env(args, resolve_device(args.device))
    policy = load_flat_policy(play.policy_dir(args), env.device)
    assert policy.is_recurrent
    before = cuda_step.LAUNCHES
    state, obs = env.reset_all()
    state, obs, stats = play.rollout(env, policy, state, obs, num_steps=5, settle=1)
    assert cuda_step.LAUNCHES == before
    assert tuple(obs.shape) == (8, 47)
    assert torch.isfinite(obs).all()
    for k in ("base_pos", "base_quat", "joint_q", "v"):
        assert torch.isfinite(getattr(state.phys, k)).all()
    assert stats["falls"] == 0
