"""CPU smoke run of the go2 handstand robustness fine-tune (the training
setup of scripts/handstand_transfer_r5.py:172-209 with its defaults, the
PD-gain range of its help text and an actuation-delay probability of 0.1)
through the port's API at N=8, with the recipe as chip_smoke.py's
``finetune_cfgs`` sets it: ``task_registry`` -> ``OnPolicyRunner`` ->
``load_flat_params`` of the shipped ``policy_flat.npz`` -> ``set_anchor``
-> two ``learn`` iterations, on the plain physics version (no kernel
launches). Every metric finite, the learning rate within its float32
bounds, the anchor loss and the nan-guard's skip count reported, the DR
drawn within its ranges."""

import math

import numpy as np
import torch

from chip_smoke import finetune_cfgs
from tests.test_torch_train import check_rows
from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models.networks import load_flat_params
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


def test_handstand_finetune_two_iterations_on_cpu():
    cfg, tcfg = finetune_cfgs(task_registry, 8)
    env = task_registry.get_task_class("go2_handstand")(cfg, device="cpu")
    runner = OnPolicyRunner(env, tcfg, None)
    load_flat_params(runner.net, resource("resources/pre_train/go2_handstand"))
    with np.load(resource("resources/pre_train/go2_handstand/policy_flat.npz")) as z:
        np.testing.assert_array_equal(runner.net.log_std.detach().numpy(),
                                      z["params/log_std"])
    runner.set_anchor()
    before = (cuda_step.LAUNCHES, cuda_step.LAUNCHES_TERRAIN, cuda_step.LAUNCHES_CS)
    rows = runner.learn(2, init_at_random_ep_len=True)
    check_rows(rows, terrain=False)
    for row in rows:
        assert math.isfinite(row["anchor_loss"]) and row["anchor_loss"] >= 0.0
        assert row["nonfinite_steps"] == 0
        assert set(row["episode_rew"]) == set(env.episode_term_names)
    assert (cuda_step.LAUNCHES, cuda_step.LAUNCHES_TERRAIN,
            cuda_step.LAUNCHES_CS) == before
    state = runner._env_state
    assert tuple(state.obs.shape) == (8, 46)
    for field, (lo, hi) in (("cstiff", (0.7, 1.5)), ("pd_gain", (0.8, 1.2)),
                            ("friction", (0.3, 1.25))):
        x = getattr(state, field)
        assert bool(((x >= lo) & (x <= hi)).all()), field
    assert state.act_delay.dtype == torch.bool
    # the anchor stays the shipped policy while the policy trains
    assert not torch.equal(runner.alg.anchor.log_std, runner.net.log_std)
