"""The reference agrees with the port's plain CPU path at a tiny width:
one env step (and the control step inside it) from the same state, actions
and generator state, flat and on the heightfield, go2 and g1; and the
shipped policies' actions and LSTM carry."""

import json
import os

import pytest
import torch

from benchlib import common as C
from conftest import BENCH, ROOT

N = 4


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


@pytest.mark.parametrize("config,traffic", [
    ("go2", "flat_train"), ("g1", "flat_train"), ("go2", "terrain_train")])
def test_env_step_matches(config, traffic):
    cfg, tr = load("configs", config + ".json"), load("traffic", traffic + ".json")
    env, _ = C.program_env(cfg, tr, N, 123, "cpu")
    ref = C.reference_env(cfg, tr, N, 123, "cpu")
    state, _ = env.reset_all()
    cap = C.StepCapture(env)
    try:
        gen = torch.Generator().manual_seed(0)
        for i in range(3):
            actions = torch.randn(N, env.num_actions, generator=gen)
            if i == 2:
                cap.arm()
            state, *_ = env.step(state, actions)
    finally:
        cap.remove()
    assert C.check_control_step(ref, cap.data) == 0.0
    assert C.check_env_step(ref, cap.data) == 0.0
    # the control: the next precision down stands in for the program
    assert C.check_control_step(ref, cap.data, torch.bfloat16) > 1e-4
    assert C.check_env_step(ref, cap.data, torch.bfloat16) > 1e-4


@pytest.mark.parametrize("task", ["go2", "g1"])
def test_policy_matches(task):
    from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy

    from reference import policy as P

    path = os.path.join(ROOT, "resources", "pre_train", task)
    net = load_flat_policy(path, "cpu")
    params = P.from_flat(os.path.join(path, "policy_flat.npz"), "cpu")
    obs = torch.randn(16, net.memory_a.cells[0].weight_ih.shape[1]
                      if net.is_recurrent else 48, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        if net.is_recurrent:
            carry = net.initial_carry(16)
            for _ in range(3):
                mine, carry_m = net.act(obs, carry)
                ref, carry_r = P.act_recurrent(params, obs, carry)
                assert C.rel_err(mine, ref) == 0.0
                assert C.rel_err(carry_m, carry_r) == 0.0
                carry = carry_m
        else:
            assert C.rel_err(net.act(obs), P.mlp(params["actor"], obs, torch.float32)) == 0.0
            low = P.mlp(params["actor"], obs, torch.float32, "tf32")
            assert C.rel_err(low, P.mlp(params["actor"], obs, torch.float32)) > 1e-5
