"""The port's spans (``utils/profiling.span``) on the CPU:

- with no profiler running, ``span`` hands back one shared no-op context
  and never builds a ``record_function``; under a profiler it records its
  name;
- under ``torch.profiler.profile()``, one ``PPO.train_iteration`` of go2 at
  N=8 on a tiny heightfield (T=3 steps at decimation 1, the windows
  re-centered every 2 steps, 2 epochs x 2 minibatches) records every span
  of the PPO phases, the policy and the env step as often as the
  iteration runs it, each inside its parent on the same thread;
- so does the play loop (``scripts/play.py::rollout``) of the shipped g1
  LSTM policy on the same heightfield, where the env step re-centers the
  windows itself.
"""

import torch
from torch.profiler import ProfilerActivity, profile

from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.rl.ppo import PPO
from unitree_rl_gym_tpu_torch.scripts import play
from unitree_rl_gym_tpu_torch.utils import profiling
from unitree_rl_gym_tpu_torch.utils.profiling import span
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8
T = 3
REFRESH = 2
EPOCHS, MINIBATCHES = 2, 2
PLAY_STEPS = 3
# each span's parent, where the loop runs it
ENV_PARTS = ("env_physics", "env_rewards", "env_reset", "terrain_window_contraction",
             "env_obs")
TRAIN_PARENTS = {"ppo_gae": "ppo_rollout", "policy_act": "ppo_rollout",
                 "env_step": "ppo_rollout", "env_refresh_terrain": "ppo_rollout",
                 "ppo_minibatch": "ppo_update",
                 **{k: "env_step" for k in ENV_PARTS}}
PLAY_PARENTS = {"env_refresh_terrain": "env_step", **{k: "env_step" for k in ENV_PARTS}}


def tiny_terrain(cfg):
    """2 x 2 sub-terrains of 4 m with a 2 m border, one physics substep a
    step, the terrain curriculum on."""
    cfg.env.num_envs = N
    cfg.control.decimation = 1
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    cfg.terrain.terrain_length = cfg.terrain.terrain_width = 4.0
    cfg.terrain.border_size = 2.0
    cfg.terrain.curriculum = True
    cfg.terrain.window_refresh_steps = REFRESH
    return cfg


def ranges(prof):
    """{name: [(start, end, thread)]} of the profile's host events."""
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end, e.thread))
    return out


def check_nesting(got, parents):
    for child, parent in parents.items():
        for a, b, tid in got[child]:
            assert any(pa <= a and b <= pb and ptid == tid
                       for pa, pb, ptid in got[parent]), (child, parent)


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    off = span("env_step")
    assert off is span("policy_act") is profiling._OFF
    with off:
        torch.zeros(2) + 1
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span("env_step")
        assert on is not profiling._OFF
        with on:
            torch.zeros(2) + 1
    assert len(ranges(prof)["env_step"]) == 1


def test_train_iteration_records_every_span():
    cfg, tcfg = task_registry.get_cfgs("go2")
    env = task_registry.get_task_class("go2")(tiny_terrain(cfg), device="cpu")
    tcfg.runner.num_steps_per_env = T
    tcfg.algorithm.num_learning_epochs = EPOCHS
    tcfg.algorithm.num_mini_batches = MINIBATCHES
    pc = tcfg.policy
    pc._class_name = tcfg.runner.policy_class_name
    net = nets.build_network(pc, env.num_obs, env.num_actions,
                             num_critic_obs=env.num_privileged_obs,
                             generator=torch.Generator().manual_seed(0))
    alg = PPO(net, tcfg.algorithm, num_steps=T, num_envs=N, device=env.device,
              share_critic_obs=env.num_privileged_obs is None, seed=0)
    state, obs = env.reset_all()
    cobs = state.priv_obs if state.priv_obs is not None else obs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        alg.train_iteration(env, state, obs, cobs)
    got = ranges(prof)
    counts = {k: len(got.get(k, ())) for k in set(TRAIN_PARENTS) | {"ppo_rollout",
                                                                      "ppo_update"}}
    assert counts == {"ppo_rollout": 1, "ppo_update": 1, "ppo_gae": 1,
                      "ppo_minibatch": EPOCHS * MINIBATCHES, "policy_act": T,
                      "env_step": T, "env_refresh_terrain": -(-T // REFRESH),
                      **{k: T for k in ENV_PARTS}}
    check_nesting(got, TRAIN_PARENTS)


def test_play_loop_records_every_span():
    cfg, _ = task_registry.get_cfgs("g1")
    env = task_registry.get_task_class("g1")(tiny_terrain(cfg), device="cpu")
    policy = nets.load_flat_policy(resource("resources/pre_train/g1"), env.device)
    assert policy.is_recurrent
    state, obs = env.reset_all()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        play.rollout(env, policy, state, obs, num_steps=PLAY_STEPS, settle=0)
    got = ranges(prof)
    counts = {k: len(got.get(k, ())) for k in set(PLAY_PARENTS) | {"env_step", "policy_act"}}
    assert counts == {"env_step": PLAY_STEPS, "policy_act": PLAY_STEPS,
                      **{k: PLAY_STEPS for k in PLAY_PARENTS}}
    check_nesting(got, PLAY_PARENTS)
    # the policy acts before the step, outside it
    for a, b, _ in got["policy_act"]:
        assert not any(sa <= a < sb for sa, sb, _ in got["env_step"])
