"""Port parity of ``PPO.rollout`` (``unitree_rl_gym_tpu_torch/rl/ppo.py``)
against the JAX package's ``PPO.rollout`` (``rl/ppo.py``) past resets:
go2 with the MLP policy (the JAX ``ActorCritic``'s params converted with
``actor_critic_from_params``, float32) at N=16 on the tiny heightfield with
the terrain and command curricula, pushes and observation noise on
(tests/test_torch_env_reset.py's cfg: 12-step episodes from random
lengths), T = 6 steps with the heightfield windows re-centered every 3
(``terrain.window_refresh_steps``), on the CPU.

The port's rollout takes the JAX rollout's draws: its action noise
(``PPO._action_noise``, replaced on the instance by ``jax.random.normal``
of each step's key from the JAX train state's key) and its env's (from
the env state's key, step by step; tests/torch_jax_draws.py). Compared: the
transitions (obs, actions with their noise, the time-out-bootstrapped
rewards, ``dones`` exactly, values, log-probs, means and stds), the
``ep_stats`` (reset count and episode-length sum exactly, the per-term
episode sums, mean step reward, terrain level and command range), and the
final env state and obs, at atol 5e-5 / rtol 1e-4. The rollout must cross
at least ``MIN_RESETS`` resets, ``MIN_TIMEOUTS`` of them time-outs (the
bootstrap), and refresh the windows at steps 0 and 3.

One JAX program (the rollout, with its env steps) is compiled, and one
small one (the draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_env import state_to_numpy
from tests.test_torch_env_reset import reset_cfg
from tests.test_torch_env_terrain import to_jax
from tests.torch_jax_draws import Injected, step_draws
from unitree_rl_gym_tpu.envs.base_env import LeggedEnv as JaxEnv
from unitree_rl_gym_tpu.envs.go2 import go2_rough_cfg as jax_go2_cfg
from unitree_rl_gym_tpu.envs.go2 import go2_rough_train_cfg as jax_train_cfg
from unitree_rl_gym_tpu.models import networks as jnets
from unitree_rl_gym_tpu.rl.ppo import PPO as JaxPPO
from unitree_rl_gym_tpu_torch.envs.base_env import LeggedEnv
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg, go2_rough_train_cfg
from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.rl.ppo import PPO
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 16
T = 6
REFRESH = 3
MIN_RESETS = 8
MIN_TIMEOUTS = 4
TOL = dict(atol=5e-5, rtol=1e-4)
FIELDS = ("obs", "actions", "rewards", "dones", "values", "log_probs", "mu", "std")
STATS = ("episode_sums", "reset_count", "episode_length_sum", "mean_step_reward",
         "terrain_level_mean", "max_command_x")


def _cfg(cfg):
    cfg = reset_cfg(cfg)
    cfg.terrain.window_refresh_steps = REFRESH
    return cfg


@pytest.fixture(scope="module")
def rollouts():
    jenv = JaxEnv(_cfg(jax_go2_cfg()))
    tenv = LeggedEnv(_cfg(go2_rough_cfg()), device="cpu")
    tc = jax_train_cfg()
    tc.policy.dtype = "float32"
    tc.policy._class_name = tc.runner.policy_class_name
    jalg = JaxPPO(net=jnets.build_network(tc.policy, 12), cfg=tc.algorithm,
                  num_steps=T, num_envs=N, share_critic_obs=True)
    ts = jalg.init(jax.random.PRNGKey(3), 48, 48)

    # the start: the port's reset_all and one more port step, so that the
    # gh carry holds the heights under the points, as the JAX CPU path's
    # per-substep lookup does
    tstate, _ = tenv.reset_all(init_at_random_ep_len=True)
    tstate, obs, *_ = tenv.step(tstate, torch.zeros((N, 12)))
    jstate, jobs = to_jax(tstate), jnp.asarray(obs.numpy())

    @jax.jit
    def draws(env_key, ppo_key):
        out = []
        for _ in range(T):
            d, env_key = step_draws(jenv, env_key)
            out += d
        eps = [jax.random.normal(k, (N, 12)) for k in jax.random.split(ppo_key, T)]
        return out, jnp.stack(eps)

    env_draws, eps = draws(jstate.key, ts.key)
    j = jax.jit(lambda ts, s, o: jalg.rollout(ts, jenv, s, o, o, None))(
        ts, jstate, jobs)
    jstate_end, jobs_end, _, _, jtr, _, jstats = j

    tcfg = go2_rough_train_cfg()
    net = nets.actor_critic_from_params(jax.device_get(ts.params), dtype="float32")
    alg = PPO(net, tcfg.algorithm, num_steps=T, num_envs=N, device="cpu",
              share_critic_obs=True)
    inj = Injected(tenv)
    inj.feed([np.asarray(x) for x in env_draws])
    seen = {"refresh": 0, "time_outs": 0}
    refresh, step = tenv.refresh_terrain, tenv.step

    def count_refresh(state):
        seen["refresh"] += 1
        return refresh(state)

    def count_time_outs(state, actions, refresh_terrain=True):
        out = step(state, actions, refresh_terrain)
        seen["time_outs"] += int(out[-1]["time_outs"].sum())
        return out

    tenv.refresh_terrain, tenv.step = count_refresh, count_time_outs
    eps = torch.from_numpy(np.asarray(eps))

    def jax_noise(t, shape):
        assert tuple(shape) == tuple(eps.shape[1:]), shape
        return eps[t]

    alg._action_noise = jax_noise
    (tstate_end, tobs_end, _, _, ttr, trew, tdones, tstats) = alg.rollout(
        tenv, tstate, obs, obs, None)
    inj.done()
    port = dict(ttr._asdict(), rewards=trew, dones=tdones)
    return {"jax": (state_to_numpy(jstate_end), np.asarray(jobs_end), jtr, jstats),
            "port": (tstate_end, tobs_end, port, tstats), "seen": seen}


def _close(t, j, what):
    t, j = np.asarray(t), np.asarray(j)
    if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, err_msg=what, **TOL)


def test_resets_timeouts_and_refreshes(rollouts):
    _, _, jtr, jstats = rollouts["jax"]
    dones = np.asarray(jtr.dones)
    assert int(dones.sum()) >= MIN_RESETS, int(dones.sum())
    assert int(jstats["reset_count"]) == int(dones.sum())
    assert rollouts["seen"]["time_outs"] >= MIN_TIMEOUTS, rollouts["seen"]
    assert rollouts["seen"]["refresh"] == len(range(0, T, REFRESH))


@pytest.mark.parametrize("field", FIELDS)
def test_transitions_match(rollouts, field):
    _, _, jtr, _ = rollouts["jax"]
    port = rollouts["port"][2]
    _close(port[field].numpy(), getattr(jtr, field), field)


@pytest.mark.parametrize("key", STATS)
def test_ep_stats_match(rollouts, key):
    jstats = rollouts["jax"][3]
    tstats = rollouts["port"][3]
    _close(tstats[key].numpy(), jstats[key], key)


@pytest.mark.parametrize("field", ["base_pos", "base_quat", "joint_q", "v",
                                   "episode_length", "commands", "terrain_level",
                                   "env_origin", "cmd_vx_range", "gh", "win_stale"])
def test_final_state_matches(rollouts, field):
    j, jobs, _, _ = rollouts["jax"]
    t, tobs, _, _ = rollouts["port"]
    if field in ("base_pos", "base_quat", "joint_q", "v"):
        _close(getattr(t.phys, field).numpy(), j["phys"][field], field)
    else:
        _close(getattr(t, field).numpy(), j[field], field)
    _close(tobs.numpy(), jobs, "obs")
