"""Port parity of the humanoid env (``envs/humanoid.py``, g1 here; h1_2 in
tests/test_torch_env_humanoid_h1_2.py): the PyTorch ``G1Env.step`` (on the
CPU, through the plain physics version) against the JAX package's
``G1Env.step`` at N=8 and decimation 1, noise and pushes off.

The state is the JAX ``reset_all``'s, converted with
``EnvState.from_numpy``; two envs then start three steps before the end of
a short episode (``max_episode_length`` 40 on both sides), so they time
out and reset inside the compared steps. Both packages take the same
actions for 12 steps. Each env is compared up to its reset (the packages
draw resets from their own generators): ``done`` exactly, and the physics
state, obs, privileged obs, reward and every reward term's episode sum
(the five humanoid terms included) at atol 5e-5 / rtol 1e-4. At its reset
step an env is compared where the port can take the JAX draws: the gait
phase it observes (computed before its reset, as the JAX step's
observation context copies the step's), its ``episode_length`` and the
buffers a reset zeroes.

One JAX ``reset_all`` and one jitted ``env.step`` are compiled, in the
module-scope fixture every case shares."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_env import state_to_numpy
from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu_torch.envs.base_env import EnvState
from unitree_rl_gym_tpu_torch.envs.registry import task_registry

N = 8
STEPS = 12
MAX_EPISODE_LENGTH = 40
RESET_ENVS = (1, 6)          # start 3 steps before their episode's end
TOL = dict(atol=5e-5, rtol=1e-4)
# buffers a reset zeroes, as the state holds them after the step
ZEROED = ("last_actions", "last_dof_vel", "feet_air_time", "episode_sums",
          "last_contacts")


def _cfg(registry, task):
    cfg, _ = registry.get_cfgs(task)
    cfg.env.num_envs = N
    cfg.control.decimation = 1
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.env.episode_length_s = MAX_EPISODE_LENGTH * cfg.sim.dt
    return cfg


def humanoid_traces(task):
    """(port env, records of every step): each record holds the JAX state
    (numpy), obs, privileged obs, reward and done, then the port's."""
    jenv = jax_registry.get_task_class(task)(_cfg(jax_registry, task))
    tenv = task_registry.get_task_class(task)(_cfg(task_registry, task),
                                              device="cpu")
    assert tenv.max_episode_length == jenv.max_episode_length == MAX_EPISODE_LENGTH
    jstate, _ = jenv.reset_all(jax.random.PRNGKey(0))
    ep = np.asarray(jstate.episode_length).copy()
    ep[list(RESET_ENVS)] = MAX_EPISODE_LENGTH - 2
    jstate = jstate.replace(episode_length=jnp.asarray(ep))
    tstate = EnvState.from_numpy(state_to_numpy(jstate), "cpu")
    step = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        a = (0.3 * rng.standard_normal((N, tenv.num_actions))).astype(np.float32)
        jstate, jobs, jpriv, jrew, jdone, _ = step(jstate, jnp.asarray(a))
        tstate, tobs, tpriv, trew, tdone, _ = tenv.step(tstate, torch.from_numpy(a))
        out.append((state_to_numpy(jstate), np.asarray(jobs), np.asarray(jpriv),
                    np.asarray(jrew), np.asarray(jdone), tstate, tobs.numpy(),
                    tpriv.numpy(), trew.numpy(), tdone.numpy()))
    return tenv, out


def alive_before(out):
    """Per step, the envs that have not reset in either package before it
    ([STEPS, N] bool)."""
    alive, masks = np.ones(N, bool), []
    for rec in out:
        masks.append(alive.copy())
        alive &= ~(rec[4] | rec[9])
    return np.stack(masks)


def steps_after(out):
    """(record, envs alive after its step, envs that reset in it)."""
    for rec, m in zip(out, alive_before(out)):
        reset = m & (rec[4] | rec[9])
        yield rec, m & ~reset, reset


def check_resets_reached(out):
    """The two envs started near their episode's end reset (time out) in
    both packages, and the others live through every step."""
    resets = [np.flatnonzero(r) for _, _, r in steps_after(out)]
    assert sorted(np.concatenate(resets).tolist()) == sorted(RESET_ENVS)
    assert alive_before(out)[-1].sum() + len(RESET_ENVS) == N


def check_done(out):
    for rec, m in zip(out, alive_before(out)):
        np.testing.assert_array_equal(rec[9][m], rec[4][m])


def check_physics(out, field):
    for rec, m, _ in steps_after(out):
        np.testing.assert_allclose(getattr(rec[5].phys, field).numpy()[m],
                                   rec[0]["phys"][field][m], **TOL)


def check_output(out, what):
    for (rec, m, _), before in zip(steps_after(out), alive_before(out)):
        j, t, rows = {
            "obs": (rec[1], rec[6], m),
            "priv_obs": (rec[2], rec[7], m),
            # the reward of a resetting step is the pre-reset physics'
            "reward": (rec[3], rec[8], before),
            "commands": (rec[0]["commands"], rec[5].commands.numpy(), m),
        }[what]
        np.testing.assert_allclose(t[rows], j[rows], **TOL)


def check_term(tenv, out, term):
    i = tenv.episode_term_names.index(term)
    for rec, m, _ in steps_after(out):
        np.testing.assert_allclose(rec[5].episode_sums.numpy()[m, i],
                                   rec[0]["episode_sums"][m, i], err_msg=term,
                                   **TOL)


def check_reset_step(tenv, out):
    """At its reset step an env observes the gait phase of its last step
    before the reset (episode length MAX_EPISODE_LENGTH + 1; sin and cos,
    the obs's and privileged obs's last two columns), not the reset's
    phase 0; its episode length is 0 and the buffers a reset zeroes are
    zero, in both packages."""
    t_pre = (MAX_EPISODE_LENGTH + 1) * tenv.dt
    phase = (t_pre % tenv.PHASE_PERIOD) / tenv.PHASE_PERIOD
    want = np.float32([np.sin(2 * np.pi * phase), np.cos(2 * np.pi * phase)])
    assert abs(want[1] - 1.0) > 0.1
    n = 0
    for rec, _, reset in steps_after(out):
        if not reset.any():
            continue
        n += int(reset.sum())
        for j, t in ((rec[1], rec[6]), (rec[2], rec[7])):
            np.testing.assert_allclose(t[reset, -2:], j[reset, -2:], **TOL)
            np.testing.assert_allclose(t[reset, -2:],
                                       np.broadcast_to(want, (reset.sum(), 2)),
                                       **TOL)
        np.testing.assert_array_equal(rec[5].episode_length.numpy()[reset], 0)
        np.testing.assert_array_equal(rec[0]["episode_length"][reset], 0)
        for f in ZEROED:
            t = getattr(rec[5], f).numpy()[reset]
            np.testing.assert_array_equal(t, rec[0][f][reset], err_msg=f)
            assert not t.any(), f
    assert n == len(RESET_ENVS)


@pytest.fixture(scope="module")
def traces():
    return humanoid_traces("g1")


def test_resets_reached(traces):
    check_resets_reached(traces[1])


def test_done_matches(traces):
    check_done(traces[1])


@pytest.mark.parametrize("field", ["base_pos", "base_quat", "joint_q", "v"])
def test_physics_state_matches(traces, field):
    check_physics(traces[1], field)


@pytest.mark.parametrize("what", ["obs", "priv_obs", "reward", "commands"])
def test_env_outputs_match(traces, what):
    check_output(traces[1], what)


@pytest.mark.parametrize("term", [
    "tracking_lin_vel", "tracking_ang_vel", "lin_vel_z", "ang_vel_xy",
    "orientation", "base_height", "dof_acc", "dof_vel", "action_rate",
    "dof_pos_limits", "alive", "hip_pos", "contact_no_vel",
    "feet_swing_height", "contact"])
def test_reward_term_matches(traces, term):
    check_term(*traces, term)


def test_reset_env_observes_pre_reset_phase(traces):
    check_reset_step(*traces)
