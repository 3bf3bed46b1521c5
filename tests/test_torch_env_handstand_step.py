"""Port parity of the go2 handstand env's step (``envs/go2_handstand.py``)
against the JAX package's ``GO2HandstandEnv.step`` at N=8, on the
fine-tune recipe's env config (tests/test_torch_env_handstand.py's
``_cfg``: the DR of scripts/handstand_transfer_r5.py) with noise and
pushes off.

The port's state 8 policy steps after ``reset_all`` (the first episodes,
tipped over by reset_all's zero-action step in both packages, have ended
by then), with ``cstiff``, ``pd_gain`` and ``act_delay`` injected
(stiffnesses 0.7-1.5, gains 1.2-0.8, two delayed envs), goes to JAX
(tests/test_torch_env_terrain.py's ``to_jax``); both packages then take
the same actions (the pretrained handstand policy's, plus noise) for 12
steps, each env compared up to its first reset (the packages draw resets
from their own generators), at least half of them through every step.
``done`` must match exactly; the physics state, obs (contact flags
included), privileged obs, reward and every reward term's episode sum at
atol 5e-5 / rtol 1e-4.

The JAX env takes its reset tables from the port's env (its two
table-building methods are overridden; tests/test_torch_env_handstand.py
holds the two packages' tables equal), which skips ~15 s of host FK; one
JAX program (``env.step``) is compiled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_env import state_to_numpy
from tests.test_torch_env_handstand import HS_TERMS, N, _cfg
from tests.test_torch_env_terrain import to_jax
from unitree_rl_gym_tpu.envs import go2_handstand as jhs
from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs import go2_handstand as ths
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy

WARMUP = 8       # port-only policy steps before the comparison starts
STEPS = 12
TOL = dict(atol=5e-5, rtol=1e-4)


def jax_env_with_tables(cfg, tenv):
    """The JAX handstand env with the port env's reset tables."""

    def tables(ts):
        return tuple(jnp.asarray(t.cpu().numpy()) for t in ts)

    class Env(jhs.GO2HandstandEnv):
        def _build_mid_tables(self):
            return tables(tenv._mid_tables)

        def _build_hold_tables(self):
            return tables(tenv._hold_tables)

    return Env(cfg)


@pytest.fixture(scope="module")
def traces():
    tenv = ths.GO2HandstandEnv(_cfg(task_registry), device="cpu")
    jenv = jax_env_with_tables(_cfg(jax_registry), tenv)
    step = jax.jit(jenv.step)
    policy = load_flat_policy(resource("resources/pre_train/go2_handstand"), "cpu")
    tstate, obs = tenv.reset_all()
    # reset_all's zero-action step tips every first episode over within a
    # few steps, in both packages; start from the episodes after those
    with torch.no_grad():
        for _ in range(WARMUP):
            tstate, obs, *_ = tenv.step(tstate, policy.act(obs))
    tstate = tstate.replace(
        cstiff=torch.linspace(0.7, 1.5, N),
        pd_gain=torch.linspace(1.2, 0.8, N),
        act_delay=torch.tensor([True, False, False, True] + [False] * (N - 4)),
    )
    jstate = to_jax(tstate)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        with torch.no_grad():
            a = policy.act(obs).numpy()
        a = (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)
        jstate, jobs, jpriv, jrew, jdone, _ = step(jstate, jnp.asarray(a))
        tstate, tobs, tpriv, trew, tdone, _ = tenv.step(tstate, torch.from_numpy(a))
        obs = tobs
        out.append((state_to_numpy(jstate), np.asarray(jobs), np.asarray(jpriv),
                    np.asarray(jrew), np.asarray(jdone), tstate, tobs.numpy(),
                    tpriv.numpy(), trew.numpy(), tdone.numpy()))
    return out


def _alive(out):
    """Per step, the envs that have not reset in either package before it
    ([STEPS, N] bool): resets draw from each package's own generator, so
    an env is compared up to the step where it resets."""
    alive, masks = np.ones(N, bool), []
    for rec in out:
        masks.append(alive.copy())
        alive &= ~(rec[4] | rec[9])
    return np.stack(masks)


def test_enough_steps_compared(traces):
    alive = _alive(traces)
    after = alive & ~np.stack([r[4] | r[9] for r in traces])
    # at least half of the envs live through every step
    assert after[-1].sum() >= N // 2, after.sum(axis=1)


def test_done_matches(traces):
    for rec, m in zip(traces, _alive(traces)):
        np.testing.assert_array_equal(rec[9][m], rec[4][m])


def test_dr_carried(traces):
    rec = traces[0]
    for f in ("cstiff", "pd_gain", "act_delay"):
        np.testing.assert_array_equal(getattr(rec[5], f).numpy(), rec[0][f])
    assert float(rec[5].task_state) == float(rec[0]["task_state"]) == 1.0


def _after(traces):
    """(record, envs alive after its step) for every step."""
    for rec, m in zip(traces, _alive(traces)):
        yield rec, m & ~(rec[4] | rec[9])


@pytest.mark.parametrize("field", ["base_pos", "base_quat", "joint_q", "v"])
def test_physics_state_matches(traces, field):
    for rec, m in _after(traces):
        np.testing.assert_allclose(
            getattr(rec[5].phys, field).numpy()[m], rec[0]["phys"][field][m], **TOL)


@pytest.mark.parametrize("what", ["obs", "priv_obs", "reward", "actions"])
def test_env_outputs_match(traces, what):
    for (rec, m), before in zip(_after(traces), _alive(traces)):
        j, t, rows = {
            "obs": (rec[1], rec[6], m),
            "priv_obs": (rec[2], rec[7], m),
            # the reward of a resetting step is the pre-reset physics'
            "reward": (rec[3], rec[8], before),
            "actions": (rec[0]["last_actions"], rec[5].last_actions.numpy(), m),
        }[what]
        np.testing.assert_allclose(t[rows], j[rows], **TOL)


@pytest.mark.parametrize("term", HS_TERMS)
def test_reward_term_matches(traces, term):
    i = HS_TERMS.index(term)
    for rec, m in _after(traces):
        np.testing.assert_allclose(rec[5].episode_sums.numpy()[m, i],
                                   rec[0]["episode_sums"][m, i], err_msg=term,
                                   **TOL)
