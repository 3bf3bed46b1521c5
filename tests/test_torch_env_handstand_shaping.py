"""Port parity of the go2 handstand's kick-up shaping terms and graces,
which only the campaign scripts turn on, against the JAX package's
``GO2HandstandEnv.step`` at N=8: the env cfg of experiment E15
(``scripts/handstand_kickup_r5.experiment_cfgs``; on the JAX side its rule
applied to the JAX cfgs): ``inversion_height`` 8, ``entry_lean`` 6 and
``pre_inversion_crouch`` -30, ``fallen_grace_s`` 8,
``illegal_contact_grace_s`` 1.5, ``handstand_class_gz_threshold`` -0.95,
mid-kick-up resets at th 0-40 deg and w 0-2 rad/s, with noise and pushes
off.

As tests/test_torch_env_handstand_step.py does: the port's state 8
policy steps after ``reset_all`` goes to JAX, then both packages take the
same actions (the pretrained handstand policy's, plus noise) for 12 steps,
each env compared up to its first reset. ``done`` must match exactly and
every reward term's episode sum, the three shaping terms included, at
atol 5e-5 / rtol 1e-4; each shaping term must move in at least one
compared env-step by more than that atol, so the comparison is not of
zeros. One JAX program
(``env.step``) is compiled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_env import state_to_numpy
from tests.test_torch_env_handstand_step import jax_env_with_tables
from tests.test_torch_env_terrain import to_jax
from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu.scripts.handstand_kickup_r5 import EXPERIMENTS
from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs import go2_handstand as ths
from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
from unitree_rl_gym_tpu_torch.scripts.handstand_kickup_r5 import experiment_cfgs
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8
EXP = "E15"
WARMUP = 8
STEPS = 12
TOL = dict(atol=5e-5, rtol=1e-4)
SHAPING = ("inversion_height", "entry_lean", "pre_inversion_crouch")


def _eval_off(cfg):
    cfg.env.num_envs = N
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    return cfg


def jax_cfg():
    """The JAX script's rule (handstand_kickup_r5.run_experiment) on the
    JAX package's cfgs."""
    cfg, _ = jax_registry.get_cfgs("go2_handstand")
    for k, v in EXPERIMENTS[EXP][1].items():
        if k.startswith("rew_"):
            cfg.rewards.scales[k[4:]] = v
        else:
            setattr(cfg.init_state if k.startswith("handstand_") else cfg.env, k, v)
    return _eval_off(cfg)


@pytest.fixture(scope="module")
def traces():
    _, cfg, _ = experiment_cfgs(EXP)
    tenv = ths.GO2HandstandEnv(_eval_off(cfg), device="cpu")
    jenv = jax_env_with_tables(jax_cfg(), tenv)
    assert list(tenv.episode_term_names) == list(jenv.episode_term_names)
    for term in SHAPING:
        assert term in tenv.episode_term_names
    step = jax.jit(jenv.step)
    policy = load_flat_policy(resource("resources/pre_train/go2_handstand"), "cpu")
    tstate, obs = tenv.reset_all()
    with torch.no_grad():
        for _ in range(WARMUP):
            tstate, obs, *_ = tenv.step(tstate, policy.act(obs))
    jstate = to_jax(tstate)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        with torch.no_grad():
            a = policy.act(obs).numpy()
        a = (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        prev = tstate.episode_sums.numpy()
        jstate, _, _, _, jdone, _ = step(jstate, jnp.asarray(a))
        tstate, obs, _, _, tdone, _ = tenv.step(tstate, torch.from_numpy(a))
        out.append((state_to_numpy(jstate), np.asarray(jdone), tstate,
                    tdone.numpy(), prev))
    return tenv.episode_term_names, out


def _compared(out):
    """(record, envs alive after its step) for every step: an env is
    compared up to its first reset in either package."""
    alive = np.ones(N, bool)
    for rec in out:
        before = alive.copy()
        alive &= ~(rec[1] | rec[3])
        yield rec, before, alive.copy()


def test_done_matches(traces):
    _, out = traces
    for rec, before, _ in _compared(out):
        np.testing.assert_array_equal(rec[3][before], rec[1][before])


def test_enough_steps_compared(traces):
    _, out = traces
    *_, (_, _, alive) = _compared(out)
    assert alive.sum() >= N // 2, alive


@pytest.mark.parametrize("term", ["inversion_height", "entry_lean",
                                  "pre_inversion_crouch", "others"])
def test_reward_term_sums_match(traces, term):
    names, out = traces
    idx = ([names.index(term)] if term != "others"
           else [i for i, n in enumerate(names) if n not in SHAPING])
    for rec, _, alive in _compared(out):
        np.testing.assert_allclose(rec[2].episode_sums.numpy()[alive][:, idx],
                                   rec[0]["episode_sums"][alive][:, idx],
                                   err_msg=term, **TOL)


@pytest.mark.parametrize("term", SHAPING)
def test_shaping_term_moves(traces, term):
    """The term changed some compared env's episode sum in some step by
    more than the comparison's atol."""
    names, out = traces
    i = names.index(term)
    moved = [np.abs(rec[2].episode_sums.numpy()[alive, i] - rec[4][alive, i]).max(initial=0.0)
             for rec, _, alive in _compared(out)]
    assert max(moved) > TOL["atol"], (term, max(moved))
