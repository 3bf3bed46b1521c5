"""Port parity of the go2 handstand env past its resets: the PyTorch
``GO2HandstandEnv.step`` against the JAX package's at N=8 on the
fine-tune recipe's env (chip_smoke.py's ``finetune_cfgs``: contact
stiffness, PD-gain, actuation-delay and push DR), with observation noise
and its contact-flag flips on, every env compared through every step.

Each port step takes the JAX step's own draws (tests/torch_jax_draws.py),
among them the reference-state initialisation (RSI) of ``_sample_reset``
(port ``envs/go2_handstand.py``, JAX ``envs/go2_handstand.py:345-505``):
the handstand-or-upright choice, hold or mid-transition, pitch, yaw,
joint jitter, height and pitch rate. The RSI probability starts at 0.7 and
anneals to 0.3 over 10 steps, half the RSI starts are mid-transition, so
every branch of it draws. The start is the port's ``reset_all``, whose
zero-action step tips the first episodes over within a few steps in both
packages; the JAX env takes its reset tables from the port's
(tests/test_torch_env_handstand_step.py).

Every port step starts from the JAX state before it (``EnvState.from_numpy``),
so that each step, resets included, is compared from the same state.

The falling robots flail (joint velocities at their 30 rad/s clamp), and
on such a state one control step is ill-conditioned: the JAX package's own
two backends, ``control_step_soa`` (what its CPU step runs) and
``control_step_vmap``, given the same inputs, disagree by up to ~3e-4 in a
velocity, beyond the physics tolerance that they set for each other
(tests/test_soa_backend.py), and the port's plain version differs from the
SoA backend by the same order there. So the physics tolerance holds an env
at a step where the reference's backends meet it; elsewhere the env is
excused from the comparisons that depend on that step's physics (obs,
privileged obs, reward, and a non-reset env's state), at most
``MAX_EXCUSED`` (5%) of the env-steps: 2 of the 128 are excused on this
seed. ``done`` is exact everywhere, and a reset
env's new state (the RSI sample, zeroed buffers, commands) does not depend
on the step's physics and is compared at every reset.

``done`` and every integer or boolean field match exactly; every float at
atol 5e-5 / rtol 1e-4. At least ``MIN_RESETS`` resets, with every env
reset at least once, must be compared. JAX compiles ``env.step``, its two
control-step backends and the draws, once each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import finetune_cfgs
from tests.test_torch_env import state_to_numpy
from tests.test_torch_env_handstand_step import jax_env_with_tables
from tests.test_torch_env_terrain import to_jax
from tests.torch_jax_draws import Injected, step_draws_fn
from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs import go2_handstand as ths
from unitree_rl_gym_tpu_torch.envs.base_env import EnvState
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N = 8
STEPS = 16
MIN_RESETS = 12
MAX_EXCUSED = 0.05
TOL = dict(atol=5e-5, rtol=1e-4)
PHYS = ("base_pos", "base_quat", "joint_q", "v")
# a reset env's new state: the reset sample and zeroed buffers
RESET_FIELDS = PHYS + ("episode_length", "commands", "actions", "last_actions",
                       "last_dof_vel", "feet_air_time", "last_contacts",
                       "episode_sums", "task_state")
FIELDS = RESET_FIELDS + ("obs", "priv_obs")


def _cfg(registry):
    cfg, _ = finetune_cfgs(registry, N)
    ist = cfg.init_state
    ist.handstand_init_prob = 0.7
    ist.handstand_init_prob_final = 0.3
    ist.handstand_anneal_steps = 10.0
    ist.handstand_mid_frac = 0.5
    cfg.noise.add_noise = True
    return cfg


def _within(a, b):
    """Per env: every entry of [N, ...] ``a`` within the tolerance of ``b``."""
    ok = np.abs(a - b) <= TOL["atol"] + TOL["rtol"] * np.abs(b)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


def backends_agree(jenv, tenv, soa, vmap, jstate, actions):
    """Per env: whether the JAX package's two control-step backends meet
    the physics tolerance with each other on this step's physics (the
    step's target as the env computes it, from the port's env)."""
    ts = EnvState.from_numpy(state_to_numpy(jstate), "cpu")
    a = torch.clamp(torch.from_numpy(actions),
                    -tenv.cfg.normalization.clip_actions,
                    tenv.cfg.normalization.clip_actions)
    a = torch.where(ts.act_delay[:, None], ts.actions, a)
    target = tenv._compute_target(a)
    q0 = ts.phys.joint_q
    target = q0 + ts.pd_gain[:, None] * (target - q0)
    args = (jstate.phys, jnp.asarray(target.numpy()), jstate.friction,
            jstate.mass_scale, jstate.cstiff)
    s, v = soa(*args), vmap(*args)
    ok = np.ones(N, bool)
    for k in PHYS:
        ok &= _within(np.asarray(getattr(v, k)), np.asarray(getattr(s, k)))
    return ok


@pytest.fixture(scope="module")
def traces():
    from unitree_rl_gym_tpu.physics import backend as jpb

    tenv = ths.GO2HandstandEnv(_cfg(task_registry), device="cpu")
    jenv = jax_env_with_tables(_cfg(jax_registry), tenv)
    step = jax.jit(jenv.step)
    draws = step_draws_fn(jenv)
    const = (jenv.robot.dyn, jenv.cparams, jenv.pd, jenv.cfg.sim.dt,
             jenv.cfg.control.decimation)
    soa, vmap = (jax.jit(lambda phys, tgt, fr, ms, cs, fn=fn: fn(
        *const, phys, tgt, fr, ms, jenv.m_eff_n, jenv.m_eff_t, cstiff=cs)[0])
        for fn in (jpb.control_step_soa, jpb.control_step_vmap))
    policy = load_flat_policy(resource("resources/pre_train/go2_handstand"), "cpu")
    tstate, _ = tenv.reset_all()
    jstate = to_jax(tstate)
    inj = Injected(tenv)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        tstate = EnvState.from_numpy(state_to_numpy(jstate), "cpu")
        with torch.no_grad():
            a = policy.act(tstate.obs).numpy()
        a = (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        agree = backends_agree(jenv, tenv, soa, vmap, jstate, a)
        d, key_after = draws(jstate.key)
        inj.feed(d)
        jstate, jobs, jpriv, jrew, jdone, jext = step(jstate, jnp.asarray(a))
        assert np.array_equal(np.asarray(jstate.key), np.asarray(key_after))
        tstate, obs, tpriv, trew, tdone, text = tenv.step(tstate, torch.from_numpy(a))
        inj.done()
        out.append({
            "jax": state_to_numpy(jstate), "port": tstate, "agree": agree,
            "obs": (np.asarray(jobs), obs.numpy()),
            "priv": (np.asarray(jpriv), tpriv.numpy()),
            "reward": (np.asarray(jrew), trew.numpy()),
            "done": (np.asarray(jdone), tdone.numpy()),
            "time_outs": (np.asarray(jext["time_outs"]), text["time_outs"].numpy()),
            "resets": (np.asarray(jext["episode_sums_at_reset"]),
                       text["episode_sums_at_reset"].numpy()),
        })
    return jenv, tenv, out


def _close(t, j, what):
    if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, err_msg=what, **TOL)


def test_resets_compared(traces):
    _, _, out = traces
    done = np.stack([r["done"][0] for r in out])
    assert int(done.sum()) >= MIN_RESETS, int(done.sum())
    assert done.any(axis=0).all(), done.any(axis=0)
    agree = np.stack([r["agree"] for r in out])
    assert (~agree).mean() <= MAX_EXCUSED, (~agree).sum(axis=1)
    # the RSI probability annealed over the steps
    assert float(out[-1]["jax"]["task_state"]) == pytest.approx(0.3)


def test_done_matches(traces):
    for i, rec in enumerate(traces[2]):
        np.testing.assert_array_equal(rec["done"][1], rec["done"][0], err_msg=str(i))
        np.testing.assert_array_equal(rec["time_outs"][1], rec["time_outs"][0])


def _get(state, field):
    if field in PHYS:
        return getattr(state.phys, field).numpy()
    return getattr(state, field).numpy()


@pytest.mark.parametrize("field", FIELDS)
def test_state_matches(traces, field):
    """Every env where the reference's backends agree; a reset env's new
    state at every reset."""
    for i, rec in enumerate(traces[2]):
        j = rec["jax"]["phys"][field] if field in PHYS else rec["jax"][field]
        t = _get(rec["port"], field)
        if j.ndim == 0:
            _close(t, j, f"{field} {i}")
            continue
        rows = rec["agree"] | (rec["done"][0] & (field in RESET_FIELDS))
        _close(t[rows], j[rows], f"{field} {i}")


@pytest.mark.parametrize("what", ["obs", "priv", "reward"])
def test_outputs_match(traces, what):
    for i, rec in enumerate(traces[2]):
        rows = rec["agree"]
        _close(rec[what][1][rows], rec[what][0][rows], f"{what} {i}")


def test_episode_sums_at_reset_match(traces):
    for i, rec in enumerate(traces[2]):
        if rec["agree"][rec["done"][0]].all():
            _close(rec["resets"][1], rec["resets"][0], f"resets {i}")
