"""The comparison fails what it must: a whole run of a cell on the CPU at a
size a test run holds (8 envs, a short warm-up), the card's look skipped,
with the timed path broken underneath (or the control in the program's
place), comes out not correct; the same run unbroken comes out correct.

The faults a cell can have: a step that returns its state unchanged, half
of the batch left out (the mean taken over the rest), and an answer
altered where it is produced; on the heightfield, a window refresh that
returns its state unchanged or alters a window. No cell spans chips, so
none can leave out an exchange between them."""

import json

import pytest

import run

N = 8
ROLLOUT_WARMUP = {"warmup_steps": 4}


def run_once(capsys, workload, *extra, traffic=None):
    rc = run.main(["--workload", workload, "--seed", "2147483659", "--seconds",
                   "0.1", "--trace", "0", *extra], device="cpu",
                  traffic_update={"num_envs": N, **(traffic or {})})
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def control_step_unchanged(monkeypatch):
    from unitree_rl_gym_tpu_torch.physics import backend

    orig = backend.control_step

    def fault(model, cparams, pd, sim_dt, decimation, state, *a, **kw):
        _, aux = orig(model, cparams, pd, sim_dt, decimation, state, *a, **kw)
        return state, aux

    monkeypatch.setattr(backend, "control_step", fault)


def control_step_half(monkeypatch):
    from unitree_rl_gym_tpu_torch.physics import backend

    orig = backend.control_step

    def fault(model, cparams, pd, sim_dt, decimation, state, *a, **kw):
        new, aux = orig(model, cparams, pd, sim_dt, decimation, state, *a, **kw)
        h = state.v.shape[0] // 2
        for k in ("base_pos", "base_quat", "joint_q", "v"):
            getattr(new, k)[h:] = getattr(state, k)[h:]
        return new, aux

    monkeypatch.setattr(backend, "control_step", fault)


def obs_altered(monkeypatch):
    from unitree_rl_gym_tpu_torch.envs.base_env import LeggedEnv

    orig = LeggedEnv.step

    def fault(self, *a, **kw):
        state, obs, *rest = orig(self, *a, **kw)
        obs = obs.clone()
        obs[0, 0] += 0.5
        return (state, obs, *rest)

    monkeypatch.setattr(LeggedEnv, "step", fault)


def action_altered(monkeypatch):
    from unitree_rl_gym_tpu_torch.models.networks import ActorCriticRecurrent

    orig = ActorCriticRecurrent.act

    def fault(self, obs, carry):
        mu, carry = orig(self, obs, carry)
        return mu + 1e-3, carry

    monkeypatch.setattr(ActorCriticRecurrent, "act", fault)


def optimizer_unchanged(monkeypatch):
    from unitree_rl_gym_tpu_torch.rl.ppo import PPO

    monkeypatch.setattr(PPO, "apply_step", lambda self, kl, norm=None: None)


def loss_on_half(monkeypatch):
    from unitree_rl_gym_tpu_torch.rl.ppo import PPO, Batch

    orig = PPO.loss

    def fault(self, b, count=None):
        h = b.obs.shape[0] // 2
        return orig(self, Batch(*(None if x is None else x[:h] for x in b)), count)

    monkeypatch.setattr(PPO, "loss", fault)


def refresh_unchanged(monkeypatch):
    from unitree_rl_gym_tpu_torch.envs.base_env import LeggedEnv

    orig = LeggedEnv.refresh_terrain

    def fault(self, state):  # the reset's first refresh still builds the windows
        return orig(self, state) if state.win is None else state

    monkeypatch.setattr(LeggedEnv, "refresh_terrain", fault)


def refresh_altered(monkeypatch):
    from unitree_rl_gym_tpu_torch.envs.base_env import LeggedEnv

    orig = LeggedEnv.refresh_terrain

    def fault(self, state):
        out = orig(self, state)
        if out.win is None:
            return out
        win = out.win.clone()
        win[0, 0, 0] += 0.05
        return out.replace(win=win)

    monkeypatch.setattr(LeggedEnv, "refresh_terrain", fault)


ROLLOUT_FAULTS = {"state_unchanged": control_step_unchanged,
                  "half_batch": control_step_half,
                  "answer_altered": action_altered}
TRAIN_FAULTS = {"state_unchanged": optimizer_unchanged,
                "half_batch": loss_on_half,
                "answer_altered": obs_altered}
# the heightfield window refresh, which only the terrain cell reaches
REFRESH_FAULTS = {"refresh_unchanged": refresh_unchanged,
                  "refresh_altered": refresh_altered}


def test_rollout_sound_is_correct(capsys):
    assert run_once(capsys, "g1.rollout", traffic=ROLLOUT_WARMUP)["correct"] is True


def test_rollout_control_is_not_correct(capsys):
    out = run_once(capsys, "g1.rollout", "--control", "1", traffic=ROLLOUT_WARMUP)
    assert out["correct"] is False


@pytest.mark.parametrize("fault", sorted(ROLLOUT_FAULTS))
def test_rollout_fault_is_not_correct(capsys, monkeypatch, fault):
    ROLLOUT_FAULTS[fault](monkeypatch)
    assert run_once(capsys, "g1.rollout", traffic=ROLLOUT_WARMUP)["correct"] is False


TRAIN_CELLS = ["go2.train", "go2.terrain_train"]


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_train_sound_is_correct(capsys, workload):
    out = run_once(capsys, workload)
    refresh = out["comparisons"].get("refresh_err")  # the same code: exact
    assert refresh is None or refresh["value"] == 0.0
    assert out["correct"] is True


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_train_control_is_not_correct(capsys, workload):
    out = run_once(capsys, workload, "--control", "1")
    assert out["correct"] is False
    refresh = out["comparisons"].get("refresh_err")  # the heightfield's alone
    assert refresh is None or refresh["value"] > refresh["limit"]


@pytest.mark.parametrize("workload,fault", [("go2.train", f) for f in sorted(TRAIN_FAULTS)]
                         + [("go2.terrain_train", f) for f in sorted(REFRESH_FAULTS)])
def test_train_fault_is_not_correct(capsys, monkeypatch, workload, fault):
    {**TRAIN_FAULTS, **REFRESH_FAULTS}[fault](monkeypatch)
    out = run_once(capsys, workload)
    assert out["correct"] is False
    if fault in REFRESH_FAULTS:
        c = out["comparisons"]["refresh_err"]
        assert c["value"] > c["limit"]
