"""The port's actuation-loop DR on go2, the analogue of the JAX package's
tests/test_env_go2.py::test_actuation_loop_dr (on the CPU, N=4): the
per-env PD-gain scale and one-step actuation delay are off by default,
drawn once at reset within their ranges when on, and change the step as
their definitions say (a delayed env actuates the previous action while
its obs keeps the commanded one; a lower gain moves less toward the same
target). Friction DR is off (its bucket draw would give the envs
different contact)."""

import torch

from unitree_rl_gym_tpu_torch.envs.base_env import LeggedEnv
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


def _env(**dr):
    cfg = go2_rough_cfg()
    cfg.env.num_envs = 4
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    for k, v in dr.items():
        setattr(cfg.domain_rand, k, v)
    return LeggedEnv(cfg, device="cpu")


def test_actuation_loop_dr():
    state, _ = _env().reset_all()
    assert state.pd_gain is None and state.act_delay is None and state.cstiff is None

    env = _env(randomize_pd_gain=True, pd_gain_range=(0.7, 1.3),
               action_delay_prob=0.5)
    state, _ = env.reset_all()
    g = state.pd_gain
    assert g.shape == (4,) and bool(((g >= 0.7) & (g <= 1.3)).all())
    assert state.act_delay.shape == (4,) and state.act_delay.dtype == torch.bool

    # delay: envs 0 and 1 in the same state, env 1 delayed; the first step
    # after reset actuates the previous (zero) action in env 1
    phys = state.phys.replace(**{
        k: torch.cat((getattr(state.phys, k)[:1], getattr(state.phys, k)[:1],
                      getattr(state.phys, k)[2:]))
        for k in ("base_pos", "base_quat", "joint_q", "v")})
    state = state.replace(
        phys=phys, pd_gain=torch.ones(4),
        act_delay=torch.tensor([False, True, False, True]),
        actions=torch.zeros(4, 12))
    big = torch.ones(4, 12)
    s1, *_ = env.step(state, big)
    dq = (s1.phys.joint_q - state.phys.joint_q).abs()
    assert float(dq[0].sum()) > 2.0 * float(dq[1].sum())
    # the delayed env's state (and obs) keep the commanded action
    assert torch.equal(s1.actions[1], big[1])

    # gain: the same state at gain 0.6 and 1.4; the low gain moves less
    state2 = state.replace(pd_gain=torch.tensor([0.6, 1.4, 1.0, 1.0]),
                           act_delay=torch.zeros(4, dtype=torch.bool))
    s2, *_ = env.step(state2, big)
    dq2 = (s2.phys.joint_q - state2.phys.joint_q).abs()
    assert float(dq2[0].sum()) < float(dq2[1].sum())
