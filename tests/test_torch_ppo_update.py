"""Port parity of a full ``PPO.update`` against the JAX package's: 5 epochs x 4
minibatches over one permutation of the T*N = 24*8 samples of one
iteration, the adaptive learning rate carried from minibatch to minibatch,
on the CPU in float32, with the stock go2 settings and with the go2
handstand fine-tune's knobs (``nan_guard``, ``anchor_kl_coef`` 0.3,
``class_target_frac`` 0.5, the handstand env's class and anchor-mask
functions).

Each case is one iteration from the same state: the port's runner rolls
its env out for 24 steps and computes GAE, then both packages' updates
take those transitions and the same permutation,
``jax.random.permutation(key, T*N)`` as the JAX update draws it
(``rl/ppo.py:544``), injected into the port's ``update(perm=...)``. The
JAX records come out of its jitted update through ``jax.debug.callback``
in a subclass's ``_apply_step``; its anchor loss is the JAX loss with the
anchor minus the loss without it, over the coefficient, at the parameters
each step started from.

  * ``go2`` and ``handstand_knobs`` (the JAX ``PPO.init`` of seed 0,
    converted; the handstand's anchor is that policy): every minibatch
    starts from the JAX state before it (parameters, Adam moments and
    step count, learning rate), and after it the port's parameters, Adam
    moments (each divided by max(|moment|) of its tensor), step count,
    learning rate, the KL the rate read, the anchor loss and the
    nan-guard decision match JAX's at the repo's PPO tolerance (atol 1e-5
    / rtol 1e-4). Parameter entries whose first gradient is float32 noise
    (below 1e-5 of the largest in their tensor; at most 0.1% of the
    parameters) are held within 2 lr instead: Adam's first step moves such
    an entry by up to ~lr in a direction the summation order picks.
  * ``handstand_s1`` (the suspected fault S1 of ROADMAP §3): the shipped
    ``resources/pre_train/go2_handstand/policy_flat.npz``, loaded by both
    packages, is its own anchor, and each update runs free. The learning
    rate sequence matches at the PPO tolerance, the skip decisions
    exactly, and the KL and anchor-loss sequences within 0.1%: the
    policy's std is as small as 0.038, so its float32 loss sums per-sample
    terms ~1e3 times their mean and the two packages' gradients part by up
    to ~5e-4 of the largest entry once the first step has moved the
    policy. In both packages the rate rises to 1.5e-3 after the first
    minibatch and the next KL is above 1e3: the fine-tune's collapse is
    the reference's own behaviour.

JAX compiles the update once for go2 and once for the handstand (both
handstand cases run the same program), and the loss once; no
``train_iteration``."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import finetune_cfgs
from tests.test_torch_ppo import JaxBatch, _flat_tree
from unitree_rl_gym_tpu.envs.go2 import go2_rough_train_cfg as jax_go2_train_cfg
from unitree_rl_gym_tpu.envs.go2_handstand import GO2HandstandEnv as JaxHandstand
from unitree_rl_gym_tpu.envs.go2_handstand import (
    go2_handstand_cfg as jax_handstand_cfg,
    go2_handstand_train_cfg as jax_handstand_train_cfg,
)
from unitree_rl_gym_tpu.export.export import load_flat_params as jax_load_flat
from unitree_rl_gym_tpu.models import networks as jnets
from unitree_rl_gym_tpu.rl.ppo import PPO as JaxPPO
from unitree_rl_gym_tpu.rl.ppo import Transition
from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N, T = 8, 24
TOL = dict(atol=1e-5, rtol=1e-4)
S1_RTOL = 1e-3
# a first gradient below this share of its tensor's largest is float32
# noise; at most MAX_NOISE_SHARE of the parameters may be such entries, as
# chip_smoke.py excuses at most 0.1% of the envs at a contact edge
NOISE_REL = 1e-5
MAX_NOISE_SHARE = 1e-3
HANDSTAND = "resources/pre_train/go2_handstand"
CASES = ("go2", "handstand_knobs", "handstand_s1")


@dataclasses.dataclass(frozen=True)
class RecordingPPO(JaxPPO):
    """The JAX PPO, reporting every optimizer application to the host."""

    records: list = dataclasses.field(default_factory=list)

    def _apply_step(self, opt, params, opt_state, lr, grads, loss, kl):
        out = super()._apply_step(opt, params, opt_state, lr, grads, loss, kl)

        def record(params, opt_state, lr, skipped, kl):
            self.records.append(dict(
                params=_flat_tree(params), adam=opt_state[1], lr=float(lr),
                skipped=float(skipped) > 0.5, kl=float(kl)))

        jax.debug.callback(record, out[0], out[1], out[2], out[3], kl,
                           ordered=True)
        return out


def _entries(net):
    """(Flax name, parameter, stored transposed) of every port parameter."""
    for head in ("actor", "critic"):
        lins = [m for m in getattr(net, head) if isinstance(m, torch.nn.Linear)]
        for i, lin in enumerate(lins):
            yield f"params/{head}/Dense_{i}/kernel", lin.weight, True
            yield f"params/{head}/Dense_{i}/bias", lin.bias, False
    yield "params/log_std", net.log_std, False


def _np(x, transposed):
    x = x.detach().numpy()
    return (x.T if transposed else x).copy()


def _port_record(alg, stats, skipped):
    params, adam = {}, {}
    for name, p, tr in _entries(alg.net):
        params[name] = _np(p, tr)
        s = alg.optimizer.state[p]
        adam[name] = (_np(s["exp_avg"], tr), _np(s["exp_avg_sq"], tr),
                      float(s["step"]))
    return dict(params=params, adam=adam, lr=alg.lr, kl=float(stats[2]),
                anchor=float(stats[3]), skipped=skipped)


def _load_jax_state(alg, rec):
    """Teacher forcing: the port's parameters, Adam state and learning rate
    set to a JAX record's."""
    mu, nu = _flat_tree(rec["adam"].mu), _flat_tree(rec["adam"].nu)
    for name, p, tr in _entries(alg.net):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a.T if tr else a))

        with torch.no_grad():
            p.copy_(t(rec["params"][name]))
        alg.optimizer.state[p] = {
            "step": torch.tensor(float(rec["adam"].count)),
            "exp_avg": t(mu[name]).clone(), "exp_avg_sq": t(nu[name]).clone()}
    alg.lr = rec["lr"]


def _nest(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *path, leaf = key.split("/")
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module")
def handstand_side():
    """The handstand fine-tune's port runner and JAX PPO (its update
    compiled once for both handstand cases)."""
    cfg, tcfg = finetune_cfgs(task_registry, N)
    jtc = jax_handstand_train_cfg()
    a = jtc.algorithm
    a.nan_guard, a.anchor_kl_coef, a.class_target_frac = True, 0.3, 0.5
    task = types.SimpleNamespace(cfg=jax_handstand_cfg())
    task.cfg.init_state.handstand_class_gz_threshold = getattr(
        cfg.init_state, "handstand_class_gz_threshold", 0.0)
    fns = dict(state_class_fn=lambda o: JaxHandstand.ppo_state_class_fn(task, o),
               anchor_mask_fn=lambda o: JaxHandstand.ppo_anchor_mask_fn(task, o))
    return _sides("go2_handstand", cfg, tcfg, jtc, fns)


def _sides(task, cfg, tcfg, jtc, fns):
    tcfg.policy.dtype = jtc.policy.dtype = "float32"
    jtc.policy._class_name = "ActorCritic"
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    runner = OnPolicyRunner(env, tcfg, None)
    jppo = RecordingPPO(net=jnets.build_network(jtc.policy, env.num_actions),
                        cfg=jtc.algorithm, num_steps=T, num_envs=N,
                        share_critic_obs=env.num_privileged_obs is None, **fns)
    update = jax.jit(lambda ts, tr, a, r, k: jppo.update(ts, tr, a, r, None, k))
    return runner, jppo, update


@pytest.fixture(scope="module", params=CASES[:2])
def updates(request):
    case = request.param
    if case == "go2":
        cfg, tcfg = task_registry.get_cfgs("go2")
        cfg.env.num_envs = N
        runner, jppo, jupdate = _sides("go2", cfg, tcfg, jax_go2_train_cfg(), {})
    else:
        runner, jppo, jupdate = request.getfixturevalue("handstand_side")
    alg, env = runner.alg, runner.env
    ts = jppo.init(jax.random.PRNGKey(0), env.num_obs,
                   env.num_privileged_obs or env.num_obs)
    if case == "handstand_s1":
        params = jax.tree.map(jnp.asarray, jax_load_flat(resource(HANDSTAND)))
        ts = ts.replace(params=params, opt_state=jppo.make_optimizer().init(params))
    if case != "go2":
        ts = ts.replace(anchor_params=ts.params)
    runner.net.load_state_dict(nets.actor_critic_from_params(
        jax.device_get(ts.params), dtype="float32").state_dict())
    alg.optimizer.state.clear()
    alg.lr = float(np.float32(alg.cfg.learning_rate))
    if case != "go2":
        runner.set_anchor()

    # one iteration's rollout and GAE, by the port
    with torch.no_grad():
        state, obs = env.reset_all(init_at_random_ep_len=True)
        cobs = state.priv_obs if state.priv_obs is not None else obs
        _, obs, cobs, _, tr, rewards, dones, _ = alg.rollout(env, state, obs,
                                                             cobs)
        _, _, last_value = alg.net(obs, None if alg.share_critic_obs else cobs)
    adv, ret = alg.compute_gae(tr.values, rewards, dones, last_value)
    key = jax.random.PRNGKey(7)
    perm = np.asarray(jax.random.permutation(key, T * N))

    # the JAX update on those transitions
    def j(x):
        return jnp.asarray(x.numpy())

    critic = (jnp.zeros((T, N, 0)) if alg.share_critic_obs else j(tr.critic_obs))
    jtr = Transition(obs=j(tr.obs), critic_obs=critic, actions=j(tr.actions),
                     rewards=j(rewards), dones=j(dones), values=j(tr.values),
                     log_probs=j(tr.log_probs), mu=j(tr.mu), std=j(tr.std))
    jppo.records.clear()
    jupdate(ts, jtr, j(adv), j(ret), key)
    jax.effects_barrier()
    jrec = list(jppo.records)
    if case != "go2":
        _anchor_losses(jppo, ts, jrec, tr, adv, ret, perm, alg.share_critic_obs)

    # the port's update, teacher-forced or free, recorded after every minibatch
    port = []
    step = alg.minibatch_step

    def recorded(b, count=None):
        if case != "handstand_s1" and port:
            _load_jax_state(alg, jrec[len(port) - 1])
        stats, skipped = step(b, count)
        port.append(_port_record(alg, stats, skipped))
        return stats, skipped

    alg.minibatch_step = recorded
    try:
        alg.update(tr, adv, ret, perm=torch.from_numpy(perm))
    finally:
        del alg.minibatch_step
    return case, port, jrec


def _anchor_losses(jppo, ts, jrec, tr, adv, ret, perm, share):
    """The JAX anchor loss of every minibatch at the parameters its step
    started from: (loss with the anchor - loss without) / coefficient."""
    def flat(x):
        x = x.numpy()
        return x.reshape((T * N,) + x.shape[2:])[perm]

    fields = dict(obs=flat(tr.obs), actions=flat(tr.actions),
                  log_probs=flat(tr.log_probs), values=flat(tr.values),
                  advantages=flat(adv), returns=flat(ret), mu=flat(tr.mu),
                  std=flat(tr.std))
    fields["critic_obs"] = (fields["obs"][:, :0] if share else flat(tr.critic_obs))
    both = _anchor_fn(jppo)
    mb = T * N // jppo.cfg.num_mini_batches
    params = ts.params
    for i, rec in enumerate(jrec):
        k = i % jppo.cfg.num_mini_batches
        batch = JaxBatch(**{f: jnp.asarray(v[k * mb:(k + 1) * mb])
                            for f, v in fields.items()})
        rec["anchor"] = float(both(params, ts.anchor_params, batch))
        params = _nest(rec["params"])


_ANCHOR_FNS = {}


def _anchor_fn(jppo):
    if id(jppo) not in _ANCHOR_FNS:
        @jax.jit
        def both(params, anchor, batch):
            with_a = jppo._loss(params, batch, None, anchor_params=anchor)[0]
            without = jppo._loss(params, batch, None)[0]
            return (with_a - without) / jppo.cfg.anchor_kl_coef

        _ANCHOR_FNS[id(jppo)] = (jppo, both)
    return _ANCHOR_FNS[id(jppo)][1]


def _noise_entries(jrec):
    """Per parameter tensor, the entries whose first gradient is float32
    noise: |g| (from JAX's second moment after the first step, (1 - 0.999)
    g^2) below NOISE_REL of the tensor's largest."""
    out = {}
    for k, nu in _flat_tree(jrec[0]["adam"].nu).items():
        g = np.sqrt(nu / (1.0 - 0.999))
        out[k] = g < NOISE_REL * g.max()
    return out


def test_twenty_minibatches_recorded(updates):
    case, port, jrec = updates
    assert len(port) == len(jrec) == 20
    assert [p["skipped"] for p in port] == [r["skipped"] for r in jrec]


@pytest.mark.parametrize("what", ["params", "adam", "lr", "kl", "anchor"])
def test_update_matches_jax_after_every_minibatch(updates, what):
    case, port, jrec = updates
    noise = _noise_entries(jrec)
    n_noise = sum(int(x.sum()) for x in noise.values())
    assert n_noise <= MAX_NOISE_SHARE * sum(x.size for x in noise.values())
    lr_max = max(r["lr"] for r in jrec)
    for i, (p, r) in enumerate(zip(port, jrec)):
        msg = f"{case} minibatch {i}"
        if what == "params":
            assert set(p["params"]) == set(r["params"])
            for k, want in r["params"].items():
                got, ok = p["params"][k], ~noise[k]
                np.testing.assert_allclose(got[ok], want[ok], err_msg=f"{msg} {k}",
                                           **TOL)
                assert np.abs(got - want)[~ok].max(initial=0.0) <= 2 * lr_max
        elif what == "adam":
            jmu, jnu = (_flat_tree(x) for x in (r["adam"].mu, r["adam"].nu))
            for k, (mu, nu, count) in p["adam"].items():
                assert count == float(r["adam"].count), msg
                for name, got, want in (("mu", mu, jmu[k]), ("nu", nu, jnu[k])):
                    mag = max(float(np.abs(want).max()), 1e-30)
                    np.testing.assert_allclose(got / mag, want / mag,
                                               err_msg=f"{msg} {k} {name}", **TOL)
        else:
            np.testing.assert_allclose(p[what], r.get(what, 0.0), err_msg=msg,
                                       **TOL)


@pytest.mark.parametrize("updates", ["handstand_s1"], indirect=True)
def test_s1_sequences_match_jax(updates):
    _, port, jrec = updates
    assert len(port) == len(jrec) == 20
    assert [p["skipped"] for p in port] == [r["skipped"] for r in jrec]
    np.testing.assert_allclose([p["lr"] for p in port], [r["lr"] for r in jrec],
                               **TOL)
    for what in ("kl", "anchor"):
        np.testing.assert_allclose([p[what] for p in port],
                                   [r[what] for r in jrec], rtol=S1_RTOL,
                                   atol=TOL["atol"], err_msg=what)
    # the collapse of ROADMAP's S1, in both packages: the rate rises after
    # the first minibatch, whose KL is ~0, and the next KL is huge
    for seq in (port, jrec):
        assert seq[0]["lr"] == pytest.approx(1.5e-3) and seq[1]["kl"] > 1e3
