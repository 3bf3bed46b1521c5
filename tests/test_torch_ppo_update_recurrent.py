"""Port parity of a full recurrent ``PPO.update`` against the JAX
package's: g1's LSTM actor-critic (obs 47, privileged obs 50, LSTM 64,
heads [32]) in float32, 5 epochs x 4 minibatches of env columns over one
injected permutation of N = 16 envs, a window of T = 8 steps with a
nonzero start carry and envs done inside it (tests/test_torch_ppo_recurrent.py's
``window``), the adaptive learning rate carried from minibatch to
minibatch.

Both packages update from the JAX ``PPO.init`` of seed 0 on the same
window, with the permutation ``jax.random.permutation(key, N)`` as the
JAX update draws it (``rl/ppo.py:465``) injected into the port's
``update(perm=...)``. The JAX records come out of its jitted update
through tests/test_torch_ppo_update.py's ``RecordingPPO``. Every minibatch
starts from the JAX state before it (parameters, Adam moments and step
count, learning rate), and after it the port's parameters, Adam moments
(each divided by max(|moment|) of its tensor), step count, learning rate
and the KL the rate read match JAX's at the repo's PPO tolerance (atol
1e-5 / rtol 1e-4); after the last, the final parameters. Parameter
entries whose first gradient is float32 noise are held within 2 lr, as
in tests/test_torch_ppo_update.py.

JAX compiles the recurrent update once (and tests/test_torch_ppo_recurrent.py's
network step); no ``train_iteration``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo import _flat_tree
from tests.test_torch_ppo_recurrent import (
    flax_named, jax_recurrent, port_net, port_tensors, window,
)
from tests.test_torch_ppo_update import (
    MAX_NOISE_SHARE, RecordingPPO, _noise_entries,
)
from unitree_rl_gym_tpu.rl.ppo import Transition
from unitree_rl_gym_tpu_torch.rl.ppo import PPO, Batch
from unitree_rl_gym_tpu_torch.utils.config import TrainCfg

T, N = 8, 16
TOL = dict(atol=1e-5, rtol=1e-4)


def _port_record(alg, stats, skipped):
    st = alg.optimizer.state
    net = alg.net
    return dict(
        params=flax_named(net, lambda p: p.detach().numpy()),
        mu=flax_named(net, lambda p: st[p]["exp_avg"].numpy()),
        nu=flax_named(net, lambda p: st[p]["exp_avg_sq"].numpy()),
        count=float(st[net.log_std]["step"]), lr=alg.lr, kl=float(stats[2]),
        skipped=skipped)


def _load_jax_state(alg, rec):
    """Teacher forcing: the port's parameters, Adam state and learning rate
    set to a JAX record's."""
    net = alg.net
    params = port_tensors(net, rec["params"])
    mu = port_tensors(net, _flat_tree(rec["adam"].mu))
    nu = port_tensors(net, _flat_tree(rec["adam"].nu))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(params[p])
            alg.optimizer.state[p] = {
                "step": torch.tensor(float(rec["adam"].count)),
                "exp_avg": mu[p].clone(), "exp_avg_sq": nu[p].clone()}
    alg.lr = rec["lr"]


@pytest.fixture(scope="module")
def updates():
    jppo = jax_recurrent(T, N, cls=RecordingPPO)
    ts = jppo.init(jax.random.PRNGKey(0), 47, 50)
    fields, carry0, dones, _ = window(jppo, ts.params, N, seed=4)
    key = jax.random.PRNGKey(7)
    perm = np.asarray(jax.random.permutation(key, N))

    def j(x):
        return jnp.asarray(x)

    jtr = Transition(obs=j(fields["obs"]), critic_obs=j(fields["critic_obs"]),
                     actions=j(fields["actions"]), rewards=jnp.zeros((T, N)),
                     dones=j(dones), values=j(fields["values"]),
                     log_probs=j(fields["log_probs"]), mu=j(fields["mu"]),
                     std=j(fields["std"]))
    jcarry = tuple(tuple((j(carry0[m, l, 0]), j(carry0[m, l, 1]))
                         for l in range(carry0.shape[1])) for m in range(2))
    jppo.records.clear()
    jax.jit(jppo.update)(ts, jtr, j(fields["advantages"]), j(fields["returns"]),
                         jcarry, key)
    jax.effects_barrier()
    jrec = list(jppo.records)

    cfg = TrainCfg().algorithm
    alg = PPO(port_net(ts.params), cfg, num_steps=T, num_envs=N, device="cpu")
    tr = Batch(**{k: torch.from_numpy(v) for k, v in fields.items()
                  if k not in ("advantages", "returns")},
               advantages=None, returns=None, dones=torch.from_numpy(dones),
               carry0=torch.from_numpy(carry0))
    port = []
    step = alg.minibatch_step

    def recorded(b, count=None):
        assert b.obs.shape[:2] == (T, N // cfg.num_mini_batches)
        if port:
            _load_jax_state(alg, jrec[len(port) - 1])
        stats, skipped = step(b, count)
        port.append(_port_record(alg, stats, skipped))
        return stats, skipped

    alg.minibatch_step = recorded
    try:
        metrics = alg.update(tr, torch.from_numpy(fields["advantages"]),
                             torch.from_numpy(fields["returns"]),
                             perm=torch.from_numpy(perm))
    finally:
        del alg.minibatch_step
    return port, jrec, metrics


def test_twenty_minibatches_recorded(updates):
    port, jrec, _ = updates
    assert len(port) == len(jrec) == 20
    assert not any(p["skipped"] for p in port)
    assert not any(r["skipped"] for r in jrec)


@pytest.mark.parametrize("what", ["params", "adam", "lr", "kl"])
def test_recurrent_update_matches_jax_after_every_minibatch(updates, what):
    port, jrec, _ = updates
    noise = _noise_entries(jrec)
    n_noise = sum(int(x.sum()) for x in noise.values())
    assert n_noise <= MAX_NOISE_SHARE * sum(x.size for x in noise.values())
    lr_max = max(r["lr"] for r in jrec)
    for i, (p, r) in enumerate(zip(port, jrec)):
        msg = f"minibatch {i}"
        if what == "params":
            assert set(p["params"]) == set(r["params"])
            for k, want in r["params"].items():
                got, ok = p["params"][k], ~noise[k]
                np.testing.assert_allclose(got[ok], want[ok], err_msg=f"{msg} {k}",
                                           **TOL)
                assert np.abs(got - want)[~ok].max(initial=0.0) <= 2 * lr_max
        elif what == "adam":
            assert p["count"] == float(r["adam"].count), msg
            for name in ("mu", "nu"):
                jm = _flat_tree(getattr(r["adam"], name))
                for k, want in jm.items():
                    mag = max(float(np.abs(want).max()), 1e-30)
                    np.testing.assert_allclose(p[name][k] / mag, want / mag,
                                               err_msg=f"{msg} {k} {name}", **TOL)
        else:
            np.testing.assert_allclose(p[what], r[what], err_msg=msg, **TOL)


def test_lr_moves_and_metrics(updates):
    """The window's KL moves the adaptive rate, and the update's metrics
    are the minibatches' means."""
    port, jrec, metrics = updates
    lrs = [r["lr"] for r in jrec]
    assert len(set(lrs)) > 1
    assert metrics["lr"] == port[-1]["lr"]
    np.testing.assert_allclose(float(metrics["kl"]), np.mean([p["kl"] for p in port]),
                               rtol=1e-5)
