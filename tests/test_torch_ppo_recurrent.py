"""Port parity of the recurrent half of ``rl/ppo.py`` (an LSTM policy,
``ActorCriticRecurrent``) against the JAX package's ``PPO``, on the CPU in
float32, with g1's network (obs 47, privileged obs 50, LSTM 64, heads
[32]):

  * one recurrent minibatch, [T, B] = [8, 8] with a nonzero start carry
    and envs done inside the window: the loss, its terms, the KL and every
    gradient (the LSTM's gate kernels and biases included) against
    ``jax.value_and_grad(PPO._loss)`` with ``carry0`` and ``dones``, at
    atol 1e-5 / rtol 1e-4;
  * the env-column minibatches of an injected permutation of the N envs:
    minibatch i is the columns ``perm[i*mb:(i+1)*mb]`` over all T steps
    with their dones and start carry, and the remainder of N mod
    ``num_mini_batches`` is dropped;
  * the rollout (a stub env with a scripted ``done`` pattern): the carry a
    done env continues with is zeroed after its step, the stored action
    means and final carry equal the JAX network's over the same steps, and
    the update's replay of the stored window reproduces the rollout's
    means, stds, values and log-probs bit for bit (ratio 1).

JAX compiles the loss's value and gradient and one network step; no
``train_iteration`` or update (tests/test_torch_ppo_update_recurrent.py
compiles the update)."""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo import JaxBatch
from unitree_rl_gym_tpu.models import networks as jnets
from unitree_rl_gym_tpu.rl.ppo import PPO as JaxPPO
from unitree_rl_gym_tpu.utils.config import TrainCfg as JaxTrainCfg
from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.rl.ppo import PPO, Batch
from unitree_rl_gym_tpu_torch.utils.config import TrainCfg
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
NUM_OBS, NUM_COBS, NUM_ACT = 47, 50, 12
T, B = 8, 8
GATES = ("i", "f", "g", "o")


def jax_recurrent(num_steps, num_envs, cls=JaxPPO, **kw):
    """A JAX PPO over g1's recurrent network in float32."""
    tc = JaxTrainCfg()
    pc = tc.policy
    pc.dtype = "float32"
    pc._class_name = "ActorCriticRecurrent"
    pc.init_noise_std, pc.actor_hidden_dims, pc.critic_hidden_dims = 0.8, [32], [32]
    net = jnets.build_network(pc, NUM_ACT)
    return cls(net=net, cfg=tc.algorithm, num_steps=num_steps, num_envs=num_envs, **kw)


def port_net(params):
    return nets.actor_critic_from_params(jax.device_get(params), is_recurrent=True,
                                         dtype="float32")


def flax_named(net, value):
    """``value(param)`` of every port parameter under its Flax name, the
    LSTM's stacked gates split and every kernel as [in, out]."""
    out = {}
    for head in ("actor", "critic"):
        lins = [m for m in getattr(net, head) if isinstance(m, torch.nn.Linear)]
        for i, lin in enumerate(lins):
            out[f"params/{head}/Dense_{i}/kernel"] = value(lin.weight).T.copy()
            out[f"params/{head}/Dense_{i}/bias"] = value(lin.bias).copy()
    for mem in ("memory_a", "memory_c"):
        for l, cell in enumerate(getattr(net, mem).cells):
            pre = f"params/{mem}/lstm_{l}"
            for g, ih, hh, b in zip(GATES, *(np.split(value(p), 4) for p in (
                    cell.weight_ih, cell.weight_hh, cell.bias_hh))):
                out[f"{pre}/i{g}/kernel"] = ih.T.copy()
                out[f"{pre}/h{g}/kernel"] = hh.T.copy()
                out[f"{pre}/h{g}/bias"] = b.copy()
    out["params/log_std"] = value(net.log_std).copy()
    return out


def port_tensors(net, flat):
    """{port parameter: tensor} from Flax-named arrays (the inverse of
    :func:`flax_named`)."""
    out = {}
    for head in ("actor", "critic"):
        lins = [m for m in getattr(net, head) if isinstance(m, torch.nn.Linear)]
        for i, lin in enumerate(lins):
            out[lin.weight] = flat[f"params/{head}/Dense_{i}/kernel"].T
            out[lin.bias] = flat[f"params/{head}/Dense_{i}/bias"]
    for mem in ("memory_a", "memory_c"):
        for l, cell in enumerate(getattr(net, mem).cells):
            pre = f"params/{mem}/lstm_{l}"
            out[cell.weight_ih] = np.concatenate(
                [flat[f"{pre}/i{g}/kernel"].T for g in GATES])
            out[cell.weight_hh] = np.concatenate(
                [flat[f"{pre}/h{g}/kernel"].T for g in GATES])
            out[cell.bias_hh] = np.concatenate([flat[f"{pre}/h{g}/bias"] for g in GATES])
    out[net.log_std] = flat["params/log_std"]
    return {p: torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for p, a in out.items()}


def carry_to_jax(carry):
    c = np.asarray(carry)
    return tuple(tuple((jnp.asarray(c[m, l, 0]), jnp.asarray(c[m, l, 1]))
                       for l in range(c.shape[1])) for m in range(2))


def carry_from_jax(carry):
    return np.stack([np.stack([np.stack([np.asarray(c), np.asarray(h)])
                               for c, h in mem]) for mem in carry])


def window(jppo, params, n_envs, seed, steps=T):
    """A recurrent window [steps, n_envs] of numpy fields around the
    policy's own outputs (JAX network, done masking as the rollout does),
    from a nonzero start carry, with envs done inside it; returns (fields,
    carry0 [2, L, 2, N, H], dones, final carry)."""
    rng = np.random.default_rng(seed)
    net = jppo.net
    carry0 = (0.5 * rng.standard_normal(
        carry_from_jax(net.initial_carry(n_envs)).shape)).astype(np.float32)
    obs = rng.standard_normal((steps, n_envs, NUM_OBS)).astype(np.float32)
    cobs = rng.standard_normal((steps, n_envs, NUM_COBS)).astype(np.float32)
    dones = rng.random((steps, n_envs)) < 0.2
    dones[steps // 2, 0] = True
    step = _jax_step(net)
    carry = carry_to_jax(carry0)
    mus, stds, values = [], [], []
    for t in range(steps):
        mu, std, value, carry = step(params, obs[t], cobs[t], carry, dones[t])
        mus.append(np.asarray(mu))
        stds.append(np.asarray(std))
        values.append(np.asarray(value))
    mu, std, value = np.stack(mus), np.stack(stds), np.stack(values)
    old_mu = (mu + 0.05 * rng.standard_normal(mu.shape)).astype(np.float32)
    old_std = (std * (1.0 + 0.01 * rng.random(std.shape))).astype(np.float32)
    actions = (old_mu + old_std * rng.standard_normal(mu.shape)).astype(np.float32)
    z = (actions - old_mu) / old_std
    logp = np.sum(-0.5 * z * z - np.log(old_std) - 0.5 * math.log(2 * math.pi), -1)
    adv = rng.standard_normal((steps, n_envs)).astype(np.float32)
    fields = dict(
        obs=obs, critic_obs=cobs, actions=actions, log_probs=logp.astype(np.float32),
        values=(value + 0.3 * rng.standard_normal(value.shape)).astype(np.float32),
        advantages=(adv - adv.mean()) / adv.std(),
        returns=(value + rng.standard_normal(value.shape)).astype(np.float32),
        mu=old_mu, std=old_std)
    return fields, carry0, dones, carry_from_jax(carry)


_STEPS = {}


def _jax_step(net):
    """One jitted network step with the rollout's done masking."""
    if id(net) not in _STEPS:
        @jax.jit
        def step(params, o, co, carry, d):
            mu, std, value, carry = net.apply(params, o, co, carry)
            return mu, std, value, jnets.reset_carry(carry, d)

        _STEPS[id(net)] = (net, step)
    return _STEPS[id(net)][1]


def port_batch(fields, carry0, dones):
    return Batch(**{k: torch.from_numpy(v) for k, v in fields.items()},
                 dones=torch.from_numpy(dones), carry0=torch.from_numpy(carry0))


# ---------------------------------------------------------------------------
# one recurrent minibatch: loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def minibatch():
    jppo = jax_recurrent(T, B)
    ts = jppo.init(jax.random.PRNGKey(0), NUM_OBS, NUM_COBS)
    fields, carry0, dones, _ = window(jppo, ts.params, B, seed=1)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(jppo._loss, has_aux=True))(
        ts.params, jb, ts.lr, carry_to_jax(carry0), jnp.asarray(dones))
    net = port_net(ts.params)
    alg = PPO(net, TrainCfg().algorithm, num_steps=T, num_envs=B, device="cpu")
    loss, stats = alg.loss(port_batch(fields, carry0, dones))
    alg.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    return dict(
        jax=dict(loss=float(jloss), surrogate=float(jstats[0]),
                 value_loss=float(jstats[1]), kl=float(jstats[2]),
                 grads=nets.flatten_params(jax.device_get(jgrads))),
        port=dict(loss=loss.item(), surrogate=float(stats[0]),
                  value_loss=float(stats[1]), kl=float(stats[2]),
                  grads=flax_named(net, lambda p: p.grad.numpy())),
        dones=dones)


def test_window_has_dones(minibatch):
    d = minibatch["dones"]
    assert d[:-1].any() and not d.all()


@pytest.mark.parametrize("what", ["loss", "surrogate", "value_loss", "kl"])
def test_recurrent_loss_matches_jax(minibatch, what):
    np.testing.assert_allclose(minibatch["port"][what], minibatch["jax"][what], **TOL)


@pytest.mark.parametrize("part", ["memory_a", "memory_c", "actor", "critic",
                                  "log_std"])
def test_recurrent_gradients_match_jax(minibatch, part):
    jg, tg = minibatch["jax"]["grads"], minibatch["port"]["grads"]
    assert set(jg) == set(tg)
    names = [k for k in jg if f"/{part}" in k]
    assert names
    for k in names:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# env-column minibatches of an injected permutation
# ---------------------------------------------------------------------------


def test_env_column_minibatches():
    """N = 10 envs in 4 minibatches: 2 columns each over all T steps, the
    permutation's last 2 envs dropped."""
    n, nmb = 10, 4
    net = nets.ActorCriticRecurrent(NUM_OBS, NUM_ACT, num_critic_obs=NUM_COBS)
    cfg = TrainCfg().algorithm
    cfg.num_mini_batches = nmb
    alg = PPO(net, cfg, num_steps=T, num_envs=n, device="cpu")
    rng = np.random.default_rng(3)
    full = Batch(
        obs=torch.randn(T, n, NUM_OBS), critic_obs=torch.randn(T, n, NUM_COBS),
        actions=torch.randn(T, n, NUM_ACT), log_probs=torch.randn(T, n),
        values=torch.randn(T, n), advantages=torch.randn(T, n),
        returns=torch.randn(T, n), mu=torch.randn(T, n, NUM_ACT),
        std=torch.rand(T, n, NUM_ACT), dones=torch.from_numpy(rng.random((T, n)) < 0.3),
        carry0=torch.randn(2, 1, 2, n, 64))
    perm = torch.from_numpy(rng.permutation(n))
    mbs, count = alg.minibatches(full, perm)
    assert len(mbs) == nmb and count == T * 2
    seen = []
    for i, b in enumerate(mbs):
        idx = perm[2 * i:2 * i + 2]
        seen += idx.tolist()
        for f in Batch._fields[:10]:
            assert torch.equal(getattr(b, f), getattr(full, f)[:, idx]), f
        assert torch.equal(b.carry0, full.carry0[:, :, :, idx])
    assert sorted(seen + perm[8:].tolist()) == list(range(n))


# ---------------------------------------------------------------------------
# the rollout: carry, done masking, and the update's replay of it
# ---------------------------------------------------------------------------


class ScriptedEnv:
    """The parts of ``LeggedEnv`` that ``PPO.rollout`` reads, stepping
    numpy-seeded observations and a scripted ``done`` pattern."""

    def __init__(self, obs, cobs, dones):
        self.obs, self.cobs, self.dones = obs, cobs, dones
        self.cfg = types.SimpleNamespace(terrain=types.SimpleNamespace(
            window_refresh_steps=0))
        self.terrain = None
        self.episode_term_names = ["alive"]

    def step(self, t, actions, refresh_terrain=True):
        n = actions.shape[0]
        extras = {"time_outs": torch.zeros(n, dtype=torch.bool),
                  "episode_sums_at_reset": torch.zeros(1),
                  "episode_reset_count": torch.zeros((), dtype=torch.int64),
                  "episode_length_at_reset": torch.zeros((), dtype=torch.int64)}
        return (t + 1, torch.from_numpy(self.obs[t + 1]),
                torch.from_numpy(self.cobs[t + 1]), torch.zeros(n),
                torch.from_numpy(self.dones[t]), extras)


@pytest.fixture(scope="module")
def rollout():
    jppo = jax_recurrent(T, B)
    ts = jppo.init(jax.random.PRNGKey(5), NUM_OBS, NUM_COBS)
    fields, carry0, dones, jfinal = window(jppo, ts.params, B, seed=2, steps=T + 1)
    env = ScriptedEnv(fields["obs"], fields["critic_obs"], dones)
    alg = PPO(port_net(ts.params), TrainCfg().algorithm, num_steps=T, num_envs=B,
              device="cpu")
    obs = torch.from_numpy(fields["obs"][0])
    cobs = torch.from_numpy(fields["critic_obs"][0])
    out = alg.rollout(env, 0, obs, cobs, torch.from_numpy(carry0))
    # the JAX network's means and carry over the same T steps
    step = _jax_step(jppo.net)
    carry, mus = carry_to_jax(carry0), []
    for t in range(T):
        mu, _, _, carry = step(ts.params, fields["obs"][t], fields["critic_obs"][t],
                               carry, dones[t])
        mus.append(np.asarray(mu))
    return alg, out, np.stack(mus), carry_from_jax(carry), carry0, dones


def test_rollout_carries_and_resets(rollout):
    alg, out, jmu, jcarry, carry0, dones = rollout
    _, _, _, carry, tr, _, tdones, _ = out
    np.testing.assert_array_equal(tdones.numpy(), dones[:T])
    np.testing.assert_array_equal(tr.carry0.numpy(), carry0)
    np.testing.assert_array_equal(tr.dones.numpy(), dones[:T])
    np.testing.assert_allclose(tr.mu.numpy(), jmu, **TOL)
    np.testing.assert_allclose(carry.numpy(), jcarry, **TOL)
    assert (carry.numpy()[..., dones[T - 1], :] == 0).all()


def test_replay_reproduces_the_rollout(rollout):
    """The loss's replay of the stored window from its start carry gives
    the rollout's action distribution, values and log-probs bit for bit
    (the importance ratio is 1)."""
    alg, out, *_ = rollout
    tr = out[4]
    with torch.no_grad():
        mu, std, value = alg._replay(tr)
    flat = {k: getattr(tr, k).reshape((T * B,) + getattr(tr, k).shape[2:])
            for k in ("mu", "std", "values", "actions", "log_probs")}
    np.testing.assert_array_equal(mu.numpy(), flat["mu"].numpy())
    np.testing.assert_array_equal(std.numpy(), flat["std"].numpy())
    np.testing.assert_array_equal(value.numpy(), flat["values"].numpy())
    np.testing.assert_array_equal(nets.log_prob(mu, std, flat["actions"]).numpy(),
                                  flat["log_probs"].numpy())
