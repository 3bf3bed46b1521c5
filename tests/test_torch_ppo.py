"""Port parity and smoke tests of the training half: the networks' Gaussian
helpers and initialisation, ``rl/ppo.py`` and ``rl/runner.py`` of
unitree_rl_gym_tpu_torch against unitree_rl_gym_tpu, on the CPU.

  * GAE against the JAX ``PPO.compute_gae`` (atol 1e-5 / rtol 1e-4);
  * two minibatch steps from the same params (a JAX ``ActorCritic``'s
    param tree converted with ``actor_critic_from_params``) and the same
    batches against the JAX ``_loss`` + ``_apply_step``: loss and gradient
    (``PPO.loss`` + backward), then params and learning rate after
    ``PPO.apply_step`` on the JAX step's gradient, all at atol 1e-5 /
    rtol 1e-4 in float32 (the policy's ``dtype``), with data that moves
    the adaptive rate down and then up. The optimizer steps start from the
    same gradient because Adam's first steps divide each gradient element
    by its own magnitude plus eps (1e-8): an element whose gradient is
    float32 rounding noise (~1e-9 here, the two packages' sums differing
    in the last bits) moves by a few percent of the learning rate either
    way, which is not a property of the port;
  * the lecun-normal initialisation's statistics;
  * a checkpoint round trip.

The CPU training runs are in tests/test_torch_train.py and
tests/test_torch_train_terrain.py (one file each, so that test workers can
run them side by side).

JAX compiles two small programs here (GAE and the minibatch step), once
each; no test compiles a JAX ``train_iteration``."""

import collections
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.models import networks as jnets
from unitree_rl_gym_tpu.rl.ppo import PPO as JaxPPO
from unitree_rl_gym_tpu.rl.ppo import Transition
from unitree_rl_gym_tpu.utils.config import TrainCfg as JaxTrainCfg
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.rl.ppo import PPO, Batch
from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
from unitree_rl_gym_tpu_torch.utils import helpers
from unitree_rl_gym_tpu_torch.utils.config import TrainCfg

TOL = dict(atol=1e-5, rtol=1e-4)
NUM_OBS, NUM_ACT = 48, 12
B = 64
# float32 bounds of the adaptive learning rate
LR_MIN, LR_MAX = float(np.float32(1e-5)), float(np.float32(1e-2))


def _jax_ppo(num_steps=3, num_envs=4):
    tc = JaxTrainCfg()
    tc.policy.dtype = "float32"
    tc.policy._class_name = "ActorCritic"
    net = jnets.build_network(tc.policy, NUM_ACT)
    return JaxPPO(net=net, cfg=tc.algorithm, num_steps=num_steps,
                  num_envs=num_envs, share_critic_obs=True)


def _port_ppo(params):
    net = nets.actor_critic_from_params(jax.device_get(params), dtype="float32")
    return PPO(net, TrainCfg().algorithm, num_steps=3, num_envs=4,
               device="cpu", share_critic_obs=True)


# ---------------------------------------------------------------------------
# GAE
# ---------------------------------------------------------------------------


def test_gae_matches_jax():
    T, N = 6, 5
    rng = np.random.default_rng(0)
    values = rng.standard_normal((T, N)).astype(np.float32)
    rewards = rng.standard_normal((T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.2
    last = rng.standard_normal(N).astype(np.float32)
    jppo = _jax_ppo(T, N)
    z = jnp.zeros((T, N))
    tr = Transition(obs=z, critic_obs=z, actions=z, rewards=jnp.asarray(rewards),
                    dones=jnp.asarray(dones), values=jnp.asarray(values),
                    log_probs=z, mu=z, std=z)
    jadv, jret = jax.jit(jppo.compute_gae)(tr, jnp.asarray(last))
    tppo = PPO(nets.ActorCritic(NUM_OBS, NUM_ACT), TrainCfg().algorithm, T, N,
               device="cpu")
    tadv, tret = tppo.compute_gae(torch.from_numpy(values),
                                  torch.from_numpy(rewards),
                                  torch.from_numpy(dones), torch.from_numpy(last))
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), **TOL)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), **TOL)


# ---------------------------------------------------------------------------
# one PPO minibatch step, JAX vs port
# ---------------------------------------------------------------------------


def _batch(params, seed, jppo):
    """A minibatch drawn around the policy's own outputs; ``seed`` 1 moves
    the old policy far away (KL above 2 x desired: the rate goes down),
    ``seed`` 2 keeps it close (KL below desired / 2: the rate goes up)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, NUM_OBS)).astype(np.float32)
    mu, std, value, _ = jppo.net.apply(params, jnp.asarray(obs))
    mu, std, value = (np.asarray(a) for a in (mu, std, value))
    spread = 2.0 if seed == 1 else 0.01
    old_mu = (mu + spread * rng.standard_normal(mu.shape)).astype(np.float32)
    old_std = (std * (1.0 + 0.1 * spread * rng.random(std.shape))).astype(np.float32)
    actions = (old_mu + old_std * rng.standard_normal(mu.shape)).astype(np.float32)
    z = (actions - old_mu) / old_std
    logp = np.sum(-0.5 * z * z - np.log(old_std) - 0.5 * math.log(2 * math.pi), -1)
    adv = rng.standard_normal(B).astype(np.float32)
    return dict(
        obs=obs, critic_obs=obs[:, :0], actions=actions,
        log_probs=logp.astype(np.float32),
        values=(value + 0.3 * rng.standard_normal(B)).astype(np.float32),
        advantages=(adv - adv.mean()) / adv.std(),
        returns=(value + rng.standard_normal(B)).astype(np.float32),
        mu=old_mu, std=old_std,
    )


# the fields the JAX ``PPO._loss`` reads off its minibatch (the port's
# Batch adds a recurrent net's dones and start carry after them)
JaxBatch = collections.namedtuple("JaxBatch", Batch._fields[:Batch._fields.index("dones")])


def _flat_tree(tree):
    return nets.flatten_params(jax.device_get(tree))


def _port_grads(tppo):
    """The port's gradients under their Flax names (kernels as [in, out])."""
    out = {}
    for head in ("actor", "critic"):
        lins = [m for m in getattr(tppo.net, head) if isinstance(m, torch.nn.Linear)]
        for i, lin in enumerate(lins):
            out[f"params/{head}/Dense_{i}/kernel"] = lin.weight.grad.numpy().T.copy()
            out[f"params/{head}/Dense_{i}/bias"] = lin.bias.grad.numpy().copy()
    out["params/log_std"] = tppo.net.log_std.grad.numpy().copy()
    return out


def _set_port_grads(tppo, grads):
    """Write Flax-named gradients into the port's ``.grad``."""
    with torch.no_grad():
        for head in ("actor", "critic"):
            lins = [m for m in getattr(tppo.net, head)
                    if isinstance(m, torch.nn.Linear)]
            for i, lin in enumerate(lins):
                lin.weight.grad.copy_(torch.tensor(
                    grads[f"params/{head}/Dense_{i}/kernel"].T))
                lin.bias.grad.copy_(torch.tensor(
                    grads[f"params/{head}/Dense_{i}/bias"]))
        tppo.net.log_std.grad.copy_(torch.tensor(grads["params/log_std"]))


def _port_params(tppo):
    out = {}
    for head in ("actor", "critic"):
        lins = [m for m in getattr(tppo.net, head) if isinstance(m, torch.nn.Linear)]
        for i, lin in enumerate(lins):
            out[f"params/{head}/Dense_{i}/kernel"] = lin.weight.detach().numpy().T.copy()
            out[f"params/{head}/Dense_{i}/bias"] = lin.bias.detach().numpy().copy()
    out["params/log_std"] = tppo.net.log_std.detach().numpy().copy()
    return out


@pytest.fixture(scope="module")
def minibatch_steps():
    """Two minibatch steps in both packages from the same params; returns
    per step (JAX record, port record) of loss, grads, params, lr."""
    jppo = _jax_ppo()
    params = jppo.net.init(jax.random.PRNGKey(0), jnp.zeros((4, NUM_OBS)))
    tppo = _port_ppo(params)
    opt = jppo.make_optimizer()
    opt_state = opt.init(params)
    lr = jnp.asarray(jppo.cfg.learning_rate, jnp.float32)

    @jax.jit
    def jstep(params, opt_state, lr, batch):
        (loss, aux), grads = jax.value_and_grad(jppo._loss, has_aux=True)(
            params, batch, lr)
        new = jppo._apply_step(opt, params, opt_state, lr, grads, loss, aux[2])
        return loss, aux, grads, new[:3]

    records = []
    for seed in (1, 2):
        bnp = _batch(params, seed, jppo)
        loss, aux, grads, (params, opt_state, lr) = jstep(
            params, opt_state, lr,
            JaxBatch(**{k: jnp.asarray(v) for k, v in bnp.items()}))
        jrec = dict(loss=float(loss), kl=float(aux[2]), grads=_flat_tree(grads),
                    params=_flat_tree(params), lr=float(lr))
        tb = Batch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in bnp.items() if k != "critic_obs"}, critic_obs=None)
        tloss, (_, _, tkl, _) = tppo.loss(tb)
        tppo.optimizer.zero_grad()
        tloss.backward()
        tgrads = _port_grads(tppo)
        _set_port_grads(tppo, jrec["grads"])
        tppo.apply_step(jrec["kl"])
        trec = dict(loss=float(tloss.detach()), kl=float(tkl), grads=tgrads,
                    params=_port_params(tppo), lr=tppo.lr)
        records.append((jrec, trec))
    return records


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("what", ["loss", "grads", "params", "lr"])
def test_minibatch_step_matches_jax(minibatch_steps, step, what):
    jrec, trec = minibatch_steps[step]
    if what == "loss":
        np.testing.assert_allclose(trec["loss"], jrec["loss"], **TOL)
        np.testing.assert_allclose(trec["kl"], jrec["kl"], **TOL)
    elif what == "lr":
        np.testing.assert_allclose(trec["lr"], jrec["lr"], **TOL)
        # the data moves the rate: down after the far batch, up after the
        # near one
        before = 1e-3 if step == 0 else minibatch_steps[0][0]["lr"]
        assert (jrec["lr"] < before) if step == 0 else (jrec["lr"] > before)
        assert LR_MIN <= trec["lr"] <= LR_MAX
    else:
        assert set(trec[what]) == set(jrec[what])
        for k in jrec[what]:
            np.testing.assert_allclose(trec[what][k], jrec[what][k], err_msg=k,
                                       **TOL)


# ---------------------------------------------------------------------------
# initialisation and checkpoints
# ---------------------------------------------------------------------------


def test_lecun_normal_init_statistics():
    tc = TrainCfg()
    tc.policy.init_noise_std = 0.7
    net = nets.build_network(tc.policy, NUM_OBS, NUM_ACT,
                             generator=torch.Generator().manual_seed(0))
    assert net.dtype == tc.policy.dtype
    np.testing.assert_allclose(net.log_std.detach().numpy(), math.log(0.7),
                               rtol=1e-6)
    for lin in [m for m in net.modules() if isinstance(m, torch.nn.Linear)]:
        w = lin.weight.detach().numpy()
        # a unit normal cut at +-2 has std 0.8796, which the scale divides
        # out: the kernel's std is sqrt(1 / fan_in), its range +-2 of the
        # uncut normal's std
        target = math.sqrt(1.0 / lin.in_features)
        assert np.std(w) == pytest.approx(target, rel=0.1 if w.size < 2000 else 0.03)
        assert np.abs(w).max() <= 2.0 * target / 0.87962566103423978 + 1e-7
        assert abs(np.mean(w)) < 0.1 * target
        assert not lin.bias.detach().numpy().any()
    # same generator seed, same network
    again = nets.build_network(tc.policy, NUM_OBS, NUM_ACT,
                               generator=torch.Generator().manual_seed(0))
    for a, b in zip(net.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def flat_env():
    cfg = go2_rough_cfg()
    cfg.env.num_envs = 8
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device="cpu")
    return env


def test_checkpoint_round_trip(flat_env, tmp_path):
    _, tc = task_registry.get_cfgs("go2")
    runner = OnPolicyRunner(flat_env, tc, str(tmp_path))
    b = _batch_for(runner)
    runner.alg.minibatch_step(b)        # fills Adam's moments, moves lr
    runner.current_learning_iteration = 7
    path = os.path.join(str(tmp_path), "model_7.pt")
    runner.save(path)
    with open(path + ".json") as f:
        assert json.load(f)["iteration"] == 7
    fresh = OnPolicyRunner(flat_env, tc, None)
    fresh.load(path)
    assert fresh.current_learning_iteration == 7
    assert fresh.alg.lr == runner.alg.lr
    for a, b_ in zip(runner.net.state_dict().values(), fresh.net.state_dict().values()):
        assert torch.equal(a, b_)
    sa, sb = runner.alg.optimizer.state_dict(), fresh.alg.optimizer.state_dict()
    for k in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
    assert torch.equal(runner.alg.gen.get_state(), fresh.alg.gen.get_state())
    assert helpers.get_load_path(os.path.dirname(str(tmp_path)),
                                 load_run=os.path.basename(str(tmp_path))) == path


def _batch_for(runner):
    g = torch.Generator().manual_seed(0)
    n = 32

    def r(*s):
        return torch.randn(*s, generator=g)

    with torch.no_grad():
        obs = r(n, NUM_OBS)
        mu, std, value = runner.net(obs)
    actions = mu + std * r(n, NUM_ACT)
    return Batch(obs=obs, critic_obs=None, actions=actions,
                 log_probs=nets.log_prob(mu, std, actions), values=value,
                 advantages=r(n), returns=value + r(n), mu=mu, std=std)
