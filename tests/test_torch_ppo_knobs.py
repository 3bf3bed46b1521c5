"""Port parity and checks of PPO's task knobs (``AlgorithmCfg``) and the
fine-tune's weight loader, on the CPU:

  * the loss of one minibatch with class re-weighting
    (``class_target_frac`` 0.5) and the anchor KL (``anchor_kl_coef`` 0.3)
    under the go2 handstand's class and mask functions (g_z above
    -0.8 and above 0, column 5 of the 46-dim obs), against the JAX
    ``PPO._loss`` from the same params, anchor params and batch: the loss,
    the surrogate, value and KL stats, the anchor loss (the JAX loss with
    the anchor minus the JAX loss without it, over the coefficient) and
    every gradient, at atol 1e-5 / rtol 1e-4 in float32;
  * the class weights: mean one, capped, one-sided;
  * ``nan_guard`` (built with ``nan_guard=True`` explicitly, its default
    being off): a minibatch with a NaN leaves the parameters, Adam's
    moments and step count, and the learning rate unchanged, and an update
    counts its skipped minibatches and keeps its stats finite;
  * the anchor: a frozen copy that the update does not move;
  * ``load_flat_params``: the full train params of the shipped
    go2_handstand ``policy_flat.npz`` into a network, as the JAX
    package's ``export.load_flat_params`` reads them.

JAX compiles one program (the loss and its gradient)."""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo import JaxBatch, _flat_tree, _port_grads
from unitree_rl_gym_tpu.envs.go2_handstand import GO2HandstandEnv as JaxHandstand
from unitree_rl_gym_tpu.envs.go2_handstand import go2_handstand_cfg as jax_handstand_cfg
from unitree_rl_gym_tpu.export.export import load_flat_params as jax_load_flat
from unitree_rl_gym_tpu.models import networks as jnets
from unitree_rl_gym_tpu.rl.ppo import PPO as JaxPPO
from unitree_rl_gym_tpu.utils.config import TrainCfg as JaxTrainCfg
from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs.go2_handstand import (
    GO2HandstandEnv, go2_handstand_cfg,
)
from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.rl.ppo import PPO, Batch
from unitree_rl_gym_tpu_torch.utils.config import TrainCfg

TOL = dict(atol=1e-5, rtol=1e-4)
NUM_OBS, NUM_ACT = 46, 12
B = 64
GZ_THRESHOLD = -0.8      # the r5 entry work's class threshold


def _knob_cfg(cfg):
    cfg.class_target_frac = 0.5
    cfg.anchor_kl_coef = 0.3
    return cfg


def _task(cfg):
    """A stand-in for the env whose class and mask methods are called: it
    carries the handstand cfg with the class threshold set."""
    cfg.init_state.handstand_class_gz_threshold = GZ_THRESHOLD
    return types.SimpleNamespace(cfg=cfg)


def _jax_ppo():
    tc = JaxTrainCfg()
    tc.policy.dtype = "float32"
    tc.policy._class_name = "ActorCritic"
    net = jnets.build_network(tc.policy, NUM_ACT)
    task = _task(jax_handstand_cfg())
    return JaxPPO(
        net=net, cfg=_knob_cfg(tc.algorithm), num_steps=3, num_envs=4,
        state_class_fn=lambda o: JaxHandstand.ppo_state_class_fn(task, o),
        anchor_mask_fn=lambda o: JaxHandstand.ppo_anchor_mask_fn(task, o),
    )


def _port_ppo(params):
    net = nets.actor_critic_from_params(jax.device_get(params), dtype="float32")
    task = _task(go2_handstand_cfg())
    return PPO(
        net, _knob_cfg(TrainCfg().algorithm), num_steps=3, num_envs=4,
        device="cpu",
        state_class_fn=lambda o: GO2HandstandEnv.ppo_state_class_fn(task, o),
        anchor_mask_fn=lambda o: GO2HandstandEnv.ppo_anchor_mask_fn(task, o),
    )


def _batch(params, jppo, seed=1):
    """A minibatch around the policy's outputs whose g_z column puts 20% of
    the samples in class 1 (g_z > -0.8) and 10% in the anchor mask
    (g_z > 0): below the 50% target, so the weights move."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, NUM_OBS)).astype(np.float32)
    gz = np.full(B, -0.95, np.float32)
    gz[: B // 10] = 0.3
    gz[B // 10: B // 5] = -0.5
    obs[:, 5] = rng.permutation(gz)
    mu, std, value, _ = jppo.net.apply(params, jnp.asarray(obs), jnp.asarray(obs))
    mu, std, value = (np.asarray(a) for a in (mu, std, value))
    old_mu = (mu + 0.3 * rng.standard_normal(mu.shape)).astype(np.float32)
    old_std = (std * (1.0 + 0.05 * rng.random(std.shape))).astype(np.float32)
    actions = (old_mu + old_std * rng.standard_normal(mu.shape)).astype(np.float32)
    z = (actions - old_mu) / old_std
    logp = np.sum(-0.5 * z * z - np.log(old_std) - 0.5 * math.log(2 * math.pi), -1)
    adv = rng.standard_normal(B).astype(np.float32)
    return dict(
        obs=obs, critic_obs=obs, actions=actions, log_probs=logp.astype(np.float32),
        values=(value + 0.3 * rng.standard_normal(B)).astype(np.float32),
        advantages=(adv - adv.mean()) / adv.std(),
        returns=(value + rng.standard_normal(B)).astype(np.float32),
        mu=old_mu, std=old_std,
    )


def _perturbed(params, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + scale * jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        params)


@pytest.fixture(scope="module")
def knob_losses():
    """(JAX record, port record) of one minibatch's loss, stats and
    gradients with class weights and the anchor KL."""
    jppo = _jax_ppo()
    params = jppo.net.init(jax.random.PRNGKey(0), jnp.zeros((4, NUM_OBS)),
                           jnp.zeros((4, NUM_OBS)))
    anchor = _perturbed(params, 0.02, seed=3)
    bnp = _batch(params, jppo)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in bnp.items()})

    @jax.jit
    def jloss(params, anchor_params, batch):
        (loss, aux), grads = jax.value_and_grad(jppo._loss, has_aux=True)(
            params, batch, None, None, None, anchor_params)
        plain, _ = jppo._loss(params, batch, None, None, None, None)
        return loss, aux, grads, plain

    loss, aux, grads, plain = jloss(params, anchor, jb)
    jrec = dict(loss=float(loss), surrogate=float(aux[0]), value=float(aux[1]),
                kl=float(aux[2]), grads=_flat_tree(grads),
                anchor=(float(loss) - float(plain)) / jppo.cfg.anchor_kl_coef)
    tppo = _port_ppo(params)
    anchor_sd = nets.actor_critic_from_params(jax.device_get(anchor)).state_dict()
    tppo.set_anchor(anchor_sd)
    tb = Batch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in bnp.items()})
    tloss, (sl, vl, kl, al) = tppo.loss(tb)
    tppo.optimizer.zero_grad()
    tloss.backward()
    trec = dict(loss=float(tloss.detach()), surrogate=float(sl), value=float(vl),
                kl=float(kl), anchor=float(al), grads=_port_grads(tppo))
    return jrec, trec, tppo, tb


@pytest.mark.parametrize("what", ["loss", "surrogate", "value", "kl", "anchor"])
def test_knob_loss_matches_jax(knob_losses, what):
    jrec, trec, _, _ = knob_losses
    np.testing.assert_allclose(trec[what], jrec[what], **TOL)
    if what == "anchor":
        assert trec[what] > 1e-4     # the anchor differs from the policy


def test_knob_grads_match_jax(knob_losses):
    jrec, trec, _, _ = knob_losses
    assert set(trec["grads"]) == set(jrec["grads"])
    for k in jrec["grads"]:
        np.testing.assert_allclose(trec["grads"][k], jrec["grads"][k],
                                   err_msg=k, **TOL)


def test_class_weights(knob_losses):
    _, _, tppo, tb = knob_losses
    w = tppo._class_weights(tb.obs)
    c = tb.obs[:, 5] > GZ_THRESHOLD
    assert float(w.mean()) == pytest.approx(1.0, rel=1e-6)
    # class 1 (20% of the samples) weighted up to half of the loss mass
    assert float(w[c].sum() / w.sum()) == pytest.approx(0.5, rel=1e-4)
    # one-sided: a batch already above the target keeps weights of 1
    up = tb.obs.clone()
    up[:, 5] = 0.5
    assert torch.equal(tppo._class_weights(up), torch.ones(B))
    # capped: one class-1 sample in the batch gets at most the cap
    one = tb.obs.clone()
    one[:, 5] = -0.95
    one[0, 5] = 0.5
    w1 = tppo._class_weights(one)
    cap = tppo.cfg.class_weight_cap
    w0 = (1.0 - 0.5) / (1.0 - 1.0 / B + 1e-6)
    expect = cap / ((cap + (B - 1) * w0) / B)
    assert float(w1[0]) == pytest.approx(expect, rel=1e-5)


def _optimizer_state(ppo):
    st = ppo.optimizer.state_dict()["state"]
    return {k: {n: t.clone() for n, t in v.items()} for k, v in st.items()}


@pytest.fixture
def guarded(knob_losses):
    """A nan-guarded port PPO (nan_guard=True set explicitly) after one good
    minibatch step, and its batch."""
    _, _, tppo, tb = knob_losses
    cfg = TrainCfg().algorithm
    assert cfg.nan_guard is False        # the default is off
    params = {k: v.detach().clone() for k, v in tppo.net.state_dict().items()}
    net = nets.ActorCritic(NUM_OBS, NUM_ACT)
    net.load_state_dict(params)
    cfg.nan_guard = True
    ppo = PPO(net, _knob_cfg(cfg), num_steps=4, num_envs=16, device="cpu",
              state_class_fn=tppo.state_class_fn)
    (_, _, _, _), skipped = ppo.minibatch_step(tb)
    assert not skipped
    return ppo, tb


def test_nan_guard_skips_nonfinite_minibatch(guarded):
    ppo, tb = guarded
    params = {k: v.clone() for k, v in ppo.net.state_dict().items()}
    opt = _optimizer_state(ppo)
    lr = ppo.lr
    adv = tb.advantages.clone()
    adv[3] = float("nan")
    stats, skipped = ppo.minibatch_step(tb._replace(advantages=adv))
    assert skipped
    assert all(float(x) == 0.0 for x in stats)
    for k, v in ppo.net.state_dict().items():
        assert torch.equal(v, params[k]), k
    after = _optimizer_state(ppo)
    for k in opt:
        for n in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(after[k][n], opt[k][n]), (k, n)
    assert ppo.lr == lr
    # a finite minibatch after it is applied again
    _, skipped = ppo.minibatch_step(tb)
    assert not skipped
    assert not torch.equal(ppo.net.log_std, params["log_std"])


def test_update_counts_skipped_minibatches(guarded):
    """An update over T*N samples with one NaN advantage skips the one
    minibatch per epoch that holds it (5 of 20) and keeps its means over
    the applied ones finite."""
    ppo, tb = guarded
    T, N = ppo.num_steps, ppo.num_envs
    g = torch.Generator().manual_seed(0)
    obs = tb.obs.reshape(T, N, NUM_OBS)
    with torch.no_grad():
        mu, std, value = ppo.net(obs)
    actions = mu + std * torch.randn(mu.shape, generator=g)
    tr = Batch(obs=obs, critic_obs=None, actions=actions,
               log_probs=nets.log_prob(mu, std, actions), values=value,
               advantages=None, returns=None, mu=mu, std=std)
    adv = torch.randn(T, N, generator=g)
    adv[1, 2] = float("nan")
    metrics = ppo.update(tr, adv, value + torch.randn(T, N, generator=g))
    assert metrics["nonfinite_steps"] == ppo.cfg.num_learning_epochs
    for k in ("surrogate_loss", "value_loss", "kl", "anchor_loss"):
        assert math.isfinite(float(metrics[k])), k
    assert all(bool(torch.isfinite(p).all()) for p in ppo.net.parameters())


def test_anchor_is_a_frozen_copy(knob_losses):
    _, _, tppo, tb = knob_losses
    ppo = PPO(nets.ActorCritic(NUM_OBS, NUM_ACT), TrainCfg().algorithm,
              num_steps=4, num_envs=16, device="cpu")
    ppo.set_anchor()
    for (k, a), b in zip(ppo.anchor.state_dict().items(),
                         ppo.net.state_dict().values()):
        assert torch.equal(a, b), k
    assert not any(p.requires_grad for p in ppo.anchor.parameters())
    before = {k: v.clone() for k, v in ppo.anchor.state_dict().items()}
    ppo.minibatch_step(tb)
    for k, v in ppo.anchor.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(ppo.net.log_std, ppo.anchor.log_std)


def test_load_flat_params_matches_jax_loader():
    path = resource("resources/pre_train/go2_handstand")
    net = nets.ActorCritic(NUM_OBS, NUM_ACT, init_noise_std=0.5,
                           num_critic_obs=NUM_OBS, dtype="bfloat16")
    nets.load_flat_params(net, path)
    ref = nets.flatten_params(jax_load_flat(path))
    got = nets.flatten_params({"params": {
        head: {f"Dense_{i}": {"kernel": lin.weight.detach().numpy().T,
                              "bias": lin.bias.detach().numpy()}
               for i, lin in enumerate(m for m in getattr(net, head)
                                       if isinstance(m, torch.nn.Linear))}
        for head in ("actor", "critic")} | {"log_std": net.log_std.detach().numpy()}})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # a network of other widths does not take them
    with pytest.raises(ValueError, match="do not fit"):
        nets.load_flat_params(nets.ActorCritic(48, NUM_ACT), path)
