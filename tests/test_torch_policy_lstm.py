"""Port parity of the LSTM actor-critic (``models/networks.py``:
``ActorCriticRecurrent``, ``LSTMCell``, ``reset_carry``, the recurrent
``actor_critic_from_flat``) against the JAX package's Flax
``ActorCriticRecurrent``.

The shipped ``resources/pre_train/{g1,h1}/policy_flat.npz`` (h1's obs is 41
wide, g1's 47; privileged obs 44 and 50) drive both packages over a
24-step sequence of numpy-seeded observations with an injected ``done``
pattern (each step's carry reset with ``reset_carry``): the action mean,
std, value and carry of ``apply``, and the action mean and carry of
``act``, at atol 1e-5 / rtol 1e-4. A network built from scratch has Flax's
parameter shapes and init distributions: lecun-normal input and head
kernels (std sqrt(1/fan_in), cut at two of the draw's stds), an
orthogonal recurrent kernel per gate, zero biases, log-std
log(init_noise_std)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.export.export import load_flat_params as jax_load_flat
from unitree_rl_gym_tpu.models import networks as jnets
from unitree_rl_gym_tpu.utils.config import TrainCfg as JaxTrainCfg
from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.models import networks as nets
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

T = 24
B = 16
TOL = dict(atol=1e-5, rtol=1e-4)


def artifact(task):
    path = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train", task)
    with open(os.path.join(path, "policy_meta.json")) as f:
        return path, json.load(f)


def carry_to_jax(carry):
    """The port's carry [2, L, 2, N, H] as the JAX package's ((actor
    layers), (critic layers)), each layer (c, h)."""
    c = carry.numpy()
    return tuple(tuple((jnp.asarray(c[m, l, 0]), jnp.asarray(c[m, l, 1]))
                       for l in range(c.shape[1])) for m in range(2))


def carry_from_jax(carry):
    return np.stack([np.stack([np.stack([np.asarray(c), np.asarray(h)])
                               for c, h in mem]) for mem in carry])


@pytest.fixture(scope="module", params=["g1", "h1"])
def sequences(request):
    """{what: (JAX values, port values)} over T steps of one artifact."""
    path, meta = artifact(request.param)
    net = jnets.ActorCriticRecurrent(
        num_actions=meta["num_actions"],
        actor_hidden_dims=tuple(meta["actor_hidden_dims"]),
        rnn_hidden_size=meta["rnn_hidden_size"],
        rnn_num_layers=meta["rnn_num_layers"], dtype="float32")
    params = jax_load_flat(path)
    port = nets.load_flat_policy(path, "cpu")
    n_obs = meta["num_obs"]
    n_cobs = port.memory_c.cells[0].weight_ih.shape[1]
    assert n_cobs == n_obs + 3
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((T, B, n_obs)).astype(np.float32)
    cobs = rng.standard_normal((T, B, n_cobs)).astype(np.float32)
    dones = rng.random((T, B)) < 0.15
    dones[3, :4] = True                  # the same envs twice in a row
    dones[4, :2] = True

    @jax.jit
    def jstep(carry, o, co, d):
        mu, std, value, carry = net.apply(params, o, co, carry)
        a_mu, a_carry = net.apply(params, o, carry, method=net.act)
        return mu, std, value, a_mu, carry, a_carry, jnets.reset_carry(carry, d)

    out = {k: ([], []) for k in ("mu", "std", "value", "act", "carry", "act_carry",
                                 "reset_carry")}
    jcarry = net.initial_carry(B)
    tcarry = port.initial_carry(B)
    np.testing.assert_array_equal(carry_from_jax(jcarry), tcarry.numpy())
    with torch.no_grad():
        for t in range(T):
            mu, std, value, a_mu, carry, a_carry, jcarry = jstep(
                jcarry, obs[t], cobs[t], dones[t])
            tmu, tstd, tvalue, tc = port(torch.from_numpy(obs[t]),
                                         torch.from_numpy(cobs[t]), tcarry)
            ta_mu, ta_c = port.act(torch.from_numpy(obs[t]), tc)
            for k, j, p in (("mu", mu, tmu), ("std", std, tstd),
                            ("value", value, tvalue), ("act", a_mu, ta_mu)):
                out[k][0].append(np.asarray(j))
                out[k][1].append(p.numpy())
            out["carry"][0].append(carry_from_jax(carry))
            out["carry"][1].append(tc.numpy())
            out["act_carry"][0].append(carry_from_jax(a_carry))
            out["act_carry"][1].append(ta_c.numpy())
            tcarry = nets.reset_carry(tc, torch.from_numpy(dones[t]))
            out["reset_carry"][0].append(carry_from_jax(jcarry))
            out["reset_carry"][1].append(tcarry.numpy())
    return out, dones


@pytest.mark.parametrize("what", ["mu", "std", "value", "act", "carry", "act_carry",
                                  "reset_carry"])
def test_pretrained_lstm_matches_jax(sequences, what):
    out, _ = sequences
    j, t = (np.stack(x) for x in out[what])
    np.testing.assert_allclose(t, j, **TOL)


def test_done_pattern_resets_the_carry(sequences):
    """``reset_carry`` zeroes exactly the done envs' carry (both memories,
    c and h) and leaves the others' bits; the pattern resets some envs
    twice in a row."""
    out, dones = sequences
    before = np.stack(out["carry"][1])               # [T, 2, L, 2, B, H]
    after = np.stack(out["reset_carry"][1])
    assert (dones[3] & dones[4]).any()
    for t in range(T):
        d = dones[t]
        assert (after[t][..., d, :] == 0).all()
        np.testing.assert_array_equal(after[t][..., ~d, :], before[t][..., ~d, :])
        assert np.abs(before[t][..., d, :]).max(initial=1.0) > 0


def test_act_leaves_the_critic_carry(sequences):
    """``act`` (run on the forward's carry) advances the actor's memory and
    returns the critic's as it was given."""
    out, _ = sequences
    for c, a in zip(*(np.stack(x) for x in (out["carry"][1], out["act_carry"][1]))):
        np.testing.assert_array_equal(a[1], c[1])
        assert not np.array_equal(a[0], c[0])


# ---------------------------------------------------------------------------
# from scratch: Flax's shapes and init distributions
# ---------------------------------------------------------------------------


def _lecun_std(fan_in):
    return np.sqrt(1.0 / fan_in)


@pytest.fixture(scope="module")
def scratch_nets():
    """(JAX flat params, port network) of g1's policy cfg, built from scratch."""
    _, tcfg = task_registry.get_cfgs("g1")
    pc = tcfg.policy
    pc._class_name = tcfg.runner.policy_class_name
    port = nets.build_network(pc, 47, 12, num_critic_obs=50,
                              generator=torch.Generator().manual_seed(0))
    jpc = JaxTrainCfg().policy
    for k in ("init_noise_std", "actor_hidden_dims", "critic_hidden_dims",
              "activation", "rnn_hidden_size", "rnn_num_layers"):
        setattr(jpc, k, getattr(pc, k))
    jpc._class_name = "ActorCriticRecurrent"
    jnet = jnets.build_network(jpc, 12)
    carry = jnet.initial_carry(2)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, 47)),
                       jnp.zeros((2, 50)), carry)
    return nets.flatten_params(params), port


def test_scratch_shapes_match_flax(scratch_nets):
    """Every Flax array has its port parameter, with the mapped shape,
    and the port has no other parameter."""
    flat, port = scratch_nets
    assert isinstance(port, nets.ActorCriticRecurrent)
    loaded = nets.actor_critic_from_flat(flat, {"is_recurrent": True})
    assert {k: tuple(v.shape) for k, v in loaded.state_dict().items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    n_flax = sum(int(np.prod(v.shape)) for v in flat.values())
    assert n_flax == sum(p.numel() for p in port.parameters())


def _rel_tol(arrays):
    """Four standard errors of a sample std over the arrays' draws."""
    return 4.0 / np.sqrt(2.0 * sum(w.size for w in arrays))


def _stats(kind, flax_arrays, port_arrays):
    """(flax, port) statistics of one kind of parameter."""
    out = []
    for arrays in (flax_arrays, port_arrays):
        if kind == "orthogonal":
            # each gate kernel [H, H] times its transpose is the identity
            out.append(max(float(np.abs(w @ w.T - np.eye(w.shape[0])).max())
                           for w in arrays))
        elif kind == "zero":
            out.append(max(float(np.abs(w).max()) for w in arrays))
        else:   # lecun: std relative to sqrt(1/fan_in), and the cut
            fan = kind
            std = np.concatenate([w.ravel() for w in arrays]).std() / _lecun_std(fan)
            cut = max(float(np.abs(w).max()) for w in arrays) / (
                2 * _lecun_std(fan) / 0.87962566)
            out.append((std, cut))
    return out


@pytest.mark.parametrize("part", ["input_kernels", "recurrent_kernels",
                                  "head_kernels", "biases", "log_std"])
def test_scratch_init_matches_flax(scratch_nets, part):
    flat, port = scratch_nets
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    gates = ("i", "f", "g", "o")
    if part == "input_kernels":
        for mem, fan in (("memory_a", 47), ("memory_c", 50)):
            fl = [flat[f"params/{mem}/lstm_0/i{g}/kernel"] for g in gates]
            (f_std, f_cut), (p_std, p_cut) = _stats(
                fan, fl, [sd[f"{mem}.cells.0.weight_ih"]])
            tol = _rel_tol(fl)
            assert abs(f_std - 1) < tol and abs(p_std - 1) < tol, (f_std, p_std)
            assert f_cut <= 1.0 + 1e-6 and p_cut <= 1.0 + 1e-6
    elif part == "recurrent_kernels":
        for mem in ("memory_a", "memory_c"):
            fl = [flat[f"params/{mem}/lstm_0/h{g}/kernel"] for g in gates]
            pw = list(np.split(sd[f"{mem}.cells.0.weight_hh"], 4))
            f_err, p_err = _stats("orthogonal", fl, pw)
            assert f_err < 1e-5 and p_err < 1e-5, (f_err, p_err)
    elif part == "head_kernels":
        for head in ("actor", "critic"):
            for i, fan in ((0, 64), (1, 32)):
                fl = [flat[f"params/{head}/Dense_{i}/kernel"]]
                (f_std, f_cut), (p_std, p_cut) = _stats(
                    fan, fl, [sd[f"{head}.{2 * i}.weight"]])
                tol = _rel_tol(fl)
                assert abs(f_std - 1) < tol and abs(p_std - 1) < tol, (f_std, p_std)
                assert f_cut <= 1.0 + 1e-6 and p_cut <= 1.0 + 1e-6
    elif part == "biases":
        fl = [v for k, v in flat.items() if k.endswith("bias")]
        pb = [v for k, v in sd.items() if "bias" in k]
        assert len(pb) == len(fl) - 6      # Flax's four hidden-gate biases are one
        assert _stats("zero", fl, pb) == [0.0, 0.0]
    else:
        np.testing.assert_allclose(sd["log_std"], flat["params/log_std"], rtol=1e-6)
        np.testing.assert_allclose(sd["log_std"], np.log(0.8), rtol=1e-6)
