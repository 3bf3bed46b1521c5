"""Module 5's activations: the port's ``ActorCritic`` and
``ActorCriticRecurrent`` with each activation of the JAX package's table
(elu, relu, selu, crelu, lrelu, tanh, sigmoid; Flax's constants) hold
against JAX ``apply`` with the same params (one JAX init of each net per
activation, mapped by ``actor_critic_from_flat``), at atol 1e-6 in float32
(small layers: matmul sums in another order). crelu doubles the width each
next layer takes, in Flax's params and in the port's. ``flat_from_actor_critic``
gives the JAX params back bit for bit. Both exporters refuse what the JAX
exporter refuses: its TorchScript table has no crelu (a KeyError after the
npz, meta and ``policy.bin``, which match byte for byte), and its numpy
runtime only elu, relu, tanh and sigmoid."""

import types

import jax
import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.export import export as jexport
from unitree_rl_gym_tpu.export.numpy_policy import NumpyPolicy as JaxNumpyPolicy
from unitree_rl_gym_tpu.models import networks as jnets
from unitree_rl_gym_tpu_torch.export import export as texport
from unitree_rl_gym_tpu_torch.export.numpy_policy import NumpyPolicy
from unitree_rl_gym_tpu_torch.models import networks as nets
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

ACTS = ("elu", "relu", "selu", "crelu", "lrelu", "tanh", "sigmoid")
N_OBS, N_COBS, N_ACT, B = 10, 13, 4, 16
MLP_DIMS, MLP_CRITIC_DIMS = (24, 16), (20,)
RNN_DIMS, RNN_CRITIC_DIMS, HIDDEN = (12,), (10,), 8
ATOL = 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, N_OBS)).astype(np.float32),
            rng.standard_normal((B, N_COBS)).astype(np.float32),
            rng.standard_normal((2, 1, 2, B, HIDDEN)).astype(np.float32))


@pytest.fixture(scope="module", params=ACTS)
def nets_of(request, data):
    """One JAX init of each actor-critic for the activation, and the port's
    nets holding those params."""
    act = request.param
    obs, cobs, _ = data
    mlp = jnets.ActorCritic(num_actions=N_ACT, actor_hidden_dims=MLP_DIMS,
                            critic_hidden_dims=MLP_CRITIC_DIMS, activation=act,
                            init_noise_std=0.7)
    rnn = jnets.ActorCriticRecurrent(num_actions=N_ACT, actor_hidden_dims=RNN_DIMS,
                                     critic_hidden_dims=RNN_CRITIC_DIMS,
                                     activation=act, rnn_hidden_size=HIDDEN)
    key = jax.random.PRNGKey(ACTS.index(act))
    p_mlp = mlp.init(key, obs, cobs)
    p_rnn = rnn.init(key, obs, cobs, rnn.initial_carry(B))
    meta = {"activation": act}
    return types.SimpleNamespace(
        act=act, mlp=mlp, rnn=rnn, p_mlp=p_mlp, p_rnn=p_rnn,
        t_mlp=nets.actor_critic_from_flat(jexport._flatten_params(p_mlp), meta),
        t_rnn=nets.actor_critic_from_flat(jexport._flatten_params(p_rnn),
                                          dict(meta, is_recurrent=True)))


def carry_to_jax(c):
    """The port's carry [2, L, 2, N, H] as the JAX ((actor layers), (critic
    layers)), each layer (c, h)."""
    return tuple(tuple((c[m, l, 0], c[m, l, 1]) for l in range(c.shape[1]))
                 for m in range(2))


def carry_from_jax(carry):
    return np.stack([np.stack([np.stack([np.asarray(c), np.asarray(h)])
                               for c, h in mem]) for mem in carry])


def test_actor_critic_matches_jax(nets_of, data):
    obs, cobs, _ = data
    mu, std, value, _ = nets_of.mlp.apply(nets_of.p_mlp, obs, cobs)
    with torch.no_grad():
        tmu, tstd, tvalue = nets_of.t_mlp(torch.from_numpy(obs), torch.from_numpy(cobs))
        tact = nets_of.t_mlp.act(torch.from_numpy(obs))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tact.numpy(), np.asarray(mu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(std), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tvalue.numpy(), np.asarray(value), rtol=0, atol=ATOL)


def test_recurrent_matches_jax(nets_of, data):
    obs, cobs, carry = data
    mu, std, value, jcarry = nets_of.rnn.apply(nets_of.p_rnn, obs, cobs,
                                               carry_to_jax(carry))
    a_mu, a_carry = nets_of.rnn.apply(nets_of.p_rnn, obs, carry_to_jax(carry),
                                      method=nets_of.rnn.act)
    with torch.no_grad():
        tmu, tstd, tvalue, tcarry = nets_of.t_rnn(
            torch.from_numpy(obs), torch.from_numpy(cobs), torch.from_numpy(carry))
        ta_mu, ta_carry = nets_of.t_rnn.act(torch.from_numpy(obs), torch.from_numpy(carry))
    for got, want in ((tmu, mu), (tstd, std), (tvalue, value), (ta_mu, a_mu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tcarry.numpy(), carry_from_jax(jcarry), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ta_carry.numpy(), carry_from_jax(a_carry), rtol=0, atol=ATOL)


def test_flat_round_trip(nets_of):
    """The port's params under their Flax names are the JAX params, bit for
    bit, crelu's doubled input widths included."""
    width = 2 if nets_of.act == "crelu" else 1
    for params, net, hidden in ((nets_of.p_mlp, nets_of.t_mlp, MLP_DIMS),
                                (nets_of.p_rnn, nets_of.t_rnn, RNN_DIMS)):
        want = jexport._flatten_params(params)
        got = nets.flat_from_actor_critic(net)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got["params/actor/Dense_1/kernel"].shape[0] == width * hidden[0]


def _runners(nets_of):
    """JAX and port stand-ins for a runner as the exporters read it."""
    pc = types.SimpleNamespace(actor_hidden_dims=list(MLP_DIMS), activation=nets_of.act,
                               rnn_hidden_size=512, rnn_num_layers=1)
    cfg = types.SimpleNamespace(policy=pc, runner=types.SimpleNamespace(
        policy_class_name="ActorCritic"))
    env = types.SimpleNamespace(num_obs=N_OBS, num_actions=N_ACT)
    jax_runner = types.SimpleNamespace(
        cfg=cfg, env=env, net=nets_of.mlp,
        train_state=types.SimpleNamespace(params=nets_of.p_mlp))
    return jax_runner, types.SimpleNamespace(cfg=cfg, env=env, net=nets_of.t_mlp)


def test_exporters_refuse_alike(nets_of, data, tmp_path):
    jax_runner, port_runner = _runners(nets_of)
    outcomes = []
    for export, runner, d in ((jexport.export_policy, jax_runner, tmp_path / "jax"),
                              (texport.export_policy, port_runner, tmp_path / "port")):
        try:
            export(runner, str(d))
            outcomes.append(None)
        except KeyError as e:
            outcomes.append(e.args)
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == (nets_of.act == "crelu")
    assert (tmp_path / "port" / "policy.bin").read_bytes() == (
        tmp_path / "jax" / "policy.bin").read_bytes()
    with np.load(tmp_path / "jax" / "policy_flat.npz") as a, \
            np.load(tmp_path / "port" / "policy_flat.npz") as b:
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    obs = data[0]
    if outcomes[0] is None:
        with torch.no_grad():
            want = torch.jit.load(str(tmp_path / "jax" / "policy_1.pt"))(torch.from_numpy(obs))
            got = torch.jit.load(str(tmp_path / "port" / "policy_1.pt"))(torch.from_numpy(obs))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    # the numpy runtimes: the same table (elu, relu, tanh, sigmoid)
    results = []
    for policy in (JaxNumpyPolicy, NumpyPolicy):
        try:
            results.append(policy(str(tmp_path / "port"))(obs))
        except KeyError as e:
            results.append(e.args)
    if isinstance(results[0], tuple):
        assert results[1] == results[0]
        assert nets_of.act in ("selu", "crelu", "lrelu")
    else:
        np.testing.assert_allclose(results[1], results[0], rtol=0, atol=ATOL)


def test_mlp_refuses_unknown_activation():
    with pytest.raises(ValueError, match="softplus"):
        nets.mlp(4, (8,), 2, "softplus")
