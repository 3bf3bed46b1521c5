"""Port parity for the actor: ``actor_critic_from_flat`` loads the Flax
weights, and the port's deterministic action equals the JAX package's
``ActorCritic.apply(..., method="act")`` and its numpy deploy shim
``NumpyPolicy`` on 64 numpy-seeded observations, within atol 1e-5 (fp32
matmuls summed in another order; TF32 is off in the port)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.export.export import _flatten_params, load_flat_params
from unitree_rl_gym_tpu.export.numpy_policy import NumpyPolicy
from unitree_rl_gym_tpu.models.networks import ActorCritic as JaxActorCritic
from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.models.networks import (
    actor_critic_from_flat, load_flat_policy,
)
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

PATH = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train", "go2")


@pytest.fixture(scope="module")
def obs():
    return np.random.default_rng(0).standard_normal((64, 48)).astype(np.float32)


@pytest.fixture(scope="module")
def flat():
    with open(os.path.join(PATH, "policy_meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(PATH, "policy_flat.npz")) as z:
        return dict(z), meta


def _port_act(net, obs):
    with torch.no_grad():
        return net.act(torch.from_numpy(obs)).numpy()


def test_pretrained_matches_numpy_policy(flat, obs):
    arrays, meta = flat
    got = _port_act(actor_critic_from_flat(arrays, meta), obs)
    np.testing.assert_allclose(got, NumpyPolicy(PATH)(obs), atol=1e-5)


def test_pretrained_matches_jax_apply(flat, obs):
    arrays, meta = flat
    net = JaxActorCritic(num_actions=meta["num_actions"],
                         actor_hidden_dims=tuple(meta["actor_hidden_dims"]))
    want, _ = net.apply(load_flat_params(PATH), obs, method="act")
    got = _port_act(load_flat_policy(PATH, "cpu"), obs)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_live_jax_params_round_trip(obs):
    """Freshly initialised JAX params, flattened to the exporter's names,
    drive the whole actor-critic: action mean, std and value."""
    net = JaxActorCritic(num_actions=12, actor_hidden_dims=(64, 32),
                         critic_hidden_dims=(48, 16), init_noise_std=0.7)
    params = net.init(jax.random.PRNGKey(3), obs[:1])
    mu, std, value, _ = net.apply(params, obs)
    port = actor_critic_from_flat(_flatten_params(params),
                                  {"activation": "elu", "is_recurrent": False})
    with torch.no_grad():
        tmu, tstd, tvalue = port(torch.from_numpy(obs))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=1e-5)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(std), atol=1e-6)
    np.testing.assert_allclose(tvalue.numpy(), np.asarray(value), atol=1e-5)


def test_recurrent_policy_raises(flat):
    """MLP arrays under ``is_recurrent=True`` name the LSTM weights they
    lack (the LSTM artifacts load in test_torch_policy_lstm.py)."""
    arrays, meta = flat
    with pytest.raises(ValueError, match="memory_a"):
        actor_critic_from_flat(arrays, dict(meta, is_recurrent=True))
