"""The port's export (module 10) against the JAX exporter and the shipped
artifacts, with no JAX program compiled.

For go2 and go2_handstand (MLP) and g1 and h1_2 (LSTM), the shipped
``resources/pre_train/<task>/policy_flat.npz`` goes into the port's network
and out through ``export.export_policy``; the JAX exporter runs on the same
params, loaded by its own ``load_flat_params`` into a ``SimpleNamespace``
runner (``jax.tree_util`` alone, no compile). The npz keys, their order and
arrays, ``policy_meta.json`` and ``policy.bin`` must equal both the shipped
files and the JAX exporter's, byte for byte where they are bytes; the
TorchScript state dicts equal tensor for tensor; the TorchScript outputs
within 1e-5 (MLP) and 1e-4 (LSTM) of the port's float32 inference policy and
within 1e-6 of the JAX TorchScript's. ``flat_from_actor_critic`` round-trips
bit for bit.

A JAX ``model_<it>.ckpt``, written with the JAX runner's payload layout
(``flax.serialization.to_bytes`` of params, optax's chain state, lr, key
and iteration), loads into the port's runner, and ``get_load_path`` finds
it; ``scripts/play.py`` resumes a port checkpoint and exports it.
"""

import filecmp
import json
import os
import types

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from unitree_rl_gym_tpu.envs.registry import task_registry as jax_registry
from unitree_rl_gym_tpu.export import export as jexport
from unitree_rl_gym_tpu_torch import resource
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.export import export
from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
from unitree_rl_gym_tpu_torch.scripts import play
from unitree_rl_gym_tpu_torch.utils import helpers
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

TASKS = ["go2", "go2_handstand", "g1", "h1_2"]
MLP_ATOL, LSTM_ATOL, JAX_TS_ATOL = 1e-5, 1e-4, 1e-6
LSTM_STEPS = 5


def shipped(task):
    d = resource(f"resources/pre_train/{task}")
    with open(os.path.join(d, "policy_meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "policy_flat.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return d, meta, arrays


def npz(path):
    with np.load(os.path.join(path, "policy_flat.npz")) as z:
        return {k: z[k] for k in z.files}


def ts_name(meta):
    return "policy_lstm_1.pt" if meta["is_recurrent"] else "policy_1.pt"


def assert_same_arrays(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("task", TASKS)
def test_export_matches_jax_and_shipped(task, tmp_path):
    d, meta, arrays = shipped(task)
    net = nets.actor_critic_from_flat(arrays, meta)
    _, train_cfg = task_registry.get_cfgs(task)
    env = types.SimpleNamespace(num_obs=meta["num_obs"], num_actions=meta["num_actions"])
    runner = types.SimpleNamespace(net=net, cfg=train_cfg, env=env)
    port_meta = export.export_policy(runner, str(tmp_path / "port"))

    _, jax_train_cfg = jax_registry.get_cfgs(task)
    jax_runner = types.SimpleNamespace(
        train_state=types.SimpleNamespace(params=jexport.load_flat_params(d)),
        cfg=jax_train_cfg, env=env,
        net=types.SimpleNamespace(is_recurrent=meta["is_recurrent"]))
    jax_meta = jexport.export_policy(jax_runner, str(tmp_path / "jax"))

    assert port_meta == jax_meta == meta
    with open(tmp_path / "port" / "policy_meta.json") as f:
        assert json.load(f) == meta
    assert_same_arrays(npz(tmp_path / "port"), arrays)
    assert_same_arrays(npz(tmp_path / "port"), npz(tmp_path / "jax"))
    for ref in (os.path.join(d, "policy.bin"), tmp_path / "jax" / "policy.bin"):
        assert filecmp.cmp(tmp_path / "port" / "policy.bin", ref, shallow=False)

    name = ts_name(meta)
    port_ts = torch.jit.load(str(tmp_path / "port" / name))
    jax_ts = torch.jit.load(str(tmp_path / "jax" / name))
    for other in (jax_ts, torch.jit.load(os.path.join(d, name))):
        a, b = port_ts.state_dict(), other.state_dict()
        assert list(a) == list(b)
        assert all(a[k].device.type == "cpu" and torch.equal(a[k], b[k]) for k in a)

    obs = torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, meta["num_obs"])).astype(np.float32))
    inference = net.inference_copy()
    with torch.no_grad():
        if not meta["is_recurrent"]:
            got = port_ts(obs)
            assert torch.allclose(got, inference.act(obs), atol=MLP_ATOL, rtol=0)
            assert torch.allclose(got, jax_ts(obs), atol=JAX_TS_ATOL, rtol=0)
            return
        carry = inference.initial_carry(1)
        first = None
        for t in range(LSTM_STEPS):
            x = obs[t:t + 1]
            want, carry = inference.act(x, carry)
            got = port_ts(x)
            first = got if first is None else first
            assert torch.allclose(got, want, atol=LSTM_ATOL, rtol=0), t
            assert torch.allclose(got, jax_ts(x), atol=JAX_TS_ATOL, rtol=0), t
        port_ts.reset_memory()
        assert torch.equal(port_ts(obs[:1]), first)


@pytest.mark.parametrize("task", TASKS)
def test_flat_round_trip(task):
    """``flat_from_actor_critic`` inverts ``actor_critic_from_flat`` bit for
    bit: on the shipped weights (the shipped npz back, key order included)
    and on a freshly initialised network of the task's train cfg."""
    _, meta, arrays = shipped(task)
    assert_same_arrays(nets.flat_from_actor_critic(nets.actor_critic_from_flat(arrays, meta)),
                       arrays)
    env_cfg, train_cfg = task_registry.get_cfgs(task)
    pc = train_cfg.policy
    pc._class_name = train_cfg.runner.policy_class_name
    net = nets.build_network(pc, meta["num_obs"], meta["num_actions"],
                             num_critic_obs=env_cfg.env.num_privileged_obs,
                             generator=torch.Generator().manual_seed(3))
    back = nets.actor_critic_from_flat(nets.flat_from_actor_critic(net), meta)
    a, b = net.state_dict(), back.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def go2_runner(num_envs=4):
    env_cfg, train_cfg = task_registry.get_cfgs("go2")
    env_cfg.env.num_envs = num_envs
    env, _ = task_registry.make_env("go2", env_cfg=env_cfg, device="cpu")
    return OnPolicyRunner(env, train_cfg, None)


@pytest.mark.parametrize("task", ["go2", "g1"])
def test_jax_checkpoint_loads(task, tmp_path):
    """A JAX runner's ``model_<it>.ckpt`` (its payload layout, the optimizer
    state built by ``optax`` on the shipped params, Adam's moments drawn at
    random) loads into the port's runner: params equal after transposition,
    lr and iteration equal, Adam's count, mu and nu as torch Adam's step,
    exp_avg and exp_avg_sq, so that one Adam step from there moves the
    params as optax's ``scale_by_adam`` update does."""
    d, meta, arrays = shipped(task)
    params = jexport.load_flat_params(d)
    rng = np.random.default_rng(1)

    def draw(a, lo):
        return rng.uniform(lo, 1.0, a.shape).astype(np.float32)

    _, jax_train_cfg = jax_registry.get_cfgs(task)
    chain = optax.chain(optax.clip_by_global_norm(jax_train_cfg.algorithm.max_grad_norm),
                        optax.scale_by_adam())
    opt_state = chain.init(params)
    adam = opt_state[1]._replace(
        count=np.asarray(7, np.int32),
        mu=jax.tree_util.tree_map(lambda a: draw(a, -1.0), params),
        nu=jax.tree_util.tree_map(lambda a: draw(a, 0.0), params))
    opt_state = (opt_state[0], adam)
    lr = np.asarray(3.25e-4, np.float32)
    payload = {"params": params, "opt_state": opt_state, "lr": lr,
               "key": np.asarray([0, 42], np.uint32), "iteration": 123}
    run = tmp_path / "Jan01_00-00-00_jax"
    run.mkdir()
    (run / "model_123.ckpt").write_bytes(serialization.to_bytes(payload))
    (run / "model_123.ckpt.json").write_text("{}")
    (run / "model_50.ckpt").write_bytes(b"")

    path = helpers.get_load_path(str(tmp_path))
    assert path == str(run / "model_123.ckpt")
    assert helpers.get_load_path(str(tmp_path), checkpoint=123) == path

    if task == "go2":
        runner = go2_runner()
    else:
        env_cfg, train_cfg = task_registry.get_cfgs(task)
        env_cfg.env.num_envs = 2
        env, _ = task_registry.make_env(task, env_cfg=env_cfg, device="cpu")
        runner = OnPolicyRunner(env, train_cfg, None)
    runner.load(path)
    assert_same_arrays(nets.flat_from_actor_critic(runner.net), arrays)
    assert runner.alg.lr == float(lr)
    assert runner.current_learning_iteration == 123

    flat_mu, flat_nu = (nets.flatten_params(t) for t in (adam.mu, adam.nu))
    pairs = nets.torch_layout(runner.net, flat_mu)
    assert len(pairs) == len(list(runner.net.parameters()))
    for (p, mu), (_, nu) in zip(pairs, nets.torch_layout(runner.net, flat_nu)):
        st = runner.alg.optimizer.state[p]
        assert float(st["step"]) == 7.0
        assert torch.equal(st["exp_avg"], torch.from_numpy(np.ascontiguousarray(mu)))
        assert torch.equal(st["exp_avg_sq"], torch.from_numpy(np.ascontiguousarray(nu)))

    grads = jax.tree_util.tree_map(lambda a: draw(a, -1.0), params)
    updates, _ = optax.scale_by_adam().update(grads, adam)
    want = nets.flatten_params(jax.tree_util.tree_map(
        lambda p, u: np.asarray(p) - float(lr) * np.asarray(u), params, updates))
    for p, g in nets.torch_layout(runner.net, nets.flatten_params(grads)):
        p.grad = torch.from_numpy(np.ascontiguousarray(g))
    for group in runner.alg.optimizer.param_groups:
        group["lr"] = runner.alg.lr
    runner.alg.optimizer.step()
    got = nets.flat_from_actor_critic(runner.net)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)

    # the newest iteration of either suffix, the port's file where an
    # iteration has both; a newest run without checkpoints is named
    (run / "model_123.pt").write_bytes(b"")
    assert helpers.get_load_path(str(tmp_path)) == str(run / "model_123.pt")
    empty = tmp_path / "Jan02_00-00-00_empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="Jan02_00-00-00_empty"):
        helpers.get_load_path(str(tmp_path))
    with pytest.raises(ValueError, match="model_9.pt"):
        helpers.get_load_path(str(tmp_path), load_run=run.name, checkpoint=9)


def test_play_resumes_and_exports(tmp_path):
    """``scripts/play.py --resume`` on the CPU: the runner loads the port
    checkpoint that ``runner.save`` wrote, plays it and writes the four
    artifacts under ``<experiment>/exported/policies``; from the shipped
    go2 weights they are the shipped files."""
    runner = go2_runner()
    nets.load_flat_params(runner.net, resource("resources/pre_train/go2"))
    runner.save(str(tmp_path / "Jan01_00-00-00_run" / "model_0.pt"))
    args = helpers.get_args(["--task=go2", "--num_envs=4", "--device=cpu", "--resume",
                             f"--experiment_name={tmp_path}"])
    out = play.play(args, num_steps=3)
    assert out["export_dir"] == str(tmp_path / "exported" / "policies")
    assert sorted(os.listdir(out["export_dir"])) == [
        "policy.bin", "policy_1.pt", "policy_flat.npz", "policy_meta.json"]
    d, meta, arrays = shipped("go2")
    assert filecmp.cmp(os.path.join(out["export_dir"], "policy.bin"),
                       os.path.join(d, "policy.bin"), shallow=False)
    assert_same_arrays(npz(out["export_dir"]), arrays)
    assert tuple(out["obs"].shape) == (4, 48) and bool(torch.isfinite(out["obs"]).all())
    with torch.no_grad():
        got = torch.jit.load(os.path.join(out["export_dir"], "policy_1.pt"))(out["obs"])
        assert torch.allclose(got, out["policy"].act(out["obs"]), atol=MLP_ATOL, rtol=0)
