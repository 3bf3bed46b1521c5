"""OnPolicyRunner — the training loop (counterpart of
``unitree_rl_gym_tpu/rl/runner.py``, the rsl_rl v1.0.2 runner contract):

    runner = OnPolicyRunner(env, train_cfg, log_dir)
    runner.learn(num_learning_iterations, init_at_random_ep_len=True)
    runner.save(path) / runner.load(path)
    runner.set_anchor()      # freeze the policy for the anchor KL
    policy = runner.get_inference_policy()   # policy(obs); policy.reset_memory()

It runs on the env's device. An LSTM policy's carry (``ActorCriticRecurrent``)
runs on from iteration to iteration, as the env state does; a checkpoint
holds the LSTM weights with the rest of the network. The env's ``ppo_state_class_fn`` and
``ppo_anchor_mask_fn``, where it has them, go to PPO's class re-weighting
and anchor KL (the JAX runner's ``state_class_fn`` / ``anchor_mask_fn``).
The anchor is not part of a checkpoint, as in the JAX package. Checkpoints are the port's own format:
``model_<iteration>.pt`` (``torch.save`` of the network and optimizer state
dicts, the learning rate, the iteration and the state of the PPO generator)
every ``save_interval`` iterations and at the end, each with the JSON meta
``model_<iteration>.pt.json`` of the JAX runner, and ``curves.json`` (one
row of metrics per iteration) beside them. ``load`` also reads the JAX
package's Flax ``model_<iteration>.ckpt`` (params, lr, iteration and Adam's
moments). The TensorBoard writer is not ported.

Env data parallelism: with an env that holds one rank's block of the envs
(``env.block``, ``parallel.mesh.EnvBlock``), every rank runs this runner on
its block; the network is built from the same seed on every rank and then
broadcast from rank 0 once, PPO keeps the replicas identical (``rl/ppo.py``),
rank 0 alone prints and writes ``model_<it>.pt``, its meta and
``curves.json``, and every rank loads a checkpoint. An LSTM policy's carry
is the block's: each rank carries its own envs' from iteration to
iteration. The throughput counts the steps of all ranks' envs.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import torch

from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.parallel.mesh import broadcast_
from unitree_rl_gym_tpu_torch.rl.ppo import PPO
from unitree_rl_gym_tpu_torch.utils import flax_msgpack
from unitree_rl_gym_tpu_torch.utils.config import TrainCfg, class_to_dict


class OnPolicyRunner:
    def __init__(self, env, train_cfg: TrainCfg, log_dir: Optional[str] = None):
        self.env = env
        self.cfg = train_cfg
        self.log_dir = log_dir
        self.device = env.device
        self.current_learning_iteration = 0
        self.block = env.block
        # rank 0 of a data-parallel run (or the only process) logs and saves
        self.is_main = self.block.rank == 0

        policy_cfg = train_cfg.policy
        policy_cfg._class_name = train_cfg.runner.policy_class_name
        init_gen = torch.Generator().manual_seed(int(train_cfg.seed))
        self.net = nets.build_network(
            policy_cfg, env.num_obs, env.num_actions,
            num_critic_obs=env.num_privileged_obs, generator=init_gen,
        ).to(self.device)
        self.alg = PPO(
            self.net, train_cfg.algorithm,
            num_steps=train_cfg.runner.num_steps_per_env,
            num_envs=env.num_envs, device=self.device,
            share_critic_obs=env.num_privileged_obs is None,
            seed=train_cfg.seed,
            # the task's critical-state classifier and anchor mask drive the
            # class re-weighting and the anchor KL (GO2HandstandEnv)
            state_class_fn=getattr(env, "ppo_state_class_fn", None),
            anchor_mask_fn=getattr(env, "ppo_anchor_mask_fn", None),
            block=self.block,
        )
        if env.distributed:
            # identical replicas from the first step: rank 0's parameters
            broadcast_(list(self.net.parameters()))
        self._env_state = None
        self._obs = None
        self._critic_obs = None
        self._carry = None
        # one row of metrics per iteration, dumped as curves.json next to
        # the checkpoints
        self._curves: List[dict] = []

    # ------------------------------------------------------------------

    def _ensure_env(self, init_at_random_ep_len=False):
        if self._env_state is None:
            state, obs = self.env.reset_all(
                init_at_random_ep_len=init_at_random_ep_len)
            self._env_state = state
            self._obs = obs
            self._critic_obs = state.priv_obs if state.priv_obs is not None else obs
            if self.net.is_recurrent:
                self._carry = self.net.initial_carry(self.env.num_envs)

    def learn(self, num_learning_iterations: int,
              init_at_random_ep_len: bool = False) -> List[dict]:
        """Train; returns the metric rows of these iterations."""
        self._ensure_env(init_at_random_ep_len)
        start = self.current_learning_iteration
        steps_per_iter = (self.env.num_envs_global
                          * self.cfg.runner.num_steps_per_env)
        rows = []
        for it in range(start, start + num_learning_iterations):
            t0 = time.perf_counter()
            (self._env_state, self._obs, self._critic_obs, self._carry,
             metrics) = self.alg.train_iteration(
                self.env, self._env_state, self._obs, self._critic_obs,
                self._carry)
            metrics = {k: v.tolist() if torch.is_tensor(v) else v
                       for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.current_learning_iteration = it + 1
            rows.append(self._log(it, metrics, steps_per_iter / dt, dt))
            if (self.log_dir and self.is_main
                    and (it + 1) % self.cfg.runner.save_interval == 0):
                self.save(os.path.join(self.log_dir, f"model_{it + 1}.pt"))
        if self.log_dir and self.is_main:
            self.save(os.path.join(
                self.log_dir, f"model_{self.current_learning_iteration}.pt"))
        return rows

    # ------------------------------------------------------------------

    def _log(self, it, metrics, fps, dt_wall) -> dict:
        count = max(float(metrics["reset_count"]), 1.0)
        ep_rews = {
            name: float(s) / count / self.env.max_episode_length_s
            for name, s in zip(self.env.episode_term_names,
                               metrics["episode_sums"])
        }
        mean_ep_len = float(metrics["episode_length_sum"]) / count
        if self.is_main:
            print(
                f"it {it:5d} | {fps:9.0f} steps/s | rew {metrics['mean_step_reward']:.4f} | "
                f"ep_len {mean_ep_len:7.1f} | vloss {metrics['value_loss']:.4f} | "
                f"kl {metrics['kl']:.4f} | lr {metrics['lr']:.2e} | "
                f"anchor {metrics['anchor_loss']:.4f} | "
                f"skipped {metrics['nonfinite_steps']:.0f}",
                flush=True,
            )
        row = {
            "it": it,
            "mean_step_reward": metrics["mean_step_reward"],
            "mean_episode_length": mean_ep_len,
            "value_loss": metrics["value_loss"],
            "surrogate_loss": metrics["surrogate_loss"],
            "kl": metrics["kl"],
            "lr": metrics["lr"],
            "anchor_loss": metrics["anchor_loss"],
            "nonfinite_steps": metrics["nonfinite_steps"],
            "fps": fps,
            "iteration_s": dt_wall,
            "rollout_s": metrics["rollout_s"],
            "update_s": metrics["update_s"],
            "episode_rew": ep_rews,
        }
        if self.env.distributed:
            row["allreduce_s"] = metrics["allreduce_s"]
        if getattr(self.env, "terrain", None) is not None:
            row["terrain_level"] = metrics["terrain_level_mean"]
        if self.env.cfg.commands.curriculum:
            row["max_command_x"] = metrics["max_command_x"]
        self._curves.append(row)
        return row

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({
            "model": self.net.state_dict(),
            "optimizer": self.alg.optimizer.state_dict(),
            "lr": self.alg.lr,
            "iteration": self.current_learning_iteration,
            "generator": self.alg.gen.get_state(),
        }, path)
        meta = {
            "iteration": self.current_learning_iteration,
            "train_cfg": class_to_dict(self.cfg),
        }
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=1, default=str)
        if self._curves and os.path.dirname(path):
            with open(os.path.join(os.path.dirname(path), "curves.json"), "w") as f:
                json.dump(self._curves, f)

    def load(self, path: str, load_optimizer: bool = True):
        """Restore a checkpoint: the port's ``model_<it>.pt``, or by its
        suffix a JAX package's ``model_<it>.ckpt`` (:meth:`_load_jax`)."""
        if path.endswith(".ckpt"):
            return self._load_jax(path, load_optimizer)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.net.load_state_dict(payload["model"])
        self.alg.lr = float(payload["lr"])
        if load_optimizer:
            self.alg.optimizer.load_state_dict(payload["optimizer"])
            self.alg.gen.set_state(payload["generator"])
        self.current_learning_iteration = int(payload["iteration"])
        return payload

    def _load_jax(self, path: str, load_optimizer: bool):
        """A JAX runner's Flax checkpoint: its params by their Flax names
        (kernels transposed, LSTM gates stacked), ``lr`` and ``iteration``,
        and with ``load_optimizer`` optax's Adam state as torch Adam's: its
        ``count`` as every parameter's ``step``, ``mu`` and ``nu`` as
        ``exp_avg`` and ``exp_avg_sq`` in the parameters' layout. The JAX
        PRNG key has no counterpart; the PPO generator stays as it is."""
        payload = flax_msgpack.load(path)
        nets.copy_flat(self.net, nets.flatten_params(payload["params"]), where=path)
        self.alg.lr = float(payload["lr"])
        if load_optimizer:
            # optax.chain(clip_by_global_norm, scale_by_adam): the second
            # state is Adam's (rl/ppo.py of the JAX package, make_optimizer)
            adam = payload["opt_state"]["1"]
            moments = [nets.torch_layout(self.net, nets.flatten_params(adam[k]), path)
                       for k in ("mu", "nu")]
            for (p, mu), (_, nu) in zip(*moments):
                self.alg.optimizer.state[p] = {
                    "step": torch.tensor(float(adam["count"])),
                    "exp_avg": torch.as_tensor(mu, dtype=torch.float32, device=p.device),
                    "exp_avg_sq": torch.as_tensor(nu, dtype=torch.float32, device=p.device),
                }
        self.current_learning_iteration = int(payload["iteration"])
        return payload

    # ------------------------------------------------------------------

    def set_anchor(self, params=None):
        """Freeze a copy of the policy as the anchor of
        ``AlgorithmCfg.anchor_kl_coef``: the current parameters by default,
        or ``params``, a state dict of the runner's network."""
        self.alg.set_anchor(params)

    def get_inference_policy(self):
        """The deterministic (mean) actor as a float32 function of obs. An
        LSTM policy holds its carry in the closure from call to call, with
        no per-env reset, and ``policy.reset_memory()`` zeroes it (the JAX
        runner's policy, after the reference's exported stateful module)."""
        net = self.net.inference_copy()
        holder = {"carry": None}

        @torch.no_grad()
        def policy(obs):
            if not net.is_recurrent:
                return net.act(obs)
            if holder["carry"] is None:
                holder["carry"] = net.initial_carry(obs.shape[0])
            mu, holder["carry"] = net.act(obs, holder["carry"])
            return mu

        def reset_memory():
            holder["carry"] = None

        policy.reset_memory = reset_memory
        return policy
