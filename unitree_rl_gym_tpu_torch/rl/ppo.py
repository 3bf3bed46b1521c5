"""PPO for the MLP actor-critic (counterpart of ``unitree_rl_gym_tpu/rl/
ppo.py``), the rsl_rl v1.0.2 contract:

  * a rollout of ``num_steps`` control steps over all envs, stored in
    [T, N, ...] tensors on the device; on terrain the heightfield windows
    are re-centered every ``terrain.window_refresh_steps`` steps;
  * time-out bootstrapping: ``rew += gamma * value * time_out``;
  * GAE(gamma, lam) with whole-batch advantage normalisation (std with
    ddof 0, as ``jnp.std``);
  * clipped surrogate + clipped value loss + entropy bonus;
  * per minibatch: the gradient clipped by its global norm (optax's
    ``clip_by_global_norm``: scaled by max_norm / norm only when
    norm >= max_norm), then the adaptive-KL learning rate (x1.5 toward
    ``desired_kl``, held in [1e-5, 1e-2]), then ``torch.optim.Adam``
    (betas 0.9/0.999, eps 1e-8) at that rate — the order of the JAX
    package's ``_apply_step``;
  * one permutation of the T*N samples per update, reused by every epoch;
  * the task knobs of ``AlgorithmCfg`` (the JAX ``PPO._loss`` and
    ``_apply_step``): class re-weighting (``class_target_frac``: one-sided,
    capped at ``class_weight_cap``, mean-one weights on the surrogate,
    value and entropy means), the anchor KL (``anchor_kl_coef``:
    KL(anchor || pi) of a frozen copy of the policy, set by
    :meth:`PPO.set_anchor`, under the task's anchor mask, with its own
    mean), and ``nan_guard`` (a minibatch whose loss, gradient norm or KL
    is not finite changes neither the parameters, nor Adam's moments and
    step count, nor the learning rate; it is counted and its stats are
    zeroed). The adaptive rate's KL stays unweighted.

The learning rate lives on the host, so each minibatch step reads its KL
(and, with ``nan_guard``, its finiteness) back from the device: one
synchronisation per minibatch, 20 per update at the defaults. The
recurrent update is not ported yet.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.utils.config import AlgorithmCfg


class Batch(NamedTuple):
    """Training samples, [B, ...] (or [T, N, ...] as rollout storage).
    ``critic_obs`` is None when the critic reads the actor's obs."""

    obs: torch.Tensor
    critic_obs: Optional[torch.Tensor]
    actions: torch.Tensor
    log_probs: torch.Tensor
    values: torch.Tensor
    advantages: Optional[torch.Tensor]
    returns: Optional[torch.Tensor]
    mu: torch.Tensor
    std: torch.Tensor


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PPO:
    """The algorithm: network, optimizer, adaptive learning rate and the
    generator of its action noise and minibatch permutation.

    ``state_class_fn`` (obs -> [B] in {0, 1}: the task-critical states, e.g.
    ``GO2HandstandEnv.ppo_state_class_fn``) drives the class re-weighting
    and, unless ``anchor_mask_fn`` is given, the anchor-KL mask; both
    features are off when it is None."""

    def __init__(self, net: nets.ActorCritic, cfg: AlgorithmCfg, num_steps: int,
                 num_envs: int, device, share_critic_obs: bool = False,
                 seed: int = 0, state_class_fn: Optional[Callable] = None,
                 anchor_mask_fn: Optional[Callable] = None):
        self.net = net
        self.cfg = cfg
        self.num_steps = num_steps
        self.num_envs = num_envs
        self.device = torch.device(device)
        # tasks without privileged obs feed the critic the actor's obs; the
        # rollout stores no duplicate
        self.share_critic_obs = share_critic_obs
        self.lr = float(np.float32(cfg.learning_rate))
        self.optimizer = torch.optim.Adam(
            net.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.state_class_fn = state_class_fn
        self.anchor_mask_fn = anchor_mask_fn
        # frozen copy of the policy for the anchor KL (set_anchor)
        self.anchor: Optional[nets.ActorCritic] = None

    def set_anchor(self, state_dict=None):
        """Freeze a copy of the network as the anchor of
        ``AlgorithmCfg.anchor_kl_coef``: the current parameters, or
        ``state_dict`` (the network's own keys) when given."""
        anchor = copy.deepcopy(self.net)
        if state_dict is not None:
            anchor.load_state_dict(state_dict)
        self.anchor = anchor.requires_grad_(False)

    # ------------------------------------------------------------------
    # rollout
    # ------------------------------------------------------------------

    @torch.no_grad()
    def rollout(self, env, env_state, obs, critic_obs):
        """Collect ``num_steps`` transitions. Returns (env_state, obs,
        critic_obs, transitions as a [T, N, ...] :class:`Batch` with
        rewards and dones, ep_stats)."""
        T, N, gamma = self.num_steps, self.num_envs, self.cfg.gamma
        every = int(getattr(env.cfg.terrain, "window_refresh_steps", 0))
        every = every if 0 < every < T else T
        store: Dict[str, list] = {k: [] for k in (
            "obs", "critic_obs", "actions", "log_probs", "values", "mu",
            "std", "rewards", "dones")}
        dev = self.device
        ep_sums = torch.zeros(len(env.episode_term_names), device=dev)
        reset_count = torch.zeros((), dtype=torch.int64, device=dev)
        ep_len_sum = torch.zeros((), dtype=torch.int64, device=dev)
        rew_sum = torch.zeros((), device=dev)
        terrain_level = max_cmd_x = torch.zeros((), device=dev)
        for t in range(T):
            if getattr(env, "terrain", None) is not None and t % every == 0:
                env_state = env.refresh_terrain(env_state)
            mu, std, value = self.net(obs, None if self.share_critic_obs
                                      else critic_obs)
            eps = torch.randn(mu.shape, generator=self.gen, device=dev)
            actions = mu + std * eps
            logp = nets.log_prob(mu, std, actions)
            env_state, next_obs, next_priv, rew, done, extras = env.step(
                env_state, actions, refresh_terrain=False)
            # time-out bootstrap (rsl_rl process_env_step)
            rew_b = rew + gamma * value * extras["time_outs"].to(rew.dtype)
            for k, x in (("obs", obs), ("actions", actions),
                         ("log_probs", logp), ("values", value), ("mu", mu),
                         ("std", std), ("rewards", rew_b), ("dones", done)):
                store[k].append(x)
            if not self.share_critic_obs:
                store["critic_obs"].append(critic_obs)
            ep_sums += extras["episode_sums_at_reset"]
            reset_count += extras["episode_reset_count"]
            ep_len_sum += extras["episode_length_at_reset"]
            rew_sum += rew.mean()
            terrain_level = extras.get("terrain_level_mean", terrain_level)
            max_cmd_x = extras.get("max_command_x", max_cmd_x)
            obs = next_obs
            critic_obs = next_priv if next_priv is not None else next_obs
        st = {k: torch.stack(v) if v else None for k, v in store.items()}
        transitions = Batch(
            obs=st["obs"], critic_obs=st["critic_obs"], actions=st["actions"],
            log_probs=st["log_probs"], values=st["values"], advantages=None,
            returns=None, mu=st["mu"], std=st["std"],
        )
        ep_stats = {
            "episode_sums": ep_sums,
            "reset_count": reset_count,
            "episode_length_sum": ep_len_sum,
            "mean_step_reward": rew_sum / T,
            "terrain_level_mean": terrain_level,
            "max_command_x": max_cmd_x,
        }
        return (env_state, obs, critic_obs, transitions, st["rewards"],
                st["dones"], ep_stats)

    # ------------------------------------------------------------------
    # GAE
    # ------------------------------------------------------------------

    def compute_gae(self, values, rewards, dones, last_value):
        """Advantages (normalised over the whole batch) and returns, [T, N]."""
        gamma, lam = self.cfg.gamma, self.cfg.lam
        adv = torch.zeros_like(last_value)
        v_next = last_value
        advantages = []
        for t in range(values.shape[0] - 1, -1, -1):
            nonterm = 1.0 - dones[t].to(values.dtype)
            delta = rewards[t] + gamma * v_next * nonterm - values[t]
            adv = delta + gamma * lam * nonterm * adv
            advantages.append(adv)
            v_next = values[t]
        advantages = torch.stack(advantages[::-1])
        returns = advantages + values
        adv_n = ((advantages - advantages.mean())
                 / (advantages.std(correction=0) + 1e-8))
        return adv_n, returns

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------

    def _class_weights(self, obs):
        """Mean-one per-sample weights of the one-sided class re-weighting:
        when the class-1 share of the minibatch is below
        ``class_target_frac``, class 1 is weighted up to restore it (capped
        at ``class_weight_cap``) and class 0 down; else all weights are 1."""
        cfg = self.cfg
        c = self.state_class_fn(obs).to(torch.float32).detach()
        frac = torch.mean(c)
        tau = cfg.class_target_frac
        low = frac < tau
        w1 = torch.where(low, torch.clamp(tau / (frac + 1e-6),
                                          max=cfg.class_weight_cap), 1.0)
        w0 = torch.where(low, (1.0 - tau) / (1.0 - frac + 1e-6), 1.0)
        w = c * w1 + (1.0 - c) * w0
        return w / torch.mean(w)

    def loss(self, b: Batch):
        """PPO loss on a minibatch [B, ...]; returns (loss, (surrogate,
        value loss, kl, anchor loss)) with the stats detached (the anchor
        loss is 0 where the anchor KL is off)."""
        cfg = self.cfg
        mu, std, value = self.net(b.obs, b.critic_obs)
        if self.state_class_fn is not None and cfg.class_target_frac > 0.0:
            w = self._class_weights(b.obs)

            def wmean(x):
                return torch.mean(w * x)
        else:
            wmean = torch.mean
        logp = nets.log_prob(mu, std, b.actions)
        ratio = torch.exp(logp - b.log_probs)
        surr = -b.advantages * ratio
        surr_clipped = -b.advantages * torch.clamp(
            ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
        surrogate_loss = wmean(torch.maximum(surr, surr_clipped))
        if cfg.use_clipped_value_loss:
            v_clipped = b.values + torch.clamp(
                value - b.values, -cfg.clip_param, cfg.clip_param)
            value_loss = wmean(torch.maximum(
                torch.square(value - b.returns),
                torch.square(v_clipped - b.returns)))
        else:
            value_loss = wmean(torch.square(value - b.returns))
        ent = wmean(nets.entropy(std))
        loss = (surrogate_loss + cfg.value_loss_coef * value_loss
                - cfg.entropy_coef * ent)
        anchor_loss = torch.zeros((), device=mu.device)
        if (cfg.anchor_kl_coef > 0.0 and self.anchor is not None
                and self.state_class_fn is not None):
            # KL(anchor || pi) on the states the anchor mask protects,
            # with its own masked mean
            with torch.no_grad(), torch.profiler.record_function(
                    "ppo_anchor_forward"):
                a_mu = self.anchor.act(b.obs)
                a_std = torch.exp(self.anchor.log_std).expand_as(a_mu)
            akl = nets.kl_divergence(a_mu, a_std, mu, std)
            mask_fn = self.anchor_mask_fn or self.state_class_fn
            mask = mask_fn(b.obs).to(akl.dtype).detach()
            anchor_loss = torch.sum(mask * akl) / (torch.sum(mask) + 1e-6)
            loss = loss + cfg.anchor_kl_coef * anchor_loss
        # the adaptive rate's KL stays unweighted (rsl_rl's schedule)
        kl = torch.mean(nets.kl_divergence(b.mu, b.std, mu, std)).detach()
        return loss, (surrogate_loss.detach(), value_loss.detach(), kl,
                      anchor_loss.detach())

    def _grad_norm(self):
        """Global norm of the .grad of every parameter (optax.global_norm)."""
        grads = [p.grad for p in self.net.parameters() if p.grad is not None]
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))

    def _clip_grads(self, norm=None):
        """optax.clip_by_global_norm on the .grad of every parameter."""
        norm = self._grad_norm() if norm is None else norm
        max_norm = self.cfg.max_grad_norm
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        for p in self.net.parameters():
            if p.grad is not None:
                p.grad.mul_(scale)

    def _adapt_lr(self, lr: float, kl: float) -> float:
        """rsl_rl's adaptive schedule in float32: x1.5 toward desired_kl,
        held in [1e-5, 1e-2]."""
        cfg = self.cfg
        if cfg.schedule != "adaptive" or cfg.desired_kl is None:
            return lr
        lr32 = np.float32(lr)
        if kl > cfg.desired_kl * 2.0:
            lr32 = max(lr32 / np.float32(1.5), np.float32(1e-5))
        if cfg.desired_kl / 2.0 > kl > 0.0:
            lr32 = min(lr32 * np.float32(1.5), np.float32(1e-2))
        return float(lr32)

    def apply_step(self, kl: float, norm=None):
        """The JAX package's ``_apply_step`` on the gradients in ``.grad``:
        global-norm clip (by ``norm`` when the caller has it), the learning
        rate adapted to ``kl``, Adam."""
        self._clip_grads(norm)
        self.lr = self._adapt_lr(self.lr, kl)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        self.optimizer.step()

    def minibatch_step(self, b: Batch):
        """One optimizer application: loss, gradient, :meth:`apply_step`.
        Returns ((surrogate, value loss, kl, anchor loss), skipped). With
        ``nan_guard`` a minibatch whose loss, gradient norm or KL is not
        finite is skipped before the optimizer: parameters, Adam's moments
        and step count, and the learning rate keep their values, and its
        stats come back as zeros with ``skipped`` True."""
        loss, stats = self.loss(b)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        norm = self._grad_norm()
        kl = stats[2]
        if self.cfg.nan_guard:
            ok = (torch.isfinite(loss.detach()) & torch.isfinite(norm)
                  & torch.isfinite(kl))
            kl_h, ok_h = torch.stack((kl, ok.to(kl.dtype))).tolist()
            if not ok_h:
                self.optimizer.zero_grad(set_to_none=True)
                return tuple(torch.zeros_like(x) for x in stats), True
        else:
            kl_h = float(kl)
        self.apply_step(kl_h, norm)
        return stats, False

    def update(self, transitions: Batch, advantages, returns):
        """num_learning_epochs x num_mini_batches PPO steps over one
        permutation of the T*N samples."""
        cfg = self.cfg
        T, N = advantages.shape
        full = transitions._replace(advantages=advantages, returns=returns)
        perm = torch.randperm(T * N, generator=self.gen, device=self.device)
        flat = Batch(*(
            None if x is None else x.reshape((T * N,) + x.shape[2:])[perm]
            for x in full
        ))
        nmb = cfg.num_mini_batches
        mb = (T * N) // nmb
        stats = torch.zeros(4, device=self.device)
        skipped = 0
        for _ in range(cfg.num_learning_epochs):
            for i in range(nmb):
                b = Batch(*(None if x is None else x[i * mb:(i + 1) * mb]
                            for x in flat))
                step_stats, was_skipped = self.minibatch_step(b)
                stats += torch.stack(step_stats)
                skipped += int(was_skipped)
        n_applied = max(cfg.num_learning_epochs * nmb - skipped, 1)
        return {
            "surrogate_loss": stats[0] / n_applied,
            "value_loss": stats[1] / n_applied,
            "kl": stats[2] / n_applied,
            "anchor_loss": stats[3] / n_applied,
            "lr": self.lr,
            "nonfinite_steps": float(skipped),
        }

    # ------------------------------------------------------------------
    # one training iteration
    # ------------------------------------------------------------------

    def train_iteration(self, env, env_state, obs, critic_obs):
        """Rollout, GAE, update. Returns (env_state, obs, critic_obs,
        metrics); ``metrics`` holds device tensors plus the host seconds of
        the rollout and the update (the device is synchronised between
        them). Both run as ``torch.profiler`` ranges ("ppo_rollout",
        "ppo_update")."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("ppo_rollout"):
            env_state, obs, critic_obs, tr, rewards, dones, ep = self.rollout(
                env, env_state, obs, critic_obs)
            with torch.no_grad():
                _, _, last_value = self.net(
                    obs, None if self.share_critic_obs else critic_obs)
            advantages, returns = self.compute_gae(tr.values, rewards, dones,
                                                   last_value)
            _sync(self.device)
        t1 = time.perf_counter()
        with torch.profiler.record_function("ppo_update"):
            metrics = self.update(tr, advantages, returns)
            _sync(self.device)
        metrics.update(ep)
        metrics["rollout_s"] = t1 - t0
        metrics["update_s"] = time.perf_counter() - t1
        return env_state, obs, critic_obs, metrics
