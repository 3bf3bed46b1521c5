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

Env data parallelism (``block``, a ``parallel.mesh.EnvBlock``; the JAX
package gets it from XLA's collectives under one global program): the
algorithm keeps the one-process semantics over all ``block.n_global`` envs,
up to the order of floating-point sums.

  * draws are global: the rollout's action noise is drawn over all envs
    and the rank keeps its rows; the update's permutation is of all T*N
    global samples, the same on every rank (the generator is seeded alike);
  * global minibatch i is ``perm[i*mb:(i+1)*mb]`` of the global flat
    indices ``t*N + n``; a rank takes the samples of it that lie in its
    block, in the permutation's order (the local counts differ);
  * every mean of the loss is a local sum over the global count; the class
    weights' share and mean and the anchor KL's mask count come from one
    all-reduce of their sums before the forward pass (only when those
    knobs are on), and after ``backward`` one all-reduce of a single flat
    buffer sums the gradients, the loss and its terms, the KL and a
    non-finite flag, so every rank takes the same clip, nan-guard and
    learning-rate decisions from the same bits and the replicas stay
    identical;
  * GAE normalises with the global mean and the global sum of squared
    deviations (two passes, ddof 0);
  * the rollout's logging sums are reduced once per iteration.

One process is the block of one rank (``block`` None gives it). Its draws
and minibatches take the same path; it makes no collective, and takes the
mean of the loss and the std of GAE as torch does, so every result is bit
for bit the one-process result.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from unitree_rl_gym_tpu_torch.models import networks as nets
from unitree_rl_gym_tpu_torch.parallel.mesh import all_reduce_sum, env_block
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
    features are off when it is None.

    ``num_envs`` is the number of envs this process holds: the block's
    ``n_local`` under env data parallelism (``block``; see the module
    docstring)."""

    def __init__(self, net: nets.ActorCritic, cfg: AlgorithmCfg, num_steps: int,
                 num_envs: int, device, share_critic_obs: bool = False,
                 seed: int = 0, state_class_fn: Optional[Callable] = None,
                 anchor_mask_fn: Optional[Callable] = None, block=None):
        self.net = net
        self.cfg = cfg
        self.num_steps = num_steps
        self.num_envs = num_envs
        self.block = env_block(num_envs, 0, 1) if block is None else block
        if self.block.n_local != num_envs:
            raise ValueError(f"{num_envs} envs on a block of {self.block.n_local}")
        self.num_envs_global = self.block.n_global
        # more than one rank: the cross-env sums are all-reduced
        self.distributed = self.block.world_size > 1
        # host seconds in the update's gradient all-reduces (data parallel)
        self.allreduce_s = 0.0
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
            eps = self.block.rows(torch.randn(
                (self.num_envs_global,) + mu.shape[1:], generator=self.gen,
                device=dev))
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
            rew_sum += self._env_mean(rew)
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
        if self.distributed:
            # the iteration's logging sums over all ranks, in one collective
            # (float64: the counts stay exact)
            k = ep_sums.numel()
            tot = all_reduce_sum(torch.cat((
                ep_sums.double(), torch.stack((
                    reset_count.double(), ep_len_sum.double(),
                    rew_sum.double(), terrain_level.double())))))
            ep_sums = tot[:k].to(ep_sums.dtype)
            reset_count, ep_len_sum = (tot[k].to(torch.int64),
                                       tot[k + 1].to(torch.int64))
            rew_sum, terrain_level = (tot[k + 2].to(rew_sum.dtype),
                                      tot[k + 3].to(rew_sum.dtype))
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
        if not self.distributed:
            adv_n = ((advantages - advantages.mean())
                     / (advantages.std(correction=0) + 1e-8))
            return adv_n, returns
        # the global mean, then the global sum of squared deviations from
        # it (two passes, as torch.std; ddof 0)
        count = advantages.shape[0] * self.num_envs_global
        mean = all_reduce_sum(advantages.sum().reshape(1))[0] / count
        dev = advantages - mean
        ss = all_reduce_sum(torch.sum(dev * dev).reshape(1))[0]
        return dev / (torch.sqrt(ss / count) + 1e-8), returns

    # ------------------------------------------------------------------
    # env data parallelism
    # ------------------------------------------------------------------

    def _env_mean(self, x):
        """The mean over all envs of [N] ``x`` (over ranks: this rank's
        share of it, summed over ranks by the caller)."""
        if not self.distributed:
            return x.mean()
        return x.sum() / self.num_envs_global

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------

    def _class_weights(self, obs, c_sum=None, count=None):
        """Mean-one per-sample weights of the one-sided class re-weighting:
        when the class-1 share of the minibatch is below
        ``class_target_frac``, class 1 is weighted up to restore it (capped
        at ``class_weight_cap``) and class 0 down; else all weights are 1.
        ``c_sum`` and ``count``: the global minibatch's class-1 count and
        size (env data parallelism); the weights take two values, so the
        global share and mean weight follow from them."""
        cfg = self.cfg
        c = self.state_class_fn(obs).to(torch.float32).detach()
        frac = torch.mean(c) if count is None else c_sum / count
        tau = cfg.class_target_frac
        low = frac < tau
        w1 = torch.where(low, torch.clamp(tau / (frac + 1e-6),
                                          max=cfg.class_weight_cap), 1.0)
        w0 = torch.where(low, (1.0 - tau) / (1.0 - frac + 1e-6), 1.0)
        w = c * w1 + (1.0 - c) * w0
        if count is None:
            return w / torch.mean(w)
        return w / ((c_sum * w1 + (count - c_sum) * w0) / count)

    def loss(self, b: Batch, count: Optional[int] = None):
        """PPO loss on a minibatch [B, ...]; returns (loss, (surrogate,
        value loss, kl, anchor loss)) with the stats detached (the anchor
        loss is 0 where the anchor KL is off).

        ``count`` (env data parallelism): the size of the global minibatch
        of which ``b`` holds this rank's samples. Every mean is then a sum
        over ``b`` divided by ``count``, and the loss and stats are this
        rank's shares of the global ones (their sum over ranks)."""
        cfg = self.cfg
        use_w = self.state_class_fn is not None and cfg.class_target_frac > 0.0
        use_anchor = (cfg.anchor_kl_coef > 0.0 and self.anchor is not None
                      and self.state_class_fn is not None)
        mask_fn = self.anchor_mask_fn or self.state_class_fn
        sums = None
        if count is not None and (use_w or use_anchor):
            # the global class-1 count and anchor-mask count: one collective
            # before the forward pass (both depend on obs alone)
            z = torch.zeros((), device=b.obs.device)
            sums = all_reduce_sum(torch.stack((
                self.state_class_fn(b.obs).to(torch.float32).sum() if use_w else z,
                mask_fn(b.obs).to(torch.float32).sum() if use_anchor else z)))
        mu, std, value = self.net(b.obs, b.critic_obs)

        def mean(x):
            return torch.mean(x) if count is None else torch.sum(x) / count

        if use_w:
            w = (self._class_weights(b.obs) if count is None
                 else self._class_weights(b.obs, sums[0], count))

            def wmean(x):
                return mean(w * x)
        else:
            wmean = mean
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
        if use_anchor:
            # KL(anchor || pi) on the states the anchor mask protects,
            # with its own masked mean
            with torch.no_grad(), torch.profiler.record_function(
                    "ppo_anchor_forward"):
                a_mu = self.anchor.act(b.obs)
                a_std = torch.exp(self.anchor.log_std).expand_as(a_mu)
            akl = nets.kl_divergence(a_mu, a_std, mu, std)
            mask = mask_fn(b.obs).to(akl.dtype).detach()
            n_mask = torch.sum(mask) if count is None else sums[1]
            anchor_loss = torch.sum(mask * akl) / (n_mask + 1e-6)
            loss = loss + cfg.anchor_kl_coef * anchor_loss
        # the adaptive rate's KL stays unweighted (rsl_rl's schedule)
        kl = mean(nets.kl_divergence(b.mu, b.std, mu, std)).detach()
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

    def minibatch_grads(self, b: Batch, count: Optional[int] = None):
        """Loss and gradient (in ``.grad``) of a minibatch; returns (loss,
        stats) as :meth:`loss`. Over ranks, ``b`` holds this rank's
        samples of a global minibatch of ``count`` samples, and one
        all-reduce of a single flat buffer makes every rank's gradient,
        loss, stats and non-finite flag the global ones (identical bits on
        every rank)."""
        loss, stats = self.loss(b, count if self.distributed else None)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if not self.distributed:
            return loss, stats
        params = list(self.net.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        loss = loss.detach()
        flag = (~torch.isfinite(loss)).to(loss.dtype)
        t0 = time.perf_counter()
        flat = all_reduce_sum(torch.cat(
            [g.reshape(-1) for g in grads]
            + [torch.stack((loss,) + tuple(stats) + (flag,))]))
        self.allreduce_s += time.perf_counter() - t0
        i = 0
        for p, g in zip(params, grads):
            p.grad = flat[i:i + g.numel()].view_as(g)
            i += g.numel()
        loss, *stats, flag = flat[i:].unbind()
        # a non-finite part on any rank makes the global loss non-finite
        loss = torch.where(flag > 0, torch.nan, loss)
        return loss, tuple(stats)

    def minibatch_step(self, b: Batch, count: Optional[int] = None):
        """One optimizer application: loss, gradient (:meth:`minibatch_grads`),
        :meth:`apply_step`. Returns ((surrogate, value loss, kl, anchor
        loss), skipped). With ``nan_guard`` a minibatch whose loss, gradient
        norm or KL is not finite is skipped before the optimizer:
        parameters, Adam's moments and step count, and the learning rate
        keep their values, and its stats come back as zeros with
        ``skipped`` True."""
        loss, stats = self.minibatch_grads(b, count)
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

    def minibatches(self, transitions: Batch, perm):
        """The num_mini_batches minibatches of one update over the [T, N]
        ``transitions`` (advantages and returns set) and the permutation
        ``perm`` of the T*N global samples: minibatch i holds this rank's
        samples of ``perm[i*mb:(i+1)*mb]`` (global flat index
        ``t*N_global + n``), in the permutation's order; one rank holds
        them all. Returns (list of :class:`Batch`, mb: the global
        minibatch size)."""
        T, N = transitions.advantages.shape
        nmb = self.cfg.num_mini_batches
        mb = (T * self.num_envs_global) // nmb

        def flat(x):
            return x.reshape((T * N,) + x.shape[2:])

        ng, off = self.num_envs_global, self.block.offset
        out = []
        for i in range(nmb):
            g = perm[i * mb:(i + 1) * mb]
            t, n = g // ng, g % ng - off
            local = (t * N + n)[(n >= 0) & (n < N)]
            out.append(Batch(*(None if x is None else flat(x)[local]
                               for x in transitions)))
        return out, mb

    def update(self, transitions: Batch, advantages, returns, perm=None):
        """num_learning_epochs x num_mini_batches PPO steps over one
        permutation of the T*N global samples (``perm``: that permutation,
        drawn from the PPO generator when None)."""
        cfg = self.cfg
        T = advantages.shape[0]
        full = transitions._replace(advantages=advantages, returns=returns)
        if perm is None:
            perm = torch.randperm(T * self.num_envs_global, generator=self.gen,
                                  device=self.device)
        mbs, mb = self.minibatches(full, perm.to(self.device))
        stats = torch.zeros(4, device=self.device)
        skipped = 0
        self.allreduce_s = 0.0
        for _ in range(cfg.num_learning_epochs):
            for b in mbs:
                step_stats, was_skipped = self.minibatch_step(b, mb)
                stats += torch.stack(step_stats)
                skipped += int(was_skipped)
        n_applied = max(cfg.num_learning_epochs * len(mbs) - skipped, 1)
        return {
            "surrogate_loss": stats[0] / n_applied,
            "value_loss": stats[1] / n_applied,
            "kl": stats[2] / n_applied,
            "anchor_loss": stats[3] / n_applied,
            "lr": self.lr,
            "nonfinite_steps": float(skipped),
            "allreduce_s": self.allreduce_s,
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
