"""The reference PPO arithmetic (rsl_rl v1.0.2): GAE with whole-batch
advantage normalisation, the clipped surrogate and clipped value loss with
the entropy bonus, the gradient clipped by its global norm, rsl_rl's
adaptive-KL learning rate and Adam (torch.optim.Adam's update written out:
betas 0.9/0.999, eps 1e-8), for the MLP actor-critic of ``policy.py``."""

import numpy as np
import torch

from reference import policy as P


def gae(values, rewards, dones, last_value, gamma, lam):
    """(normalised advantages, returns), [T, N]."""
    adv = torch.zeros_like(last_value)
    v_next = last_value
    out = []
    for t in range(values.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t].to(values.dtype)
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        adv = delta + gamma * lam * nonterm * adv
        out.append(adv)
        v_next = values[t]
    adv = torch.stack(out[::-1])
    returns = adv + values
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8), returns


def leaves(params):
    """The parameter tensors of ``params`` in a fixed order, with names."""
    out = [("log_std", params["log_std"])]
    for head in ("actor", "critic"):
        for i, (w, b) in enumerate(params[head]):
            out += [(f"{head}.{i}.weight", w), (f"{head}.{i}.bias", b)]
    return out


def rebuild(named):
    """``params`` from the named leaves of :func:`leaves`."""
    d = dict(named)
    params = {"log_std": d["log_std"]}
    for head in ("actor", "critic"):
        n = sum(1 for k in d if k.startswith(head + ".") and k.endswith(".weight"))
        params[head] = [(d[f"{head}.{i}.weight"], d[f"{head}.{i}.bias"])
                        for i in range(n)]
    return params


def loss(params, mb, cfg, dtype, quant=None):
    """(loss, kl) of one minibatch ``mb`` (a dict of [B, ...] tensors: obs,
    critic_obs or None, actions, log_probs, values, advantages, returns,
    mu, std)."""
    mu, std, value = P.forward(params, mb["obs"], mb["critic_obs"], dtype, quant)
    logp = P.log_prob(mu, std, mb["actions"])
    ratio = torch.exp(logp - mb["log_probs"])
    adv = mb["advantages"]
    surr = torch.maximum(-adv * ratio, -adv * torch.clamp(
        ratio, 1.0 - cfg["clip_param"], 1.0 + cfg["clip_param"])).mean()
    if cfg["use_clipped_value_loss"]:
        v_clip = mb["values"] + torch.clamp(value - mb["values"],
                                            -cfg["clip_param"], cfg["clip_param"])
        vloss = torch.maximum(torch.square(value - mb["returns"]),
                              torch.square(v_clip - mb["returns"])).mean()
    else:
        vloss = torch.square(value - mb["returns"]).mean()
    total = (surr + cfg["value_loss_coef"] * vloss
             - cfg["entropy_coef"] * P.entropy(std).mean())
    kl = P.kl_divergence(mb["mu"], mb["std"], mu, std).mean().detach()
    return total, kl


class Adam:
    """torch.optim.Adam's step, with the learning rate given per step."""

    def __init__(self, named, betas=(0.9, 0.999), eps=1e-8):
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(p) for k, p in named}
        self.v = {k: torch.zeros_like(p) for k, p in named}
        self.t = 0

    def step(self, named, grads, lr):
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        out = []
        for k, p in named:
            g = grads[k]
            self.m[k] = self.m[k] * self.b1 + (1.0 - self.b1) * g
            self.v[k] = self.v[k] * self.b2 + (1.0 - self.b2) * g * g
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            out.append((k, p - (lr / bc1) * self.m[k] / denom))
        return out


def adapt_lr(lr, kl, cfg):
    """rsl_rl's adaptive schedule, in float32 as the configuration keeps the
    rate."""
    if cfg["schedule"] != "adaptive" or cfg["desired_kl"] is None:
        return lr
    lr32 = np.float32(lr)
    if kl > cfg["desired_kl"] * 2.0:
        lr32 = max(lr32 / np.float32(1.5), np.float32(1e-5))
    if cfg["desired_kl"] / 2.0 > kl > 0.0:
        lr32 = min(lr32 * np.float32(1.5), np.float32(1e-2))
    return float(lr32)


def update_steps(params, minibatches, cfg, dtype, quant=None):
    """Follow the first ``len(minibatches)`` optimizer steps from
    ``params``. Returns (losses, the clipped gradient of step 1 by leaf,
    the parameters after the last step by leaf, the parameters at the
    start by leaf)."""
    named = [(k, p.detach().clone()) for k, p in leaves(params)]
    start = dict(named)
    opt = Adam(named)
    lr = float(np.float32(cfg["learning_rate"]))
    losses, first_grad = [], None
    for mb in minibatches:
        req = [(k, p.clone().requires_grad_(True)) for k, p in named]
        total, kl = loss(rebuild(req), mb, cfg, dtype, quant)
        grads = torch.autograd.grad(total, [p for _, p in req])
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < cfg["max_grad_norm"], 1.0,
                            cfg["max_grad_norm"] / norm)
        grads = {k: g * scale for (k, _), g in zip(req, grads)}
        if first_grad is None:
            first_grad = grads
        lr = adapt_lr(lr, float(kl), cfg)
        named = opt.step(named, grads, lr)
        losses.append(float(total.detach()))
    return losses, first_grad, dict(named), start
