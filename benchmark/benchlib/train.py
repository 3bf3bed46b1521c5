"""The ``train`` mode: PPO from seeded weights, the window driving
``PPO.train_iteration`` (rollout, GAE, the minibatch update) as
``bench_torch.py`` does.

Set-up builds one env, one network and one PPO, loads the seeded weights,
resets, and runs ``warmup_iterations`` iterations through the same call
the window makes. The first of them is followed by the reference: its
rollout buffer, its GAE and its first three optimizer steps are captured
(wrappers on the PPO instance, removed before the window); the last
captures one env step (and the control step inside it) at a step drawn
from the seed and, on a heightfield, one of its window refreshes, also
drawn from the seed. The same objects then go on into the window.
"""

import math
import time

import numpy as np
import torch

from benchlib import common as C
from benchlib import counts as K
from benchlib import weights as W

N_STEPS_FOLLOWED = 3


class UpdateCapture:
    """Wrappers on one PPO instance for its next iteration: the rollout's
    buffer and last obs, the update's advantages, returns and permutation,
    the loss of the first three minibatch steps, the clipped gradient of
    the first (from Adam's first moment after it) and the parameters after
    the third."""

    def __init__(self, alg):
        self.alg, self.d = alg, {"losses": []}
        self.names = [n for n, _ in alg.net.named_parameters()]
        orig = {k: getattr(alg, k) for k in (
            "rollout", "update", "minibatches", "minibatch_grads",
            "minibatch_step")}
        self.orig = orig

        def rollout(*a, **kw):
            out = orig["rollout"](*a, **kw)
            env_state, obs, critic_obs, carry, tr, rewards, dones, ep = out
            self.d.update(last_obs=obs.clone(), last_critic_obs=critic_obs.clone(),
                          transitions=tr, rewards=rewards, dones=dones)
            return out

        def update(transitions, advantages, returns, perm=None):
            self.d.update(advantages=advantages.clone(), returns=returns.clone())
            return orig["update"](transitions, advantages, returns, perm)

        def minibatches(transitions, perm):
            self.d["perm"] = perm.clone()
            return orig["minibatches"](transitions, perm)

        def minibatch_grads(b, count=None):
            loss, stats = orig["minibatch_grads"](b, count)
            if len(self.d["losses"]) < N_STEPS_FOLLOWED:
                self.d["losses"].append(float(loss.detach()))
            return loss, stats

        def minibatch_step(b, count=None):
            k = len(self.d["losses"])
            out = orig["minibatch_step"](b, count)
            params = dict(alg.net.named_parameters())
            if k == 0:
                st = alg.optimizer.state
                self.d["first_grad"] = {
                    n: st[p]["exp_avg"].detach().clone() / (1.0 - 0.9)
                    for n, p in params.items() if p in st}
            if k == N_STEPS_FOLLOWED - 1:
                self.d["params_after"] = {n: p.detach().clone()
                                          for n, p in params.items()}
            return out

        for k, f in (("rollout", rollout), ("update", update),
                     ("minibatches", minibatches),
                     ("minibatch_grads", minibatch_grads),
                     ("minibatch_step", minibatch_step)):
            setattr(alg, k, f)

    def remove(self):
        for k in self.orig:
            delattr(self.alg, k)


def setup(ctx):
    """Build, load the seeded weights, reset and warm up with the captures;
    returns the state the window and the reference need."""
    from unitree_rl_gym_tpu_torch.models import networks as nets
    from unitree_rl_gym_tpu_torch.rl.ppo import PPO

    dev, seed, n = ctx["device"], ctx["seed"], ctx["num_envs"]
    env, tcfg = C.program_env(ctx["config"], ctx["traffic"], n, seed, dev)
    pc = tcfg.policy
    pc._class_name = tcfg.runner.policy_class_name
    if pc._class_name != "ActorCritic":
        raise ValueError("the train mode follows the MLP actor-critic only")
    net = nets.build_network(pc, env.num_obs, env.num_actions,
                             num_critic_obs=env.num_privileged_obs,
                             generator=torch.Generator().manual_seed(0)).to(dev)
    params0 = W.mlp_params(seed, dev, env.num_obs,
                           env.num_privileged_obs or env.num_obs,
                           env.num_actions, pc.actor_hidden_dims,
                           pc.critic_hidden_dims, pc.init_noise_std)
    net.load_state_dict(W.program_state_dict(params0), strict=True)
    alg = PPO(net, tcfg.algorithm, num_steps=tcfg.runner.num_steps_per_env,
              num_envs=n, device=env.device,
              share_critic_obs=env.num_privileged_obs is None, seed=seed)
    state, obs = env.reset_all()
    cobs = state.priv_obs if state.priv_obs is not None else obs
    carry = [state, obs, cobs, None]
    T = tcfg.runner.num_steps_per_env
    warm = int(ctx["traffic"].get("warmup_iterations", 2))
    if warm < 2:
        raise ValueError("the train mode warms up two iterations or more")
    cap = UpdateCapture(alg)
    *carry, _ = alg.train_iteration(env, *carry)
    cap.remove()
    upd = C.to_device(cap.d, "cpu")
    step_cap = C.StepCapture(env)
    ref_cap = C.RefreshCapture(env) if env.terrain is not None else None
    for i in range(1, warm):
        if i == warm - 1:
            step_cap.arm(after=int(seed) % T)
            if ref_cap is not None:
                ref_cap.arm(after=int(seed) % refreshes_per_iteration(env.cfg, T))
        *carry, _ = alg.train_iteration(env, *carry)
    step_cap.remove()
    if ref_cap is not None:
        ref_cap.remove()
    C.sync(env.device)
    return dict(env=env, alg=alg, net=net, tcfg=tcfg, carry=carry, T=T, N=n,
                params0=params0, update=upd, step=step_cap.data,
                refresh=None if ref_cap is None else ref_cap.data)


def refreshes_per_iteration(cfg, T):
    """How often ``PPO.rollout`` re-centers the heightfield windows in an
    iteration of ``T`` steps: at every step ``t`` with ``t % every == 0``."""
    every = int(getattr(cfg.terrain, "window_refresh_steps", 0))
    every = every if 0 < every < T else T
    return -(-T // every)


def window(ctx, s, seconds, log):
    """Whole iterations until ``seconds`` have passed; returns the run's
    counts and times."""
    alg, env, carry = s["alg"], s["env"], s["carry"]
    iters, roll, upd, per = 0, 0.0, 0.0, []
    C.sync(env.device)
    t0 = time.perf_counter()
    while True:
        ti = time.perf_counter()
        *carry, m = alg.train_iteration(env, *carry)
        per.append((time.perf_counter() - ti) * 1e3)
        iters += 1
        roll += m["rollout_s"]
        upd += m["update_s"]
        if time.perf_counter() - t0 >= seconds:
            break
    C.sync(env.device)
    w = time.perf_counter() - t0
    s["carry"] = carry
    log(f"iteration host ms: {' '.join(f'{x:.1f}' for x in per)}")
    return dict(iterations=iters, window_s=w, env_steps=iters * s["T"] * s["N"],
                control_steps=iters * s["T"], rollout_s=roll, update_s=upd,
                iteration_ms=per)


def work(ctx, s, ref_env, run):
    """The window's counted work, from the configuration's file and the
    reference's model: the control step's operations and bytes per launch,
    and the networks' operations in all (in their compute type)."""
    from reference.physics.backend import soa_model_for

    pc = ctx["config"]["train_cfg"]["policy"]
    ac = ctx["config"]["train_cfg"]["algorithm"]
    cfg = ref_env.cfg
    m = soa_model_for(ref_env.robot.dyn)
    terrain = cfg.terrain.mesh_type in ("heightfield", "trimesh")
    cs = bool(cfg.domain_rand.randomize_contact_stiffness)
    fwd = (K.mlp_flops(ref_env.num_obs, pc["actor_hidden_dims"], ref_env.num_actions)
           + K.mlp_flops(ref_env.num_privileged_obs or ref_env.num_obs,
                         pc["critic_hidden_dims"], 1))
    samples = s["T"] * s["N"]
    # the rollout's forward of every sample and the last value, then each
    # epoch's forward and backward (x3) of every sample
    per_iter = (samples + s["N"]) * fwd + ac["num_learning_epochs"] * samples * 3 * fwd
    return dict(
        step_flops=s["N"] * K.flops_per_env(m, cfg.control.decimation,
                                            cfg.sim.contact_iterations,
                                            terrain, cs),
        step_bytes=s["N"] * K.bytes_per_env(m, terrain, cs),
        net_flops=run["iterations"] * per_iter,
        net_precision=pc["dtype"],
    )


def _quant(dtype_name, control):
    """(compute dtype, control rounding) of the configuration's network."""
    dt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    if not control:
        return dt, None
    return dt, (torch.float8_e4m3fn if dt == torch.bfloat16 else "tf32")


def check(ctx, s, ref_env, control=False):
    """The compared numbers: control step, env step, policy, GAE, and the
    first three optimizer steps."""
    dev = ctx["device"]
    lowp = torch.bfloat16 if control else None
    nums = {"control_step_err": C.check_control_step(ref_env, s["step"], lowp),
            "env_step_err": C.check_env_step(ref_env, s["step"], lowp)}
    if ref_env.terrain is not None:
        nums["refresh_err"] = (math.inf if s.get("refresh") is None
                               else C.check_refresh(ref_env, s["refresh"], lowp))
    tcfg = s["tcfg"]
    dt, quant = _quant(tcfg.policy.dtype, control)
    nums.update(_check_ppo(s, dev, dt, quant, control))
    return nums


def _check_ppo(s, dev, dt, quant, control):
    from reference import policy as P
    from reference import ppo as RP

    u, params0, ac = s["update"], s["params0"], s["tcfg"].algorithm
    tr = u["transitions"]
    T, N = tr.values.shape
    rows = 1 << 18

    def fwd(q, obs, cobs):
        return P.forward(params0, obs.to(dev), None if cobs is None else cobs.to(dev),
                         dt, q)

    # the policy over the whole buffer (the rollout ran at params0)
    flat = lambda x: None if x is None else x.reshape((T * N,) + x.shape[2:])
    obs, cobs = flat(tr.obs), flat(tr.critic_obs)
    pol = 0.0
    with torch.no_grad():
        for sl in C.block_rows(T * N, rows):
            mu, std, val = fwd(None, obs[sl], None if cobs is None else cobs[sl])
            lp = P.log_prob(mu, std, flat(tr.actions)[sl].to(dev))
            if control:
                mine = fwd(quant, obs[sl], None if cobs is None else cobs[sl])
                mine = (mine[0], mine[2], P.log_prob(mine[0], mine[1],
                                                     flat(tr.actions)[sl].to(dev)))
            else:
                mine = (flat(tr.mu)[sl].to(dev), flat(tr.values)[sl].to(dev),
                        flat(tr.log_probs)[sl].to(dev))
            pol = max(pol, C.worst(zip(mine, (mu, val, lp))))
        # GAE from the buffer's values, rewards and dones
        last_v = fwd(None, u["last_obs"], None if tr.critic_obs is None
                     else u["last_critic_obs"])[2]
        adv, ret = RP.gae(tr.values.to(dev), u["rewards"].to(dev),
                          u["dones"].to(dev), last_v, ac.gamma, ac.lam)
    if control:
        m_adv, m_ret = C.round_to(adv, torch.bfloat16), C.round_to(ret, torch.bfloat16)
    else:
        m_adv, m_ret = u["advantages"].to(dev), u["returns"].to(dev)
    gae_err = C.worst([(m_adv, adv), (m_ret, ret)])
    # the first three minibatches of the update's permutation
    cfg = {k: getattr(ac, k) for k in (
        "clip_param", "use_clipped_value_loss", "value_loss_coef",
        "entropy_coef", "learning_rate", "schedule", "desired_kl",
        "max_grad_norm")}
    perm = u["perm"]
    mb = (T * N) // ac.num_mini_batches
    fields = dict(obs=obs, critic_obs=cobs, actions=flat(tr.actions),
                  log_probs=flat(tr.log_probs), values=flat(tr.values),
                  mu=flat(tr.mu), std=flat(tr.std),
                  advantages=adv.reshape(-1).cpu(), returns=ret.reshape(-1).cpu())
    mbs = []
    for i in range(N_STEPS_FOLLOWED):
        idx = perm[i * mb:(i + 1) * mb].cpu()
        mbs.append({k: None if v is None else v[idx].to(dev)
                    for k, v in fields.items()})
    r_losses, r_grad, r_after, r_start = RP.update_steps(params0, mbs, cfg, dt)
    if control:
        m_losses, m_grad, m_after, _ = RP.update_steps(params0, mbs, cfg, dt, quant)
    else:
        m_losses = u["losses"]
        m_grad = {W.from_program_name(k): v.to(dev) for k, v in u["first_grad"].items()}
        m_after = {W.from_program_name(k): v.to(dev)
                   for k, v in u["params_after"].items()}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-6)
                   for a, b in zip(m_losses, r_losses)) if len(m_losses) == len(r_losses) \
        else math.inf
    return {"policy_err": pol, "gae_err": gae_err, "loss_gap": loss_gap,
            "grad_gap": leaf_gap(m_grad, r_grad),
            "step_gap": leaf_gap({k: m_after[k] - r_start[k] for k in r_start},
                                 {k: r_after[k] - r_start[k] for k in r_start},
                                 r_grad)}


def leaf_gap(mine, ref, grads=None):
    """The worst leaf's |‖mine‖ - ‖ref‖| over max(‖ref‖ of that leaf, the
    median leaf's ‖ref‖). ``grads`` (the reference's first gradient): a
    leaf whose gradient is under a thousandth of the median leaf's is left
    out (Adam moves it by round-off alone)."""
    if set(mine) != set(ref):
        return math.inf
    rn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    mn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in mine.items()}
    keep = list(rn)
    if grads is not None:
        gn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads.items()}
        med = float(np.median(list(gn.values())))
        keep = [k for k in keep if gn[k] >= 1e-3 * med]
    med = float(np.median([rn[k] for k in keep]))
    gap = 0.0
    for k in keep:
        d = abs(mn[k] - rn[k]) / max(rn[k], med, 1e-30)
        gap = max(gap, d if math.isfinite(d) else math.inf)
    return gap
