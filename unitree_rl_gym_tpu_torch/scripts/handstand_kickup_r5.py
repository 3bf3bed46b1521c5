"""Round-5 handstand kick-up-to-hold campaign (counterpart of
``unitree_rl_gym_tpu/scripts/handstand_kickup_r5.py``).

The r4 campaign produced the first real holds (16/16 envs >= 5 s,
reset-aware) but no kick-up-to-hold conversion: any recipe that mixes
upright starts erodes the hold faster than the kick-up is acquired,
because upright-idle episodes are ~5x longer and dominate the PPO sample
mix. This script runs the fixes (``AlgorithmCfg.anchor_kl_coef``, a
frozen-anchor KL toward the shipped holder on inverted states, and
``class_target_frac``, one-sided sample re-weighting) over a small
experiment grid, with reset-aware eval in the loop and best-checkpoint
selection.

Every experiment fine-tunes from the shipped 16/16 holder artifact
(``resources/pre_train/go2_handstand``, ``networks.load_flat_params``)
with that same artifact frozen as the anchor.

Eval criteria (reset-aware):
  * hold: from planted inverted starts (RSI p=1), longest
    termination-free run with g_z above the band edge and base > 0.3 m;
    held = >= 5 s (200 steps @ 40 Hz)
  * conversion: from upright starts (p=0), the same criterion held >= 3 s
    (120 steps); the 'done' bar is >= 25% of envs

Usage:  python -m unitree_rl_gym_tpu_torch.scripts.handstand_kickup_r5 \
            [--exp E1 ...] [--out DIR] [--src DIR]

It runs on the GPU (the env through kernel K1 at the handstand's sizes;
functions take ``device="cpu"`` for the plain PyTorch path). The reset
draws come from the eval env's ``torch.Generator``, seeded with the
rollout's seed where the JAX script passes ``PRNGKey(seed)`` to
``reset_all``. The best checkpoint is ``best.pt`` (the port's runner
format; ``helpers.get_load_path`` takes it).
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR, resolve_device

ART = os.path.join(
    UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train", "go2_handstand"
)

# (name, iters, env overrides, algo overrides)
# p anneals over `handstand_anneal_steps` CONTROL steps (24/iter).
EXPERIMENTS = {
    # moderate upright exposure, default clip; anchor carries erosion duty
    "E1": (4000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.6,
                handstand_anneal_steps=48000.0, handstand_mid_frac=0.3,
                handstand_mid_th_deg=(15.0, 120.0),
                handstand_mid_w=(1.0, 6.0)),
           dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                clip_param=0.2)),
    # stronger anchor, deeper anneal (more kick-up practice)
    "E2": (6000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.35,
                handstand_anneal_steps=72000.0, handstand_mid_frac=0.3,
                handstand_mid_th_deg=(15.0, 120.0),
                handstand_mid_w=(1.0, 6.0)),
           dict(anchor_kl_coef=3.0, class_target_frac=0.6,
                clip_param=0.2)),
    # heavy re-weighting, weak anchor
    "E3": (6000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.35,
                handstand_anneal_steps=72000.0, handstand_mid_frac=0.3,
                handstand_mid_th_deg=(15.0, 120.0),
                handstand_mid_w=(1.0, 6.0)),
           dict(anchor_kl_coef=0.3, class_target_frac=0.7,
                clip_param=0.2)),
    # staged fallen-band grace (the reference's own intent for this
    # termination, go2_handstand_env.py:211-212 comment): with a LONG
    # grace window a kick-up attempt is non-lethal at any episode time,
    # so upright exploration can find the transition; the anchor holds
    # the skill. Grace is tightened back in E5 before shipping (eval
    # always uses the stock 1.5 s).
    "E4": (6000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.3,
                handstand_anneal_steps=48000.0, handstand_mid_frac=0.3,
                handstand_mid_th_deg=(15.0, 120.0),
                handstand_mid_w=(1.0, 6.0),
                fallen_grace_s=8.0),
           dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                clip_param=0.2)),
    # braking drill: mid states concentrated at the ARRIVAL condition
    # (the deterministic kick-up reaches the band but over/under-rotates;
    # E1/E2 conv runs of 1-6 steps): th spans the top of the transition
    # through the hold band, w at the r3-measured arrival rates
    "E6": (6000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.4,
                handstand_anneal_steps=48000.0, handstand_mid_frac=0.45,
                handstand_mid_th_deg=(85.0, 125.0),
                handstand_mid_w=(2.0, 7.0),
                fallen_grace_s=8.0),
           dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                clip_param=0.2)),
    # staged ILLEGAL-CONTACT termination (r5 arrival diagnostics: every
    # deterministic kick-up attempt starts 0.1-0.4 s after reset and dies
    # by illegal contact mid-transition at ~10 rad/s with the base at
    # ~0.19 m — PPO never collects reward through the contact-rich
    # trajectory, so the kick never refines). A 1 s immunity window at
    # episode start makes the transition trainable; holds still must be
    # contact-clean past the window. Anneal back via E8/E9 before any
    # artifact ships (eval uses stock terminations throughout).
    "E7": (6000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.4,
                handstand_anneal_steps=48000.0, handstand_mid_frac=0.45,
                handstand_mid_th_deg=(85.0, 125.0),
                handstand_mid_w=(2.0, 7.0),
                fallen_grace_s=8.0, illegal_contact_grace_s=1.0),
           dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                clip_param=0.2)),
    # termination re-tightening chain (resume prior best via --src)
    "E8": (3000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.5,
                handstand_anneal_steps=0.0, handstand_mid_frac=0.3,
                handstand_mid_th_deg=(85.0, 125.0),
                handstand_mid_w=(2.0, 7.0),
                fallen_grace_s=3.0, illegal_contact_grace_s=0.5),
           dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                clip_param=0.2)),
    "E9": (3000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.6,
                handstand_anneal_steps=0.0, handstand_mid_frac=0.3,
                handstand_mid_th_deg=(85.0, 125.0),
                handstand_mid_w=(2.0, 7.0),
                fallen_grace_s=1.5),
           dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                clip_param=0.2)),
    # anti-face-roll shaping (r5 diagnostics on E7's final policy: 32/33
    # attempts invert near-perfectly — peak g_z med 0.56, p90 0.98 — but
    # at base height 0.13-0.21 m, a ground-level flip that dies by
    # illegal contact; only 3/33 ever reached band+height). The flat
    # orientation term pays the same for inversion at any height, so the
    # flip is the cheaper optimum. E10 shifts the orientation payout
    # onto the orientation x height product (rewards.inversion_height)
    # so only a PRESSED-UP inversion pays, widens the mid drill back to
    # the full press phase, and stretches the illegal-contact immunity
    # to 1.5 s (a press is slower than a flip and transits
    # thigh/calf-contact crouches).
    "E10": (6000,
            dict(handstand_init_prob=1.0, handstand_init_prob_final=0.4,
                 handstand_anneal_steps=48000.0, handstand_mid_frac=0.4,
                 handstand_mid_th_deg=(15.0, 125.0),
                 handstand_mid_w=(1.0, 7.0),
                 fallen_grace_s=8.0, illegal_contact_grace_s=1.5,
                 rew_orientation=1.0, rew_inversion_height=8.0),
            dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                 clip_param=0.2)),
    # arrival-speed braking drill (chain from E10's best via --src): the
    # E7/E10 diagnostics measured entry d(g_z)/dt of 10-17 /s (~= pitch
    # rate at th 90 deg) on the policy's own kick-ups, but every earlier
    # drill capped mid-state w at 6-7 rad/s — the policy never practices
    # braking at the speed it actually arrives. E11 drills th through
    # the top of the transition at the measured arrival rates, keeps the
    # E10 shaping so slower, higher presses stay more profitable, and
    # holds the graces open.
    "E11": (6000,
            dict(handstand_init_prob=1.0, handstand_init_prob_final=0.4,
                 handstand_anneal_steps=24000.0, handstand_mid_frac=0.45,
                 handstand_mid_th_deg=(80.0, 140.0),
                 handstand_mid_w=(3.0, 14.0),
                 fallen_grace_s=8.0, illegal_contact_grace_s=1.5,
                 rew_orientation=1.0, rew_inversion_height=8.0),
            dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                 clip_param=0.2)),
    # pivot-ENTRY drill (chain from E11's best via --src). The r5 basin
    # probe (handstand_basin.py on E11: 87.5% of planted mid states
    # convert to >= 3 s holds, across th 40-140 AND w up to 14 rad/s —
    # including 88% from near-static th 40-70 leans) proved the brake/
    # press skill is complete; the only broken link is upright ->
    # planted lean. E12 drills exactly that entry (static-ish th 30-75
    # leans), widens the re-weighting class to g_z > -0.8 so entry
    # states aren't drowned by upright idle (the anchor mask stays
    # g_z > 0 via ppo_anchor_mask_fn), and halves the remaining flat
    # orientation pay so the dive-flip attractor loses to the pivot.
    "E12": (6000,
            dict(handstand_init_prob=1.0, handstand_init_prob_final=0.4,
                 handstand_anneal_steps=24000.0, handstand_mid_frac=0.35,
                 handstand_mid_th_deg=(30.0, 75.0),
                 handstand_mid_w=(0.5, 3.0),
                 handstand_class_gz_threshold=-0.8,
                 fallen_grace_s=8.0, illegal_contact_grace_s=1.5,
                 rew_orientation=0.5, rew_inversion_height=8.0),
            dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                 clip_param=0.2)),
    # entry-GRADIENT drill (the r5 wrap-up recipe). E12 drilled entry
    # STATES (th 30-75 leans) and still converted 0: the remaining
    # hypothesis (doc/handstand_r5_notes.md, E12 results) is that the
    # upright -> lean sequence has no reward GRADIENT under the stock
    # terms — inversion_height only pays once inverted AND high, while
    # upright idle banks stay_still+stability (~3/step) and the first
    # degrees of lean pay nothing. E13 supplies the gradient directly:
    # the new rewards.entry_lean ramp (arccos-steep near upright, gated
    # on planted front feet AND base > 0.235 m so the dive-flip earns
    # ~0), cuts the idle payout (stay_still/stability 0.3) and the
    # anti-rock penalty (lin_vel_xy -0.5 — the entry IS a CoM
    # translation), zeroes flat orientation entirely, drills the entry
    # bridge (mid th 5-60, the new sub-30-deg mid-table rows), and
    # widens the re-weighting class to g_z > -0.95 (th >= 18 deg) so
    # even shallow leans aren't drowned by upright idle. Anchor mask
    # stays g_z > 0: the hold is pinned, everything below the horizon
    # is free to change.
    "E13": (6000,
            dict(handstand_init_prob=1.0, handstand_init_prob_final=0.35,
                 handstand_anneal_steps=24000.0, handstand_mid_frac=0.45,
                 handstand_mid_th_deg=(5.0, 60.0),
                 handstand_mid_w=(0.3, 2.5),
                 handstand_class_gz_threshold=-0.95,
                 fallen_grace_s=8.0, illegal_contact_grace_s=1.5,
                 rew_orientation=0.0, rew_inversion_height=8.0,
                 rew_entry_lean=6.0, rew_stay_still=0.3,
                 rew_stability=0.3, rew_lin_vel_xy=-0.5),
            dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                 clip_param=0.2)),
    # boundary drill (chain from E13's final via --src). E13's entry
    # gradient moved the basin edge all the way down: 94.1% of planted
    # th 5-60 / w 0.3-2.5 leans convert to >= 3 s holds — yet from TRUE
    # upright the deterministic policy still dive-flips (arrival diag:
    # min_h med 0.15, entry d(gz)/dt ~10/s). The remaining boundary is
    # sharp in OBS space: a th >= ~2 deg pivot has the hind contact
    # flags at 0 (rotation about the front feet lifts them ~1 cm+),
    # while upright has them at 1 — the policy discriminates on the
    # flags and keeps its inherited dive in the hind-loaded region.
    # E14 drills the continuum ACROSS the flag boundary: mid th 0-40
    # (th=0 w=0 IS the upright start, planted at FK height), w from 0,
    # heavier mid share, rewards as E13.
    "E14": (6000,
            dict(handstand_init_prob=1.0, handstand_init_prob_final=0.3,
                 handstand_anneal_steps=24000.0, handstand_mid_frac=0.55,
                 handstand_mid_th_deg=(0.0, 40.0),
                 handstand_mid_w=(0.0, 2.0),
                 handstand_class_gz_threshold=-0.95,
                 fallen_grace_s=8.0, illegal_contact_grace_s=1.5,
                 rew_orientation=0.0, rew_inversion_height=8.0,
                 rew_entry_lean=6.0, rew_stay_still=0.3,
                 rew_stability=0.3, rew_lin_vel_xy=-0.5),
            dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                 clip_param=0.2)),
    # dive-morphing drill (chain via --src). The per-step sigma noise
    # never samples the coherent multi-step rock from upright, so the
    # dive-flip stays the deterministic primitive there no matter how
    # richly the lean PAYS (E13/E14). E15 stops waiting for exploration
    # and morphs the primitive itself: rewards.pre_inversion_crouch
    # penalizes the base dipping below 0.235 m in the transition region
    # (exactly where the dive sweeps, 0.13-0.21 m), so every PPO update
    # lifts the flip a little until it becomes the tall planted pivot
    # the press basin catches (94% conversion from planted leans).
    "E15": (6000,
            dict(handstand_init_prob=1.0, handstand_init_prob_final=0.3,
                 handstand_anneal_steps=24000.0, handstand_mid_frac=0.55,
                 handstand_mid_th_deg=(0.0, 40.0),
                 handstand_mid_w=(0.0, 2.0),
                 handstand_class_gz_threshold=-0.95,
                 fallen_grace_s=8.0, illegal_contact_grace_s=1.5,
                 rew_orientation=0.0, rew_inversion_height=8.0,
                 rew_entry_lean=6.0, rew_stay_still=0.3,
                 rew_stability=0.3, rew_lin_vel_xy=-0.5,
                 rew_pre_inversion_crouch=-30.0),
            dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                 clip_param=0.2)),
    # grace re-tightening fine-tune (resume E4's best via --src)
    "E5": (3000,
           dict(handstand_init_prob=1.0, handstand_init_prob_final=0.5,
                handstand_anneal_steps=0.0, handstand_mid_frac=0.3,
                handstand_mid_th_deg=(15.0, 120.0),
                handstand_mid_w=(1.0, 6.0),
                fallen_grace_s=3.0),
           dict(anchor_kl_coef=1.0, class_target_frac=0.5,
                clip_param=0.2)),
}

EVAL_EVERY = 500          # iters between reset-aware evals
N_EVAL = 16


def experiment_cfgs(name):
    """(iters, env cfg, train cfg) of experiment ``name``: the stock
    go2_handstand cfgs at 4096 envs with its overrides (RSI knobs on
    ``init_state``, ``rew_<term>`` reward scales, the rest on ``env``) and
    the campaign's PPO settings."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    iters, env_over, algo_over = EXPERIMENTS[name]
    cfg, tcfg = task_registry.get_cfgs("go2_handstand")
    cfg.env.num_envs = 4096
    for k, v in env_over.items():
        # RSI knobs live on init_state; reward-scale overrides use a
        # rew_ prefix; termination staging (grace) lives on env
        if k.startswith("rew_"):
            cfg.rewards.scales[k[4:]] = v
        else:
            tgt_blk = cfg.init_state if k.startswith("handstand_") else cfg.env
            setattr(tgt_blk, k, v)
    tcfg.policy.init_noise_std = 0.5
    tcfg.algorithm.entropy_coef = 0.005
    # staged-termination regimes explode the critic transiently; worth
    # the guard's cost here
    tcfg.algorithm.nan_guard = True
    for k, v in algo_over.items():
        setattr(tcfg.algorithm, k, v)
    tcfg.runner.max_iterations = iters
    tcfg.runner.save_interval = 10 ** 9  # the campaign saves; skip periodic
    return iters, cfg, tcfg


def load_holder(src=ART, device=None):
    """The go2_handstand actor-critic (the task's train cfg) holding the
    full train params of the flat artifact ``src``, on ``device``."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.models import networks as nets

    cfg, tcfg = task_registry.get_cfgs("go2_handstand")
    tcfg.policy._class_name = tcfg.runner.policy_class_name
    net = nets.build_network(tcfg.policy, cfg.env.num_observations,
                             cfg.env.num_actions,
                             num_critic_obs=cfg.env.num_privileged_obs)
    return nets.load_flat_params(net, src).to(resolve_device(device))


def policy_steps(env, net, state, obs, steps):
    """``steps`` steps of the deterministic policy of ``net`` (a float32
    copy: the network may compute in bf16) from ``state``/``obs``. Returns
    (final state, final obs, and per step done, projected g_z and base
    height, each [steps, N] on the env's device)."""
    net32 = net.inference_copy().to(env.device)
    carry = net32.initial_carry(env.num_envs) if net32.is_recurrent else None
    done, pgz, h = [], [], []
    with torch.no_grad():
        for _ in range(steps):
            if net32.is_recurrent:
                mu, carry = net32.act(obs, carry)
            else:
                mu = net32.act(obs)
            state, obs, _, _, d, _ = env.step(state, mu)
            done.append(d)
            pgz.append(env._projected_gravity(state.phys.base_quat)[:, 2])
            h.append(state.phys.base_pos[:, 2])
    return state, obs, torch.stack(done), torch.stack(pgz), torch.stack(h)


def rollout(env, net, steps, seed):
    """:func:`policy_steps` from ``env.reset_all()`` with ``env.gen``
    seeded with ``seed`` (where the JAX script passes ``PRNGKey(seed)``)."""
    env.gen.manual_seed(int(seed))
    state, obs = env.reset_all()
    return policy_steps(env, net, state, obs, steps)


def best_runs(ok):
    """Per env the longest run of consecutive True steps of ``ok`` [T, N]."""
    run = np.zeros(ok.shape[1])
    best = np.zeros(ok.shape[1])
    for t in range(ok.shape[0]):
        run = np.where(ok[t], run + 1, 0)
        best = np.maximum(best, run)
    return best


class Evaluator:
    """Reset-aware hold/conversion eval (tests/test_pretrained_go2's
    criteria): one 16-env eval env per RSI probability, cached across
    experiments, and a plain loop of ``env.step`` under ``torch.no_grad``
    with the policy in float32. ``_fn(init_prob, steps, net)`` gives the
    rollout of a seed as numpy (done, g_z, height) [steps, N_EVAL]."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.envs = {}

    def _env(self, init_prob):
        if init_prob not in self.envs:
            from unitree_rl_gym_tpu_torch.envs.registry import task_registry

            cfg, _ = task_registry.get_cfgs("go2_handstand")
            cfg.env.num_envs = N_EVAL
            cfg.noise.add_noise = False
            cfg.domain_rand.randomize_friction = False
            cfg.domain_rand.randomize_base_mass = False
            cfg.domain_rand.push_robots = False
            cfg.domain_rand.randomize_contact_stiffness = False
            cfg.env.test = True
            cfg.init_state.handstand_init_prob = init_prob
            cfg.init_state.handstand_init_prob_final = init_prob
            cfg.init_state.handstand_mid_frac = 0.0
            self.envs[init_prob] = task_registry.get_task_class(
                "go2_handstand"
            )(cfg, device=self.device)
        return self.envs[init_prob]

    def _fn(self, init_prob, steps, net):
        env = self._env(init_prob)

        def fn(seed):
            _, _, done, pgz, h = rollout(env, net, steps, seed)
            return tuple(x.cpu().numpy() for x in (done, pgz, h))

        return fn

    def runs(self, net, init_prob, steps, seed=0):
        env = self._env(init_prob)
        th_lo = env.cfg.init_state.handstand_hold_th_deg[0]
        pgz_th = float(-np.cos(np.deg2rad(th_lo)) - 0.01)
        done, pgz, h = self._fn(init_prob, steps, net)(seed)
        done = np.asarray(done)
        pgz = np.asarray(pgz)
        ok = (~done) & (pgz > pgz_th) & (np.asarray(h) > 0.3)
        return best_runs(ok), pgz.max(axis=0)

    def rates(self, net, seed=0):
        hold, _ = self.runs(net, 1.0, 450, seed)
        conv, conv_maxg = self.runs(net, 0.0, 500, seed)
        return {
            "hold_rate": float((hold >= 200).mean()),
            "conv_rate": float((conv >= 120).mean()),
            # kick-up initiation from upright: reaching the inverted band
            # at all, regardless of holding it ("not attempting" against
            # "attempting, not braking")
            "init_rate": float((conv_maxg > 0.2).mean()),
            "hold_runs": hold.astype(int).tolist(),
            "conv_runs": conv.astype(int).tolist(),
        }


def run_experiment(name, out_root, ev=None, src=None, iters=None,
                   eval_every=EVAL_EVERY, device=None):
    """Fine-tune experiment ``name`` from the holder (``src`` or the shipped
    artifact, also the anchor) for ``iters`` (default the experiment's)
    iterations, evaluating every ``eval_every``; saves ``best.pt``,
    ``best_export/`` and ``campaign.json`` under ``out_root/name`` and
    ``final_export/`` at the end. Returns the best record."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.export.export import export_policy
    from unitree_rl_gym_tpu_torch.models.networks import load_flat_params
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    n_iters, cfg, tcfg = experiment_cfgs(name)
    iters = n_iters if iters is None else iters
    tcfg.runner.max_iterations = iters
    out = os.path.join(out_root, name)
    os.makedirs(out, exist_ok=True)

    env = task_registry.get_task_class("go2_handstand")(
        cfg, device=resolve_device(device))
    runner = OnPolicyRunner(env, tcfg, log_dir=os.path.join(out, "logs"))
    load_flat_params(runner.net, src or ART)
    runner.set_anchor()  # anchor = the shipped 16/16 holder

    ev = ev or Evaluator(env.device)
    base = ev.rates(runner.net)
    print(f"[{name}] baseline holder: {base['hold_rate']:.2f} hold, "
          f"{base['conv_rate']:.2f} conv", flush=True)

    history = [dict(it=0, **{k: base[k] for k in ("hold_rate", "conv_rate")})]
    best = dict(score=(-1.0, -1.0), it=0)
    dead_evals = 0
    for chunk_start in range(0, iters, eval_every):
        n = min(eval_every, iters - chunk_start)
        runner.learn(n, init_at_random_ep_len=True)
        r = ev.rates(runner.net)
        it = runner.current_learning_iteration
        print(f"[{name}] it {it}: hold {r['hold_rate']:.2f} "
              f"conv {r['conv_rate']:.2f} init {r['init_rate']:.2f} "
              f"runs {sorted(r['conv_runs'])[-4:]}",
              flush=True)
        history.append(dict(it=it, hold_rate=r["hold_rate"],
                            conv_rate=r["conv_rate"],
                            init_rate=r["init_rate"]))
        # watchdog: a run whose hold and initiation are both zero has
        # diverged past recovery; stop burning chip time (the best
        # checkpoint is already on disk)
        dead = r["hold_rate"] == 0.0 and r["init_rate"] == 0.0
        dead_evals = dead_evals + 1 if dead else 0
        if dead_evals >= 2:
            print(f"[{name}] early stop: policy destroyed "
                  f"(2 consecutive dead evals)", flush=True)
            break
        # selection: conversion first, but never ship a hold regression
        # below the 50% acceptance bar
        score = (r["conv_rate"] if r["hold_rate"] >= 0.5 else -1.0,
                 r["hold_rate"])
        if score > tuple(best["score"]):
            best = dict(score=list(score), it=it, rates=r)
            runner.save(os.path.join(out, "best.pt"))
            export_policy(runner, os.path.join(out, "best_export"))
        with open(os.path.join(out, "campaign.json"), "w") as f:
            json.dump(dict(history=history, best=best), f, indent=1)
    # final policy too (staged-termination experiments may only show
    # their value after a tightening phase chained via --src)
    export_policy(runner, os.path.join(out, "final_export"))
    print(f"[{name}] done. best it {best['it']} score {best['score']}",
          flush=True)
    return best


def main(argv=None):
    from unitree_rl_gym_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", nargs="*", default=["E1", "E2", "E3"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "handstand_r5"))
    ap.add_argument("--src", default=None,
                    help="flat artifact dir to fine-tune from "
                         "(default: the shipped holder; also the anchor)")
    args = ap.parse_args(argv)
    results = {}
    ev = Evaluator()
    for name in args.exp:
        results[name] = run_experiment(name, args.out, ev, src=args.src)
    print(json.dumps(results, indent=1, default=str))
    return results


if __name__ == "__main__":
    main()
