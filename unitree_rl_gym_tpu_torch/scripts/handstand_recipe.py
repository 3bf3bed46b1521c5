"""Staged training recipe for the shipped go2_handstand artifact
(counterpart of ``unitree_rl_gym_tpu/scripts/handstand_recipe.py``).

The handstand hold is a delicate unstable-equilibrium skill that PPO erodes
whenever long upright-idle episodes dominate the sample mix, so the
artifact is trained in stages, each resuming the previous checkpoint:

  1. bootcamp   — all episodes start planted in the balanceable band
                  (RSI p=1, no mid states), sigma_0=0.5, 5000 iters:
                  learns the balance feedback
  2. braking    — p=1 with 25% mid-transition kick-up states (planted
                  feet, consistent rotation velocity), 2500 iters:
                  learns to arrest incoming pitch rates without
                  forgetting the hold
  3. kick-up mix — mid band widened to launch angles (th 15-140 deg),
                  30% mid, p annealed 1.0 -> 0.8 over 96k steps,
                  clip 0.1, 6000 iters: preserves the hold under
                  upright exposure

Run on the GPU:  python -m unitree_rl_gym_tpu_torch.scripts.handstand_recipe
Artifacts land in resources/pre_train/go2_handstand, replacing the shipped
fixture the parity tests read; ``main(out_dir=...)`` writes elsewhere.

Each phase is a plain (cfg overrides, train overrides, iters) triple: env
semantics (rewards, termination, obs) are never touched; only the
training-time RSI distribution and PPO hyperparameters vary. Each phase
logs and saves ``model_phase_end.pt`` under ``<log_root>/handstand_<phase>_logs``
(default the temporary directory).
"""

import json
import os
import tempfile

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR, resolve_device

PHASES = [
    # (name, iters, env overrides, train overrides)
    ("bootcamp", 5000,
     dict(handstand_init_prob=1.0, handstand_init_prob_final=1.0,
          handstand_anneal_steps=0.0, handstand_mid_frac=0.0),
     dict(clip_param=0.2)),
    ("braking", 2500,
     dict(handstand_init_prob=1.0, handstand_init_prob_final=1.0,
          handstand_anneal_steps=0.0, handstand_mid_frac=0.25),
     dict(clip_param=0.2)),
    ("kickup_mix", 6000,
     dict(handstand_init_prob=1.0, handstand_init_prob_final=0.8,
          handstand_anneal_steps=96000.0, handstand_mid_frac=0.3,
          handstand_mid_th_deg=(15.0, 120.0),
          handstand_mid_w=(1.0, 6.0)),
     dict(clip_param=0.1)),
]


def main(out_dir=None, iters=None, num_envs=4096, log_root=None, device=None):
    """Train the phases in order (each ``iters`` iterations, default the
    phase's), each from the previous phase's checkpoint, and export the
    last runner to ``out_dir``. Returns the checkpoint of every phase."""
    from unitree_rl_gym_tpu_torch.envs.go2_handstand import (
        GO2HandstandEnv, go2_handstand_cfg, go2_handstand_train_cfg,
    )
    from unitree_rl_gym_tpu_torch.export.export import export_policy
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    device = resolve_device(device)
    out_dir = out_dir or os.path.join(
        UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train",
        "go2_handstand",
    )
    log_root = log_root or tempfile.gettempdir()
    ckpt = None
    ckpts = []
    curves = []
    runner = None
    for name, phase_iters, env_over, train_over in PHASES:
        n = phase_iters if iters is None else iters
        cfg = go2_handstand_cfg()
        cfg.env.num_envs = num_envs
        for k, v in env_over.items():
            setattr(cfg.init_state, k, v)
        tcfg = go2_handstand_train_cfg()
        tcfg.policy.init_noise_std = 0.5
        tcfg.algorithm.entropy_coef = 0.005
        for k, v in train_over.items():
            setattr(tcfg.algorithm, k, v)
        tcfg.runner.max_iterations = n

        env = GO2HandstandEnv(cfg, device=device)
        log_dir = os.path.join(log_root, f"handstand_{name}_logs")
        runner = OnPolicyRunner(env, tcfg, log_dir=log_dir)
        if ckpt:
            runner.load(ckpt)
        runner.learn(num_learning_iterations=n, init_at_random_ep_len=True)
        ckpt = os.path.join(log_dir, "model_phase_end.pt")
        runner.save(ckpt)
        ckpts.append(ckpt)
        cj = os.path.join(log_dir, "curves.json")
        if os.path.exists(cj):
            with open(cj) as f:
                curves.extend(json.load(f))
        print(f"[handstand_recipe] phase {name} done ({n} iters)")

    os.makedirs(out_dir, exist_ok=True)
    export_policy(runner, out_dir)
    with open(os.path.join(out_dir, "curves.json"), "w") as f:
        json.dump(curves, f)
    print(f"[handstand_recipe] artifacts written to {out_dir}")
    return ckpts


if __name__ == "__main__":
    main()
