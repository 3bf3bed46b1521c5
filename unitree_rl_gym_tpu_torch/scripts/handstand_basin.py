"""Map the hold basin of attraction over mid-transition states (counterpart
of ``unitree_rl_gym_tpu/scripts/handstand_basin.py``).

Resets every env mid-kick-up (RSI mid states: planted front feet, trunk
pitched th with pitch rate w toward inversion) and runs the deterministic
policy, then bins the outcome by the *initial* (th, w) read back from the
first-step state. The arrival diagnostics (handstand_diag.py) show where
the policy's own kick-ups arrive; this shows from where the policy can
brake into a >= 3 s hold. If the basin is empty even at low w, the braking
drill never taught braking; if a basin exists but excludes the arrival
envelope, the kick itself must be slowed or shaped into the basin.

    python -m unitree_rl_gym_tpu_torch.scripts.handstand_basin \\
        [--src <artifact>] [--envs 256] [--w 1 14] [--th 40 140]

On the GPU; ``basin(..., device="cpu")`` runs the plain PyTorch path.
"""

import argparse
import json

import numpy as np

from unitree_rl_gym_tpu_torch import resolve_device
from unitree_rl_gym_tpu_torch.scripts.handstand_kickup_r5 import (
    ART, best_runs, load_holder, policy_steps,
)

TH_BINS = [40, 70, 90, 110, 125, 140]
W_BINS = [0, 2, 4, 6, 8, 11, 14.5]


def basin_grid(th0, w0, held):
    """The hold-from-mid rate and env count of every occupied (th, w) bin
    of the initial pitch ``th0`` (degrees) and pitch rate ``w0`` [N], as
    ``{"th<lo>-<hi> w<lo>-<hi>": "<rate> (<n>)"}``."""
    grid = {}
    for i in range(len(TH_BINS) - 1):
        for j in range(len(W_BINS) - 1):
            m = (
                (th0 >= TH_BINS[i]) & (th0 < TH_BINS[i + 1])
                & (w0 >= W_BINS[j]) & (w0 < W_BINS[j + 1])
            )
            if m.sum() == 0:
                continue
            grid[f"th{TH_BINS[i]}-{TH_BINS[i+1]} w{W_BINS[j]}-{W_BINS[j+1]}"] = (
                f"{held[m].mean():.2f} ({int(m.sum())})"
            )
    return grid


def basin(src=ART, envs=256, steps=450, w=(1.0, 14.0), th=(40.0, 140.0),
          seed=0, device=None):
    """Reset ``envs`` envs mid-kick-up with pitch in ``th`` (degrees) and
    pitch rate in ``w`` (rad/s), run the policy of ``src`` ``steps`` steps;
    returns (rate, grid, th0, w0, held) with th0/w0 the read-back initial
    pitch and rate [envs] and held the >= 3 s holds [envs]."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    cfg, _ = task_registry.get_cfgs("go2_handstand")
    cfg.env.num_envs = envs
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.env.test = True
    cfg.init_state.handstand_init_prob = 1.0
    cfg.init_state.handstand_init_prob_final = 1.0
    cfg.init_state.handstand_mid_frac = 1.0
    cfg.init_state.handstand_mid_th_deg = tuple(th)
    cfg.init_state.handstand_mid_w = tuple(w)
    env = task_registry.get_task_class("go2_handstand")(
        cfg, device=resolve_device(device))
    net = load_holder(src, env.device)

    th_lo = cfg.init_state.handstand_hold_th_deg[0]
    pgz_th = float(-np.cos(np.deg2rad(th_lo)) - 0.01)

    env.gen.manual_seed(int(seed))
    state, obs = env.reset_all()
    # initial pitch and rate straight from the post-reset physics state
    gz0 = env._projected_gravity(state.phys.base_quat)[:, 2].cpu().numpy()
    w0 = state.phys.v[:, 1].cpu().numpy()          # body pitch rate
    _, _, done, pgz, h = policy_steps(env, net, state, obs, steps)
    done, pgz, h = (x.cpu().numpy() for x in (done, pgz, h))
    best = best_runs((~done) & (pgz > pgz_th) & (h > 0.3))
    th0 = np.rad2deg(np.arccos(np.clip(-gz0, -1.0, 1.0)))
    held = best >= 120          # 3 s
    return float(held.mean()), basin_grid(th0, w0, held), th0, w0, held


def main(argv=None):
    from unitree_rl_gym_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=ART)
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=450)
    ap.add_argument("--w", type=float, nargs=2, default=(1.0, 14.0))
    ap.add_argument("--th", type=float, nargs=2, default=(40.0, 140.0))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rate, grid, _, _, held = basin(args.src, args.envs, args.steps, args.w,
                                   args.th, args.seed)
    print(f"overall hold-from-mid rate: {rate:.3f} "
          f"({int(held.sum())}/{args.envs})")
    for k in sorted(grid):
        print(f"  {k}: {grid[k]}")
    out = dict(src=args.src, rate=rate, grid=grid)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
