"""Arrival diagnostics for the handstand kick-up conversion (counterpart of
``unitree_rl_gym_tpu/scripts/handstand_diag.py``).

From all-upright starts, runs the deterministic policy and dissects every
attempt (a maximal segment with projected_gravity_z > 0.0): entry rate,
peak g_z, base height through the segment, and how the attempt ends
(termination / fell back below the hemisphere / survived to eval end).
Answers "why doesn't the arrival convert": over-rotation past the band,
under-rotation falling back, height collapse (toppling with g_z still
high), or termination mid-crossing.

    python -m unitree_rl_gym_tpu_torch.scripts.handstand_diag --src <artifact>

On the GPU; ``diagnose(..., device="cpu")`` runs the plain PyTorch path.
"""

import argparse
import json

import numpy as np

from unitree_rl_gym_tpu_torch.scripts.handstand_kickup_r5 import (
    ART, Evaluator, load_holder,
)


def analyze(done, pgz, h, band=(0.242, 0.438), dt=0.025):
    """done/pgz/h: [T, N]. Returns attempt records."""
    T, N = pgz.shape
    attempts = []
    for i in range(N):
        t = 0
        while t < T:
            if pgz[t, i] > 0.0:
                t0 = t
                while t < T and pgz[t, i] > 0.0 and not done[t, i]:
                    t += 1
                seg = slice(t0, t)
                peak = float(pgz[seg, i].max())
                hmin = float(h[seg, i].min())
                # entry pitch rate from the g_z slope: d(gz)/dt = sin(th)*w
                if t0 >= 2:
                    dgz = (pgz[t0, i] - pgz[t0 - 2, i]) / (2 * dt)
                else:
                    dgz = 0.0
                end = (
                    "terminated" if (t < T and done[t, i])
                    else ("fell_back" if t < T else "eval_end")
                )
                in_band_steps = int(
                    ((pgz[seg, i] > band[0]) & (pgz[seg, i] < band[1])
                     & (h[seg, i] > 0.3)).sum()
                )
                attempts.append(dict(
                    env=i, t0=t0, steps=t - t0, peak_gz=round(peak, 3),
                    min_h=round(hmin, 3), entry_dgz=round(float(dgz), 2),
                    end=end, in_band_steps=in_band_steps,
                ))
            else:
                t += 1
    return attempts


def diagnose(src=ART, steps=500, seed=0, device=None):
    """``analyze`` of ``steps`` upright-start steps (the conversion eval
    env) of the policy of ``src``; returns (attempts, number of envs)."""
    net = load_holder(src, device)
    ev = Evaluator(device)
    done, pgz, h = ev._fn(0.0, steps, net)(seed)
    return analyze(np.asarray(done), np.asarray(pgz), np.asarray(h)), pgz.shape[1]


def main(argv=None):
    from unitree_rl_gym_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=ART)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    att, n_envs = diagnose(args.src, args.steps, args.seed)

    by_end = {}
    for a in att:
        by_end.setdefault(a["end"], []).append(a)
    print(f"{len(att)} attempts across {n_envs} envs")
    for end, rows in by_end.items():
        peaks = np.array([r["peak_gz"] for r in rows])
        hs = np.array([r["min_h"] for r in rows])
        steps = np.array([r["steps"] for r in rows])
        print(f"  {end}: n={len(rows)} peak_gz med {np.median(peaks):.2f} "
              f"(p90 {np.percentile(peaks, 90):.2f}) min_h med "
              f"{np.median(hs):.2f} len med {np.median(steps):.0f} steps")
    over = sum(1 for a in att if a["peak_gz"] > 0.5)
    inband = sum(1 for a in att if a["in_band_steps"] > 0)
    low = sum(1 for a in att if a["min_h"] < 0.3)
    print(f"  over-rotated past band (peak>0.5): {over}")
    print(f"  achieved band+height at least 1 step: {inband}")
    print(f"  height collapsed below 0.3 during attempt: {low}")
    print(json.dumps(att[:40], indent=0))
    return att


if __name__ == "__main__":
    main()
