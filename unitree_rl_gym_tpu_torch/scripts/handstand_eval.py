"""Multi-seed handstand capability eval (counterpart of
``unitree_rl_gym_tpu/scripts/handstand_eval.py``).

Evaluates a flat artifact dir across several reset seeds with the
reset-aware criteria (tests/test_pretrained_go2 semantics;
``handstand_kickup_r5.Evaluator``) and prints a per-seed capability table.

    python -m unitree_rl_gym_tpu_torch.scripts.handstand_eval \\
        [--src resources/pre_train/go2_handstand] [--seeds 0 1 2 3 4]

On the GPU; ``evaluate(..., device="cpu")`` runs the plain PyTorch path.
"""

import argparse
import json

import numpy as np

from unitree_rl_gym_tpu_torch.scripts.handstand_kickup_r5 import (
    ART, Evaluator, load_holder,
)


def evaluate(src=ART, seeds=(0, 1, 2), device=None):
    """The hold, conversion and initiation rates of ``src`` for each reset
    seed, and their means."""
    net = load_holder(src, device)
    ev = Evaluator(device)
    rows = []
    for seed in seeds:
        r = ev.rates(net, seed=seed)
        rows.append(dict(seed=seed, **{
            k: r[k] for k in ("hold_rate", "conv_rate", "init_rate")
        }, hold_runs=sorted(r["hold_runs"])[:4],
            conv_runs=sorted(r["conv_runs"])[-4:]))
        print(f"seed {seed}: hold {r['hold_rate']:.2f} "
              f"conv {r['conv_rate']:.2f} init {r['init_rate']:.2f} "
              f"worst-hold-runs {sorted(r['hold_runs'])[:4]}", flush=True)
    agg = {
        "hold_rate_mean": float(np.mean([r["hold_rate"] for r in rows])),
        "conv_rate_mean": float(np.mean([r["conv_rate"] for r in rows])),
        "init_rate_mean": float(np.mean([r["init_rate"] for r in rows])),
    }
    return dict(src=src, per_seed=rows, **agg)


def main(argv=None):
    from unitree_rl_gym_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=ART)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    args = ap.parse_args(argv)
    out = evaluate(args.src, args.seeds)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
