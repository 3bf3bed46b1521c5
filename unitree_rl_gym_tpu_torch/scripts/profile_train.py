"""Profile full PPO train iterations on the card and print the device time
by kernel (counterpart of ``unitree_rl_gym_tpu/scripts/profile_train.py``):

    python -m unitree_rl_gym_tpu_torch.scripts.profile_train --task=go2 \\
        [--num_envs=4096] [--iters=2] [--out=DIR] [--device=cpu]

Builds the config as ``bench_torch.build`` does (the program the port's
bench measures), times 3 iterations after a warm-up with the device
synchronised, then runs ``--iters`` iterations under ``torch.profiler``
and sums the device time of every kernel by name from its CUDA events:
the top 25 with their share, and the total. ``--out`` also writes the
Chrome trace there.

The aggregation is the one the port's ``chip_smoke.py`` prints:
:func:`iteration_breakdown` (one training iteration by part: the
control-step kernel, the rollout and update ranges, GEMMs, the idle share)
and :func:`step_breakdown` (per rollout step by kernel group).
"""

import argparse
import json
import os
import sys
import time

import torch

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR, resolve_device

TOP = 25
# kernel names counted as matrix products; the per-step view counts the
# first three, as chip_smoke.py's per-step profile always has
GEMM_NAMES = ("gemm", "xmma", "cutlass", "gemv")


def build(task, num_envs, device):
    """``bench_torch.build``: (alg, env, (state, obs, critic obs, carry),
    env-steps per iteration)."""
    sys.path.insert(0, UNITREE_RL_GYM_TPU_ROOT_DIR)
    import bench_torch

    return bench_torch.build(task, num_envs, device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_iterations(alg, env, carry, iters=3):
    """One warm-up iteration, then ``iters`` timed with the device
    synchronised; returns (ms per iteration, the carry after them)."""
    *carry, _ = alg.train_iteration(env, *carry)
    sync(env.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        *carry, _ = alg.train_iteration(env, *carry)
    sync(env.device)
    return (time.perf_counter() - t0) / iters * 1e3, carry


def profiled(fn, device):
    """Run ``fn()`` under ``torch.profiler`` (CPU, and CUDA on a card) with
    the device synchronised around it; returns the profile."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities) as prof:
        fn()
        sync(device)
    return prof


def profile_iterations(alg, env, carry, iters):
    """``iters`` train iterations under the profiler; returns (profile, the
    carry after them)."""
    out = {}

    def run():
        c = carry
        for _ in range(iters):
            *c, _ = alg.train_iteration(env, *c)
        out["carry"] = c

    return profiled(run, env.device), out["carry"]


def device_events(prof):
    """(spans, kernels) of a profile: the device spans of each profiler
    range, {name: [(start_us, end_us)]}, and every device kernel as (name,
    start_us, ms)."""
    spans, kernels = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
        else:
            kernels.append((e.name, e.time_range.start, e.time_range.elapsed_us() / 1e3))
    return spans, kernels


def by_name(kernels, scale=1.0):
    """Device ms per kernel name, times ``scale``."""
    out = {}
    for name, _, ms in kernels:
        out[name] = out.get(name, 0.0) + ms * scale
    return out


def top_kernels(kernels, top=TOP):
    """(total device ms, [(ms, share %, name)] of the ``top`` kernel names
    by device time)."""
    names = by_name(kernels)
    total = sum(names.values())
    rows = sorted(names.items(), key=lambda kv: -kv[1])[:top]
    return total, [(ms, 100.0 * ms / max(total, 1e-12), name[:110]) for name, ms in rows]


def iteration_breakdown(prof, iteration_ms, rollout_ms, update_ms,
                        kernel="k3_ms", rollout_range=("window_contraction_ms",
                                                       "terrain_window_contraction"),
                        update_range=None):
    """Device time of one profiled training iteration by part: the
    control-step kernel by name (reported as ``kernel``) and kernels by the
    profiler range they ran in (the rollout, the update, and the ranges
    ``rollout_range`` / ``update_range`` (label, range name) inside them: a
    kernel belongs to a range when it starts inside that range's span on
    the device timeline). Idle shares are measured against the unprofiled
    host times."""
    spans, kernels = device_events(prof)
    total = sum(k[2] for k in kernels)
    if total == 0.0:
        return {"device_ms_per_iteration": "not measured (the profiler saw no device time)"}

    def in_range(name):
        if name not in spans:
            return "not measured (no device span for the range)"
        return sum(ms for _, t, ms in kernels
                   if any(a <= t < b for a, b in spans[name]))

    names = by_name(kernels)
    step_kernel = sum(v for k, v in names.items() if "utrl_control_step" in k)
    rollout, update = in_range("ppo_rollout"), in_range("ppo_update")
    out = {
        "device_ms_per_iteration": total,
        kernel: step_kernel,
        "rollout_device_ms": rollout,
        "update_device_ms": update,
        "gemm_kernels_ms": sum(v for k, v in names.items()
                               if any(g in k.lower() for g in GEMM_NAMES)),
        "n_kernel_names": len(names),
        "device_idle_share": max(0.0, 1.0 - total / iteration_ms),
        "top_kernels_ms": [[k[:80], v] for k, v in
                           sorted(names.items(), key=lambda kv: -kv[1])[:10]],
    }
    inner = {}
    for part, rng in (("rollout", rollout_range), ("update", update_range)):
        if rng is not None:
            out[rng[0]] = inner[part] = in_range(rng[1])
    if isinstance(rollout, float) and isinstance(inner.get("rollout", 0.0), float):
        out["rollout_other_ms"] = rollout - step_kernel - inner.get("rollout", 0.0)
        out["rollout_idle_share"] = max(0.0, 1.0 - rollout / rollout_ms)
    if isinstance(update, float):
        if isinstance(inner.get("update", 0.0), float) and update_range is not None:
            out["update_other_ms"] = update - inner["update"]
        out["update_idle_share"] = max(0.0, 1.0 - update / update_ms)
    return out


def step_breakdown(prof, steps, step_ms):
    """Device time per rollout step by kernel group over ``steps`` profiled
    steps; the idle share is measured against the unprofiled ``step_ms``."""
    names = by_name(device_events(prof)[1], 1.0 / steps)
    total = sum(names.values())
    if total == 0.0:
        return {"device_ms_per_step": "not measured (the profiler saw no device time)"}
    k1 = sum(v for k, v in names.items() if "utrl_control_step" in k)
    mm = sum(v for k, v in names.items() if any(g in k.lower() for g in GEMM_NAMES[:3]))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device_ms_per_step": total,
        "k1_ms_per_step": k1,
        "actor_matmul_ms_per_step": mm,
        "other_kernels_ms_per_step": total - k1 - mm,
        "n_kernel_names": len(names),
        "device_idle_share": max(0.0, 1.0 - total / step_ms),
        "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="go2")
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    alg, env, carry, spi = build(args.task, args.num_envs, device)
    ms, carry = time_iterations(alg, env, carry, 3)
    print(f"[profile] {args.task}: {ms:.2f} ms/iter "
          f"({spi / ms * 1000:.0f} env-steps/s)")
    prof, carry = profile_iterations(alg, env, carry, args.iters)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    total_ms, rows = top_kernels(device_events(prof)[1])
    print(f"[profile] total device kernel time over {args.iters} iters: "
          f"{total_ms:.1f} ms")
    for dur, pct, name in rows:
        print(f"{dur:9.2f} ms {pct:5.1f}%  {name}")
    print(json.dumps({"task": args.task, "num_envs": args.num_envs,
                      "iteration_ms": ms, "env_steps_per_s": spi / ms * 1e3,
                      "profiled_iters": args.iters, "device_ms_total": total_ms,
                      "top": [list(r) for r in rows]}))


if __name__ == "__main__":
    main()
