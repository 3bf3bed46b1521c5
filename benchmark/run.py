#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``unitree_rl_gym_tpu_torch``):
one cell of ``BENCHMARK.json`` per run, on one NVIDIA H100.

    python3 benchmark/run.py --workload go2.train --seed 7 --seconds 20 --trace 0

The cell names a configuration (``configs/<name>.json``: the task and its
every cfg value) and a traffic mix (``traffic/<name>.json``: the mode,
``train`` or ``rollout``, the number of envs, the warm-up and any cfg
overrides); its limits are ``limits/<cell>.json`` and every metric is read
by ``metrics/<metric>.py``. Adding a cell, a configuration, a mix or a
metric adds files and edits none.

A run builds the program from the seed, warms up every shape it will use
(set-up, ``setup_s``: from the process's start to the window's), then
measures whole iterations (or steps) until ``--seconds`` have passed,
synchronising the device at the end. ``--trace 1`` runs the same window
under ``torch.profiler`` and prints the per-layer metrics instead of the
end-to-end ones. After the window the plain reference (``reference/``)
judges what the program produced, and the last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), with the numbers compared and
their limits last, as they are also printed last on standard error.

An option the benchmark's own runs never pass: ``--control 1`` puts the
reference computed in the next precision down in the program's place
(it must come out not correct).

Exits non-zero without a result when there is no card (or fewer than the
cell asks for), when the program is not there, or when ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "unitree_rl_gym_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "unitree_rl_gym_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHE_DIRS = {
    "UTRL_BUILD_CACHE_DIR": os.path.join(ROOT, PROGRAM, "_build"),
    "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, ".bench_cache", "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(ROOT, ".bench_cache", "triton"),
}

for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def spec_of(workload):
    """(BENCHMARK.json, the cell's entry, configuration, traffic, limits)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    return (bench, cell, load_json("configs", cell["config"] + ".json"),
            load_json("traffic", cell["traffic"] + ".json"),
            load_json("limits", workload + ".json"))


def metrics_of(bench, workload, trace):
    """The cell's metrics of the run's kind: end-to-end untraced, per-layer
    traced; a metric with a ``workloads`` list counts only in those."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device=None, traffic_update=None):
    """Set-up, window, reference; returns (result dict, comparisons). On a
    CPU ``device`` (the harness's tests) the card checks are skipped;
    ``traffic_update`` (the tests' width and shorter warm-up) updates the
    mix."""
    for k, v in CACHE_DIRS.items():
        os.environ[k] = v
    os.environ["USE_FLAX"] = "0"
    bench, cell, config, traffic, limits = spec_of(args.workload)
    traffic.update(traffic_update or {})
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch.cuda.is_available() is False: no result")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise SystemExit(f"{torch.cuda.device_count()} cards, the cell asks "
                             f"for {cell['chips']}: no result")
        device = torch.device("cuda", 0)
        log(f"card: {card_line()}")
        # one process, one host thread for torch's CPU pool: the host
        # dispatches, and a pool of spinning threads only adds contention
        torch.set_num_threads(1)
    device = torch.device(device)
    if importlib.util.find_spec(PROGRAM) is None:
        raise SystemExit(f"the program ({PROGRAM}) is not in this checkout: no result")
    from unitree_rl_gym_tpu_torch.utils.cache import enable_persistent_cache

    from benchlib import common as C
    from benchlib import trace as TR

    enable_persistent_cache(CACHE_DIRS["UTRL_BUILD_CACHE_DIR"])
    mode = importlib.import_module("benchlib." + traffic["mode"])
    n = int(traffic["num_envs"])
    ctx = dict(config=config, traffic=traffic, seed=int(args.seed), device=device,
               num_envs=n, control=bool(args.control))
    s = mode.setup(ctx)
    t_window = time.perf_counter()
    setup_s = t_window - T_START
    log(f"{args.workload}: {n} envs, seed {args.seed}, set-up {setup_s:.3f} s")
    red = None
    if args.trace:
        from torch.profiler import record_function
        from unitree_rl_gym_tpu_torch.physics import backend as pback

        control_step = pback.control_step

        def spanned(*a, **kw):
            with record_function("bench.control_step"):
                return control_step(*a, **kw)

        pback.control_step = spanned
        try:
            with TR.profile() as prof:
                with record_function(TR.WINDOW_SPAN):
                    run = mode.window(ctx, s, args.seconds, log)
        finally:
            pback.control_step = control_step
    else:
        run = mode.window(ctx, s, args.seconds, log)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if args.trace:
        t = time.perf_counter()
        red = TR.reduce(prof)
        del prof
        log(f"trace reduced in {time.perf_counter() - t:.1f} s: "
            f"{ {k: v for k, v in red.items() if k.startswith('bench.')} }")
    run.update(mode=traffic["mode"], setup_s=setup_s, num_envs=n, trace=red,
               peaks=load_json("peaks.json"))
    # the reference: the program's objects are freed first
    t = time.perf_counter()
    ref_env = C.reference_env(config, traffic, n, args.seed, device)
    run["work"] = mode.work(ctx, s, ref_env, run)
    for k in ("alg", "net", "env", "policy", "state", "obs", "carry"):
        s.pop(k, None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = mode.check(ctx, s, ref_env, control=bool(args.control))
    log(f"reference took {time.perf_counter() - t:.1f} s")
    comparisons = {k: {"value": numbers.get(k, math.inf), "limit": float(v)}
                   for k, v in limits.items()}
    correct = (set(numbers) == set(limits)
               and all(c["value"] <= c["limit"] for c in comparisons.values()))
    for c in comparisons.values():  # JSON has no infinity: "not finite" is null
        if not math.isfinite(c["value"]):
            c["value"] = None
    metrics = {}
    for m in metrics_of(bench, args.workload, args.trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    work_count = run.get("iterations", run.get("steps", 0))
    result = {
        "correct": bool(correct),
        "attempted": work_count,
        "failed": 0 if correct else work_count,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if red is not None and "busy_s" in red:
        result["device"].update(busy_s=red["busy_s"], window_s=run["window_s"])
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red.get("idle_gaps", [])}
    result["comparisons"] = comparisons
    return result, comparisons


def main(argv=None, device=None, traffic_update=None):
    args = parse(argv)
    try:
        result, comparisons = run_cell(args, device, traffic_update)
    except SystemExit as e:
        print(f"[bench] {e}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_modules()
    if found:
        print(f"[bench] forbidden modules loaded: {', '.join(found)}: no result",
              file=sys.stderr, flush=True)
        return 3
    for k, c in comparisons.items():
        ok = "ok" if c["value"] is not None and c["value"] <= c["limit"] else "OVER"
        print(f"[bench] compared {k}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
