#!/usr/bin/env python3
"""One traced run of a cell, as ``run.py --trace 1`` makes it, with the
program's spans read from the same profile (``benchlib/program_spans.py``):
their table on standard error as ``[bench] spans`` lines, then one JSON
line on standard output after run.py's own, with the per-layer numbers of
the spans (``env_step_ms``, ``policy_ms``, ``host_syncs``,
``env_step_idle``) and the totals they are held to.

    python3 benchmark/spans.py --workload go2.rollout --seed 7 --seconds 30

``run.py`` does not call the reduction itself; this entry point puts it
beside ``trace.reduce`` and the mode's window for the one run, and changes
nothing that run.py prints.
"""

import json
import sys
import time

import run
from benchlib import program_spans as PS
from benchlib import rollout, train
from benchlib import trace as TR


def main(argv=None, device=None, traffic_update=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    found = {}
    reduce = TR.reduce
    windows = {m: m.window for m in (rollout, train)}

    def both(prof, *a, **kw):
        t = time.perf_counter()
        found["spans"] = PS.reduce(prof)
        run.log(f"spans reduced in {time.perf_counter() - t:.1f} s")
        found["trace"] = reduce(prof, *a, **kw)
        return found["trace"]

    def captured(mode):
        def window(*a, **kw):
            found["run"] = windows[mode](*a, **kw)
            return found["run"]
        return window

    TR.reduce = both
    for m in windows:
        m.window = captured(m)
    try:
        rc = run.main(argv + ["--trace", "1"], device, traffic_update)
    finally:
        TR.reduce = reduce
        for m, w in windows.items():
            m.window = w
    if rc != 0 or "spans" not in found:
        return rc or 1
    red, r = found["spans"], found["run"]
    steps = r["control_steps"]
    for line in PS.table(red, steps):
        run.log(f"spans {line}")
    control = (found["trace"].get("bench.control_step") or {}).get("device_s", 0.0)
    out = {"metrics": PS.metrics(r, red), "control_steps": steps,
           "control_step_ms": control / steps * 1e3,
           "busy_ms": red.get("busy_s", 0.0) / steps * 1e3,
           "device_idle": 100.0 * red.get("idle_s", 0.0) / red["window_s"] if red else None}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
