"""The program's own spans in a traced run: where the device's time, the
host's blocking calls and the device's idle time fall among the layers the
port marks (``utils/profiling.span`` in ``unitree_rl_gym_tpu_torch``).

One pass over the profile's Kineto events (the same profile as
``trace.reduce``'s, on the same clock). The spans' names are frozen here
(``SPANS``); a profile without them (a program that does not mark its
layers) gives no span rows, and the readers of the metrics below return
None there.

Inside the harness's ``bench.window`` range, on the window's thread, the
spans nest into paths (``ppo_rollout/env_step/env_physics``); every moment
of the window belongs to the innermost path open then ("" where none is).
For each path:

- ``n``: how many spans ended the path; ``host_s``: the host's time in it
  with its children's taken out;
- ``device_s``, ``launches``: the device operations (kernels, memcpys,
  memsets) whose launch call lies in it and not in a child, matched by
  correlation id as ``trace.reduce`` matches them. A launch is placed by
  its time on the window thread's paths, whichever thread made it (the
  backward's kernels come from autograd's device thread while the window's
  thread waits in ``backward``). The device time is the union's: where
  operations overlap, the overlap counts once, for the one that started
  first, so the paths' device seconds sum to the window's busy time;
- ``syncs``: the host-blocking runtime calls (``SYNC_CALLS``) that started
  in it on the window's thread;
- ``idle_s``: the device's idle time (the gaps between its merged
  operations, and before the first and after the last) while the path was
  the innermost, so the paths' idle seconds sum to the window's idle time.

Operations with no launch call in the profile go to ``NO_LAUNCH``.
"""

import bisect

import torch

WINDOW_SPAN = "bench.window"
SPANS = ("ppo_rollout", "ppo_update", "ppo_gae", "ppo_minibatch", "ppo_anchor_forward",
         "policy_act", "env_step", "env_physics", "env_rewards", "env_reset", "env_obs",
         "env_refresh_terrain", "terrain_window_contraction")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
NO_LAUNCH = "(no launch)"
FIELDS = ("n", "host_s", "device_s", "launches", "syncs", "idle_s")


def events(prof):
    """The profile's events this module reads, as (name, start_ns, end_ns,
    thread, correlation id, on_device) tuples: the device's operations,
    and on the host the window, the spans and the runtime calls."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == cuda
        if on_device:
            if e.is_user_annotation():
                continue
        elif not (name in SPANS or name == WINDOW_SPAN or name.startswith("cu")):
            continue
        a = e.start_ns()
        out.append((name, a, a + e.duration_ns(), e.start_thread_id(),
                    e.correlation_id(), on_device))
    return out


def paths(spans, w0, w1):
    """The spans (start, end, name) of one thread as the window's timeline:
    contiguous segments (start, end, path) from ``w0`` to ``w1``, and how
    many spans ended each path."""
    segs, stack, count = [], [], {}
    t = w0

    def emit(upto):
        nonlocal t
        if upto > t:
            segs.append((t, upto, stack[-1][1] if stack else ""))
            t = upto

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        while stack and stack[-1][0] <= a:
            emit(stack[-1][0])
            stack.pop()
        emit(a)
        path = f"{stack[-1][1]}/{name}" if stack else name
        count[path] = count.get(path, 0) + 1
        stack.append((b, path))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(w1)
    return segs, count


def reduce_events(evs):
    """The window's totals and the rows by path (module docstring); {}
    without a window."""
    win = [(a, b, tid) for name, a, b, tid, _, dev in evs
           if not dev and name == WINDOW_SPAN]
    if not win:
        return {}
    w0, w1, wtid = win[0]
    spans, launches, syncs, ops = [], {}, [], []
    for name, a, b, tid, corr, dev in evs:
        if dev:
            ops.append((a, b, corr))
        elif name in SPANS:
            if tid == wtid:
                spans.append((a, b, name))
        elif name.startswith("cu"):
            launches[corr] = a
            if name in SYNC_CALLS and tid == wtid and w0 <= a < w1:
                syncs.append(a)
    segs, count = paths(spans, w0, w1)
    starts = [s[0] for s in segs]
    rows = {}

    def row(path):
        if path not in rows:
            rows[path] = dict.fromkeys(FIELDS, 0)
            rows[path]["n"] = count.get(path, 0)
        return rows[path]

    def path_at(t):
        if not w0 <= t < w1:
            return None
        return segs[bisect.bisect_right(starts, t) - 1][2]

    for p in count:
        row(p)
    for a, b, p in segs:
        row(p)["host_s"] += (b - a) * 1e-9
    for t in syncs:
        row(path_at(t))["syncs"] += 1
    # the device's time, as a partition of the union of its operations
    busy, gaps, covered = 0, [], w0
    for a, b, corr in sorted(ops):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        p = path_at(launches[corr]) if corr in launches else NO_LAUNCH
        r = row(NO_LAUNCH if p is None else p)
        r["launches"] += 1
        if a > covered:
            gaps.append((covered, a))
        if b > covered:
            r["device_s"] += (b - max(a, covered)) * 1e-9
            busy += b - max(a, covered)
            covered = b
    if covered < w1:
        gaps.append((covered, w1))
    # the idle time by the path the host was in
    i = 0
    for g0, g1 in gaps:
        while segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b, p = segs[j]
            row(p)["idle_s"] += (min(b, g1) - max(a, g0)) * 1e-9
            j += 1
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "idle_s": (w1 - w0 - busy) * 1e-9, "syncs": len(syncs), "paths": rows}


def reduce(prof):
    return reduce_events(events(prof))


def _under(red, inside, outside=None):
    """The rows whose path passes ``inside`` and not ``outside``; None when
    no path passes ``inside``."""
    sel = [r for p, r in red.get("paths", {}).items()
           if inside in p.split("/") and (outside is None or outside not in p.split("/"))]
    return sel or None


def metrics(run, red):
    """The per-layer numbers of a traced run (``run``: the mode's window,
    with ``mode`` and ``control_steps``), keyed as ``<name>.<mode>``:
    ``env_step_ms`` (device ms a control step of the operations launched
    in the env step outside its physics), ``policy_ms`` (the same in
    ``policy_act``), ``host_syncs`` (blocking calls a control step) and
    ``env_step_idle`` (% of the window the device idled while the host's
    innermost span was the env step outside its physics). A number whose
    span is absent is left out."""
    steps = run.get("control_steps") or 0
    if not red or steps <= 0:
        return {}
    out = {"host_syncs": red["syncs"] / steps}
    env = _under(red, "env_step", "env_physics")
    if env is not None:
        out["env_step_ms"] = sum(r["device_s"] for r in env) / steps * 1e3
        out["env_step_idle"] = 100.0 * sum(r["idle_s"] for r in env) / red["window_s"]
    pol = _under(red, "policy_act")
    if pol is not None:
        out["policy_ms"] = sum(r["device_s"] for r in pol) / steps * 1e3
    return {f"{k}.{run['mode']}": v for k, v in out.items()}


def table(red, steps):
    """The rows as lines, the most device time first, per control step."""
    if not red:
        return ["no bench.window range in the profile"]
    lines = [f"window {red['window_s']:.3f} s, busy {red['busy_s']:.3f} s, idle "
             f"{red['idle_s']:.3f} s, {red['syncs']} syncs, {steps} control steps",
             "path | n | host ms/step | device ms/step | launches/step | syncs/step | "
             "idle ms/step"]
    for p, r in sorted(red["paths"].items(), key=lambda kv: -kv[1]["device_s"]):
        lines.append(f"{p or '(no span)'} | {r['n']} | {r['host_s'] / steps * 1e3:.3f} | "
                     f"{r['device_s'] / steps * 1e3:.3f} | {r['launches'] / steps:.2f} | "
                     f"{r['syncs'] / steps:.3f} | {r['idle_s'] / steps * 1e3:.3f}")
    return lines
