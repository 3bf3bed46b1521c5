"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers and the result's ``device`` and ``breakdown``
need. The arithmetic follows the port's ``scripts/profile_train.py``
(device events by name; a kernel belongs to a range by its launch).

Device events are every CUDA activity that is not a user annotation:
kernels, memcpys and memsets. ``busy_s`` is the length of their union.
A kernel belongs to a harness span (``record_function`` on the host, e.g.
``bench.control_step``) when the CUDA launch call that made it
(``cudaLaunchKernel``, ``cuLaunchKernel``) lies inside the span on the
span's thread, matched by correlation id; where the profiler recorded no
such launch, by its start inside the span's device-side annotation.
"""

import bisect

import numpy as np
import torch

WINDOW_SPAN = "bench.window"


def profile():
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    return _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(iv):
    """Union of [start, end) intervals (sorted by start) as a list."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(prof, spans=("bench.control_step",), top=10):
    """The profile as a dict: ``busy_s``, ``device_ops`` (the ``top``
    device operations by total time, [name, s]), ``idle_gaps`` (the
    ``top`` longest gaps between device activity inside the window, each
    named by the innermost host event on the window's thread at the gap's
    start), and for each span name its device seconds, launch count and
    how its kernels were attributed."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu, launches = [], [], {}
    span_cpu = {s: [] for s in spans}
    span_dev = {s: [] for s in spans}
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation():
                if name in span_dev:
                    span_dev[name].append((a, a + d))
                continue
            dev.append((a, a + d, name, e.correlation_id()))
            continue
        tid = e.start_thread_id()
        if name == WINDOW_SPAN:
            window = (a, a + d, tid)
        elif name in span_cpu:
            span_cpu[name].append((a, a + d, tid))
        if "aunch" in name:  # cudaLaunchKernel*, cuLaunchKernel*
            launches[e.correlation_id()] = (a, tid)
        cpu.append((a, a + d, tid, name))
    out = {"n_device_events": len(dev)}
    if not dev:
        return out
    dev.sort()
    merged = _merge([(a, b) for a, b, _, _ in dev])
    out["busy_s"] = sum(b - a for a, b in merged) * 1e-9
    by_name = {}
    for a, b, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    out["device_ops"] = [[k, v] for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:top]]
    # spans: kernels launched inside them
    for s in spans:
        cs = sorted(span_cpu[s])
        starts = [c[0] for c in cs]

        def inside(t, tid):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and cs[i][1] >= t and cs[i][2] == tid

        by_corr = [(a, b) for a, b, _, c in dev
                   if c in launches and inside(*launches[c])]
        if by_corr:
            sel, how = by_corr, "correlation"
        else:
            ds = sorted(span_dev[s])
            ds_starts = [x[0] for x in ds]

            def in_dev(t):
                i = bisect.bisect_right(ds_starts, t) - 1
                return i >= 0 and ds[i][1] > t

            sel, how = [(a, b) for a, b, _, _ in dev if in_dev(a)], "device_annotation"
        out[s] = {"device_s": sum(b - a for a, b in sel) * 1e-9,
                  "n_kernels": len(sel), "n_spans": len(cs), "attributed_by": how}
    # idle gaps inside the window, named by what the host was doing
    if window is not None:
        w0, w1, wtid = window
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1])
                for i in range(len(merged) - 1)
                if w0 <= merged[i][1] and merged[i + 1][0] <= w1]
        if merged and merged[0][0] > w0:
            gaps.append((merged[0][0] - w0, w0))
        gaps.sort(reverse=True)
        host = [c for c in cpu if c[2] == wtid and c[3] != WINDOW_SPAN]
        hs = np.array([c[0] for c in host], dtype=np.int64)
        he = np.array([c[1] for c in host], dtype=np.int64)
        named = []
        for length, t in gaps[:top]:
            cover = np.nonzero((hs <= t) & (he >= t))[0]
            label = host[cover[np.argmax(hs[cover])]][3] if len(cover) else "none"
            named.append([label, length * 1e-9])
        out["idle_gaps"] = named
        out["window_device_s"] = (w1 - w0) * 1e-9
    return out
