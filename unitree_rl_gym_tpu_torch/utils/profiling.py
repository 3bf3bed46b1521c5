"""Profiling hooks (counterpart of ``unitree_rl_gym_tpu/utils/profiling.py``).

Two levels:
  * always on: the runner's per-iteration wall clock and env-steps/s
    (``Perf/total_fps`` in TensorBoard, ``fps`` in ``curves.json``);
  * on demand: :func:`trace`, a context manager over ``torch.profiler``
    (CPU activity, and CUDA activity where a card is present) that writes a
    Chrome trace under ``log_dir`` for TensorBoard or ``chrome://tracing``.

    UTRL_PROFILE_ITERS=3 python -m unitree_rl_gym_tpu_torch.scripts.train --task=go2

traces iterations 2..4 into ``<log_dir>/profile`` (``rl/runner.py``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body and write ``<log_dir>/trace_<pid>_<ns>.json``; yields
    the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Stopwatch:
    """Cheap section timer: sums wall time per named section."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {v:.3f}s/{self.counts[k]}" for k, v in self.totals.items()
        )
