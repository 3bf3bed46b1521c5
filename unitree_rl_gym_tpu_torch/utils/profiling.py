"""Profiling hooks (counterpart of ``unitree_rl_gym_tpu/utils/profiling.py``).

Three levels:
  * always on: the runner's per-iteration wall clock and env-steps/s
    (``Perf/total_fps`` in TensorBoard, ``fps`` in ``curves.json``);
  * spans: :func:`span` marks a layer of the program (the env step and its
    parts, the policy, the PPO phases) as a ``torch.profiler`` range while a
    profiler runs, and costs one flag check when none does;
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

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    runs (in the same trace as the device's kernels); otherwise one shared
    no-op context. The flag is read at every call, so a profiler started
    later sees the spans; a bare ``record_function`` costs several
    microseconds even with no profiler running, the check under one
    microsecond."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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
