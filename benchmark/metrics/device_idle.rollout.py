"""device_idle.rollout: the share of the traced window in which no device
operation ran (the union of the profiler's kernel, memcpy and memset
intervals), in %."""


def read(run):
    t = run.get("trace") or {}
    if run["mode"] != "rollout" or "busy_s" not in t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / run["window_s"])
