"""``benchlib/program_spans.py`` on hand-built event lists: a child's time
taken out of its parent's, device operations put down to the span their
launch call lies in (by correlation id, whichever thread launched), the
device's idle time cut along the host's spans, the count of blocking calls
on the window's thread; the paths' device and idle seconds summing to the
window's busy and idle time on random profiles; no span rows for a
program that marks no layers. Then one traced run of ``spans.py`` on the
CPU."""

import json

import numpy as np
import pytest

from benchlib import program_spans as PS

W = 1  # the window's thread


def host(name, a, b, tid=W, corr=0):
    return (name, a, b, tid, corr, False)


def op(corr, a, b):
    return ("kernel", a, b, 0, corr, True)


# times in ns; the window is [0, 1000)
EVENTS = [
    host("bench.window", 0, 1000),
    host("policy_act", 20, 90),
    host("env_step", 100, 500),
    host("env_physics", 150, 250),
    host("env_obs", 300, 400),
    host("cudaLaunchKernel", 30, 35, corr=1),     # policy_act
    host("cudaLaunchKernel", 120, 125, corr=2),   # env_step, not a child
    host("cudaLaunchKernel", 160, 165, corr=3),   # env_physics
    host("cudaLaunchKernel", 170, 175, tid=2, corr=6),  # another thread, env_physics
    host("cudaMemcpyAsync", 310, 312, corr=4),    # env_obs
    host("cudaLaunchKernel", 600, 605, corr=5),   # no span
    host("cudaStreamSynchronize", 130, 140, corr=7),
    host("cudaMemcpy", 320, 330, corr=8),
    host("cudaStreamSynchronize", 700, 710, tid=2, corr=9),  # not the window's thread
    host("aten::add", 121, 126),
    op(1, 40, 60), op(2, 125, 145), op(3, 170, 260), op(6, 250, 280),
    op(4, 315, 335), op(5, 610, 700), op(99, 900, 950),
]
NS = 1e-9


@pytest.fixture(scope="module")
def red():
    return PS.reduce_events(EVENTS)


def field(red, k):
    return {p: r[k] for p, r in red["paths"].items() if r[k]}


def test_self_time_takes_out_the_children(red):
    assert field(red, "n") == {"policy_act": 1, "env_step": 1, "env_step/env_physics": 1,
                               "env_step/env_obs": 1}
    host_s = field(red, "host_s")
    assert host_s == pytest.approx({"": 530 * NS, "policy_act": 70 * NS,
                                    "env_step": 200 * NS, "env_step/env_physics": 100 * NS,
                                    "env_step/env_obs": 100 * NS})


def test_operations_go_to_their_launch_calls_span(red):
    assert field(red, "launches") == {"policy_act": 1, "env_step": 1,
                                      "env_step/env_physics": 2, "env_step/env_obs": 1,
                                      "": 1, PS.NO_LAUNCH: 1}
    # the overlap of ops 3 and 6 counts once, for op 3
    assert field(red, "device_s") == pytest.approx({
        "policy_act": 20 * NS, "env_step": 20 * NS, "env_step/env_physics": 110 * NS,
        "env_step/env_obs": 20 * NS, "": 90 * NS, PS.NO_LAUNCH: 50 * NS})
    assert red["busy_s"] == pytest.approx(310 * NS)


def test_idle_time_is_cut_along_the_hosts_spans(red):
    assert field(red, "idle_s") == pytest.approx({
        "": 390 * NS, "policy_act": 50 * NS, "env_step": 150 * NS,
        "env_step/env_physics": 20 * NS, "env_step/env_obs": 80 * NS})
    assert red["idle_s"] == pytest.approx(690 * NS)


def test_blocking_calls_on_the_windows_thread(red):
    assert red["syncs"] == 2
    assert field(red, "syncs") == {"env_step": 1, "env_step/env_obs": 1}


def test_metrics(red):
    got = PS.metrics({"mode": "rollout", "control_steps": 2}, red)
    assert got == pytest.approx({"host_syncs.rollout": 1.0,
                                 "env_step_ms.rollout": 40 * NS / 2 * 1e3,
                                 "env_step_idle.rollout": 23.0,
                                 "policy_ms.rollout": 20 * NS / 2 * 1e3})


def test_a_program_without_spans_gives_no_span_metrics():
    bare = [e for e in EVENTS if e[0] not in PS.SPANS]
    red = PS.reduce_events(bare)
    assert set(red["paths"]) == {"", PS.NO_LAUNCH}
    assert PS.metrics({"mode": "train", "control_steps": 2}, red) == {"host_syncs.train": 1.0}
    assert PS.reduce_events(bare[1:]) == {}
    assert PS.metrics({"mode": "train", "control_steps": 2}, {}) == {}


@pytest.mark.parametrize("seed", range(8))
def test_paths_sum_to_the_windows_busy_and_idle_time(seed):
    rng = np.random.default_rng(seed)
    w0, w1 = 1_000, 200_000
    evs = [host("bench.window", w0, w1)]

    def nest(a, b, depth):
        t = a
        while depth < 3 and t < b - 50:
            s = int(rng.integers(t, b - 20))
            e = int(rng.integers(s + 10, min(b, s + (b - a) // 2 + 11)))
            evs.append(host(str(rng.choice(PS.SPANS)), s, e))
            nest(s, e, depth + 1)
            t = e + 1

    nest(0, w1 + 5_000, 0)
    for corr in range(1, 400):
        t = int(rng.integers(0, w1 + 5_000))
        evs.append(host("cudaLaunchKernel", t, t + 3, tid=int(rng.integers(1, 3)), corr=corr))
        a = t + int(rng.integers(0, 3_000))   # two streams: operations overlap
        evs.append(op(corr if rng.random() < 0.95 else -corr, a, a + int(rng.integers(1, 900))))
    red = PS.reduce_events(evs)
    dev = sum(r["device_s"] for r in red["paths"].values())
    idle = sum(r["idle_s"] for r in red["paths"].values())
    host_s = sum(r["host_s"] for r in red["paths"].values())
    window = (w1 - w0) * NS
    assert dev == pytest.approx(red["busy_s"], rel=1e-9)
    assert idle == pytest.approx(red["idle_s"], rel=1e-9)
    assert host_s == pytest.approx(window, rel=1e-9)
    assert red["busy_s"] + red["idle_s"] == pytest.approx(window, rel=1e-9)
    assert dev <= red["busy_s"] * (1 + 1e-12) and idle <= red["idle_s"] * (1 + 1e-12)


def test_spans_entry_point_on_the_cpu(capsys):
    import spans

    rc = spans.main(["--workload", "go2.rollout", "--seed", "2147483659", "--seconds", "0.1"],
                    device="cpu", traffic_update={"num_envs": 8, "warmup_steps": 4})
    assert rc == 0
    out = capsys.readouterr()
    result, found = (json.loads(x) for x in out.out.strip().splitlines()[-2:])
    assert result["correct"]
    steps = found["control_steps"]
    assert steps >= 1 and f"[bench] spans env_step | {steps} |" in out.err
    assert set(found["metrics"]) == {"host_syncs.rollout", "env_step_ms.rollout",
                                     "env_step_idle.rollout", "policy_ms.rollout"}
