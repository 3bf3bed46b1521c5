#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (unitree_rl_gym_tpu_torch) on one
NVIDIA GPU:

    python3 chip_smoke.py

It drives the port's two paths at 4096 envs — the go2 flat policy rollout
of ``scripts/play.py`` with the pretrained MLP actor [512, 256, 128]
(kernel K1), then PPO training of go2 on heightfield terrain with the
terrain curriculum through ``OnPolicyRunner.learn`` (kernel K3) — and holds
every kernel of those paths against its plain PyTorch version on the same
inputs:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    kernels K1 and K3 (one library, csrc/control_step.cu) from
              source with nvcc;
  3. compare  one control step through K1 (``backend.control_step``, the
              env's path) and through the plain version
              (``backend.control_step_soa``) at N=4096, from a fresh reset and
              from the state after 100 policy steps, at the physics tolerance
              of the tests (atol 5e-5 / rtol 1e-4 on the state;
              aux / max(|aux|, 1) within 5e-4). An env that differs is excused
              only if one of its contact points sat within 1e-6 of the
              activation edge (|phi| < 1e-6) during that step, and at most
              0.1% of the envs (4 of 4096) may be excused; those envs are
              counted and their largest errors printed;
  4. time     K1 and the plain version on the same inputs (CUDA events);
  5. slice    400 control steps of play's loop; every one must launch K1
              once, and the policy must walk (the health bar of
              tests/test_pretrained_go2.py after the first third of the
              steps; falls <= 1% of envs);
  6. profile  20 more steps under torch.profiler: device time per step by
              kernel (K1, the actor's matmuls, the env's other kernels) and
              the device's idle share of the unprofiled step time;
  7. compare_terrain  one control step through K3 (``backend.control_step``
              with ``gh``) and through the plain version on the go2_terrain
              env (the go2 task with ``terrain.mesh_type = "heightfield"``
              and the terrain curriculum, as bench.py's go2_terrain), from
              the reset state and after 24 steps of the freshly initialised
              policy, with K1's tolerance and excuse rule, p_xy included;
  8. time_terrain  K3 and the plain version (CUDA events);
  9. train    ``OnPolicyRunner.learn`` on go2_terrain: one warm-up
              iteration, then TRAIN_ITERS iterations with the launch counts
              zeroed just before: K3 must launch 24 times per iteration and
              K1 never; every metric finite, lr in [1e-5, 1e-2], the terrain
              level reported, and the last checkpoint must load into a
              fresh runner with identical parameters;
 10. profile_train  one more iteration under torch.profiler: device time
              by K3, the window contraction, the PPO update and the rest,
              and the device's idle share of the unprofiled iteration.

Each phase prints one JSON line with its wall time. Any failure raises and
the script exits non-zero; without CUDA it exits non-zero before printing a
result. The line before the last is the card's name and power limit; the
line before that, the kernels line; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time

N_ENVS = 4096
WALK_STEPS = 100         # policy steps before the second comparison state
SLICE_STEPS = 400        # control steps of the main-path run
TIME_LAUNCHES = 20       # K1 launches timed with CUDA events
TIME_PLAIN = 3           # plain-version control steps timed
PROFILE_STEPS = 20       # rollout steps under torch.profiler (after the slice)
TERRAIN_WALK_STEPS = 24  # policy steps before the second terrain comparison
TRAIN_ITERS = 5          # counted PPO iterations on go2_terrain
LR_MIN, LR_MAX = 9.999999747378752e-06, 0.009999999776482582  # float32 1e-5, 1e-2
PHI_EDGE = 1e-6          # |phi| below which a contact flip excuses an env
MAX_EXCUSED_SHARE = 1e-3  # of the envs, in one comparison
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TIME_LIMIT_S = 1150


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def compare(ref, got, min_abs_phi, torch, name="K1"):
    """Per-env check of a kernel (``got``) against the plain version
    (``ref``); ``p_xy`` [2*ncp, N], where present, is held to the state's
    tolerance.
    Returns (max state error, max normalised aux error, excused envs,
    per-output max errors, largest errors among the excused envs)."""
    bad = torch.zeros(min_abs_phi.shape[0], dtype=torch.bool,
                      device=min_abs_phi.device)
    errs = {}
    state_keys = [k for k in ("base_pos", "base_quat", "joint_q", "v", "p_xy")
                  if k in ref]
    ref = dict(ref, **({"p_xy": ref["p_xy"].T} if "p_xy" in ref else {}))
    got = dict(got, **({"p_xy": got["p_xy"].T} if "p_xy" in got else {}))
    for k in state_keys:
        diff = (got[k] - ref[k]).abs()
        errs[k] = float(diff.max())
        bad |= (diff > 5e-5 + 1e-4 * ref[k].abs()).flatten(1).any(1)
    for k in ("torques", "cf_rb", "rb_pos_w", "rb_vel_w"):
        mag = max(float(ref[k].abs().max()), 1.0)
        diff = (got[k] - ref[k]).abs() / mag
        errs[k] = float(diff.max())
        bad |= (diff > 5e-4).flatten(1).any(1)
    edge = min_abs_phi < PHI_EDGE
    unexplained = bad & ~edge
    if bool(unexplained.any()):
        n = int(unexplained.nonzero()[0, 0])
        env_errs = {k: float((got[k][n] - ref[k][n]).abs().max()) for k in got
                    if k in ref and got[k].shape[0] == bad.shape[0]}
        raise RuntimeError(
            f"{name} disagrees with the plain version in "
            f"{int(unexplained.sum())} envs away from any contact edge; "
            f"max errors (aux normalised) {errs}; env {n}: errors {env_errs}, "
            f"min |phi| {float(min_abs_phi[n])}, "
            f"v {got['v'][n].tolist()} vs {ref['v'][n].tolist()}")
    excused = bad & edge
    n_excused = int(excused.sum())

    def max_errs(rows):
        if not bool(rows.any()):
            return 0.0, 0.0
        s = max(float((got[k] - ref[k])[rows].abs().max())
                for k in state_keys)
        a = max(float(((got[k] - ref[k])[rows]).abs().max())
                / max(float(ref[k].abs().max()), 1.0)
                for k in ("torques", "cf_rb", "rb_pos_w", "rb_vel_w"))
        return s, a

    excused_errs = max_errs(excused)
    check(n_excused <= MAX_EXCUSED_SHARE * bad.shape[0],
          f"{n_excused} envs disagree at a contact edge, more than "
          f"{MAX_EXCUSED_SHARE:.1%} of {bad.shape[0]}; largest errors there "
          f"(state, aux normalised) {excused_errs}")
    state_err, aux_err = max_errs(~excused)
    return state_err, aux_err, n_excused, errs, excused_errs


def cuda_ms(torch, fn, reps, warmup):
    """Device ms per call of ``fn`` (CUDA events around ``reps`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def flat_outputs(state, aux):
    out = {k: getattr(state, k) for k in ("base_pos", "base_quat", "joint_q", "v")}
    out.update(aux)
    return out


def bound(cuda_step, m, decimation, iterations, terrain):
    """(bound_ms, ops_ms, bytes_ms, flops_per_env, bytes_per_env) of one
    control step of N_ENVS envs on the H100's published peaks."""
    flops = cuda_step.flops_per_env(m, decimation, iterations, terrain=terrain)
    nbytes = cuda_step.bytes_per_env(m, terrain=terrain)
    t_ops = N_ENVS * flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = N_ENVS * nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes, flops, nbytes


def profile_train(runner, torch, iteration_ms, rollout_ms, update_ms):
    """Device time of one training iteration by part, from torch.profiler:
    kernels by name (K3) and by the profiler range they ran in (the
    rollout, the update, the window contraction: a kernel belongs to a
    range when it starts inside that range's span on the device timeline).
    Idle shares are measured against the unprofiled host times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.learn(1)
        torch.cuda.synchronize()
    spans, kernels = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
        else:
            kernels.append((e.name, e.time_range.start, e.time_range.elapsed_us() / 1e3))
    total = sum(k[2] for k in kernels)
    if total == 0.0:
        return {"device_ms_per_iteration": "not measured (the profiler saw no device time)"}

    def in_range(name):
        if name not in spans:
            return "not measured (no device span for the range)"
        return sum(ms for _, t, ms in kernels
                   if any(a <= t < b for a, b in spans[name]))

    by_name = {}
    for name, _, ms in kernels:
        by_name[name] = by_name.get(name, 0.0) + ms
    k3 = sum(v for k, v in by_name.items() if "utrl_control_step" in k)
    rollout, update = in_range("ppo_rollout"), in_range("ppo_update")
    window = in_range("terrain_window_contraction")
    out = {
        "device_ms_per_iteration": total,
        "k3_ms": k3,
        "window_contraction_ms": window,
        "rollout_device_ms": rollout,
        "update_device_ms": update,
        "gemm_kernels_ms": sum(v for k, v in by_name.items()
                               if any(g in k.lower() for g in ("gemm", "xmma", "cutlass", "gemv"))),
        "n_kernel_names": len(by_name),
        "device_idle_share": max(0.0, 1.0 - total / iteration_ms),
        "top_kernels_ms": [[k[:80], v] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
    }
    if isinstance(rollout, float) and isinstance(window, float):
        out["rollout_other_ms"] = rollout - k3 - window
        out["rollout_idle_share"] = max(0.0, 1.0 - rollout / rollout_ms)
    if isinstance(update, float):
        out["update_idle_share"] = max(0.0, 1.0 - update / update_ms)
    return out


def terrain_phases(torch, dev):
    """Phases 7-10 on go2_terrain; returns K3's entry of the kernels line."""
    import tempfile

    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import cuda_step
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    # ---- 7. K3 against the plain version on the go2_terrain env ----
    t0 = time.time()
    env_cfg, train_cfg = task_registry.get_cfgs("go2")
    env_cfg.env.num_envs = N_ENVS
    env_cfg.terrain.mesh_type = "heightfield"
    env_cfg.terrain.curriculum = True
    t_env = time.time()
    env, _ = task_registry.make_env("go2", env_cfg=env_cfg, device=dev)
    env_build_s = time.time() - t_env
    check(env.grid.heights.is_cuda, "heightfield not on the card")
    cfg = env.cfg
    m = pb.soa_model_for(env.robot.dyn)
    step_args = (env.robot.dyn, env.cparams, env.pd, cfg.sim.dt, cfg.control.decimation)
    tmp = tempfile.TemporaryDirectory()
    runner = OnPolicyRunner(env, train_cfg, tmp.name)
    net = runner.net

    def inputs(state, obs):
        with torch.no_grad():
            actions = torch.clamp(net.act(obs), -cfg.normalization.clip_actions,
                                  cfg.normalization.clip_actions)
        return (state.phys, env._compute_target(actions), state.friction,
                state.mass_scale, env.m_eff_n, env.m_eff_t, state.gh)

    state, obs = env.reset_all()
    cases = {"reset": inputs(state, obs)}
    with torch.no_grad():
        for _ in range(TERRAIN_WALK_STEPS):
            state, obs, *_ = env.step(state, net.act(obs))
    cases["walk"] = inputs(state, obs)
    max_state_err = max_aux_err = 0.0
    excused, excused_errs, per_output = {}, {}, {}
    for name, x in cases.items():
        ref_s, ref_aux = pb.control_step_soa(*step_args, *x[:6], gh=x[6], want_phi=True)
        got_s, got_aux = pb.control_step(*step_args, *x)
        torch.cuda.synchronize()
        check(tuple(got_aux["p_xy"].shape) == (2 * m.ncp, N_ENVS), "p_xy shape")
        s_err, a_err, excused[name], per_output[name], e_errs = compare(
            flat_outputs(ref_s, ref_aux), flat_outputs(got_s, got_aux),
            ref_aux["min_abs_phi"], torch, name="K3")
        max_state_err = max(max_state_err, s_err)
        max_aux_err = max(max_aux_err, a_err)
        excused_errs[name] = {"state": e_errs[0], "aux_normalised": e_errs[1]}
    gh = cases["walk"][6]
    emit({"phase": "compare_terrain", "n_envs": N_ENVS, "env_build_seconds": env_build_s,
          "heightfield_shape": list(env.grid.heights.shape),
          "gh_range_m": [float(gh.min()), float(gh.max())],
          "max_abs_err_state": max_state_err, "max_err_aux_normalised": max_aux_err,
          "excused_contact_edge_envs": excused,
          "max_excused_envs": int(MAX_EXCUSED_SHARE * N_ENVS),
          "max_errors_of_excused_envs": excused_errs,
          "max_errors_by_output": per_output, "seconds": time.time() - t0})

    # ---- 8. timing on the same inputs (walk state) ----
    t0 = time.time()
    x = cases["walk"]
    k3_ms = cuda_ms(torch, lambda: pb.control_step(*step_args, *x), TIME_LAUNCHES, 3)
    plain_ms = cuda_ms(torch, lambda: pb.control_step_soa(*step_args, *x[:6], gh=x[6]),
                       TIME_PLAIN, 1)
    bound_ms, t_ops, t_bytes, flops, nbytes = bound(
        cuda_step, m, cfg.control.decimation, env.cparams.iterations, True)
    emit({"phase": "time_terrain", "k3_ms": k3_ms, "plain_ms": plain_ms,
          "flops_per_env": flops, "bytes_per_env": nbytes, "bound_ms": bound_ms,
          "ops_ms": t_ops, "bytes_ms": t_bytes, "seconds": time.time() - t0})

    # ---- 9. the training path: OnPolicyRunner.learn on go2_terrain ----
    t0 = time.time()
    runner.learn(1, init_at_random_ep_len=True)      # warm-up, not counted
    torch.cuda.synchronize()
    cuda_step.LAUNCHES = 0
    cuda_step.LAUNCHES_TERRAIN = 0
    rows = runner.learn(TRAIN_ITERS)
    torch.cuda.synchronize()
    k3_launches, k1_launches = cuda_step.LAUNCHES_TERRAIN, cuda_step.LAUNCHES
    steps = train_cfg.runner.num_steps_per_env
    check(k3_launches == steps * TRAIN_ITERS,
          f"K3 launched {k3_launches} times in {TRAIN_ITERS} iterations of {steps} steps")
    check(k1_launches == 0, f"K1 launched {k1_launches} times on terrain")
    for row in rows:
        for k, v in row.items():
            vals = v.values() if isinstance(v, dict) else [v]
            check(all(math.isfinite(float(u)) for u in vals),
                  f"non-finite {k} at iteration {row['it']}: {v}")
        check(row["nonfinite_steps"] == 0, f"nonfinite_steps {row['nonfinite_steps']}")
        # the schedule holds lr in float32 [1e-5, 1e-2], as the JAX package
        check(LR_MIN <= row["lr"] <= LR_MAX, f"lr {row['lr']} outside [1e-5, 1e-2]")
        check("terrain_level" in row, "terrain_level_mean not reported")
    for k in ("base_pos", "base_quat", "joint_q", "v"):
        check(bool(torch.isfinite(getattr(runner._env_state.phys, k)).all()),
              f"non-finite {k} after training")
    ckpt = os.path.join(tmp.name, f"model_{runner.current_learning_iteration}.pt")
    fresh = OnPolicyRunner(env, train_cfg, None)
    fresh.load(ckpt)
    same = all(torch.equal(a, b) for a, b in zip(
        runner.net.state_dict().values(), fresh.net.state_dict().values()))
    check(same, f"parameters loaded from {os.path.basename(ckpt)} differ")
    check(fresh.alg.lr == runner.alg.lr, "lr not restored from the checkpoint")
    it_s = sorted(r["iteration_s"] for r in rows)[len(rows) // 2]
    roll_s = sorted(r["rollout_s"] for r in rows)[len(rows) // 2]
    upd_s = sorted(r["update_s"] for r in rows)[len(rows) // 2]
    emit({"phase": "train", "config": "go2_terrain", "n_envs": N_ENVS,
          "iterations": TRAIN_ITERS, "k3_launches": k3_launches,
          "k1_launches": k1_launches,
          "median_iteration_ms": it_s * 1e3,
          "train_env_steps_per_s": N_ENVS * steps / it_s,
          "median_rollout_ms": roll_s * 1e3, "median_update_ms": upd_s * 1e3,
          "rollout_share": roll_s / it_s,
          "env_steps_per_s_by_iteration": [r["fps"] for r in rows],
          "mean_step_reward": [r["mean_step_reward"] for r in rows],
          "value_loss": [r["value_loss"] for r in rows],
          "kl": [r["kl"] for r in rows], "lr": [r["lr"] for r in rows],
          "terrain_level": [r["terrain_level"] for r in rows],
          "checkpoint_round_trip": True, "seconds": time.time() - t0})

    # ---- 10. where the time of an iteration goes ----
    t0 = time.time()
    emit(dict(profile_train(runner, torch, it_s * 1e3, roll_s * 1e3, upd_s * 1e3),
              phase="profile_train", seconds=time.time() - t0))
    tmp.cleanup()
    return {
        "name": "control_step_terrain",
        "route": "cuda",
        "source": "unitree_rl_gym_tpu_torch/csrc/control_step.cu",
        "replaces": "unitree_rl_gym_tpu/physics/pallas_step.py:186",
        "replaces_function": "pallas_step.control_step_pallas (_kernel, "
                             "has_gh=True, has_cs=False)",
        "launches": k3_launches,
        "max_abs_err": max_state_err,
        "max_err": max_state_err,
        "max_err_aux_normalised": max_aux_err,
        "ms": k3_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def profile_step(env, policy, play, torch, step_ms):
    """Device time per rollout step by kernel group, from torch.profiler
    over PROFILE_STEPS steps; the idle share is measured against the
    unprofiled ``step_ms`` of the slice phase."""
    from torch.profiler import ProfilerActivity, profile

    state, obs = env.reset_all()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        play.rollout(env, policy, state, obs, PROFILE_STEPS, settle=PROFILE_STEPS)
        torch.cuda.synchronize()
    kernels = {}   # kernel name -> device ms per step
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms = e.time_range.elapsed_us() / PROFILE_STEPS / 1e3
            kernels[e.name] = kernels.get(e.name, 0.0) + ms
    total = sum(kernels.values())
    if total == 0.0:
        return {"device_ms_per_step": "not measured (the profiler saw no device time)"}
    k1 = sum(v for k, v in kernels.items() if "utrl_control_step" in k)
    mm = sum(v for k, v in kernels.items()
             if "gemm" in k.lower() or "xmma" in k.lower() or "cutlass" in k.lower())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device_ms_per_step": total,
        "k1_ms_per_step": k1,
        "actor_matmul_ms_per_step": mm,
        "other_kernels_ms_per_step": total - k1 - mm,
        "n_kernel_names": len(kernels),
        "device_idle_share": max(0.0, 1.0 - total / step_ms),
        "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
    }


def main():
    signal.alarm(TIME_LIMIT_S)   # never run unbounded
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import cuda_step
    from unitree_rl_gym_tpu_torch.scripts import play
    from unitree_rl_gym_tpu_torch.utils import helpers

    dev = torch.device("cuda")

    # ---- 1. device ----
    t0 = time.time()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": time.time() - t0})

    # ---- 2. build ----
    t0 = time.time()
    args = helpers.get_args(["--task=go2", f"--num_envs={N_ENVS}", "--device=cuda"])
    env = play.make_play_env(args, dev)
    m = pb.soa_model_for(env.robot.dyn)
    t_build = time.time()
    lib_path = cuda_step.build(m)
    build_s = time.time() - t_build
    ptxas = [ln.strip() for ln in cuda_step.BUILD_LOGS.get(lib_path, "").splitlines()
             if "registers" in ln or "spill" in ln or "stack frame" in ln]
    emit({"phase": "build", "library": lib_path.split("unitree_rl_gym_tpu_torch/")[-1],
          "build_seconds": build_s, "ptxas": ptxas, "seconds": time.time() - t0})

    # ---- 3. K1 against the plain version at full width ----
    t0 = time.time()
    policy = load_flat_policy(play.policy_dir(args), dev)
    cfg = env.cfg
    step_args = (env.robot.dyn, env.cparams, env.pd, cfg.sim.dt,
                 cfg.control.decimation)

    def inputs(state, obs):
        with torch.no_grad():
            actions = torch.clamp(policy.act(obs), -cfg.normalization.clip_actions,
                                  cfg.normalization.clip_actions)
        return (state.phys, env._compute_target(actions), state.friction,
                state.mass_scale, env.m_eff_n, env.m_eff_t)

    state, obs = env.reset_all()
    cases = {"reset": inputs(state, obs)}
    with torch.no_grad():
        for _ in range(WALK_STEPS):
            state, obs, *_ = env.step(state, policy.act(obs))
    cases["walk"] = inputs(state, obs)
    max_state_err = max_aux_err = 0.0
    excused, excused_errs, per_output = {}, {}, {}
    for name, x in cases.items():
        ref_s, ref_aux = pb.control_step_soa(*step_args, *x, want_phi=True)
        got_s, got_aux = pb.control_step(*step_args, *x)
        torch.cuda.synchronize()
        s_err, a_err, excused[name], per_output[name], e_errs = compare(
            flat_outputs(ref_s, ref_aux), flat_outputs(got_s, got_aux),
            ref_aux["min_abs_phi"], torch)
        max_state_err = max(max_state_err, s_err)
        max_aux_err = max(max_aux_err, a_err)
        excused_errs[name] = {"state": e_errs[0], "aux_normalised": e_errs[1]}
    emit({"phase": "compare", "n_envs": N_ENVS, "max_abs_err_state": max_state_err,
          "max_err_aux_normalised": max_aux_err, "excused_contact_edge_envs": excused,
          "max_excused_envs": int(MAX_EXCUSED_SHARE * N_ENVS),
          "max_errors_of_excused_envs": excused_errs,
          "max_errors_by_output": per_output, "seconds": time.time() - t0})

    # ---- 4. timing on the same inputs (walk state) ----
    t0 = time.time()
    x = cases["walk"]

    k1_ms = cuda_ms(torch, lambda: pb.control_step(*step_args, *x), TIME_LAUNCHES, 3)
    plain_ms = cuda_ms(torch, lambda: pb.control_step_soa(*step_args, *x), TIME_PLAIN, 1)
    bound_ms, t_ops, t_bytes, flops, nbytes = bound(
        cuda_step, m, cfg.control.decimation, env.cparams.iterations, False)
    emit({"phase": "time", "k1_ms": k1_ms, "plain_ms": plain_ms,
          "flops_per_env": flops, "bytes_per_env": nbytes,
          "bound_ms": bound_ms, "ops_ms": t_ops, "bytes_ms": t_bytes,
          "seconds": time.time() - t0})

    # ---- 5. the main path: play's loop at full width ----
    t0 = time.time()
    state, obs = env.reset_all()
    torch.cuda.synchronize()
    cuda_step.LAUNCHES = 0
    t_loop = time.time()
    state, obs, stats = play.rollout(env, policy, state, obs, SLICE_STEPS,
                                     settle=SLICE_STEPS // 3)
    torch.cuda.synchronize()
    loop_s = time.time() - t_loop
    launches = cuda_step.LAUNCHES
    check(launches == SLICE_STEPS,
          f"K1 launched {launches} times in {SLICE_STEPS} control steps")
    check(tuple(obs.shape) == (N_ENVS, 48), f"obs shape {tuple(obs.shape)}")
    check(bool(torch.isfinite(obs).all()), "non-finite observations")
    for k in ("base_pos", "base_quat", "joint_q", "v"):
        check(bool(torch.isfinite(getattr(state.phys, k)).all()), f"non-finite {k}")
    check(stats["abs_vx_tracking_err"] < 0.25,
          f"vx tracking error {stats['abs_vx_tracking_err']}")
    check(stats["abs_yaw_rate_err"] < 0.4,
          f"yaw-rate tracking error {stats['abs_yaw_rate_err']}")
    check(stats["falls"] <= 0.01 * N_ENVS,
          f"{stats['falls']} non-timeout terminations after settling")
    step_ms = loop_s / SLICE_STEPS * 1e3
    emit({"phase": "slice", "n_envs": N_ENVS, "steps": SLICE_STEPS,
          "k1_launches": launches, "env_steps_per_s": N_ENVS * SLICE_STEPS / loop_s,
          "step_ms": step_ms, "k1_ms": k1_ms, "plain_ms": plain_ms,
          "k1_share_of_step": k1_ms / step_ms,
          "abs_vx_tracking_err": stats["abs_vx_tracking_err"],
          "abs_yaw_rate_err": stats["abs_yaw_rate_err"],
          "base_height": stats["base_height"], "falls": stats["falls"],
          "seconds": time.time() - t0})

    # ---- 6. where the time goes (after the main path's counts were read) ----
    t0 = time.time()
    emit(dict(profile_step(env, policy, play, torch, step_ms), phase="profile",
              seconds=time.time() - t0))
    del env, policy, state, obs, cases, x

    # ---- 7-10. the training path on terrain (K3) ----
    k3_entry = terrain_phases(torch, dev)

    emit({"kernels": [{
        "name": "control_step_flat",
        "route": "cuda",
        "source": "unitree_rl_gym_tpu_torch/csrc/control_step.cu",
        "replaces": "unitree_rl_gym_tpu/physics/pallas_step.py:186",
        "replaces_function": "pallas_step.control_step_pallas (_kernel, "
                             "has_gh=False, has_cs=False)",
        "launches": launches,
        "max_abs_err": max_state_err,
        "max_err": max_state_err,
        "max_err_aux_normalised": max_aux_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }, k3_entry]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
