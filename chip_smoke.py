#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (unitree_rl_gym_tpu_torch) on one
NVIDIA GPU:

    python3 chip_smoke.py

It drives the port's three paths at 4096 envs — the go2 flat policy
rollout of ``scripts/play.py`` with the pretrained MLP actor [512, 256,
128] (kernel K1), PPO training of go2 on heightfield terrain with the
terrain curriculum through ``OnPolicyRunner.learn`` (kernel K3), and the
go2 handstand robustness fine-tune from the shipped policy with contact
stiffness, friction, push, PD-gain and actuation-delay DR and PPO's
nan guard, anchor KL and class weights (kernel K2) — and holds every
kernel of those paths against its plain PyTorch version on the same
inputs:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    every library from source with nvcc, all started together:
              csrc/control_step.cu (K1, K3) and csrc/control_step_cs.cu
              (K2) at go2's sizes and at the handstand's (79 contact
              points); prints K1's and K3's ptxas report;
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
              and the device's idle share of the unprofiled iteration;
 11. build_cs K2's ptxas report (flat at the handstand's sizes, terrain at
              go2's), built in phase 2;
 12. compare_cs  one control step through K2 (``backend.control_step``
              with ``cstiff``) and through the plain version on the
              fine-tune's env (stiffness drawn U(0.7, 1.5)), from its
              reset and after 50 steps of the pretrained handstand
              policy, with K1's tolerance and excuse rule; K2 with every
              stiffness 1 must give K1's bits on the same inputs; K2's
              terrain instance against the plain version at the
              go2_terrain reset;
 13. time_cs  K2 and the plain version (CUDA events) and K2's bound;
 14. hold     450 steps of the pretrained handstand policy under the eval
              overrides of tests/test_pretrained_go2.py (K1 at the
              handstand's sizes): at least half of the envs hold a
              termination-free handstand for 200 steps and the mean held
              g_z is above the hold band's edge;
 15. finetune ``OnPolicyRunner.learn`` of the fine-tune from the shipped
              policy after ``set_anchor``: one warm-up iteration, then
              FINETUNE_ITERS iterations with the launch counts zeroed just
              before: K2 must launch 24 times per iteration and K1 and K3
              never; every metric finite, lr in [1e-5, 1e-2], the anchor
              loss and the nan guard's skips printed, the checkpoint loads
              back bit for bit, and the hold rate after the fine-tune is
              printed (not gated);
 16. profile_finetune  one more iteration under torch.profiler: device
              time of K2, the anchor forward, the update and the rest, and
              the idle share.

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
HS_WALK_STEPS = 50       # handstand policy steps before the second K2 comparison
HOLD_STEPS = 450         # pretrained handstand steps of the hold phase
HOLD_MIN_RUN = 200       # steps of a held handstand (5 s at 40 Hz)
HOLD_MIN_SHARE = 0.5     # share of the envs that must hold that long
FINETUNE_ITERS = 5       # counted fine-tune iterations
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


def profile_train(runner, torch, iteration_ms, rollout_ms, update_ms,
                  kernel="k3_ms", rollout_range=("window_contraction_ms",
                                                 "terrain_window_contraction"),
                  update_range=None):
    """Device time of one training iteration by part, from torch.profiler:
    the control-step kernel by name (reported as ``kernel``) and kernels by
    the profiler range they ran in (the rollout, the update, and the ranges
    ``rollout_range`` / ``update_range`` (label, range name) inside them: a
    kernel belongs to a range when it starts inside that range's span on
    the device timeline). Idle shares are measured against the unprofiled
    host times."""
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
    step_kernel = sum(v for k, v in by_name.items() if "utrl_control_step" in k)
    rollout, update = in_range("ppo_rollout"), in_range("ppo_update")
    out = {
        "device_ms_per_iteration": total,
        kernel: step_kernel,
        "rollout_device_ms": rollout,
        "update_device_ms": update,
        "gemm_kernels_ms": sum(v for k, v in by_name.items()
                               if any(g in k.lower() for g in ("gemm", "xmma", "cutlass", "gemv"))),
        "n_kernel_names": len(by_name),
        "device_idle_share": max(0.0, 1.0 - total / iteration_ms),
        "top_kernels_ms": [[k[:80], v] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
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


# kernel instances by their template arguments <HAS_GH, HAS_CS>
KERNEL_NAMES = {("0", "0"): "K1", ("1", "0"): "K3", ("0", "1"): "K2 flat",
                ("1", "1"): "K2 terrain"}


def ptxas_by_kernel(log):
    """nvcc's -Xptxas -v report by kernel instance: {name: [lines]}."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        hit = re.search(r"entry function '.*?ILb([01])ELb([01])E", ln)
        if hit:
            cur = KERNEL_NAMES[hit.groups()]
            out[cur] = []
        elif cur and ("registers" in ln or "stack frame" in ln):
            out[cur].append(ln.split(" : ")[-1].strip())
    return out


def handstand_model(dev):
    """The SoAModel of the go2 handstand's robot (79 contact points)."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.physics import backend as pb

    cfg, _ = task_registry.get_cfgs("go2_handstand")
    cfg.env.num_envs = 1
    env, _ = task_registry.make_env("go2_handstand", env_cfg=cfg, device=dev)
    return pb.soa_model_for(env.robot.dyn)


def finetune_cfgs(task_registry, num_envs):
    """(env cfg, train cfg) of the go2 handstand robustness fine-tune: the
    training setup of the JAX package's scripts/handstand_transfer_r5.py
    (:172-209) with its defaults, its help text's PD-gain range 0.8-1.2 and
    an actuation-delay probability of 0.1."""
    cfg, tcfg = task_registry.get_cfgs("go2_handstand")
    cfg.env.num_envs = num_envs
    ist = cfg.init_state
    ist.handstand_init_prob = ist.handstand_init_prob_final = 1.0
    ist.handstand_anneal_steps = 0.0
    ist.handstand_mid_frac = 0.25
    dr = cfg.domain_rand
    dr.randomize_contact_stiffness = True
    dr.contact_stiffness_range = (0.7, 1.5)
    dr.randomize_friction = True
    dr.friction_range = (0.3, 1.25)
    dr.push_robots = True
    dr.push_interval_s = 3.0
    dr.max_push_vel_xy = 0.4
    dr.randomize_pd_gain = True
    dr.pd_gain_range = (0.8, 1.2)
    dr.action_delay_prob = 0.1
    tcfg.policy.init_noise_std = 0.5
    tcfg.algorithm.entropy_coef = 0.005
    tcfg.algorithm.nan_guard = True
    tcfg.algorithm.anchor_kl_coef = 0.3
    tcfg.algorithm.class_target_frac = 0.5
    return cfg, tcfg


def hold_env(task_registry, dev):
    """The go2 handstand under the eval overrides of
    tests/test_pretrained_go2.py:109-123 (noise, friction and mass DR,
    pushes and contact stiffness off; every episode a planted hold)."""
    cfg, _ = task_registry.get_cfgs("go2_handstand")
    cfg.env.num_envs = N_ENVS
    cfg.noise.add_noise = False
    dr = cfg.domain_rand
    dr.randomize_friction = dr.randomize_base_mass = False
    dr.push_robots = dr.randomize_contact_stiffness = False
    cfg.env.test = True
    ist = cfg.init_state
    ist.handstand_init_prob = ist.handstand_init_prob_final = 1.0
    ist.handstand_mid_frac = 0.0
    env, _ = task_registry.make_env("go2_handstand", env_cfg=cfg, device=dev)
    return env


def hold_eval(env, act, torch):
    """The health bar of tests/test_pretrained_go2.py:171-198 over
    HOLD_STEPS steps of ``act``: per env the longest termination-free run
    of a held handstand (g_z above the hold band's lower edge less 0.01,
    base above 0.3 m), and the mean g_z over the held steps."""
    th_lo = env.cfg.init_state.handstand_hold_th_deg[0]
    band_edge = -math.cos(math.radians(th_lo))
    state, obs = env.reset_all()
    dev = env.device
    run = torch.zeros(env.num_envs, device=dev)
    best = torch.zeros(env.num_envs, device=dev)
    gz_sum = torch.zeros((), device=dev)
    n_held = torch.zeros((), device=dev)
    with torch.no_grad():
        for _ in range(HOLD_STEPS):
            state, obs, _, _, done, _ = env.step(state, act(obs))
            gz = env._projected_gravity(state.phys.base_quat)[:, 2]
            ok = ~done & (gz > band_edge - 0.01) & (state.phys.base_pos[:, 2] > 0.3)
            run = torch.where(ok, run + 1.0, 0.0)
            best = torch.maximum(best, run)
            gz_sum += torch.where(ok, gz, 0.0).sum()
            n_held += ok.sum()
    return {
        "hold_share": float((best >= HOLD_MIN_RUN).float().mean()),
        "mean_held_gz": float(gz_sum / torch.clamp(n_held, min=1.0)),
        "band_edge_gz": band_edge,
        "median_best_run_steps": float(best.median()),
    }


def handstand_phases(torch, dev, libs, build_s):
    """Phases 11-16 on the go2 handstand; returns K2's entry of the kernels
    line."""
    import tempfile

    from unitree_rl_gym_tpu_torch import resource
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.models.networks import (
        load_flat_params, load_flat_policy,
    )
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import cuda_step
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    artifact = resource("resources/pre_train/go2_handstand")

    # ---- 11. K2's builds (started with every other build in phase 2) ----
    t0 = time.time()
    report = {}
    for (lib, sizes), path in libs.items():
        report[f"{lib} {' '.join(sizes)}"] = {
            "library": path.split("unitree_rl_gym_tpu_torch/")[-1],
            "ptxas": ptxas_by_kernel(cuda_step.BUILD_LOGS.get(path, "")),
        }
    emit({"phase": "build_cs", "build_seconds_all_libraries": build_s,
          "libraries": report, "seconds": time.time() - t0})

    # ---- 12. K2 against the plain version on the fine-tune's env ----
    t0 = time.time()
    env_cfg, train_cfg = finetune_cfgs(task_registry, N_ENVS)
    env, _ = task_registry.make_env("go2_handstand", env_cfg=env_cfg, device=dev)
    cfg = env.cfg
    m = pb.soa_model_for(env.robot.dyn)
    check((m.ncp, m.nrb) == (79, 29), f"handstand model sizes {(m.ncp, m.nrb)}")
    step_args = (env.robot.dyn, env.cparams, env.pd, cfg.sim.dt, cfg.control.decimation)
    policy = load_flat_policy(artifact, dev)

    def inputs(state, obs):
        with torch.no_grad():
            actions = torch.clamp(policy.act(obs), -cfg.normalization.clip_actions,
                                  cfg.normalization.clip_actions)
        return (state.phys, env._compute_target(actions), state.friction,
                state.mass_scale, env.m_eff_n, env.m_eff_t)

    state, obs = env.reset_all()
    cs = state.cstiff
    check(cs is not None and bool(((cs >= 0.7) & (cs <= 1.5)).all()),
          "cstiff not drawn in [0.7, 1.5]")
    cases = {"reset": inputs(state, obs)}
    with torch.no_grad():
        for _ in range(HS_WALK_STEPS):
            state, obs, *_ = env.step(state, policy.act(obs))
    cases["walk"] = inputs(state, obs)
    max_state_err = max_aux_err = 0.0
    excused, excused_errs, per_output = {}, {}, {}
    for name, x in cases.items():
        ref_s, ref_aux = pb.control_step_soa(*step_args, *x, want_phi=True, cstiff=cs)
        got_s, got_aux = pb.control_step(*step_args, *x, cstiff=cs)
        torch.cuda.synchronize()
        s_err, a_err, excused[name], per_output[name], e_errs = compare(
            flat_outputs(ref_s, ref_aux), flat_outputs(got_s, got_aux),
            ref_aux["min_abs_phi"], torch, name="K2")
        max_state_err = max(max_state_err, s_err)
        max_aux_err = max(max_aux_err, a_err)
        excused_errs[name] = {"state": e_errs[0], "aux_normalised": e_errs[1]}
    # K2 with every stiffness 1 against K1 on the same inputs: the same bits
    x = cases["walk"]
    k2 = flat_outputs(*pb.control_step(*step_args, *x,
                                       cstiff=torch.ones_like(cs)))
    k1 = flat_outputs(*pb.control_step(*step_args, *x))
    torch.cuda.synchronize()
    differ = [k for k in k1 if not torch.equal(k1[k], k2[k])]
    check(not differ, f"K2 with cstiff = 1 differs from K1 in {differ}")
    # the terrain instance against the plain version at the go2_terrain reset
    t_cfg, _ = task_registry.get_cfgs("go2")
    t_cfg.env.num_envs = N_ENVS
    t_cfg.terrain.mesh_type = "heightfield"
    t_cfg.terrain.curriculum = True
    t_env, _ = task_registry.make_env("go2", env_cfg=t_cfg, device=dev)
    t_state, _ = t_env.reset_all()
    gen = torch.Generator(device=dev).manual_seed(0)
    t_cs = 0.7 + 0.8 * torch.rand(N_ENVS, generator=gen, device=dev)
    t_args = (t_env.robot.dyn, t_env.cparams, t_env.pd, t_env.cfg.sim.dt,
              t_env.cfg.control.decimation)
    t_x = (t_state.phys, t_env._compute_target(torch.zeros(N_ENVS, 12, device=dev)),
           t_state.friction, t_state.mass_scale, t_env.m_eff_n, t_env.m_eff_t)
    ref_s, ref_aux = pb.control_step_soa(*t_args, *t_x, gh=t_state.gh,
                                         want_phi=True, cstiff=t_cs)
    got_s, got_aux = pb.control_step(*t_args, *t_x, t_state.gh, cstiff=t_cs)
    torch.cuda.synchronize()
    t_ncp = pb.soa_model_for(t_env.robot.dyn).ncp
    check(tuple(got_aux["p_xy"].shape) == (2 * t_ncp, N_ENVS), "p_xy shape")
    t_err, t_aux_err, t_excused, t_per_output, _ = compare(
        flat_outputs(ref_s, ref_aux), flat_outputs(got_s, got_aux),
        ref_aux["min_abs_phi"], torch, name="K2 (terrain)")
    emit({"phase": "compare_cs", "n_envs": N_ENVS, "ncp": m.ncp,
          "cstiff_range": [float(cs.min()), float(cs.max())],
          "max_abs_err_state": max_state_err, "max_err_aux_normalised": max_aux_err,
          "excused_contact_edge_envs": excused,
          "max_excused_envs": int(MAX_EXCUSED_SHARE * N_ENVS),
          "max_errors_of_excused_envs": excused_errs,
          "max_errors_by_output": per_output,
          "cs_one_bit_identical_to_k1": True,
          "terrain_max_abs_err_state": t_err,
          "terrain_max_err_aux_normalised": t_aux_err,
          "terrain_excused_contact_edge_envs": t_excused,
          "terrain_max_errors_by_output": t_per_output,
          "seconds": time.time() - t0})

    # ---- 13. timing on the same inputs (walk state) ----
    t0 = time.time()
    k2_ms = cuda_ms(torch, lambda: pb.control_step(*step_args, *x, cstiff=cs),
                    TIME_LAUNCHES, 3)
    plain_ms = cuda_ms(torch, lambda: pb.control_step_soa(*step_args, *x, cstiff=cs),
                       TIME_PLAIN, 1)
    k1_hs_ms = cuda_ms(torch, lambda: pb.control_step(*step_args, *x), TIME_LAUNCHES, 3)
    k2_terrain_ms = cuda_ms(
        torch, lambda: pb.control_step(*t_args, *t_x, t_state.gh, cstiff=t_cs),
        TIME_LAUNCHES, 3)
    flops = cuda_step.flops_per_env(m, cfg.control.decimation, env.cparams.iterations,
                                    cs=True)
    nbytes = cuda_step.bytes_per_env(m, cs=True)
    t_ops = N_ENVS * flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = N_ENVS * nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    emit({"phase": "time_cs", "k2_ms": k2_ms, "plain_ms": plain_ms,
          "k1_same_inputs_ms": k1_hs_ms, "k2_terrain_go2_ms": k2_terrain_ms,
          "flops_per_env": flops, "bytes_per_env": nbytes, "bound_ms": bound_ms,
          "ops_ms": t_ops, "bytes_ms": t_bytes, "seconds": time.time() - t0})
    del t_env, t_state, t_x, cases

    # ---- 14. the pretrained handstand holds (K1 at the handstand's sizes) ----
    t0 = time.time()
    h_env = hold_env(task_registry, dev)
    cuda_step.LAUNCHES = cuda_step.LAUNCHES_CS = 0
    hold = hold_eval(h_env, policy.act, torch)
    torch.cuda.synchronize()
    k1_hold = cuda_step.LAUNCHES
    check(k1_hold == HOLD_STEPS + 1,
          f"K1 launched {k1_hold} times in reset_all and {HOLD_STEPS} hold steps")
    check(cuda_step.LAUNCHES_CS == 0, "K2 launched without contact-stiffness DR")
    check(hold["hold_share"] >= HOLD_MIN_SHARE,
          f"{hold['hold_share']:.1%} of the envs held a handstand >= "
          f"{HOLD_MIN_RUN} steps, below {HOLD_MIN_SHARE:.0%}")
    check(hold["mean_held_gz"] > hold["band_edge_gz"],
          f"mean held g_z {hold['mean_held_gz']:.3f} below the band edge "
          f"{hold['band_edge_gz']:.3f}")
    emit(dict(hold, phase="hold", n_envs=N_ENVS, steps=HOLD_STEPS,
              k1_launches=k1_hold, min_run_steps=HOLD_MIN_RUN,
              min_share=HOLD_MIN_SHARE, seconds=time.time() - t0))

    # ---- 15. the fine-tune: OnPolicyRunner.learn from the shipped policy ----
    t0 = time.time()
    tmp = tempfile.TemporaryDirectory()
    runner = OnPolicyRunner(env, train_cfg, tmp.name)
    load_flat_params(runner.net, artifact)
    runner.set_anchor()
    runner.learn(1, init_at_random_ep_len=True)      # warm-up, not counted
    torch.cuda.synchronize()
    cuda_step.LAUNCHES = cuda_step.LAUNCHES_TERRAIN = cuda_step.LAUNCHES_CS = 0
    rows = runner.learn(FINETUNE_ITERS)
    torch.cuda.synchronize()
    k2_launches = cuda_step.LAUNCHES_CS
    others = (cuda_step.LAUNCHES, cuda_step.LAUNCHES_TERRAIN)
    steps = train_cfg.runner.num_steps_per_env
    check(k2_launches == steps * FINETUNE_ITERS,
          f"K2 launched {k2_launches} times in {FINETUNE_ITERS} iterations of {steps} steps")
    check(others == (0, 0), f"K1, K3 launched {others} times in the fine-tune")
    for row in rows:
        for k, v in row.items():
            vals = v.values() if isinstance(v, dict) else [v]
            check(all(math.isfinite(float(u)) for u in vals),
                  f"non-finite {k} at iteration {row['it']}: {v}")
        check(LR_MIN <= row["lr"] <= LR_MAX, f"lr {row['lr']} outside [1e-5, 1e-2]")
    for k in ("base_pos", "base_quat", "joint_q", "v"):
        check(bool(torch.isfinite(getattr(runner._env_state.phys, k)).all()),
              f"non-finite {k} after the fine-tune")
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
    hold_after = hold_eval(h_env, runner.get_inference_policy(), torch)
    emit({"phase": "finetune", "config": "go2_handstand robustness fine-tune",
          "n_envs": N_ENVS, "iterations": FINETUNE_ITERS, "k2_launches": k2_launches,
          "k1_k3_launches": list(others),
          "median_iteration_ms": it_s * 1e3,
          "train_env_steps_per_s": N_ENVS * steps / it_s,
          "median_rollout_ms": roll_s * 1e3, "median_update_ms": upd_s * 1e3,
          "env_steps_per_s_by_iteration": [r["fps"] for r in rows],
          "mean_step_reward": [r["mean_step_reward"] for r in rows],
          "value_loss": [r["value_loss"] for r in rows],
          "kl": [r["kl"] for r in rows], "lr": [r["lr"] for r in rows],
          "anchor_loss": [r["anchor_loss"] for r in rows],
          "nan_guard_skipped_minibatches": [r["nonfinite_steps"] for r in rows],
          "hold_after_finetune": hold_after,
          "checkpoint_round_trip": True, "seconds": time.time() - t0})

    # ---- 16. where the time of a fine-tune iteration goes ----
    t0 = time.time()
    emit(dict(profile_train(runner, torch, it_s * 1e3, roll_s * 1e3, upd_s * 1e3,
                            kernel="k2_ms", rollout_range=None,
                            update_range=("anchor_forward_ms", "ppo_anchor_forward")),
              phase="profile_finetune", seconds=time.time() - t0))
    tmp.cleanup()
    return {
        "name": "control_step_cs",
        "route": "cuda",
        "source": "unitree_rl_gym_tpu_torch/csrc/control_step_cs.cu",
        "replaces": "unitree_rl_gym_tpu/physics/pallas_step.py:186",
        "replaces_function": "pallas_step.control_step_pallas (_kernel, "
                             "has_cs=True; has_gh=False on the fine-tune's "
                             "path, has_gh=True in the terrain instance)",
        "launches": k2_launches,
        "max_abs_err": max_state_err,
        "max_err": max_state_err,
        "max_err_aux_normalised": max_aux_err,
        "max_abs_err_terrain_instance": t_err,
        "ms": k2_ms,
        "ms_terrain_instance_go2": k2_terrain_ms,
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

    # ---- 2. build: every library (K1 and K3; K2) at go2's sizes and at
    #      the handstand's, all nvcc processes started together ----
    t0 = time.time()
    args = helpers.get_args(["--task=go2", f"--num_envs={N_ENVS}", "--device=cuda"])
    env = play.make_play_env(args, dev)
    m = pb.soa_model_for(env.robot.dyn)
    m_hs = handstand_model(dev)
    t_build = time.time()
    libs = cuda_step.build_all([m, m_hs])
    build_s = time.time() - t_build
    lib_path = libs[("control_step", cuda_step.size_defines(m))]
    emit({"phase": "build", "library": lib_path.split("unitree_rl_gym_tpu_torch/")[-1],
          "build_seconds": build_s, "libraries_built_together": len(libs),
          "ptxas": ptxas_by_kernel(cuda_step.BUILD_LOGS.get(lib_path, "")),
          "seconds": time.time() - t0})

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

    # ---- 11-16. the handstand robustness fine-tune (K2) ----
    k2_entry = handstand_phases(torch, dev, libs, build_s)

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
    }, k3_entry, k2_entry]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
