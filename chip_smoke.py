#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (unitree_rl_gym_tpu_torch) on one
NVIDIA GPU:

    python3 chip_smoke.py

It drives the port's four paths at 4096 envs — the go2 flat policy
rollout of ``scripts/play.py`` with the pretrained MLP actor [512, 256,
128] (kernel K1), PPO training of go2 on heightfield terrain with the
terrain curriculum through ``OnPolicyRunner.learn`` (kernel K3), the
go2 handstand robustness fine-tune from the shipped policy with contact
stiffness, friction, push, PD-gain and actuation-delay DR and PPO's
nan guard, anchor KL and class weights (kernel K2), and env data-parallel
go2 training over 2 torch.distributed ranks (kernel K4: each rank's launch
of its K1, K3 or K2 instance on its 2048-env block) — and holds every
kernel of those paths against its plain PyTorch version on the same
inputs (K4 on each rank's block, and against the rows of a one-process
launch, bit for bit):

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
              the idle share;
 17-20. the data-parallel phases (``dp_phases``): 2 ranks on the one card,
              spawned (``parallel.mesh.spawn_ranks``), over gloo, named
              explicitly (NCCL refuses two ranks on one device); the
              one-process runs happen in this process first:
 17. dp_kernel  K1 on a go2 reset, K3 on a go2_terrain reset and K2 on the
              fine-tune's DR reset, each launched once over all 4096 envs
              here and then by each rank on its 2048-env block through
              ``backend.control_step(..., block=)`` (K4): each rank holds
              its K4 outputs against the plain version on its block, with
              K1's tolerance and excuse rule, and every output of every
              rank must be bit-identical to its rows of the one-process
              launch; each rank's K4 time (CUDA events, one rank at a
              time) beside the one-process launch's;
 18. dp_parity  go2 flat at float32 compute, 1 iteration from the same
              seed as 1 rank x 4096 and as 2 ranks x 2048, three ways: the
              float32 policy, the policy held in float64
              (``hold_in_float64``), and the float64 policy with the push
              DR off. Every way: the ranks' parameters, Adam moments and
              lr bit-identical, and lr equal between the runs. Given the
              one process's float64 update inputs and its parameters
              before each minibatch, every rank's all-reduced gradient
              within atol 1e-7 / rtol 1e-5 of the one process's (scaled by
              max(|g|, 1)), its loss and stats within atol 1e-7 / rtol
              1e-5. Without pushes: each rank's rollout (obs, actions,
              log-probs, values, means, returns) bit-identical to its rows
              of the one process's, and the parameters after the
              free-running iteration within 1e-4 of the one process's.
              With pushes the parameter errors and how far each rank's
              rollout is from its rows are printed, not gated:
              ``curricula.push_robots``' batched ``einsum``s round a
              2048-env block otherwise than its rows of the 4096-env call,
              and Adam's first step, at the rate the first minibatch
              raised to 1.5e-3, moves an entry whose gradient is rounding
              noise by ~lr either way;
 19. dp_train   the flagship at its stock settings (bf16 compute): go2
              flat at 4096 envs, one warm-up + DP_TRAIN_ITERS counted + one
              profiled iteration, as 1 rank (K1 launched 24 times per
              iteration, K4 never) and as 2 ranks (each rank's K4 launched
              24 times per iteration, K1, K3 and K2 never): iteration,
              rollout and update ms, env-steps/s, the device's busy ms and
              idle share, the gloo all-reduce ms per minibatch; every
              metric finite, lr in [1e-5, 1e-2], rank 0's checkpoint loads
              back bit for bit, the ranks end bit-identical;
 20. dp_terrain go2_terrain as 2 ranks x 2048, one warm-up + 2 iterations:
              K4 over K3 with each rank's gh carry and window refresh;
              counts and finiteness as in dp_train.

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
DP_WORLD = 2             # ranks of the data-parallel phases, on one card
DP_TRAIN_ITERS = 5       # counted data-parallel flagship iterations
DP_TERRAIN_ITERS = 2     # counted data-parallel go2_terrain iterations
DP_PARITY_ATOL = 1e-4    # 1 rank vs 2 ranks after one float32 iteration
# the rollout fields dp_parity compares between 1 rank and 2 ranks
DATA_FIELDS = ("obs", "actions", "advantages", "returns")
# ... and those that must be bit-identical without pushes (the advantages
# are normalised with sums over ranks: printed)
EXACT_FIELDS = ("obs", "actions", "log_probs", "values", "mu", "returns")
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


# ---------------------------------------------------------------------------
# 17-20. env data parallelism over DP_WORLD ranks on the one card (K4)
# ---------------------------------------------------------------------------


def hold_in_float64(net):
    """Hold a policy in float64 for a parity check of the data-parallel
    path (dp_parity here, tests/test_torch_parallel_train.py): parameters
    and matmuls in float64, the heads' outputs and ``std`` in float32 as
    always. The env, the physics and the rollout stay float32, but the
    update's sums over samples carry no float32 rounding, which depends on
    how the samples are split over ranks (Adam's first step turns the sign
    of a gradient entry that sits within that rounding of zero into ~lr)."""
    import torch

    class Float64Policy(type(net)):
        def _head(self, seq, x):
            return seq(x.to(torch.float64)).to(torch.float32)

        def forward(self, obs, critic_obs=None):
            mu, std, value = super().forward(obs, critic_obs)
            return mu, std.to(torch.float32), value

    net.double()
    net.__class__ = Float64Policy


def dp_runner(block, dev, terrain=False, dtype=None, log_dir=None,
              float64=False, pushes=True):
    """A runner of go2 flat (go2_terrain with ``terrain``) at N_ENVS global
    envs, on ``block`` (None: one process), from the train cfg's seed;
    ``float64``: its policy held in float64 (``hold_in_float64``);
    ``pushes`` False: the push DR off."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    cfg, tcfg = task_registry.get_cfgs("go2")
    cfg.env.num_envs = N_ENVS
    if terrain:
        cfg.terrain.mesh_type = "heightfield"
        cfg.terrain.curriculum = True
    if dtype is not None:
        tcfg.policy.dtype = dtype
    cfg.domain_rand.push_robots = cfg.domain_rand.push_robots and pushes
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device=dev, block=block)
    runner = OnPolicyRunner(env, tcfg, log_dir)
    if float64:
        hold_in_float64(runner.net)
    return runner


def flat_grad(net):
    import torch

    return torch.cat([p.grad.reshape(-1) for p in net.parameters()])


def parity_run(block, dev, float64, grads=False, pushes=True):
    """dp_parity's one iteration at float32 compute (the policy in float64
    with ``float64``, the push DR off without ``pushes``). Returns (runner, {replica state, lr, parameters},
    what the update saw: its transitions with advantages and returns, its
    permutation and, with ``grads``, before each minibatch the parameters,
    then the gradient, loss and stats)."""
    from unitree_rl_gym_tpu_torch.parallel.dryrun import replica_state

    runner = dp_runner(block, dev, dtype="float32", float64=float64,
                       pushes=pushes)
    alg = runner.alg
    seen = {"params": [], "grads": [], "stats": []}
    minibatches, minibatch_grads = alg.minibatches, alg.minibatch_grads

    def record_minibatches(transitions, perm):
        seen["transitions"], seen["perm"] = transitions, perm
        return minibatches(transitions, perm)

    def record_grads(b, count=None):
        seen["params"].append([p.detach().clone() for p in alg.net.parameters()])
        loss, stats = minibatch_grads(b, count)
        seen["grads"].append(flat_grad(alg.net).clone())
        seen["stats"].append([float(loss.detach())] + [float(x) for x in stats])
        return loss, stats

    alg.minibatches = record_minibatches
    if grads:
        alg.minibatch_grads = record_grads
    runner.learn(1, init_at_random_ep_len=True)
    del alg.minibatches
    if grads:
        del alg.minibatch_grads
    out = {"state": replica_state(runner).cpu(), "lr": alg.lr,
           "params": {n: p.detach().cpu().float()
                      for n, p in runner.net.named_parameters()}}
    return runner, out, seen


def divergence(tr, rows, block):
    """How far a rank's rollout (``tr``, [T, n_local, ...]) is from its rows
    of the one process's (``rows``: field -> [T, N, ...] tensors): the
    largest error of each field, and the first step at which it is not
    bit-identical (None: never)."""
    out = {}
    for k, v in rows.items():
        d = (getattr(tr, k) - block.rows(v.to(tr.obs.device), 1)).abs()
        per_step = d.reshape(d.shape[0], -1).amax(dim=1)
        bad = (per_step > 0).nonzero()
        out[k] = {"max_abs_err": float(per_step.max()),
                  "first_step": int(bad[0, 0]) if bad.numel() else None}
    return out


def push_rows_err(torch, dev):
    """How far ``curricula.push_robots`` (which turns every env's velocity
    to the world frame and back with two batched ``einsum``s, pushed or
    not) gives each 2048-env block other bits than its rows of one
    4096-env call, on seeded states with no env due for a push."""
    from unitree_rl_gym_tpu_torch.envs import curricula
    from unitree_rl_gym_tpu_torch.physics import engine as eng

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n, h = N_ENVS, N_ENVS // DP_WORLD
    phys = eng.PhysicsState(
        base_pos=randn(n, 3),
        base_quat=torch.nn.functional.normalize(randn(n, 4), dim=1),
        joint_q=randn(n, 12), v=randn(n, 18))
    steps = torch.ones(n, dtype=torch.int32, device=dev)

    def push(rows):
        part = eng.PhysicsState(**{k: getattr(phys, k)[rows] for k in
                                   ("base_pos", "base_quat", "joint_q", "v")})
        return curricula.push_robots(randn(1, 2).expand(part.v.shape[0], 2),
                                     1000, steps[rows], part).v

    whole = push(slice(0, n))
    return max(float((push(slice(o, o + h)) - whole[o:o + h]).abs().max())
               for o in range(0, n, h))


def teacher_forced(runner, block, ref, dev):
    """The rank's all-reduced gradient, loss and stats of every minibatch
    of the one-process update ``ref`` (its transitions, permutation and
    parameters before each minibatch) against that update's own: the
    largest gradient error over max(|g|, 1), whether every entry is within
    atol 1e-7 / rtol 1e-5 of it so scaled, the largest error of the loss
    and stats and whether each is within atol 1e-7 / rtol 1e-5."""
    import torch

    alg = runner.alg
    full = ref["transitions"]
    local = type(full)(*(None if x is None else block.rows(x.to(dev), 1)
                         for x in full))
    mbs, mb = alg.minibatches(local, ref["perm"].to(dev))
    worst, within, stats_err, stats_within = 0.0, True, 0.0, True
    for i, (params, want) in enumerate(zip(ref["params"], ref["grads"])):
        with torch.no_grad():
            for p, q in zip(alg.net.parameters(), params):
                p.copy_(q)
        loss, stats = alg.minibatch_grads(mbs[i % len(mbs)], mb)
        got, want = flat_grad(alg.net), want.to(dev)
        mag = max(float(want.abs().max()), 1.0)
        d = (got - want).abs() / mag
        within &= bool((d <= 1e-7 + 1e-5 * want.abs() / mag).all())
        worst = max(worst, float(d.max()))
        for g, w in zip([float(loss.detach())] + [float(x) for x in stats],
                        ref["stats"][i]):
            stats_err = max(stats_err, abs(g - w))
            stats_within &= abs(g - w) <= 1e-7 + 1e-5 * abs(w)
    return {"minibatches": len(ref["grads"]), "max_grad_err_normalised": worst,
            "grads_within_tolerance": within, "max_stats_abs_err": stats_err,
            "stats_within_tolerance": stats_within}


def launch_counts():
    from unitree_rl_gym_tpu_torch.physics import cuda_step

    return {"k4": cuda_step.LAUNCHES_SHARDED, "k1": cuda_step.LAUNCHES,
            "k3": cuda_step.LAUNCHES_TERRAIN, "k2": cuda_step.LAUNCHES_CS}


def zero_launch_counts():
    from unitree_rl_gym_tpu_torch.physics import cuda_step

    cuda_step.LAUNCHES_SHARDED = cuda_step.LAUNCHES = 0
    cuda_step.LAUNCHES_TERRAIN = cuda_step.LAUNCHES_CS = 0


def dp_train_run(runner, torch, iters, name, expect):
    """One warm-up iteration, then ``iters`` counted with the launch counts
    zeroed just before, then one profiled: checks the counts against
    ``expect`` ({counter: launches per iteration}, every other counter 0),
    every metric finite and lr within bounds. Returns the phase's record."""
    runner.learn(1, init_at_random_ep_len=True)      # warm-up, not counted
    torch.cuda.synchronize()
    zero_launch_counts()
    rows = runner.learn(iters)
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = runner.cfg.runner.num_steps_per_env
    want = {k: expect.get(k, 0) * steps * iters for k in counts}
    check(counts == want, f"{name}: launches {counts}, expected {want}")
    for row in rows:
        for k, v in row.items():
            vals = v.values() if isinstance(v, dict) else [v]
            check(all(math.isfinite(float(u)) for u in vals),
                  f"{name}: non-finite {k} at iteration {row['it']}: {v}")
        check(row["nonfinite_steps"] == 0, f"{name}: nonfinite_steps")
        check(LR_MIN <= row["lr"] <= LR_MAX, f"{name}: lr {row['lr']} outside [1e-5, 1e-2]")
    for k in ("base_pos", "base_quat", "joint_q", "v"):
        check(bool(torch.isfinite(getattr(runner._env_state.phys, k)).all()),
              f"{name}: non-finite {k} after training")

    def med(key):
        return sorted(r[key] for r in rows)[len(rows) // 2]

    it_s, roll_s, upd_s = med("iteration_s"), med("rollout_s"), med("update_s")
    rec = {"launches": counts, "iterations": iters,
           "median_iteration_ms": it_s * 1e3,
           "train_env_steps_per_s": runner.env.num_envs_global * steps / it_s,
           "median_rollout_ms": roll_s * 1e3, "median_update_ms": upd_s * 1e3,
           "env_steps_per_s_by_iteration": [r["fps"] for r in rows],
           "kl": [r["kl"] for r in rows], "lr": [r["lr"] for r in rows],
           "value_loss": [r["value_loss"] for r in rows]}
    if "allreduce_s" in rows[0]:
        n_mb = (runner.cfg.algorithm.num_learning_epochs
                * runner.cfg.algorithm.num_mini_batches)
        rec["allreduce_ms_per_minibatch"] = med("allreduce_s") * 1e3 / n_mb
    if "terrain_level" in rows[0]:
        rec["terrain_level"] = [r["terrain_level"] for r in rows]
    rec["profile"] = profile_train(
        runner, torch, it_s * 1e3, roll_s * 1e3, upd_s * 1e3,
        kernel="k4_ms" if "k4" in expect else "k1_ms", rollout_range=None)
    return rec


def kernel_inputs(torch, dev):
    """dp_kernel's three cases at N_ENVS envs: {name: {"args": the control
    step's model and constants, "m_eff": ..., "inputs": tensors on the card
    (the reset state, a seeded random action's target, gh, cstiff)}}."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    cases = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in ("K1", "K3", "K2"):
        if name == "K2":
            cfg, _ = finetune_cfgs(task_registry, N_ENVS)
            task = "go2_handstand"
        else:
            cfg, _ = task_registry.get_cfgs("go2")
            cfg.env.num_envs = N_ENVS
            task = "go2"
            if name == "K3":
                cfg.terrain.mesh_type = "heightfield"
                cfg.terrain.curriculum = True
        env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
        state, _ = env.reset_all()
        actions = 0.3 * torch.randn((N_ENVS, env.num_actions), generator=gen,
                                    device=dev)
        x = {k: getattr(state.phys, k) for k in ("base_pos", "base_quat",
                                                 "joint_q", "v")}
        x.update(target=env._compute_target(actions), friction=state.friction,
                 mass_scale=state.mass_scale)
        if name == "K3":
            x["gh"] = state.gh
        if name == "K2":
            x["cstiff"] = state.cstiff
        cases[name] = {"args": (env.robot.dyn, env.cparams, env.pd, env.cfg.sim.dt,
                                env.cfg.control.decimation),
                       "m_eff": (env.m_eff_n, env.m_eff_t), "inputs": x}
    return cases


def kernel_step(case, x, block=None, plain=False):
    """``backend.control_step`` of a dp_kernel case on inputs ``x``: K1, K3
    or K2 over all envs, K4 on ``block``; with ``plain``, the plain version
    (``backend.control_step_soa``, with ``min_abs_phi``) on ``x``'s envs.
    Flat outputs."""
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import engine as eng

    phys = eng.PhysicsState(**{k: x[k] for k in ("base_pos", "base_quat",
                                                  "joint_q", "v")})
    step_args = (*case["args"], phys, x["target"], x["friction"],
                 x["mass_scale"], *case["m_eff"])
    if plain:
        s, aux = pb.control_step_soa(*step_args, gh=x.get("gh"), want_phi=True,
                                     cstiff=x.get("cstiff"))
    else:
        s, aux = pb.control_step(*step_args, gh=x.get("gh"),
                                 cstiff=x.get("cstiff"), block=block)
    return flat_outputs(s, aux)


def dp_rank(out_dir):
    """One rank of phases 17-20 (started by ``parallel.mesh.spawn_ranks``):
    its K4 launches and times, its float32 iteration, the flagship's and
    go2_terrain's training on its block; writes ``<out_dir>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
    from unitree_rl_gym_tpu_torch.parallel.dryrun import replica_state

    dev = pmesh.init_process_group("cuda", backend="gloo")
    block = pmesh.env_block(N_ENVS)
    res = {"rank": block.rank, "block": (block.offset, block.n_local)}

    # ---- 17. K4 on this rank's block; timed one rank at a time ----
    cases = torch.load(os.path.join(out_dir, "kernel_cases.pt"), weights_only=False)
    res["kernel"] = {}
    for name, case in cases.items():
        x = pmesh.shard_env_state({k: v.to(dev) for k, v in case["inputs"].items()},
                                  block)
        zero_launch_counts()
        out = kernel_step(case, x, block)
        torch.cuda.synchronize()
        check(launch_counts()["k4"] == 1, f"rank {block.rank}: {name} not launched as K4")
        # against the plain version on the same block, with K1's tolerance
        # and excuse rule
        ref = kernel_step(case, x, plain=True)
        s_err, a_err, n_excused, per_output, e_errs = compare(
            ref, out, ref["min_abs_phi"], torch,
            name=f"K4 ({name}) on rank {block.rank}")
        vs_plain = {"max_abs_err_state": s_err, "max_err_aux_normalised": a_err,
                    "excused_contact_edge_envs": n_excused,
                    "max_excused_envs": int(MAX_EXCUSED_SHARE * block.n_local),
                    "max_errors_of_excused_envs": {"state": e_errs[0],
                                                   "aux_normalised": e_errs[1]},
                    "max_errors_by_output": per_output}
        del ref
        ms = None
        for r in range(block.world_size):
            dist.barrier()
            if r == block.rank:
                ms = cuda_ms(torch, lambda: kernel_step(case, x, block), TIME_LAUNCHES, 3)
        dist.barrier()
        res["kernel"][name] = {"out": {k: v.cpu() for k, v in out.items()},
                               "ms": ms, "vs_plain": vs_plain}

    # ---- 18. one iteration, float32 compute, with the policy in float32
    #      (its rollout against the one process's rows) and in float64;
    #      then the one process's float64 update, teacher-forced; then the
    #      float64 policy without pushes (its rollout against the rows) ----
    _, p32, seen = parity_run(block, dev, False)
    rows = torch.load(os.path.join(out_dir, "parity32_data.pt"))
    p32["rollout_divergence"] = divergence(seen["transitions"], rows, block)
    del rows, seen
    runner, p64, seen = parity_run(block, dev, True)
    ref = torch.load(os.path.join(out_dir, "parity64_update.pt"), weights_only=False)
    p64["rollout_divergence"] = divergence(
        seen["transitions"], {k: getattr(ref["transitions"], k) for k in DATA_FIELDS},
        block)
    res["parity"] = {"float32": p32, "float64": p64,
                     "teacher_forced": teacher_forced(runner, block, ref, dev)}
    del runner, ref, seen
    _, p64np, seen = parity_run(block, dev, True, pushes=False)
    rows = torch.load(os.path.join(out_dir, "parity64_no_push_data.pt"))
    p64np["rollout_divergence"] = divergence(seen["transitions"], rows, block)
    res["parity"]["float64_no_push"] = p64np
    del rows, seen

    # ---- 19. the flagship (bf16), rank 0 writing the checkpoints ----
    runner = dp_runner(block, dev, log_dir=os.path.join(out_dir, "ckpt"))
    res["train"] = dp_train_run(runner, torch, DP_TRAIN_ITERS, "dp_train",
                                {"k4": 1})
    res["train"].update(
        state=replica_state(runner).cpu(), lr_final=runner.alg.lr,
        iteration=runner.current_learning_iteration,
        params={n: p.detach().cpu() for n, p in runner.net.named_parameters()})
    del runner

    # ---- 20. go2_terrain ----
    runner = dp_runner(block, dev, terrain=True)
    res["terrain"] = dp_train_run(runner, torch, DP_TERRAIN_ITERS, "dp_terrain",
                                  {"k4": 1})
    res["terrain"]["state"] = replica_state(runner).cpu()
    torch.save(res, os.path.join(out_dir, f"rank{block.rank}.pt"))


def dp_phases(torch, dev, t_start):
    """Phases 17-20: the one-process parts here, the ranks' in DP_WORLD
    spawned processes sharing the card over gloo; returns K4's entry of the
    kernels line."""
    import tempfile

    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import cuda_step
    from unitree_rl_gym_tpu_torch.physics import engine as eng
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    t0 = time.time()
    tmp = tempfile.TemporaryDirectory()
    out_dir = tmp.name

    # ---- 17 (one process): each instance once over all envs, timed ----
    cases = kernel_inputs(torch, dev)
    whole, whole_ms = {}, {}
    for name, case in cases.items():
        x = case["inputs"]
        whole[name] = {k: v.cpu() for k, v in kernel_step(case, x).items()}
        whole_ms[name] = cuda_ms(torch, lambda: kernel_step(case, x),
                                 TIME_LAUNCHES, 3)
    blk0 = pmesh.env_block(N_ENVS, 0, DP_WORLD)
    k1 = cases["K1"]
    x0 = pmesh.shard_env_state(k1["inputs"], blk0)
    phys0 = {k: x0[k] for k in ("base_pos", "base_quat", "joint_q", "v")}
    plain_block_ms = cuda_ms(torch, lambda: pb.control_step_soa(
        *k1["args"], eng.PhysicsState(**phys0), x0["target"], x0["friction"],
        x0["mass_scale"], *k1["m_eff"]), TIME_PLAIN, 1)
    torch.save({n: dict(c, inputs={k: v.cpu() for k, v in c["inputs"].items()})
                for n, c in cases.items()}, os.path.join(out_dir, "kernel_cases.pt"))
    m = pb.soa_model_for(k1["args"][0])
    decimation, iterations = k1["args"][4], k1["args"][1].iterations
    del cases, x0, phys0
    t_kernel_prep = time.time() - t0

    # ---- 18 (one process): one iteration over all envs, both ways; the
    #      float32 rollout's data and the float64 update's inputs, per-
    #      minibatch parameters, gradients and stats, for the ranks ----
    t1 = time.time()
    _, one32, seen = parity_run(None, dev, False)
    torch.save({k: getattr(seen["transitions"], k).cpu() for k in DATA_FIELDS},
               os.path.join(out_dir, "parity32_data.pt"))
    _, one64, seen = parity_run(None, dev, True, grads=True)
    tr = seen["transitions"]
    torch.save({"transitions": type(tr)(*(None if x is None else x.cpu() for x in tr)),
                "perm": seen["perm"].cpu(),
                "params": [[p.cpu() for p in ps] for ps in seen["params"]],
                "grads": [g.cpu() for g in seen["grads"]], "stats": seen["stats"]},
               os.path.join(out_dir, "parity64_update.pt"))
    del seen, tr
    _, one64np, seen = parity_run(None, dev, True, pushes=False)
    torch.save({k: getattr(seen["transitions"], k).cpu()
                for k in EXACT_FIELDS + ("advantages",)},
               os.path.join(out_dir, "parity64_no_push_data.pt"))
    one_parity = {"float32": one32, "float64": one64,
                  "float64_no_push": one64np}
    del seen
    t_parity_one = time.time() - t1

    # ---- 19 (one process): the flagship's first card record ----
    t1 = time.time()
    runner = dp_runner(None, dev)
    one_train = dp_train_run(runner, torch, DP_TRAIN_ITERS, "dp_train (1 rank)",
                             {"k1": 1})
    env_one = runner.env
    train_cfg = runner.cfg
    del runner
    t_train_one = time.time() - t1

    # ---- the ranks: DP_WORLD processes on the card, over gloo ----
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t1 = time.time()
    budget = TIME_LIMIT_S - 60 - (time.time() - t_start)
    pmesh.spawn_ranks(dp_rank, DP_WORLD, (out_dir,), timeout_s=budget)
    t_ranks = time.time() - t1
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]

    # ---- 17. every rank's K4 outputs against its rows of the launch (the
    #      ranks held them against the plain version on their blocks) ----
    max_err, plain_err, kernel_rec = 0.0, 0.0, {}
    for name in whole:
        for res in ranks:
            off, n = res["block"]
            got = res["kernel"][name]["out"]
            check(set(got) == set(whole[name]), f"dp_kernel {name}: outputs {sorted(got)}")
            for k, v in got.items():
                want = (whole[name][k][:, off:off + n] if k == "p_xy"
                        else whole[name][k][off:off + n])
                check(v.shape == want.shape, f"dp_kernel {name} {k}: shape")
                err = float((v - want).abs().max())
                max_err = max(max_err, err)
                check(torch.equal(v, want),
                      f"dp_kernel {name}: rank {res['rank']}'s {k} differs from "
                      f"its rows of the one-process launch by up to {err}")
        vs_plain = [r["kernel"][name]["vs_plain"] for r in ranks]
        plain_err = max([plain_err] + [v["max_abs_err_state"] for v in vs_plain])
        kernel_rec[name] = {"one_process_ms_4096": whole_ms[name],
                            "rank_ms_2048": [r["kernel"][name]["ms"] for r in ranks],
                            "vs_plain_by_rank": vs_plain}
    emit({"phase": "dp_kernel", "world": DP_WORLD, "n_global": N_ENVS,
          "n_local": N_ENVS // DP_WORLD, "backend": "gloo", "bit_identical": True,
          "max_abs_err_vs_one_process_rows": max_err,
          "max_abs_err_state_vs_plain": plain_err, "kernels": kernel_rec,
          "plain_ms_block_k1": plain_block_ms,
          "seconds_one_process": t_kernel_prep})

    # ---- 18. 1 rank vs 2 ranks after one iteration: the ranks identical
    #      and lr equal every way; every minibatch's all-reduced gradient,
    #      given the one process's inputs and parameters, within atol 1e-7
    #      / rtol 1e-5 of its own (scaled by max(|g|, 1)). With pushes
    #      (whose batched einsums round a block otherwise than its rows of
    #      the whole batch) the free-running parameters are printed with
    #      the number of entries beyond DP_PARITY_ATOL; without them and
    #      with the policy in float64, each rank's rollout must be its rows
    #      of the one process's, bit for bit, and the parameters within
    #      DP_PARITY_ATOL ----
    rec = {}
    for prec, one in one_parity.items():
        mine = [r["parity"][prec] for r in ranks]
        for r in mine[1:]:
            check(torch.equal(r["state"], mine[0]["state"]),
                  f"dp_parity ({prec}): the ranks' params, Adam state or lr differ")
        check(mine[0]["lr"] == one["lr"],
              f"dp_parity ({prec}): lr {mine[0]['lr']} vs {one['lr']}")
        errs = {n: float((p - one["params"][n]).abs().max())
                for n, p in mine[0]["params"].items()}
        worst = max(errs, key=errs.get)
        n_above = sum(int(((p - one["params"][n]).abs() > DP_PARITY_ATOL).sum())
                      for n, p in mine[0]["params"].items())
        rec[prec] = {"lr": one["lr"], "max_abs_param_err": errs[worst],
                     "max_err_tensor": worst, "entries_above_bound": n_above,
                     "n_params": sum(p.numel() for p in mine[0]["params"].values()),
                     "max_abs_err_by_tensor": errs}
        rec[prec]["rollout_divergence_by_rank"] = [
            r["parity"][prec]["rollout_divergence"] for r in ranks]
    tf = [r["parity"]["teacher_forced"] for r in ranks]
    emit({"phase": "dp_parity", "compute_dtype": "float32", "iterations": 1,
          "policy_float32": rec["float32"], "policy_float64": rec["float64"],
          "policy_float64_no_push": rec["float64_no_push"],
          "push_robots_block_vs_rows_max_abs_err": push_rows_err(torch, dev),
          "teacher_forced_policy_float64": tf, "ranks_bit_identical": True,
          "param_bound_printed": DP_PARITY_ATOL,
          "seconds_one_process": t_parity_one})
    no_push = rec["float64_no_push"]
    for r, div in enumerate(no_push["rollout_divergence_by_rank"]):
        late = {k: v for k, v in div.items()
                if k in EXACT_FIELDS and v["first_step"] is not None}
        check(not late, f"dp_parity (float64, no pushes): rank {r}'s rollout "
                        f"differs from its rows of the one process's: {late}")
    check(no_push["max_abs_param_err"] <= DP_PARITY_ATOL,
          f"dp_parity (float64, no pushes): parameters differ by "
          f"{no_push['max_abs_param_err']} in {no_push['max_err_tensor']}, "
          f"beyond {DP_PARITY_ATOL}")
    for t in tf:
        check(t["grads_within_tolerance"] and t["stats_within_tolerance"],
              f"dp_parity: the all-reduced gradient or stats differ from the "
              f"one process's: {t}")

    # ---- 19. the flagship: 1 rank, then 2 ranks on the one card ----
    tr = [r["train"] for r in ranks]
    for r in tr[1:]:
        check(torch.equal(r["state"], tr[0]["state"]),
              "dp_train: the ranks' params, Adam state or lr differ")
    ckpt = os.path.join(out_dir, "ckpt", f"model_{tr[0]['iteration']}.pt")
    fresh = OnPolicyRunner(env_one, train_cfg, None)
    fresh.load(ckpt)
    same = all(torch.equal(p.detach().cpu(), tr[0]["params"][n])
               for n, p in fresh.net.named_parameters())
    check(same and fresh.alg.lr == tr[0]["lr_final"],
          f"dp_train: {os.path.basename(ckpt)} does not load back rank 0's state")
    del fresh, env_one
    emit({"phase": "dp_train", "config": "go2 flat (bench.py's flagship), bf16",
          "n_global": N_ENVS, "one_rank": one_train,
          "two_ranks_one_card": {"backend": "gloo", "per_rank": [
              {k: v for k, v in r.items() if k not in ("state", "params")}
              for r in tr]},
          "ranks_bit_identical": True, "checkpoint_round_trip": True,
          "seconds_one_process": t_train_one, "seconds_ranks_all_phases": t_ranks})

    # ---- 20. go2_terrain on 2 ranks ----
    te = [r["terrain"] for r in ranks]
    for r in te[1:]:
        check(torch.equal(r["state"], te[0]["state"]),
              "dp_terrain: the ranks' params, Adam state or lr differ")
    emit({"phase": "dp_terrain", "config": "go2_terrain", "n_global": N_ENVS,
          "per_rank": [{k: v for k, v in r.items() if k != "state"} for r in te],
          "ranks_bit_identical": True, "seconds": time.time() - t0})
    tmp.cleanup()

    n_local = N_ENVS // DP_WORLD
    flops = cuda_step.flops_per_env(m, decimation, iterations)
    nbytes = cuda_step.bytes_per_env(m)
    t_ops = n_local * flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_local * nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "name": "control_step_sharded",
        "route": "cuda",
        "source": "unitree_rl_gym_tpu_torch/csrc/control_step.cu",
        "replaces": "unitree_rl_gym_tpu/physics/pallas_step.py:315",
        "replaces_function": "pallas_step.control_step_pallas_sharded (each "
                             "rank's K1 instance on its 2048-env block on the "
                             "flagship's path; K3 and K2 held in dp_kernel)",
        "launches": sum(r["launches"]["k4"] for r in tr),
        "launches_per_rank": [r["launches"]["k4"] for r in tr],
        "max_abs_err": plain_err,
        "max_abs_err_vs_one_process_rows": max_err,
        "ms": kernel_rec["K1"]["rank_ms_2048"][0],
        "ms_per_rank": kernel_rec["K1"]["rank_ms_2048"],
        "ms_by_instance_per_rank": {k: v["rank_ms_2048"] for k, v in kernel_rec.items()},
        "plain_ms": plain_block_ms,
        "bound_ms": max(t_ops, t_bytes),
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


def _time_limit(signum, frame):
    raise TimeoutError(f"chip_smoke ran past {TIME_LIMIT_S} s")


def main():
    # never run unbounded; raised, so that spawned ranks are stopped too
    signal.signal(signal.SIGALRM, _time_limit)
    signal.alarm(TIME_LIMIT_S)
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

    # ---- 17-20. env data parallelism over 2 ranks (K4) ----
    k4_entry = dp_phases(torch, dev, t_start)

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
    }, k3_entry, k2_entry, k4_entry]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
