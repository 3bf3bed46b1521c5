#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (unitree_rl_gym_tpu_torch) on one
NVIDIA GPU:

    python3 chip_smoke.py

It drives the port's five paths at 4096 envs — the go2 flat policy
rollout of ``scripts/play.py`` with the pretrained MLP actor [512, 256,
128] (kernel K1), PPO training of go2 on heightfield terrain with the
terrain curriculum through ``OnPolicyRunner.learn`` (kernel K3), the
go2 handstand robustness fine-tune from the shipped policy with contact
stiffness, friction, push, PD-gain and actuation-delay DR and PPO's
nan guard, anchor KL and class weights (kernel K2), env data-parallel
go2 and g1 (LSTM, recurrent PPO) training over 2 torch.distributed ranks
(kernel K4: each rank's launch of its K1, K3 or K2 instance on its
2048-env block, at go2's, the handstand's and the humanoids' sizes), and
the dryrun's g1-terrain-LSTM class on the ranks, and the humanoids
g1, h1 and h1_2 with their LSTM actor-critics: play of the shipped
policies and g1 training with recurrent PPO (K1 and K3 at the humanoids'
sizes), and play's resume-and-export of go2 and g1 with the exported
TorchScript policies driven through K1 — and holds every kernel of those paths against its plain PyTorch
version on the same inputs (K4 on each rank's block, and against the rows
of a one-process launch, bit for bit):

  1. device   the card's name and power limit (nvidia-smi);
  2. build    every library from source with nvcc, all started together:
              csrc/control_step.cu (K1, K3) and csrc/control_step_cs.cu
              (K2) at go2's sizes and at the handstand's (79 contact
              points), and csrc/control_step.cu at g1's, h1's and h1_2's;
              prints every instance's ptxas report (registers,
              stack frame, spills), the lanes per env, each instance's
              shared-memory scratch per env and the blocks per SM that the
              CUDA runtime's occupancy calculator grants it; no instance
              of any library may spill a register, and the resident blocks
              of every instance a path runs (K1, K3, K2 flat, K2 terrain,
              K1 at the handstand's sizes, K1 at each humanoid's, K3 at
              g1's and h1_2's) must hold all 4096 envs at once;
  3. compare  one control step through K1 (``backend.control_step``, the
              env's path) and through the plain version
              (``backend.control_step_soa``) at N=4096, from a fresh reset and
              from the state after 100 policy steps, at the physics tolerance
              of the tests (atol 5e-5 / rtol 1e-4 on the state;
              aux / max(|aux|, 1) within 5e-4). An env that differs is excused
              only if one of its contact points sat within 1e-6 of the
              activation edge (|phi| < 1e-6) during that step, and at most
              0.1% of the envs (4 of 4096) may be excused; those envs are
              counted and their largest errors printed. The largest state
              error must be the earlier kernels' to the last bit
              (``PARENT_MAX_ABS_ERR``: 0, the plain version's bits), and
              one more launch over the first
              4095 envs (its last warp one env short) must give the first
              4095 rows of the 4096-env launch bit for bit (so for K3 and
              K2 in phases 7 and 12);
  4. time     K1 and the plain version on the same inputs (CUDA events),
              beside K1's ptxas report; K1 also on the first envs only,
              one per SM (one env's chain of dependent phases);
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
              policy, with K1's tolerance, excuse rule and gates, p_xy
              included;
  8. time_terrain  K3 and the plain version (CUDA events), beside K3's
              ptxas report;
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
              policy, with K1's tolerance, excuse rule and gates; K2 with
              every stiffness 1 must give K1's bits on the same inputs; K2's
              terrain instance against the plain version at the
              go2_terrain reset;
 13. time_cs  K2 and the plain version (CUDA events) and K2's bound,
              the terrain instance at go2's sizes and its bound, beside
              K2's ptxas report, scratch and resident blocks;
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
 17. dp_kernel  K1 on a go2 reset, K3 on a go2_terrain reset, K2 on the
              fine-tune's DR reset, and each humanoid instance of
              HUMANOID_INSTANCES (K1 at g1's, h1's and h1_2's sizes, K3 at
              g1's and h1_2's) on its phase-21 env's reset, each with a
              seeded random action's target, each launched once over all 4096 envs
              here and then by each rank on its 2048-env block through
              ``backend.control_step(..., block=)`` (K4): each rank holds
              its K4 outputs against the plain version on its block, with
              K1's tolerance and excuse rule, and every output of every
              rank must be bit-identical to its rows of the one-process
              launch; each rank's K4 time (CUDA events, one rank at a
              time) beside the one-process launch's, and each instance's
              bound at 2048 envs;
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
              counts and finiteness as in dp_train;
 27. dp_train_g1 (in the same ranks, after 20) g1 flat with the LSTM
              actor-critic and recurrent PPO (bf16) as 2 ranks x 2048: one
              warm-up + DP_G1_ITERS counted + one profiled iteration, each
              rank's K4 (K1 at g1's sizes) launched 24 times per iteration
              and K1, K3 and K2 never, every metric finite, lr in [1e-5,
              1e-2]; iteration, rollout and update ms, the all-reduce ms
              per minibatch, device busy ms and idle share; the ranks end
              bit-identical, and every rank loads rank 0's last checkpoint
              back to its own state bit for bit;
 28. dp_dryrun_g1 (in the same ranks) ``parallel/dryrun.py``'s
              g1-terrain-lstm class (g1 on a 2 x 2 heightfield, the LSTM, 4
              envs a rank, one iteration; the dryrun checks the replicas):
              each rank's K4 (K3 at g1's sizes) launched DRYRUN_G1_LAUNCHES
              times and nothing else, losses finite, lr in bounds; then K4 on
              each rank's DRYRUN_ENVS_PER_RANK-env block of the class's env
              (the reset state, a seeded random action) against the plain
              version on the block and bit for bit against its rows of one
              launch over all the class's envs, timed with the plain
              version; the kernels line's entry for this instance gives
              those blocks' ms, error and bound.
 21-24. the humanoids (``humanoid_phases``), each instance of
              HUMANOID_INSTANCES (K1 at g1's, h1's and h1_2's sizes, K3 at
              g1's and h1_2's on bench.py's heightfield with the curriculum):
 21. compare_humanoid  one control step through the instance and through
              the plain version at N=4096, from the reset and after 100
              steps (terrain: 24) of the shipped LSTM policy
              (``resources/pre_train/{g1,h1,h1_2,g1_terrain}``; h1_2's on
              terrain), with K1's tolerance, excuse rule and 4095-env bit
              check; the largest state error is printed as the instance's
              ``PARENT_MAX_ABS_ERR`` entry;
 22. time_humanoid  the instance and the plain version (CUDA events),
              its bound, ptxas report, scratch and resident blocks; K1 at
              g1's sizes also on 132 envs (one env's chain);
 23. play_humanoid  400 steps of play's rollout with the shipped h1_2, g1
              and h1 LSTM policies (the actor and its carry on the card):
              K1 launched once per step and never K3, K2 or K4; h1_2's and
              g1's non-timeout terminations after the first third at most
              PLAY_FALL_BAR of the envs (h1's printed);
 24. train_g1 ``OnPolicyRunner.learn`` on g1 flat with the LSTM
              actor-critic and recurrent PPO: one warm-up iteration, then
              G1_TRAIN_ITERS with the counts zeroed just before (K1 24
              times per iteration, never K3, K2 or K4), every metric
              finite, lr in [1e-5, 1e-2], the last checkpoint (LSTM
              included) loads into a fresh runner bit for bit; then one
              profiled iteration (profile_train_g1: device ms by kernel,
              idle share).
 25-26. export and play of the exported policies (``export_phases``): a
              runner on the card takes the shipped weights
              (``networks.load_flat_params``) and saves ``model_0.pt`` in a
              run directory; ``scripts/play.py``'s entry (``play.play``:
              ``--resume``, 4096 envs, ``--device=cuda``, 400 steps) loads it,
              exports it to the run's ``exported/policies`` and plays it: K1
              launched 401 times (the 400 steps and ``reset_all``'s
              zero-action step) and never K3, K2 or K4, non-timeout
              terminations after play's settling window at most 1% of the
              envs, and ``policy.bin`` byte for byte the shipped file:
 25. export   go2 (MLP): ``policy_1.pt`` loaded onto the card within 1e-5 of
              the runner's float32 inference policy on the 4096 final
              observations, and on the CPU within 1e-5 of the export's
              ``NumpyPolicy``; then 400 steps of play's rollout driven by
              the loaded TorchScript module itself through K1, under the
              same gates (K1 400 times). Both rollouts' env-steps/s are
              printed;
 26. export_lstm  g1 (LSTM): ``policy_lstm_1.pt`` on the card, stepped over
              env 0's observations of 100 g1 steps through K1, within 1e-4
              of the float32 inference policy with its carry, and
              ``reset_memory()`` gives its first output again exactly.

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
DP_G1_ITERS = 3          # counted data-parallel g1 iterations (LSTM, recurrent PPO)
DRYRUN_G1_LAUNCHES = 5   # the dryrun's g1 class: reset_all's step + a 4-step rollout
DRYRUN_ENVS_PER_RANK = 4  # the dryrun's envs a rank (parallel/dryrun.py)
HUMANOID_WALK_STEPS = 100     # LSTM policy steps before the second flat comparison
HUMANOID_TERRAIN_STEPS = 24   # ... before the second terrain comparison
PLAY_HUMANOID_STEPS = 400     # steps of each pretrained humanoid's play
G1_TRAIN_ITERS = 5            # counted g1 training iterations
# non-timeout terminations after the first third of play, over the envs:
# go2's bar (1%), unless the JAX package's own play of the same artifact
# misses it (tests/jax_play_falls.py on the CPU, 64 envs, the same steps;
# PERF.md), in which case its rate plus one percentage point
PLAY_FALL_BAR = {"h1_2": 0.01, "g1": 0.01}
EXPORT_PLAY_STEPS = 400       # play steps of each exported policy (export phases)
EXPORT_LSTM_STEPS = 100       # g1 steps whose env-0 observations step policy_lstm_1.pt
EXPORT_MLP_ATOL = 1e-5        # policy_1.pt against the runner's float32 inference policy
EXPORT_LSTM_ATOL = 1e-4       # policy_lstm_1.pt against it, carry and all
EXPORT_FALL_BAR = 0.01        # the slice phase's bar, after play's settling window
# the humanoid instances the paths run: (name, task, terrain, artifact)
HUMANOID_INSTANCES = (
    ("K1 g1", "g1", False, "g1"), ("K1 h1", "h1", False, "h1"),
    ("K1 h1_2", "h1_2", False, "h1_2"), ("K3 g1", "g1", True, "g1_terrain"),
    ("K3 h1_2", "h1_2", True, "h1_2"),
)
# the rollout fields dp_parity compares between 1 rank and 2 ranks
DATA_FIELDS = ("obs", "actions", "advantages", "returns")
# ... and those that must be bit-identical without pushes (the advantages
# are normalised with sums over ranks: printed)
EXACT_FIELDS = ("obs", "actions", "log_probs", "values", "mu", "returns")
LR_MIN, LR_MAX = 9.999999747378752e-06, 0.009999999776482582  # float32 1e-5, 1e-2
PHI_EDGE = 1e-6          # |phi| below which a contact flip excuses an env
MAX_EXCUSED_SHARE = 1e-3  # of the envs, in one comparison
# The largest state error against the plain version of K1 (compare), K3
# (compare_terrain) and K2 (compare_cs) over the envs not excused at a
# contact edge, as every earlier form of the kernels gives it on these
# inputs (PERF.md §6). A schedule that keeps every output's sequence of
# roundings gives these to the last bit; any other value means the bits
# moved. They are 0: the plain version divides by dt as the kernel does
# (``soa._div``); until it did, torch's product with a float32 reciprocal
# left 4.6e-5 to 5.3e-5 here, with the kernel's bits the same.
PARENT_MAX_ABS_ERR = {"K1": 0.0, "K3": 0.0, "K2": 0.0}
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


def check_parent_err(name, err):
    check(err == PARENT_MAX_ABS_ERR[name],
          f"{name}: largest state error against the plain version {err!r}, "
          f"the earlier kernels' was {PARENT_MAX_ABS_ERR[name]!r}: the bits moved")


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


def first_envs(x, n):
    """A control step's inputs (phys state, target, friction, mass scale,
    then the per-point m_eff_n and m_eff_t) cut to their first ``n`` envs."""
    phys, target, friction, mass_scale, m_eff_n, m_eff_t = x
    phys = phys.replace(**{k: getattr(phys, k)[:n].contiguous()
                           for k in ("base_pos", "base_quat", "joint_q", "v")})
    return (phys, target[:n].contiguous(), friction[:n].contiguous(),
            mass_scale[:n].contiguous(), m_eff_n, m_eff_t)


def flat_outputs(state, aux):
    out = {k: getattr(state, k) for k in ("base_pos", "base_quat", "joint_q", "v")}
    out.update(aux)
    return out


def check_rows(rows, torch, runner, what):
    """Every metric of every iteration finite, lr in [1e-5, 1e-2] and the
    env state finite after ``what``."""
    for row in rows:
        for k, v in row.items():
            vals = v.values() if isinstance(v, dict) else [v]
            check(all(math.isfinite(float(u)) for u in vals),
                  f"non-finite {k} at iteration {row['it']}: {v}")
        check(LR_MIN <= row["lr"] <= LR_MAX, f"lr {row['lr']} outside [1e-5, 1e-2]")
    for k in ("base_pos", "base_quat", "joint_q", "v"):
        check(bool(torch.isfinite(getattr(runner._env_state.phys, k)).all()),
              f"non-finite {k} after {what}")


def check_partial_launch(torch, run, x, extra, whole, name):
    """A launch over the first N_ENVS - 1 envs (its last warp one env
    short) against the first N_ENVS - 1 rows of the launch over all envs
    (``whole``, flat outputs), bit for bit. ``run(x, extra)`` launches the
    kernel on a control step's inputs ``x`` (``first_envs``' tuple) and its
    per-env keyword operands ``extra`` (gh [ncp, N], cstiff [N]) and
    returns flat outputs. Returns the envs of the short launch."""
    n = N_ENVS - 1
    ex = {k: (v[:, :n] if k == "gh" else v[:n]).contiguous() for k, v in extra.items()}
    got = run(first_envs(x, n), ex)
    torch.cuda.synchronize()
    differ = [k for k in got if not torch.equal(
        got[k], whole[k][:, :n] if k == "p_xy" else whole[k][:n])]
    check(not differ, f"{name} over the first {n} envs differs from its launch "
          f"over {N_ENVS} in {differ}")
    return n


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
    partial = check_partial_launch(
        torch, lambda xx, ex: flat_outputs(*pb.control_step(*step_args, *xx, **ex)),
        x[:6], {"gh": x[6]}, flat_outputs(got_s, got_aux), "K3")
    check_parent_err("K3", max_state_err)
    gh = cases["walk"][6]
    emit({"phase": "compare_terrain", "n_envs": N_ENVS, "env_build_seconds": env_build_s,
          "parent_max_abs_err_state": PARENT_MAX_ABS_ERR["K3"],
          "short_launch_rows_bit_identical": partial,
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
          "ops_ms": t_ops, "bytes_ms": t_bytes,
          "ptxas": instance_ptxas(cuda_step, m, "control_step", "K3"),
          "seconds": time.time() - t0})

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


def spill_bytes(lines):
    """(spill stores, spill loads) in bytes from an instance's ptxas lines."""
    import re

    for ln in lines:
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if hit:
            return int(hit.group(1)), int(hit.group(2))
    raise RuntimeError(f"no spill report in ptxas lines {lines}")


def instance_ptxas(cuda_step, m, library, instance):
    """The ptxas lines of ``instance`` in the build of ``library`` for
    SoAModel ``m`` (phase 2 built it)."""
    log = cuda_step.BUILD_LOGS.get(cuda_step.library_path(m, library), "")
    return ptxas_by_kernel(log).get(instance, [])


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
    partial = check_partial_launch(
        torch, lambda xx, ex: flat_outputs(*pb.control_step(*step_args, *xx, **ex)),
        x, {"cstiff": cs}, flat_outputs(got_s, got_aux), "K2")
    check_parent_err("K2", max_state_err)
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
          "parent_max_abs_err_state": PARENT_MAX_ABS_ERR["K2"],
          "short_launch_rows_bit_identical": partial,
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
    # the terrain instance's bound at go2's sizes and the terrain env's
    # decimation
    t_m = pb.soa_model_for(t_env.robot.dyn)
    tr_ops = N_ENVS * cuda_step.flops_per_env(
        t_m, t_env.cfg.control.decimation, t_env.cparams.iterations, terrain=True,
        cs=True) / PEAK_FP32_FLOPS * 1e3
    tr_bytes = N_ENVS * cuda_step.bytes_per_env(
        t_m, terrain=True, cs=True) / PEAK_BYTES_PER_S * 1e3
    emit({"phase": "time_cs", "k2_ms": k2_ms, "plain_ms": plain_ms,
          "k2_terrain_go2_bound_ms": max(tr_ops, tr_bytes),
          "k1_same_inputs_ms": k1_hs_ms, "k2_terrain_go2_ms": k2_terrain_ms,
          "flops_per_env": flops, "bytes_per_env": nbytes, "bound_ms": bound_ms,
          "ops_ms": t_ops, "bytes_ms": t_bytes,
          "ptxas": {"K2 flat": instance_ptxas(cuda_step, m, "control_step_cs", "K2 flat"),
                    "K2 terrain (go2 sizes)": instance_ptxas(
                        cuda_step, pb.soa_model_for(t_env.robot.dyn),
                        "control_step_cs", "K2 terrain")},
          "scratch_bytes_per_env": {
              "K2 flat": cuda_step.scratch_bytes(m, "control_step_cs"),
              "K2 terrain (go2 sizes)": cuda_step.scratch_bytes(
                  pb.soa_model_for(t_env.robot.dyn), "control_step_cs", True)},
          "resident_blocks_per_sm": {
              "K2 flat": cuda_step.resident_envs(m, "control_step_cs")[0],
              "K2 terrain (go2 sizes)": cuda_step.resident_envs(
                  pb.soa_model_for(t_env.robot.dyn), "control_step_cs", True)[0]},
          "seconds": time.time() - t0})
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
    check_rows(rows, torch, runner, "the fine-tune")
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
        "bound_ms_terrain_instance_go2": max(tr_ops, tr_bytes),
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
    of a gradient entry that sits within that rounding of zero into ~lr).
    A recurrent net's memories compute in float64 too; its carry stays
    float32, as always."""
    import torch

    class Float64Policy(type(net)):
        _compute_dtype = torch.float64

        def forward(self, *args, **kwargs):
            # std is expanded before the cast: its gradient sums over
            # samples in float64
            mu, std, *rest = super().forward(*args, **kwargs)
            return (mu, std.to(torch.float32), *rest)

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


def g1_dp_runner(block, dev, log_dir=None):
    """A runner of g1 flat (``scripts/train.py --task=g1``'s cfgs: the LSTM
    actor-critic, recurrent PPO, bf16 compute) at N_ENVS global envs on
    ``block``, from the train cfg's seed."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

    cfg, tcfg = task_registry.get_cfgs("g1")
    cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env("g1", env_cfg=cfg, device=dev, block=block)
    return OnPolicyRunner(env, tcfg, log_dir)


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
    """dp_kernel's cases at N_ENVS envs: K1, K3 and K2 at go2's and the
    handstand's sizes, then each humanoid instance (HUMANOID_INSTANCES: K1
    at g1's, h1's and h1_2's sizes, K3 at g1's and h1_2's, on the envs of
    phases 21-22); {name: {"args": the control step's model and constants,
    "m_eff": ..., "inputs": tensors on the card (the reset state, a seeded
    random action's target, gh, cstiff)}}."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    cases = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    humanoids = {name: (task, terrain)
                 for name, task, terrain, _ in HUMANOID_INSTANCES}
    for name in ("K1", "K3", "K2") + tuple(humanoids):
        if name in humanoids:
            env = humanoid_env(*humanoids[name], dev)
        elif name == "K2":
            cfg, _ = finetune_cfgs(task_registry, N_ENVS)
            env, _ = task_registry.make_env("go2_handstand", env_cfg=cfg, device=dev)
        else:
            cfg, _ = task_registry.get_cfgs("go2")
            cfg.env.num_envs = N_ENVS
            if name == "K3":
                cfg.terrain.mesh_type = "heightfield"
                cfg.terrain.curriculum = True
            env, _ = task_registry.make_env("go2", env_cfg=cfg, device=dev)
        cases[name] = env_case(torch, env, gen, cstiff=name == "K2")
    return cases


def env_case(torch, env, gen, cstiff=False):
    """A kernel case of ``env`` (one process over all its envs): the
    control step's model and constants, ``m_eff``, and as inputs the reset
    state with a seeded random action's target (from ``gen``), its ``gh``
    on terrain and, with ``cstiff``, its contact stiffness."""
    state, _ = env.reset_all()
    actions = 0.3 * torch.randn((env.num_envs, env.num_actions), generator=gen,
                                device=gen.device)
    x = {k: getattr(state.phys, k) for k in ("base_pos", "base_quat",
                                             "joint_q", "v")}
    x.update(target=env._compute_target(actions), friction=state.friction,
             mass_scale=state.mass_scale)
    if state.gh is not None:
        x["gh"] = state.gh
    if cstiff:
        x["cstiff"] = state.cstiff
    return {"args": (env.robot.dyn, env.cparams, env.pd, env.cfg.sim.dt,
                     env.cfg.control.decimation),
            "m_eff": (env.m_eff_n, env.m_eff_t), "inputs": x}


def instance_bound(case, n, terrain, cs=False):
    """{"bound_ms", "ops_ms", "bytes_ms"} of one control step of a kernel
    case over ``n`` envs on the H100's published peaks."""
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import cuda_step

    mm = pb.soa_model_for(case["args"][0])
    kw = {"terrain": terrain, "cs": cs}
    ops = n * cuda_step.flops_per_env(
        mm, case["args"][4], case["args"][1].iterations, **kw) / PEAK_FP32_FLOPS * 1e3
    nb = n * cuda_step.bytes_per_env(mm, **kw) / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops, nb), "ops_ms": ops, "bytes_ms": nb}


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


def plain_ms(torch, case, x):
    """The plain version's device ms per control step of a kernel case on
    inputs ``x``."""
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import engine as eng

    phys = eng.PhysicsState(**{k: x[k] for k in ("base_pos", "base_quat",
                                                  "joint_q", "v")})
    return cuda_ms(torch, lambda: pb.control_step_soa(
        *case["args"], phys, x["target"], x["friction"], x["mass_scale"],
        *case["m_eff"], gh=x.get("gh")), TIME_PLAIN, 1)


def dp_rank(out_dir):
    """One rank of phases 17-20, 27 and 28 (started by
    ``parallel.mesh.spawn_ranks``): its K4 launches and times, its float32
    iteration, the flagship's, go2_terrain's and g1's training on its
    block, and the dryrun's g1 class; writes ``<out_dir>/rank<r>.pt``."""
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
    del runner

    # ---- 27. g1 flat, the LSTM and recurrent PPO: rank 0 writes the
    #      checkpoints, every rank loads the last one back ----
    ckpt_dir = os.path.join(out_dir, "ckpt_g1")
    runner = g1_dp_runner(block, dev, log_dir=ckpt_dir)
    rec = dp_train_run(runner, torch, DP_G1_ITERS, "dp_train_g1", {"k4": 1})
    state = replica_state(runner)
    dist.barrier()
    fresh = g1_dp_runner(block, dev)
    fresh.load(os.path.join(ckpt_dir, f"model_{runner.current_learning_iteration}.pt"))
    rec.update(state=state.cpu(), iteration=runner.current_learning_iteration,
               checkpoint_loads_back=bool(torch.equal(replica_state(fresh), state)))
    res["train_g1"] = rec
    del runner, fresh

    # ---- 28. the dryrun's g1-terrain-LSTM class (K3's instance at g1's
    #      sizes as each rank's K4) ----
    from unitree_rl_gym_tpu_torch.parallel import dryrun

    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.time()
    row = dryrun.dryrun_class("g1-terrain-lstm", dev, DRYRUN_ENVS_PER_RANK)
    torch.cuda.synchronize()
    res["dryrun_g1"] = {"launches": launch_counts(), "row": row,
                        "seconds": time.time() - t0}
    res["dryrun_g1"]["kernel"] = dryrun_kernel(torch, dist, dev)
    torch.save(res, os.path.join(out_dir, f"rank{block.rank}.pt"))


def dryrun_kernel(torch, dist, dev):
    """K4 as the dryrun's g1-terrain-lstm class launches it: K3's instance
    at g1's sizes on this rank's DRYRUN_ENVS_PER_RANK-env block of the
    class's env (its cfgs, one process over all the class's envs: the
    reset state and a seeded random action's target). Held against the
    plain version on the block (``compare``) and bit for bit against its
    rows of one launch over all the class's envs; timed one rank at a
    time, with the plain version's ms and the bound on the block."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.parallel import dryrun
    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh

    world = dist.get_world_size()
    task, cfg, _ = dryrun.class_cfgs("g1-terrain-lstm", DRYRUN_ENVS_PER_RANK * world)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
    case = env_case(torch, env, torch.Generator(device=dev).manual_seed(0))
    del env
    blk = pmesh.env_block(cfg.env.num_envs)
    whole = kernel_step(case, case["inputs"])
    x = pmesh.shard_env_state(case["inputs"], blk)
    zero_launch_counts()
    out = kernel_step(case, x, blk)
    torch.cuda.synchronize()
    check(launch_counts()["k4"] == 1,
          f"rank {blk.rank}: the dryrun's K3 g1 block not launched as K4")
    differ = [k for k, v in out.items() if not torch.equal(
        v, whole[k][:, blk.offset:blk.offset + blk.n_local] if k == "p_xy"
        else whole[k][blk.offset:blk.offset + blk.n_local])]
    check(not differ, f"dp_dryrun_g1: rank {blk.rank}'s K4 differs from its rows "
                      f"of the {cfg.env.num_envs}-env launch in {differ}")
    ref = kernel_step(case, x, plain=True)
    s_err, a_err, n_excused, per_output, _ = compare(
        ref, out, ref["min_abs_phi"], torch,
        name=f"K4 (the dryrun's K3 g1) on rank {blk.rank}")
    ms = p_ms = None
    for r in range(world):
        dist.barrier()
        if r == blk.rank:
            ms = cuda_ms(torch, lambda: kernel_step(case, x, blk), TIME_LAUNCHES, 3)
            p_ms = plain_ms(torch, case, x)
    dist.barrier()
    return {"n_local": blk.n_local, "rows_bit_identical": True,
            "max_abs_err_state": s_err, "max_err_aux_normalised": a_err,
            "excused_contact_edge_envs": n_excused,
            "max_errors_by_output": per_output, "ms": ms, "plain_ms": p_ms,
            **instance_bound(case, blk.n_local, terrain=True)}


def dp_phases(torch, dev, t_start):
    """Phases 17-20, 27 and 28: the one-process parts here, the ranks' in
    DP_WORLD spawned processes sharing the card over gloo; returns K4's
    entries of the kernels line (its instances on the flagship's path, at
    g1's sizes in dp_train_g1 and in dp_dryrun_g1's terrain)."""
    import tempfile

    from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import cuda_step
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

    # the plain version's ms on rank 0's block of the flagship's instance,
    # and of the two the g1 paths run (27; 28 at its own block size)
    plain_block_ms = {
        name: plain_ms(torch, cases[name],
                       pmesh.shard_env_state(cases[name]["inputs"], blk0))
        for name in ("K1", "K1 g1", "K3 g1")}
    torch.save({n: dict(c, inputs={k: v.cpu() for k, v in c["inputs"].items()})
                for n, c in cases.items()}, os.path.join(out_dir, "kernel_cases.pt"))
    m = pb.soa_model_for(k1["args"][0])
    ptxas = {name: instance_ptxas(
        cuda_step, pb.soa_model_for(case["args"][0]),
        "control_step_cs" if name == "K2" else "control_step",
        "K2 flat" if name == "K2" else name.split()[0])
        for name, case in cases.items()}
    # each instance's bound at a rank's block: K1 and K3 at go2's sizes,
    # K2 at the fine-tune's (79 points, decimation 5), the humanoid
    # instances at their robots'
    n_local = N_ENVS // DP_WORLD
    bound_by_instance = {
        name: instance_bound(case, n_local, name.startswith("K3"), name == "K2")
        for name, case in cases.items()}
    decimation, iterations = k1["args"][4], k1["args"][1].iterations
    del cases
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
          "plain_ms_block": plain_block_ms, "ptxas_by_instance": ptxas,
          "bound_ms_by_instance_per_rank": bound_by_instance,
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

    # ---- 27. g1 flat with the LSTM on 2 ranks: the replicas identical,
    #      the last checkpoint (rank 0's) loaded back bit for bit on every
    #      rank; dp_train_run held the launches, losses and lr ----
    tg = [r["train_g1"] for r in ranks]
    for r in tg[1:]:
        check(torch.equal(r["state"], tg[0]["state"]),
              "dp_train_g1: the ranks' params, Adam state or lr differ")
    for rank, r in enumerate(tg):
        check(r["checkpoint_loads_back"],
              f"dp_train_g1: rank {rank} does not load model_{r['iteration']}.pt "
              "back to its own state")
    emit({"phase": "dp_train_g1",
          "config": "g1 flat (scripts/train.py --task=g1): LSTM actor-critic, "
                    "recurrent PPO, bf16",
          "n_global": N_ENVS, "backend": "gloo", "world": DP_WORLD,
          "per_rank": [{k: v for k, v in r.items() if k != "state"} for r in tg],
          "ranks_bit_identical": True, "checkpoint_loads_back_every_rank": True})

    # ---- 28. the dryrun's g1-terrain-LSTM class ----
    dg = [r["dryrun_g1"] for r in ranks]
    for rank, r in enumerate(dg):
        want = {k: DRYRUN_G1_LAUNCHES if k == "k4" else 0 for k in r["launches"]}
        check(r["launches"] == want,
              f"dp_dryrun_g1: rank {rank} launched {r['launches']}, expected {want}")
        check(all(math.isfinite(float(r["row"][k]))
                  for k in ("value_loss", "surrogate_loss", "kl")),
              f"dp_dryrun_g1: rank {rank}: non-finite losses {r['row']}")
        check(LR_MIN <= r["row"]["lr"] <= LR_MAX, f"dp_dryrun_g1: lr {r['row']['lr']}")
    emit({"phase": "dp_dryrun_g1",
          "config": "parallel/dryrun.py's g1-terrain-lstm class: g1 on a 2 x 2 "
                    "heightfield of 4 m, terrain curriculum, LSTM, "
                    f"{DRYRUN_ENVS_PER_RANK} envs a rank, T 4, 2 epochs x 2 "
                    "minibatches",
          "per_rank": dg, "replicas_checked_by_the_dryrun": True,
          "k4_block_vs_plain_and_rows": True})
    tmp.cleanup()

    def entry(name, instance, launches_by_rank, path, by_rank, p_ms, b, n):
        """A K4 entry of the kernels line for one instance on ``n``-env
        blocks: each rank's error against the plain version and ms there
        (``by_rank``), the plain version's ms and the bound on a block."""
        return {
            "name": name, "route": "cuda",
            "source": "unitree_rl_gym_tpu_torch/csrc/control_step.cu",
            "replaces": "unitree_rl_gym_tpu/physics/pallas_step.py:315",
            "replaces_function": "pallas_step.control_step_pallas_sharded "
                                 f"(each rank's {instance} instance on its "
                                 f"{n}-env block; {path})",
            "launches": sum(launches_by_rank),
            "launches_per_rank": launches_by_rank,
            "max_abs_err": max(r["max_abs_err_state"] for r in by_rank),
            "ms": by_rank[0]["ms"],
            "ms_per_rank": [r["ms"] for r in by_rank],
            "plain_ms": p_ms,
            "bound_ms": b["bound_ms"],
            "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
            "library_ms": None,
        }

    g1_by_rank = [dict(v, ms=ms) for v, ms in zip(
        kernel_rec["K1 g1"]["vs_plain_by_rank"], kernel_rec["K1 g1"]["rank_ms_2048"])]
    dk = [r["kernel"] for r in dg]

    flops = cuda_step.flops_per_env(m, decimation, iterations)
    nbytes = cuda_step.bytes_per_env(m)
    t_ops = n_local * flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_local * nbytes / PEAK_BYTES_PER_S * 1e3
    return [{
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
        "plain_ms": plain_block_ms["K1"],
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_ms_by_instance_per_rank": bound_by_instance,
        "library_ms": None,
    }, entry("control_step_sharded_g1", "K1 g1",
             [r["launches"]["k4"] for r in tg],
             f"dp_train_g1's {DP_G1_ITERS} counted iterations", g1_by_rank,
             plain_block_ms["K1 g1"], bound_by_instance["K1 g1"], n_local),
        entry("control_step_sharded_g1_terrain", "K3 g1",
              [r["launches"]["k4"] for r in dg], "dp_dryrun_g1's g1-terrain-lstm "
              "class; held on its own blocks", dk, dk[0]["plain_ms"], dk[0],
              dk[0]["n_local"])]


# ---------------------------------------------------------------------------
# 21-24. the humanoids (g1, h1, h1_2) with their LSTM policies (K1, K3)
# ---------------------------------------------------------------------------


def task_model(task, dev):
    """The SoAModel of ``task``'s robot."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.physics import backend as pb

    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = 1
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
    return pb.soa_model_for(env.robot.dyn)


def humanoid_env(task, terrain, dev):
    """``task`` at N_ENVS envs: play.py's eval env on the plane, the
    training cfg on bench.py's heightfield with the terrain curriculum."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.scripts import play
    from unitree_rl_gym_tpu_torch.utils import helpers

    if not terrain:
        return play.make_play_env(helpers.get_args(
            [f"--task={task}", f"--num_envs={N_ENVS}", "--device=cuda"]), dev)
    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = N_ENVS
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.curriculum = True
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
    return env


def humanoid_phases(torch, dev, n_sm):
    """Phases 21-24 on the humanoids; returns their entries of the kernels
    line (one per instance: K1 at g1's, h1's and h1_2's sizes, K3 at g1's
    and h1_2's)."""
    import tempfile

    from unitree_rl_gym_tpu_torch import resource
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    from unitree_rl_gym_tpu_torch.physics import cuda_step
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
    from unitree_rl_gym_tpu_torch.scripts import play

    entries, play_envs = {}, {}
    # ---- 21-22. each instance against the plain version, then timed ----
    for name, task, terrain, artifact in HUMANOID_INSTANCES:
        t0 = time.time()
        env = humanoid_env(task, terrain, dev)
        if not terrain:
            play_envs[task] = env
        cfg = env.cfg
        m = pb.soa_model_for(env.robot.dyn)
        step_args = (env.robot.dyn, env.cparams, env.pd, cfg.sim.dt,
                     cfg.control.decimation)
        policy = load_flat_policy(resource(f"resources/pre_train/{artifact}"), dev)
        check(policy.is_recurrent, f"{artifact} is not an LSTM policy")
        clip = cfg.normalization.clip_actions

        def inputs(state, obs, carry):
            with torch.no_grad():
                actions = torch.clamp(policy.act(obs, carry)[0], -clip, clip)
            x = (state.phys, env._compute_target(actions), state.friction,
                 state.mass_scale, env.m_eff_n, env.m_eff_t)
            return x + ((state.gh,) if terrain else ())

        state, obs = env.reset_all()
        carry = policy.initial_carry(N_ENVS)
        cases = {"reset": inputs(state, obs, carry)}
        walk = HUMANOID_TERRAIN_STEPS if terrain else HUMANOID_WALK_STEPS
        torch.cuda.synchronize()
        zero_launch_counts()
        with torch.no_grad():
            for _ in range(walk):
                actions, carry = policy.act(obs, carry)
                state, obs, *_ = env.step(state, actions)
        torch.cuda.synchronize()
        walk_launches = launch_counts()
        cases["walk"] = inputs(state, obs, carry)
        max_state_err = max_aux_err = 0.0
        excused, excused_errs, per_output = {}, {}, {}
        for case, x in cases.items():
            ref_s, ref_aux = pb.control_step_soa(
                *step_args, *x[:6], gh=x[6] if terrain else None, want_phi=True)
            got_s, got_aux = pb.control_step(*step_args, *x)
            torch.cuda.synchronize()
            s_err, a_err, excused[case], per_output[case], e_errs = compare(
                flat_outputs(ref_s, ref_aux), flat_outputs(got_s, got_aux),
                ref_aux["min_abs_phi"], torch, name=name)
            max_state_err = max(max_state_err, s_err)
            max_aux_err = max(max_aux_err, a_err)
            excused_errs[case] = {"state": e_errs[0], "aux_normalised": e_errs[1]}
        partial = check_partial_launch(
            torch, lambda xx, ex: flat_outputs(*pb.control_step(*step_args, *xx, **ex)),
            x[:6], {"gh": x[6]} if terrain else {}, flat_outputs(got_s, got_aux), name)
        emit({"phase": "compare_humanoid", "instance": name, "n_envs": N_ENVS,
              "artifact": artifact, "walk_steps": walk,
              "sizes": {"nb": m.nb, "nv": m.nv, "ncp": m.ncp, "nrb": m.nrb,
                        "decimation": cfg.control.decimation},
              "max_abs_err_state": max_state_err,
              "new_parent_max_abs_err_entry": {name: max_state_err},
              "short_launch_rows_bit_identical": partial,
              "max_err_aux_normalised": max_aux_err,
              "excused_contact_edge_envs": excused,
              "max_excused_envs": int(MAX_EXCUSED_SHARE * N_ENVS),
              "max_errors_of_excused_envs": excused_errs,
              "max_errors_by_output": per_output, "seconds": time.time() - t0})

        t0 = time.time()
        x = cases["walk"]
        ms = cuda_ms(torch, lambda: pb.control_step(*step_args, *x), TIME_LAUNCHES, 3)
        plain_ms = cuda_ms(torch, lambda: pb.control_step_soa(
            *step_args, *x[:6], gh=x[6] if terrain else None), TIME_PLAIN, 1)
        bound_ms, t_ops, t_bytes, flops, nbytes = bound(
            cuda_step, m, cfg.control.decimation, env.cparams.iterations, terrain)
        lib = "control_step"
        timing = {"phase": "time_humanoid", "instance": name, "ms": ms,
                  "plain_ms": plain_ms, "flops_per_env": flops,
                  "bytes_per_env": nbytes, "bound_ms": bound_ms, "ops_ms": t_ops,
                  "bytes_ms": t_bytes,
                  "ptxas": instance_ptxas(cuda_step, m, lib, name.split()[0]),
                  "scratch_bytes_per_env": cuda_step.scratch_bytes(m, lib, terrain),
                  "resident_blocks_per_sm": cuda_step.resident_envs(m, lib, terrain)[0]}
        if name == "K1 g1":
            # one env per SM: one env's chain of dependent phases
            x_sm = first_envs(x, n_sm)
            timing["ms_one_env_per_sm"] = cuda_ms(
                torch, lambda: pb.control_step(*step_args, *x_sm), TIME_LAUNCHES, 3)
            timing["envs_one_per_sm"] = n_sm
        emit(dict(timing, seconds=time.time() - t0))
        entries[name] = {
            "name": "control_step_" + ("terrain" if terrain else "flat") + f" ({task} sizes)",
            "route": "cuda",
            "source": "unitree_rl_gym_tpu_torch/csrc/control_step.cu",
            "replaces": "unitree_rl_gym_tpu/physics/pallas_step.py:186",
            "replaces_function": "pallas_step.control_step_pallas (_kernel, "
                                 f"has_gh={terrain}, has_cs=False)",
            "launches": walk_launches["k3" if terrain else "k1"],
            "launches_path": f"{walk} LSTM policy steps through LeggedEnv.step "
                             f"({task}{'_terrain' if terrain else ''})",
            "max_abs_err": max_state_err,
            "max_err": max_state_err,
            "max_err_aux_normalised": max_aux_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        }
        del env, cases, x, state, obs, carry
        torch.cuda.empty_cache()

    # ---- 23. play: the pretrained LSTM policies through play.rollout ----
    for task in ("h1_2", "g1", "h1"):
        t0 = time.time()
        env = play_envs[task]
        policy = load_flat_policy(resource(f"resources/pre_train/{task}"), dev)
        check(all(p.is_cuda for p in policy.parameters()), "the actor is not on the card")
        state, obs = env.reset_all()
        check(obs.is_cuda, "observations are not on the card")
        torch.cuda.synchronize()
        zero_launch_counts()
        t_loop = time.time()
        state, obs, stats = play.rollout(env, policy, state, obs, PLAY_HUMANOID_STEPS,
                                         settle=PLAY_HUMANOID_STEPS // 3)
        torch.cuda.synchronize()
        loop_s = time.time() - t_loop
        counts = launch_counts()
        check(counts == {"k4": 0, "k1": PLAY_HUMANOID_STEPS, "k3": 0, "k2": 0},
              f"{task} play: launches {counts} in {PLAY_HUMANOID_STEPS} steps")
        check(tuple(obs.shape) == (N_ENVS, env.num_obs), f"obs shape {tuple(obs.shape)}")
        for k in ("base_pos", "base_quat", "joint_q", "v"):
            check(bool(torch.isfinite(getattr(state.phys, k)).all()), f"non-finite {k}")
        rate = stats["falls"] / N_ENVS
        if task in PLAY_FALL_BAR:
            check(rate <= PLAY_FALL_BAR[task],
                  f"{task}: {stats['falls']} non-timeout terminations after settling "
                  f"({rate:.2%}), above the bar {PLAY_FALL_BAR[task]:.2%}")
        entries[f"K1 {task}"]["launches"] += counts["k1"]
        entries[f"K1 {task}"]["launches_path"] += (
            f" + {PLAY_HUMANOID_STEPS} steps of scripts/play.py's rollout")
        emit({"phase": "play_humanoid", "task": task, "n_envs": N_ENVS,
              "steps": PLAY_HUMANOID_STEPS, "k1_launches": counts["k1"],
              "env_steps_per_s": N_ENVS * PLAY_HUMANOID_STEPS / loop_s,
              "step_ms": loop_s / PLAY_HUMANOID_STEPS * 1e3,
              "fall_rate": rate, "fall_bar": PLAY_FALL_BAR.get(task, "not gated"),
              **{k: stats[k] for k in ("abs_vx_tracking_err", "abs_vy_tracking_err",
                                       "abs_yaw_rate_err", "base_height", "falls",
                                       "episodes")},
              "seconds": time.time() - t0})
        del env, state, obs
        play_envs.pop(task)
    torch.cuda.empty_cache()

    # ---- 24. g1 training: OnPolicyRunner.learn with the LSTM and recurrent PPO ----
    t0 = time.time()
    env_cfg, train_cfg = task_registry.get_cfgs("g1")
    env_cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env("g1", env_cfg=env_cfg, device=dev)
    tmp = tempfile.TemporaryDirectory()
    runner = OnPolicyRunner(env, train_cfg, tmp.name)
    check(runner.net.is_recurrent, "g1 trains without its LSTM")
    runner.learn(1, init_at_random_ep_len=True)      # warm-up, not counted
    torch.cuda.synchronize()
    zero_launch_counts()
    rows = runner.learn(G1_TRAIN_ITERS)
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = train_cfg.runner.num_steps_per_env
    check(counts == {"k4": 0, "k1": steps * G1_TRAIN_ITERS, "k3": 0, "k2": 0},
          f"g1 training: launches {counts} in {G1_TRAIN_ITERS} iterations of {steps} steps")
    check_rows(rows, torch, runner, "g1 training")
    check(tuple(runner._carry.shape) == (2, 1, 2, N_ENVS, 64)
          and bool(torch.isfinite(runner._carry).all()), "the LSTM carry")
    ckpt = os.path.join(tmp.name, f"model_{runner.current_learning_iteration}.pt")
    fresh = OnPolicyRunner(env, train_cfg, None)
    fresh.load(ckpt)
    sd, fsd = runner.net.state_dict(), fresh.net.state_dict()
    check(any("memory_a" in k for k in sd) and sd.keys() == fsd.keys()
          and all(torch.equal(sd[k], fsd[k]) for k in sd),
          f"parameters loaded from {os.path.basename(ckpt)} differ")
    check(fresh.alg.lr == runner.alg.lr, "lr not restored from the checkpoint")
    it_s = sorted(r["iteration_s"] for r in rows)[len(rows) // 2]
    roll_s = sorted(r["rollout_s"] for r in rows)[len(rows) // 2]
    upd_s = sorted(r["update_s"] for r in rows)[len(rows) // 2]
    entries["K1 g1"]["launches"] += counts["k1"]
    entries["K1 g1"]["launches_path"] += (
        f" + {G1_TRAIN_ITERS} iterations of OnPolicyRunner.learn (g1)")
    emit({"phase": "train_g1", "config": "g1 flat, ActorCriticRecurrent (LSTM 64)",
          "n_envs": N_ENVS, "iterations": G1_TRAIN_ITERS, "k1_launches": counts["k1"],
          "median_iteration_ms": it_s * 1e3,
          "train_env_steps_per_s": N_ENVS * steps / it_s,
          "median_rollout_ms": roll_s * 1e3, "median_update_ms": upd_s * 1e3,
          "env_steps_per_s_by_iteration": [r["fps"] for r in rows],
          "mean_step_reward": [r["mean_step_reward"] for r in rows],
          "value_loss": [r["value_loss"] for r in rows],
          "kl": [r["kl"] for r in rows], "lr": [r["lr"] for r in rows],
          "checkpoint_round_trip": True, "seconds": time.time() - t0})
    t0 = time.time()
    emit(dict(profile_train(runner, torch, it_s * 1e3, roll_s * 1e3, upd_s * 1e3,
                            kernel="k1_ms", rollout_range=None),
              phase="profile_train_g1", seconds=time.time() - t0))
    tmp.cleanup()
    return [entries[name] for name, *_ in HUMANOID_INSTANCES]


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


def export_phases(torch, dev):
    """Phases 25-26: play's resume-and-export on the card, then the exported
    files against the policy they came from. Returns K1's launches per task
    (go2 at go2's sizes, g1 at g1's)."""
    import filecmp
    import tempfile
    import types

    import numpy as np

    from unitree_rl_gym_tpu_torch import resource
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.export.numpy_policy import NumpyPolicy
    from unitree_rl_gym_tpu_torch.models.networks import load_flat_params
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
    from unitree_rl_gym_tpu_torch.scripts import play
    from unitree_rl_gym_tpu_torch.utils import helpers

    def checked_play(run, what, k1):
        """``run()`` between zeroed and read counts: K1 ``k1`` times, and
        never K3, K2 or K4."""
        torch.cuda.synchronize()
        zero_launch_counts()
        out = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == {"k4": 0, "k1": k1, "k3": 0, "k2": 0},
              f"{what}: launches {counts} in {EXPORT_PLAY_STEPS} steps")
        return out, counts["k1"]

    def check_falls(stats, what):
        rate = stats["falls"] / N_ENVS
        check(rate <= EXPORT_FALL_BAR,
              f"{what}: {stats['falls']} non-timeout terminations after settling "
              f"({rate:.2%}), above the bar {EXPORT_FALL_BAR:.2%}")
        return rate

    launches = {}
    for task, phase in (("go2", "export"), ("g1", "export_lstm")):
        t0 = time.time()
        tmp = tempfile.TemporaryDirectory()
        shipped = resource(f"resources/pre_train/{task}")
        args = helpers.get_args([f"--task={task}", f"--num_envs={N_ENVS}", "--device=cuda",
                                 "--resume", f"--experiment_name={tmp.name}"])
        # the checkpoint to resume: a runner on the card with the shipped weights
        env_cfg, train_cfg = task_registry.get_cfgs(task)
        env_cfg.env.num_envs = 8
        env, _ = task_registry.make_env(task, env_cfg=env_cfg, device=dev)
        runner = OnPolicyRunner(env, train_cfg, None)
        load_flat_params(runner.net, shipped)
        check(all(p.is_cuda for p in runner.net.parameters()), "the runner is not on the card")
        runner.save(os.path.join(tmp.name, "Jan01_00-00-00_shipped", "model_0.pt"))
        del runner, env

        # the entry's reset_all takes one zero-action step: one launch more
        out, k1 = checked_play(lambda: play.play(args, num_steps=EXPORT_PLAY_STEPS),
                               f"{task} play --resume", EXPORT_PLAY_STEPS + 1)
        env, policy, stats = out["env"], out["policy"], out["stats"]
        exported = out["export_dir"]
        check(exported == os.path.join(tmp.name, "exported", "policies"),
              f"exported to {exported}")
        check(all(p.is_cuda for p in policy.parameters()), "the played policy is not on the card")
        rate = check_falls(stats, f"{task} play --resume")
        check(filecmp.cmp(os.path.join(exported, "policy.bin"),
                          os.path.join(shipped, "policy.bin"), shallow=False),
              f"{task}: the exported policy.bin differs from the shipped one")
        result = {"phase": phase, "task": task, "n_envs": N_ENVS, "steps": EXPORT_PLAY_STEPS,
                  "exported": sorted(os.listdir(exported)),
                  "policy_bin_equals_shipped": True,
                  "play_k1_launches": k1,
                  "play_env_steps_per_s": N_ENVS * EXPORT_PLAY_STEPS / out["rollout_s"],
                  "play_fall_rate": rate, "play_falls": stats["falls"]}

        if not policy.is_recurrent:
            obs = out["obs"]
            mod = torch.jit.load(os.path.join(exported, "policy_1.pt"), map_location=dev)
            with torch.no_grad():
                err = float((mod(obs) - policy.act(obs)).abs().max())
                check(err <= EXPORT_MLP_ATOL, f"policy_1.pt on the card: {err} from the "
                      f"runner's inference policy (bar {EXPORT_MLP_ATOL})")
                cpu_mod = torch.jit.load(os.path.join(exported, "policy_1.pt"),
                                         map_location="cpu")
                obs_cpu = obs.cpu()
                np_err = float(np.abs(cpu_mod(obs_cpu).numpy()
                                      - NumpyPolicy(exported)(obs_cpu.numpy())).max())
            check(np_err <= EXPORT_MLP_ATOL, f"policy_1.pt on the CPU: {np_err} from "
                  f"NumpyPolicy (bar {EXPORT_MLP_ATOL})")
            # play's rollout driven by the loaded TorchScript module itself
            state, obs = env.reset_all()
            ts_policy = types.SimpleNamespace(is_recurrent=False, act=mod)
            t_loop = time.time()
            (state, obs, ts_stats), k1_ts = checked_play(
                lambda: play.rollout(env, ts_policy, state, obs, EXPORT_PLAY_STEPS,
                                     settle=EXPORT_PLAY_STEPS // 5),
                "go2 play of policy_1.pt", EXPORT_PLAY_STEPS)
            loop_s = time.time() - t_loop
            k1 += k1_ts
            for k in ("base_pos", "base_quat", "joint_q", "v"):
                check(bool(torch.isfinite(getattr(state.phys, k)).all()), f"non-finite {k}")
            result.update({
                "torchscript_cuda_max_abs_err": err, "torchscript_cpu_vs_numpy_max_abs_err": np_err,
                "atol": EXPORT_MLP_ATOL, "torchscript_play_k1_launches": k1_ts,
                "torchscript_play_env_steps_per_s": N_ENVS * EXPORT_PLAY_STEPS / loop_s,
                "torchscript_play_fall_rate": check_falls(ts_stats, "go2 play of policy_1.pt"),
                "torchscript_play_abs_vx_tracking_err": ts_stats["abs_vx_tracking_err"]})
        else:
            # env 0's observations and actions over EXPORT_LSTM_STEPS steps of
            # the float32 inference policy with its carry, through K1
            state, obs = env.reset_all()
            carry = policy.initial_carry(N_ENVS)
            obs0, act0 = [], []
            torch.cuda.synchronize()
            zero_launch_counts()
            with torch.no_grad():
                for _ in range(EXPORT_LSTM_STEPS):
                    actions, carry = policy.act(obs, carry)
                    obs0.append(obs[:1].clone())
                    act0.append(actions[:1].clone())
                    state, obs, *_ = env.step(state, actions)
            torch.cuda.synchronize()
            counts = launch_counts()
            check(counts == {"k4": 0, "k1": EXPORT_LSTM_STEPS, "k3": 0, "k2": 0},
                  f"g1 rollout: launches {counts} in {EXPORT_LSTM_STEPS} steps")
            k1 += counts["k1"]
            mod = torch.jit.load(os.path.join(exported, "policy_lstm_1.pt"), map_location=dev)
            check(mod.hidden_state.is_cuda, "policy_lstm_1.pt is not on the card")
            with torch.no_grad():
                mod.reset_memory()
                got = [mod(o) for o in obs0]
                err = max(float((g - a).abs().max()) for g, a in zip(got, act0))
                mod.reset_memory()
                again = mod(obs0[0])
            check(err <= EXPORT_LSTM_ATOL, f"policy_lstm_1.pt on the card: {err} from the "
                  f"float32 inference policy over {EXPORT_LSTM_STEPS} steps "
                  f"(bar {EXPORT_LSTM_ATOL})")
            check(torch.equal(again, got[0]), "reset_memory() did not restore the first output")
            result.update({"lstm_steps": EXPORT_LSTM_STEPS, "rollout_k1_launches": counts["k1"],
                           "torchscript_cuda_max_abs_err": err, "atol": EXPORT_LSTM_ATOL,
                           "reset_memory_first_output_equal": True})
        launches[task] = k1
        emit(dict(result, k1_launches=k1, seconds=time.time() - t0))
        del out, env, policy, state, obs
        tmp.cleanup()
        torch.cuda.empty_cache()
    return launches


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
    m_hum = {task: task_model(task, dev) for task in ("g1", "h1", "h1_2")}
    t_build = time.time()
    libs = cuda_step.build_all([m, m_hs], only=[(mm, "control_step")
                                                for mm in m_hum.values()])
    build_s = time.time() - t_build
    lib_path = libs[("control_step", cuda_step.size_defines(m))]
    ptxas = ptxas_by_kernel(cuda_step.BUILD_LOGS.get(lib_path, ""))
    # every instance of every library spills no register
    spills = {}
    for (lib, sizes), path in libs.items():
        for inst, lines in ptxas_by_kernel(cuda_step.BUILD_LOGS.get(path, "")).items():
            spills[f"{inst} ({lib} {' '.join(sizes)})"] = spill_bytes(lines)
    check(len(spills) == 2 * len(libs), f"ptxas reports {sorted(spills)}")
    # the instances the paths run, at the sizes they run them: every env of
    # a launch resident at once
    runs = {"K1": (m, "control_step", False), "K3": (m, "control_step", True),
            "K2 flat": (m_hs, "control_step_cs", False),
            "K2 terrain": (m, "control_step_cs", True),
            "K1 at the handstand's sizes": (m_hs, "control_step", False)}
    runs.update({name: (m_hum[task], "control_step", terrain)
                 for name, task, terrain, _ in HUMANOID_INSTANCES})
    scratch = {k: cuda_step.scratch_bytes(mm, lib, terr) for k, (mm, lib, terr) in runs.items()}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    resident = {k: cuda_step.resident_envs(mm, lib, terr) for k, (mm, lib, terr) in runs.items()}
    emit({"phase": "build", "library": lib_path.split("unitree_rl_gym_tpu_torch/")[-1],
          "build_seconds": build_s, "libraries_built_together": len(libs),
          "ptxas": ptxas, "spill_bytes_stores_loads": spills,
          "ptxas_humanoid": {name: instance_ptxas(cuda_step, m_hum[task], "control_step",
                                                  name.split()[0])
                             for name, task, _, _ in HUMANOID_INSTANCES},
          "lanes_per_env": cuda_step.lanes_per_env(m),
          "scratch_bytes_per_env": scratch,
          "resident_blocks_per_sm": {k: b for k, (b, _) in resident.items()},
          "envs_per_block": resident["K1"][1], "sms": n_sm,
          "seconds": time.time() - t0})
    for k, v in spills.items():
        check(v == (0, 0), f"{k} spills registers: {v} bytes (stores, loads)")
    for k, (blocks, per_block) in resident.items():
        check(blocks * per_block * n_sm >= N_ENVS,
              f"{k}: {blocks} resident blocks of {per_block} envs on {n_sm} SMs "
              f"hold fewer than {N_ENVS} envs")

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
    partial = check_partial_launch(
        torch, lambda xx, ex: flat_outputs(*pb.control_step(*step_args, *xx, **ex)),
        x, {}, flat_outputs(got_s, got_aux), "K1")
    check_parent_err("K1", max_state_err)
    emit({"phase": "compare", "n_envs": N_ENVS, "max_abs_err_state": max_state_err,
          "parent_max_abs_err_state": PARENT_MAX_ABS_ERR["K1"],
          "short_launch_rows_bit_identical": partial,
          "max_err_aux_normalised": max_aux_err, "excused_contact_edge_envs": excused,
          "max_excused_envs": int(MAX_EXCUSED_SHARE * N_ENVS),
          "max_errors_of_excused_envs": excused_errs,
          "max_errors_by_output": per_output, "seconds": time.time() - t0})

    # ---- 4. timing on the same inputs (walk state) ----
    t0 = time.time()
    x = cases["walk"]

    k1_ms = cuda_ms(torch, lambda: pb.control_step(*step_args, *x), TIME_LAUNCHES, 3)
    plain_ms = cuda_ms(torch, lambda: pb.control_step_soa(*step_args, *x), TIME_PLAIN, 1)
    # one env per SM: no other warp to switch to, so this is one env's
    # chain of dependent phases, what bounds the kernel from below
    x_sm = first_envs(x, n_sm)
    k1_sm_ms = cuda_ms(torch, lambda: pb.control_step(*step_args, *x_sm),
                       TIME_LAUNCHES, 3)
    bound_ms, t_ops, t_bytes, flops, nbytes = bound(
        cuda_step, m, cfg.control.decimation, env.cparams.iterations, False)
    emit({"phase": "time", "k1_ms": k1_ms, "plain_ms": plain_ms,
          "k1_ms_one_env_per_sm": k1_sm_ms, "envs_one_per_sm": n_sm,
          "flops_per_env": flops, "bytes_per_env": nbytes,
          "bound_ms": bound_ms, "ops_ms": t_ops, "bytes_ms": t_bytes,
          "ptxas": ptxas["K1"], "seconds": time.time() - t0})

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

    # ---- 17-20, 27-28. env data parallelism over 2 ranks (K4): go2, then
    #      g1 with the LSTM (training, and the dryrun's terrain class) ----
    k4_entries = dp_phases(torch, dev, t_start)

    # ---- 21-24. the humanoids with their LSTM policies (K1, K3) ----
    humanoid_entries = humanoid_phases(torch, dev, n_sm)

    # ---- 25-26. play's resume-and-export, the exported policies (K1) ----
    export_launches = export_phases(torch, dev)
    launches += export_launches["go2"]
    for (name, *_), entry in zip(HUMANOID_INSTANCES, humanoid_entries):
        if name == "K1 g1":
            entry["launches"] += export_launches["g1"]
            entry["launches_path"] += (
                f" + {EXPORT_PLAY_STEPS} steps of scripts/play.py --resume and "
                f"{EXPORT_LSTM_STEPS} steps checking policy_lstm_1.pt")

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
    }, k3_entry, k2_entry, *k4_entries, *humanoid_entries]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
