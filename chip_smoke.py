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
TorchScript policies driven through K1, and the tooling scripts
(roofline with its FMA probe kernel, profile_train, profile_residue,
make_pretrain) and a flagship iteration for each other activation, and
the handstand campaign scripts (kick-up experiments with their
reset-aware evaluator, the transfer fine-tune's setup and capture, eval,
diag, basin and the staged recipe; K1 at the handstand's sizes and K2),
the per-substep ``ground_fn`` terrain mode (K3 on sampled heights) and the
per-env vmap formulation — and holds every kernel of those paths against
its plain PyTorch version on the same inputs (K4 on each rank's block, and
against the rows of a one-process launch, bit for bit):

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
 29-33. module 12's tooling and module 5's remainder (``tooling_phases``),
              each through its script's functions, at 4096 go2 envs:
 29. roofline ``scripts/roofline.py``: the dispatch overhead, bf16 GEMM
              (8192^2), the PPO update's thin bf16 chain, the fp32 FMA
              probe (the hand-written ``csrc/roofline_fma.cu``, built in
              phase 2) and HBM bandwidth; every rate finite and positive
              and at most 1.05 x its H100 SXM data-sheet figure; the probe
              within rtol 1e-4 of its plain version (the same chain in torch
              ops), timed with it; every kernels-line bound restated at the
              measured fp32 (or HBM) rate beside the data-sheet bound;
 30. profile_train  ``scripts/profile_train.py`` on the flagship: 3 timed
              iterations, then 2 under torch.profiler with the counts zeroed
              just before (K1 exactly 48 times, nothing else), the device
              time by kernel name (top 25, share, total > 0);
 31. profile_residue  ``scripts/profile_residue.py``'s five programs (A
              train iteration, B rollout, C env with zero actions, D C
              without noise, E 24 control steps), each 1 + 3 calls with the
              counts zeroed just before (K1 exactly 24 times a call, nothing
              else), and the JAX script's JSON keys, every value finite;
 32. make_pretrain  ``scripts/make_pretrain.py``, 2 iterations, ``--out``
              under a temporary directory: K1 1 + 48 times, the shipped
              ``resources/pre_train/go2`` file names and meta keys,
              ``policy.bin``'s header, ``NumpyPolicy`` on the written npz
              within 1e-5 of the runner's policy on the final obs;
 33. activations  one flagship ``OnPolicyRunner`` iteration for each of
              relu, selu, crelu, lrelu, tanh and sigmoid: K1 exactly 24
              times each, every metric finite, lr in bounds; prints whether
              the TensorBoard writer was present.
 34-37. module 12's handstand scripts (``handstand_campaign_phases``), each
              through its script's functions, every launch counted:
 34. kickup   ``handstand_kickup_r5.run_experiment("E15", tmp, iters=2,
              eval_every=1)`` from the shipped holder at 4096 envs: K1 at
              the handstand's sizes 24 times an iteration (and once for the
              training env's reset) and K2 never, counted in each
              ``runner.learn`` call; each ``Evaluator.rates`` call (16 envs)
              launches K1 once a step and reset of its two rollouts (952),
              counted in the call, its host seconds printed; the baseline holder's hold_rate at least 0.5;
              ``best.pt``, ``best_export/policy.bin``, ``campaign.json`` and
              ``final_export/`` written;
 35. transfer_capture  ``handstand_transfer_r5.transfer_runner`` with
              FINETUNE_ARGS (4096 envs): one iteration through K2 (24
              launches), then ``TransferEval._capture`` of the shipped
              holder (K1, 16 envs, 150 steps + reset): at least one balanced
              state of the six expected shapes, finite. Its MuJoCo half
              (``transfer_rate``) needs ``mujoco``, which this machine may
              lack: it is held on the CPU by the tests, not run here;
 36. eval_diag_basin  ``handstand_eval.evaluate`` over seeds 0-2 (K1, 952
              launches a seed), ``handstand_diag.diagnose`` for 500 steps
              and ``handstand_basin.basin`` at 256 envs and 450 steps: every
              env's read-back initial pitch within the asked 40-140 deg
              (slack 10) and rate within 1-14 rad/s (slack 8 below, 2
              above: the read-back follows reset_all's zero-action step),
              and the grid's counts those of the binned envs;
 37. recipe   ``handstand_recipe.main(out_dir=tmp)`` with 1 iteration a
              phase at 4096 envs: K1 1 + 24 times a phase, the three
              checkpoints at iterations 1, 2, 3 (each phase loaded the last
              one's), the exported npz equal to the last checkpoint's
              parameters and ``NumpyPolicy`` within 1e-5 of the exported
              policy loaded back on the card;
 38. ground_fn  ``backend.control_step(ground_fn=grid.height_at)`` on
              go2_terrain at 4096 envs, at the reset (seeded random
              actions) and after WALK_STEPS of the pretrained go2 policy
              (its actions), the counts zeroed before each: K3 launched
              exactly once and nothing else, its outputs bit for bit those
              of K3 on ``sample_point_heights``' ``gh``, and the plain
              version on that ``gh`` held as in phase 7
              (``PARENT_MAX_ABS_ERR`` 0); against the per-substep sampling
              of the plain version, at the reset at most 1% of the envs
              beyond the JAX suite's staleness budget (base_pos 5e-3,
              joint_q 2e-2), and after the walk some env changed (feet land
              between substeps), its staleness printed;
 39. vmap     ``backend.control_step_vmap`` on the card at go2's and g1's
              sizes (4096 envs, reset states, seeded random actions)
              against the plain version and K1 at the physics tolerance;
              an env beyond it is excused only within VMAP_EDGE (5e-4) of
              the contact edge, up to VMAP_MAX_SHARE (0.2%) of the envs,
              each within VMAP_EXCUSED_CAP, counted and printed; timed with
              CUDA events beside K1.

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
import threading
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
# the fine-tune's options of scripts/handstand_transfer_r5.py: its defaults,
# its help text's PD-gain range and an actuation-delay probability of 0.1
FINETUNE_ARGS = ["--pd-gain", "0.8", "1.2", "--delay-prob", "0.1"]
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
ROOFLINE_MARGIN = 1.05        # no measured rate above 1.05 x its data-sheet figure
FMA_RTOL = 1e-4               # the FMA probe against its plain version (which
                              # rounds each of the 2048 rounds once, as fmaf)
PROFILE_TRAIN_ITERS = 2       # profiled iterations of scripts/profile_train.py
RESIDUE_ITERS = 3             # timed calls of each scripts/profile_residue.py program
PRETRAIN_ITERS = 2            # iterations of scripts/make_pretrain.py
PRETRAIN_ATOL = 1e-5          # NumpyPolicy on its npz against the runner's policy
ACTIVATION_NAMES = ("relu", "selu", "crelu", "lrelu", "tanh", "sigmoid")
KICKUP_EXP = "E15"            # the campaign's last experiment (every shaping term on)
KICKUP_ITERS = 2              # iterations of handstand_kickup_r5.run_experiment
KICKUP_EVAL_EVERY = 1         # ... with an Evaluator.rates call after each
# K1 launches of one Evaluator.rates call at 16 envs: the hold rollout's
# reset_all + 450 steps, the conversion rollout's reset_all + 500 steps
RATES_LAUNCHES = (1 + 450) + (1 + 500)
CAPTURE_SETTLE = 150          # TransferEval._capture's steps (its default)
EVAL_SEEDS = (0, 1, 2)        # handstand_eval's default seeds
DIAG_STEPS = 500              # handstand_diag's default steps
BASIN_ENVS = 256              # handstand_basin's defaults
BASIN_STEPS = 450
BASIN_TH = (40.0, 140.0)      # its default pitch (deg) and pitch-rate (rad/s)
BASIN_W = (1.0, 14.0)         # ranges of the mid-kick-up resets
# slack of the read-back initial pitch and rate around the asked ranges:
# the read-back follows reset_all's zero-action control step (25 ms of
# contact with the front feet planted), which moves th by a few degrees and
# w by several rad/s (on the CPU at 256 envs, seed 0: th 40.9-146.2 deg, w
# -4.9-13.8 rad/s)
BASIN_TH_SLACK = 10.0
BASIN_W_SLACK = (8.0, 2.0)
RECIPE_ITERS = 1              # iterations of each handstand_recipe phase
# the JAX suite's staleness budget of the frozen-height formulation against
# the per-substep one at decimation 4 (tests/test_pallas_terrain.py:101-113,
# pinned on standing states), and the share of envs that may exceed it at
# the reset of 4096 envs on the stock heightfield (a foot crossing a step
# edge between substeps); after a walk, feet land between substeps and
# more envs exceed it (phase 38 prints how many)
STALE_ATOL = {"base_pos": 5e-3, "joint_q": 2e-2}
STALE_MAX_SHARE = 0.01
VMAP_TASKS = ("go2", "g1")    # control_step_vmap's sizes on the card
VMAP_REPS = 3                 # control_step_vmap calls timed
# the per-env formulation sums in another order than the plain version (and
# the kernels), and near the contact edge the PGS solve amplifies the last
# bits: an env beyond the physics tolerance is excused only if one of its
# points sat within VMAP_EDGE of the edge, up to VMAP_MAX_SHARE of the envs,
# each within VMAP_EXCUSED_CAP. On the H100 at the g1 reset with seeded
# actions, 4 of 4096 envs lie beyond it, their nearest points 1.0e-5,
# 1.4e-5, 2.3e-5 and 1.7e-4 from the edge, their largest errors 7.7e-5
# (state) and 8.4e-6 (normalised aux); go2 has none
VMAP_EDGE = 5e-4
VMAP_MAX_SHARE = 2e-3
VMAP_EXCUSED_CAP = {"state": 1e-3, "aux_normalised": 1e-3}
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


def beyond_tolerance(ref, got, torch):
    """Per-env physics tolerance of ``got`` against ``ref`` (the plain
    version): the state (``p_xy`` [2*ncp, N] included, where present) at
    atol 5e-5 / rtol 1e-4, the aux outputs at 5e-4 of their largest
    magnitude. Returns (envs beyond it [N] bool, per-output max errors,
    ``max_errs(rows)``: the largest state and normalised aux errors over
    the envs ``rows``)."""
    state_keys = [k for k in ("base_pos", "base_quat", "joint_q", "v", "p_xy")
                  if k in ref]
    ref = dict(ref, **({"p_xy": ref["p_xy"].T} if "p_xy" in ref else {}))
    got = dict(got, **({"p_xy": got["p_xy"].T} if "p_xy" in got else {}))
    bad = torch.zeros(ref["base_pos"].shape[0], dtype=torch.bool,
                      device=ref["base_pos"].device)
    errs = {}
    for k in state_keys:
        diff = (got[k] - ref[k]).abs()
        errs[k] = float(diff.max())
        bad |= (diff > 5e-5 + 1e-4 * ref[k].abs()).flatten(1).any(1)
    for k in ("torques", "cf_rb", "rb_pos_w", "rb_vel_w"):
        mag = max(float(ref[k].abs().max()), 1.0)
        diff = (got[k] - ref[k]).abs() / mag
        errs[k] = float(diff.max())
        bad |= (diff > 5e-4).flatten(1).any(1)

    def max_errs(rows):
        if not bool(rows.any()):
            return 0.0, 0.0
        s = max(float((got[k] - ref[k])[rows].abs().max())
                for k in state_keys)
        a = max(float(((got[k] - ref[k])[rows]).abs().max())
                / max(float(ref[k].abs().max()), 1.0)
                for k in ("torques", "cf_rb", "rb_pos_w", "rb_vel_w"))
        return s, a

    return bad, errs, max_errs


def compare(ref, got, min_abs_phi, torch, name="K1"):
    """Per-env check of a kernel (``got``) against the plain version
    (``ref``) at ``beyond_tolerance``'s tolerance. An env beyond it is
    excused if one of its points sat within PHI_EDGE of the contact
    activation edge, up to MAX_EXCUSED_SHARE of the envs.
    Returns (max state error, max normalised aux error, excused envs,
    per-output max errors, largest errors among the excused envs)."""
    bad, errs, max_errs = beyond_tolerance(ref, got, torch)
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
    excused_errs = max_errs(excused)
    check(n_excused <= MAX_EXCUSED_SHARE * bad.shape[0],
          f"{n_excused} envs disagree at a contact edge, more than "
          f"{MAX_EXCUSED_SHARE:.1%} of {bad.shape[0]}; largest errors there "
          f"(state, aux normalised) {excused_errs}")
    state_err, aux_err = max_errs(~excused)
    return state_err, aux_err, n_excused, errs, excused_errs


def compare_vmap(ref, got, min_abs_phi, torch, name):
    """``control_step_vmap`` (``got``) against ``ref`` (the plain version or
    K1) at ``beyond_tolerance``'s tolerance. An env beyond it is excused
    only if one of its points sat within VMAP_EDGE of the contact edge, up
    to VMAP_MAX_SHARE of the envs, each within VMAP_EXCUSED_CAP. Returns
    the phase's record for ``ref``."""
    bad, errs, max_errs = beyond_tolerance(ref, got, torch)
    rows = bad.nonzero()[:, 0]
    phis = [float(p) for p in min_abs_phi[rows]]
    excused_errs = max_errs(bad)
    detail = (f"{name}: {len(phis)} envs beyond the physics tolerance "
              f"(envs {rows.tolist()[:16]}, min |phi| {phis[:16]}, largest "
              f"errors there (state, aux normalised) {excused_errs}); "
              f"max errors {errs}")
    check(all(p < VMAP_EDGE for p in phis), f"{detail}: one away from the "
          f"contact edge (min |phi| >= {VMAP_EDGE})")
    check(len(phis) <= VMAP_MAX_SHARE * bad.shape[0],
          f"{detail}: more than {VMAP_MAX_SHARE:.1%} of {bad.shape[0]}")
    check(excused_errs[0] <= VMAP_EXCUSED_CAP["state"]
          and excused_errs[1] <= VMAP_EXCUSED_CAP["aux_normalised"],
          f"{detail}: beyond the cap {VMAP_EXCUSED_CAP}")
    s_err, a_err = max_errs(~bad)
    return {"max_abs_err_state_within_tolerance": s_err,
            "max_err_aux_normalised_within_tolerance": a_err,
            "envs_beyond_tolerance": len(phis),
            "min_abs_phi_of_envs_beyond": phis,
            "max_errors_beyond_tolerance": list(excused_errs),
            "max_errors_by_output": errs}


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
    """Device time of one more training iteration by part, from
    torch.profiler (``scripts/profile_train.iteration_breakdown``: the
    control-step kernel reported as ``kernel``, the rollout and update
    ranges and ``rollout_range`` / ``update_range`` inside them, idle
    shares against the unprofiled host times)."""
    from unitree_rl_gym_tpu_torch.scripts import profile_train as ptrain

    prof = ptrain.profiled(lambda: runner.learn(1), runner.device)
    return ptrain.iteration_breakdown(prof, iteration_ms, rollout_ms, update_ms,
                                      kernel, rollout_range, update_range)


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
    """(env cfg, train cfg) of the go2 handstand robustness fine-tune at
    ``num_envs`` envs from ``task_registry`` (the port's, or the JAX
    package's in the parity tests): ``scripts/handstand_transfer_r5.py``'s
    ``transfer_cfgs`` with FINETUNE_ARGS."""
    from unitree_rl_gym_tpu_torch.scripts import handstand_transfer_r5 as transfer

    cfg, tcfg = transfer.transfer_cfgs(transfer.parse_args(FINETUNE_ARGS),
                                       registry=task_registry)
    cfg.env.num_envs = num_envs
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
    over PROFILE_STEPS steps (``scripts/profile_train.step_breakdown``); the
    idle share is measured against the unprofiled ``step_ms`` of the slice
    phase."""
    from unitree_rl_gym_tpu_torch.scripts import profile_train as ptrain

    state, obs = env.reset_all()
    prof = ptrain.profiled(lambda: play.rollout(env, policy, state, obs, PROFILE_STEPS,
                                                settle=PROFILE_STEPS), env.device)
    return ptrain.step_breakdown(prof, PROFILE_STEPS, step_ms)


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


def fma_entry(torch, dev):
    """Phase 29's kernel check: the FMA probe (``scripts/roofline.fma_chain``)
    against its plain version on the roofline's input, timed with it; the
    kernels line's entry without ``launches``."""
    from unitree_rl_gym_tpu_torch.scripts import roofline as rl

    x = rl.fma_input(dev)
    got, ref = rl.fma_chain(x), rl.fma_chain_plain(x)
    torch.cuda.synchronize()
    rel = float(((got - ref).abs() / ref.abs()).max())
    check(rel <= FMA_RTOL, f"FMA probe: largest relative error {rel} against its "
          f"plain version (bar {FMA_RTOL})")
    t_ops = rl.fma_flops() / PEAK_FP32_FLOPS * 1e3
    t_bytes = rl.fma_bytes() / PEAK_BYTES_PER_S * 1e3
    return {
        "name": "roofline_fma",
        "route": "cuda",
        "source": "unitree_rl_gym_tpu_torch/csrc/roofline_fma.cu",
        "replaces": "unitree_rl_gym_tpu/scripts/roofline.py:114",
        "replaces_function": "roofline.vpu_f32 (a jnp FMA chain that XLA fuses; "
                             "no Pallas kernel)",
        "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": rel,
        "rtol": FMA_RTOL,
        "ms": cuda_ms(torch, lambda: rl.fma_chain(x), TIME_LAUNCHES, 3),
        "plain_ms": cuda_ms(torch, lambda: rl.fma_chain_plain(x), TIME_PLAIN, 1),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def tooling_phases(torch, dev, entries):
    """Phases 29-33: module 12's scripts and module 5's remainder on the
    card. ``entries``: the kernels line so far, whose bounds phase 29
    restates at the measured rates. Returns (K1's launches in phases
    30-33, the FMA probe's entry of the kernels line)."""
    import struct
    import tempfile

    import numpy as np

    from unitree_rl_gym_tpu_torch import resource
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.export.numpy_policy import NumpyPolicy
    from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner
    from unitree_rl_gym_tpu_torch.scripts import make_pretrain as mp
    from unitree_rl_gym_tpu_torch.scripts import profile_residue as pres
    from unitree_rl_gym_tpu_torch.scripts import profile_train as ptrain
    from unitree_rl_gym_tpu_torch.scripts import roofline as rl
    from unitree_rl_gym_tpu_torch.utils import helpers

    def k1_only(counts, n, what):
        check(counts == {"k4": 0, "k1": n, "k3": 0, "k2": 0},
              f"{what}: launches {counts}, expected K1 {n} times and nothing else")
        return n

    # ---- 29. roofline: the measured rates of this card ----
    t0 = time.time()
    rl.LAUNCHES_FMA = 0
    rates = rl.measure(dev)
    fma_launches = rl.LAUNCHES_FMA
    check(fma_launches > 0, "the roofline did not launch the FMA probe")
    for key in ("dispatch_overhead_ms", *rl.RATE_DATASHEET):
        check(math.isfinite(rates[key]) and rates[key] > 0, f"roofline {key} {rates[key]}")
    for key, sheet in rl.RATE_DATASHEET.items():
        bar = ROOFLINE_MARGIN * rl.DATASHEET_H100_SXM[sheet]
        check(rates[key] <= bar, f"roofline {key} {rates[key]} above {bar} "
              f"({ROOFLINE_MARGIN} x the data sheet's {sheet}): the count or the timing is wrong")
    fma = dict(fma_entry(torch, dev), launches=fma_launches)
    fp32_scale = PEAK_FP32_FLOPS / (rates["fma_f32_tflops"] * 1e12)
    hbm_scale = PEAK_BYTES_PER_S / (rates["hbm_gbps"] * 1e9)
    bounds = {e["name"]: {"bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
                          "bound_ms_at_measured_rate": e["bound_ms"] * (
                              fp32_scale if e["bound_by"] == "operations" else hbm_scale)}
              for e in entries + [fma]}
    emit(dict(rates, phase="roofline", fma_launches=fma_launches,
              fma_max_rel_err=fma["max_rel_err"], fma_ms=fma["ms"],
              fma_plain_ms=fma["plain_ms"], bounds_at_measured_rates=bounds,
              seconds=time.time() - t0))

    # ---- 30. profile_train: the flagship's device time by kernel name ----
    t0 = time.time()
    alg, env, carry, spi = ptrain.build("go2", N_ENVS, dev)
    it_ms, carry = ptrain.time_iterations(alg, env, carry, 3)
    zero_launch_counts()
    prof, carry = ptrain.profile_iterations(alg, env, carry, PROFILE_TRAIN_ITERS)
    k1 = k1_only(launch_counts(), 24 * PROFILE_TRAIN_ITERS, "profile_train's window")
    total, rows = ptrain.top_kernels(ptrain.device_events(prof)[1])
    check(total > 0, "profile_train: the profiler saw no device time")
    check(rows and all(name for _, _, name in rows), f"profile_train rows {rows}")
    emit({"phase": "profile_train", "task": "go2", "n_envs": N_ENVS,
          "iteration_ms": it_ms, "env_steps_per_s": spi / it_ms * 1e3,
          "profiled_iters": PROFILE_TRAIN_ITERS, "k1_launches": k1,
          "device_ms_total": total, "device_ms_per_iteration": total / PROFILE_TRAIN_ITERS,
          "top": [list(r) for r in rows], "seconds": time.time() - t0})
    del alg, env, carry, prof

    # ---- 31. profile_residue: the flagship iteration's A-E breakdown ----
    t0 = time.time()
    progs, spi = pres.programs("go2", N_ENVS, dev)
    ms, k1_res = {}, 0
    for name, fn in progs.items():
        torch.cuda.synchronize()
        zero_launch_counts()
        ms[name] = pres.timeit(fn, RESIDUE_ITERS, dev)
        k1_res += k1_only(launch_counts(), 24 * (RESIDUE_ITERS + 1),
                          f"profile_residue program {name}, {RESIDUE_ITERS + 1} calls")
    res = pres.residue(ms, "go2", N_ENVS, spi)
    check(all(math.isfinite(v) for k, v in res.items() if k not in ("task", "num_envs")),
          f"profile_residue: {res}")
    emit(dict(res, phase="profile_residue", calls_per_program=RESIDUE_ITERS + 1,
              k1_launches=k1_res, k1_launches_per_call=24, ms_unrounded=ms,
              seconds=time.time() - t0))
    del progs
    k1 += k1_res

    # ---- 32. make_pretrain: train, export, curves ----
    t0 = time.time()
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "pre_train", "go2")
    args = helpers.get_args(["--task=go2", f"--num_envs={N_ENVS}", f"--device={dev.type}",
                             f"--max_iterations={PRETRAIN_ITERS}",
                             f"--experiment_name={os.path.join(tmp.name, 'logs')}"])
    zero_launch_counts()
    out_dir, runner = mp.make_pretrain(args, out)
    torch.cuda.synchronize()
    # reset_all's zero-action step, then 24 an iteration
    k1 += k1_only(launch_counts(), 1 + 24 * PRETRAIN_ITERS, "make_pretrain")
    shipped = resource("resources/pre_train/go2")
    check(out_dir == out, f"make_pretrain wrote to {out_dir}")
    check(sorted(os.listdir(out)) == sorted(os.listdir(shipped)),
          f"make_pretrain wrote {sorted(os.listdir(out))}, the shipped go2 has "
          f"{sorted(os.listdir(shipped))}")
    with open(os.path.join(out, "policy_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(shipped, "policy_meta.json")) as f:
        check(set(meta) == set(json.load(f)), f"policy_meta.json keys {sorted(meta)}")
    with open(os.path.join(out, "policy.bin"), "rb") as f:
        header = struct.unpack("<9I", f.read(36))
    check(header == (0x4C525455, 1, 0, 48, 12, 0, 0, 4, 0), f"policy.bin header {header}")
    obs = runner._obs
    mu = runner.get_inference_policy()(obs).cpu().numpy()
    np_err = float(np.abs(NumpyPolicy(out)(obs.cpu().numpy()) - mu).max())
    check(np_err <= PRETRAIN_ATOL, f"NumpyPolicy on make_pretrain's npz: {np_err} from "
          f"the runner's policy (bar {PRETRAIN_ATOL})")
    with open(os.path.join(out, "curves.json")) as f:
        check(len(json.load(f)) == PRETRAIN_ITERS, "curves.json rows")
    emit({"phase": "make_pretrain", "task": "go2", "n_envs": N_ENVS,
          "iterations": PRETRAIN_ITERS, "files": sorted(os.listdir(out)),
          "policy_bin_header": list(header), "numpy_policy_max_abs_err": np_err,
          "atol": PRETRAIN_ATOL, "k1_launches": 1 + 24 * PRETRAIN_ITERS,
          "seconds": time.time() - t0})
    del runner
    tmp.cleanup()

    # ---- 33. activations: one flagship iteration per non-elu activation ----
    t0 = time.time()
    tmp = tempfile.TemporaryDirectory()
    env_cfg, _ = task_registry.get_cfgs("go2")
    env_cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env("go2", env_cfg=env_cfg, device=dev)
    losses, writer = {}, {}
    for act in ACTIVATION_NAMES:
        _, train_cfg = task_registry.get_cfgs("go2")
        train_cfg.policy.activation = act
        runner = OnPolicyRunner(env, train_cfg, os.path.join(tmp.name, act))
        runner.learn(0)   # the env's reset (one zero-action step), the writer
        zero_launch_counts()
        rows = runner.learn(1)
        k1 += k1_only(launch_counts(), 24, f"the {act} iteration")
        check_rows(rows, torch, runner, f"the {act} iteration")
        losses[act] = {k: rows[-1][k] for k in ("value_loss", "surrogate_loss", "kl", "lr")}
        writer[act] = runner._writer is not None
        del runner
    emit({"phase": "activations", "task": "go2", "n_envs": N_ENVS,
          "iterations_each": 1, "k1_launches_each": 24, "losses": losses,
          "tensorboard_writer": writer, "seconds": time.time() - t0})
    tmp.cleanup()
    return k1, fma


# ---------------------------------------------------------------------------
# 34-37. module 12's handstand campaign scripts
# ---------------------------------------------------------------------------


def handstand_campaign_phases(torch, dev):
    """Phases 34-37: the handstand campaign scripts on the card, each
    through its script's functions. Returns their K1 and K2 launches."""
    import tempfile

    import numpy as np

    from unitree_rl_gym_tpu_torch.export.numpy_policy import NumpyPolicy
    from unitree_rl_gym_tpu_torch.models import networks as nets
    from unitree_rl_gym_tpu_torch.scripts import handstand_basin as basin
    from unitree_rl_gym_tpu_torch.scripts import handstand_diag as diag
    from unitree_rl_gym_tpu_torch.scripts import handstand_eval as hs_eval
    from unitree_rl_gym_tpu_torch.scripts import handstand_kickup_r5 as kickup
    from unitree_rl_gym_tpu_torch.scripts import handstand_recipe as recipe
    from unitree_rl_gym_tpu_torch.scripts import handstand_transfer_r5 as transfer

    launches = {"k1": 0, "k2": 0}

    def only(counts, what, k1=0, k2=0):
        check(counts == {"k4": 0, "k1": k1, "k3": 0, "k2": k2},
              f"{what}: launches {counts}, expected K1 {k1} and K2 {k2} times "
              "and nothing else")
        launches["k1"] += k1
        launches["k2"] += k2

    def timed_rates(ev, log):
        """``ev.rates`` with each call's host seconds and launches logged
        and checked, the counts zeroed just before the call: K1 once a step
        of each 16-env rollout and its reset."""
        rates = ev.rates

        def fn(net, seed=0):
            torch.cuda.synchronize()
            zero_launch_counts()
            t = time.time()
            r = rates(net, seed)
            torch.cuda.synchronize()
            log.append({"seconds": time.time() - t, "seed": seed,
                        **{k: r[k] for k in ("hold_rate", "conv_rate", "init_rate")}})
            only(launch_counts(), "Evaluator.rates", k1=RATES_LAUNCHES)
            return r

        ev.rates = fn
        return ev

    def counted_learn(log):
        """``OnPolicyRunner.learn`` with the counts zeroed just before each
        call and read just after it, appended to ``log``; returns the
        original to put back."""
        from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

        learn = OnPolicyRunner.learn

        def fn(self, *a, **k):
            torch.cuda.synchronize()
            zero_launch_counts()
            rows = learn(self, *a, **k)
            torch.cuda.synchronize()
            log.append(launch_counts())
            return rows

        OnPolicyRunner.learn = fn
        return OnPolicyRunner, learn

    # ---- 34. kickup: handstand_kickup_r5.run_experiment from the shipped
    #      holder at 4096 envs, an Evaluator.rates call after each iteration ----
    t0 = time.time()
    tmp = tempfile.TemporaryDirectory()
    rates_log = []
    ev = timed_rates(kickup.Evaluator(dev), rates_log)
    learn_log = []
    runner_cls, learn = counted_learn(learn_log)
    try:
        best = kickup.run_experiment(KICKUP_EXP, tmp.name, ev, iters=KICKUP_ITERS,
                                     eval_every=KICKUP_EVAL_EVERY, device=dev)
    finally:
        runner_cls.learn = learn
    n_rates = len(rates_log)
    check(n_rates == 1 + KICKUP_ITERS // KICKUP_EVAL_EVERY,
          f"{n_rates} Evaluator.rates calls")
    check(len(learn_log) == KICKUP_ITERS // KICKUP_EVAL_EVERY,
          f"{len(learn_log)} runner.learn calls")
    # each learn call: KICKUP_EVAL_EVERY iterations of 24 steps, the first
    # call after the training env's reset_all (its zero-action step)
    for i, counts in enumerate(learn_log):
        only(counts, f"run_experiment's learn call {i}",
             k1=(i == 0) + 24 * KICKUP_EVAL_EVERY)
    check(ev.envs[1.0].num_envs == ev.envs[0.0].num_envs == kickup.N_EVAL,
          "eval envs of another size than N_EVAL")
    check(rates_log[0]["hold_rate"] >= HOLD_MIN_SHARE,
          f"the shipped holder's baseline hold_rate {rates_log[0]['hold_rate']} "
          f"below {HOLD_MIN_SHARE}")
    out = os.path.join(tmp.name, KICKUP_EXP)
    for f in ("best.pt", "best_export/policy.bin", "campaign.json",
              "final_export/policy.bin"):
        check(os.path.exists(os.path.join(out, f)), f"run_experiment wrote no {f}")
    with open(os.path.join(out, "campaign.json")) as f:
        campaign = json.load(f)
    emit({"phase": "kickup", "experiment": KICKUP_EXP, "n_envs": N_ENVS,
          "iterations": KICKUP_ITERS, "eval_every": KICKUP_EVAL_EVERY,
          "eval_envs": kickup.N_EVAL,
          "k1_launches_training": 1 + 24 * KICKUP_ITERS,
          "k1_launches_per_rates_call": RATES_LAUNCHES, "k2_launches": 0,
          "rates_calls": rates_log,
          "rates_host_seconds": [r["seconds"] for r in rates_log],
          "best": {k: best[k] for k in ("score", "it")},
          "history": campaign["history"], "seconds": time.time() - t0})
    tmp.cleanup()

    # ---- 35. transfer_capture: the fine-tune's training setup (transfer_cfgs
    #      of FINETUNE_ARGS, K2), one iteration, then TransferEval._capture of
    #      the shipped holder (K1, 16 envs) ----
    t0 = time.time()
    tmp = tempfile.TemporaryDirectory()
    args = transfer.parse_args(FINETUNE_ARGS + ["--out", tmp.name])
    env, runner = transfer.transfer_runner(args, dev)
    check(env.num_envs == N_ENVS, f"the fine-tune's env holds {env.num_envs} envs")
    runner.learn(0, init_at_random_ep_len=True)   # the env's reset
    torch.cuda.synchronize()
    zero_launch_counts()
    rows = runner.learn(1)
    torch.cuda.synchronize()
    only(launch_counts(), "the fine-tune iteration", k2=24)
    check_rows(rows, torch, runner, "the fine-tune iteration")
    del env, runner
    tev = transfer.TransferEval(kickup.Evaluator(dev))
    holder = kickup.load_holder(kickup.ART, dev)
    torch.cuda.synchronize()
    zero_launch_counts()
    t_cap = time.time()
    states = tev._capture(holder, settle=CAPTURE_SETTLE)
    torch.cuda.synchronize()
    capture_s = time.time() - t_cap
    only(launch_counts(), "TransferEval._capture", k1=1 + CAPTURE_SETTLE)
    check(len(states) >= 1, "TransferEval._capture held no state")
    shapes = [tuple(a.shape) for a in states[0]]
    check(shapes == [(3,), (4,), (12,), (3,), (3,), (12,)], f"captured shapes {shapes}")
    check(all(np.isfinite(a).all() for st in states for a in st), "non-finite capture")
    emit({"phase": "transfer_capture", "n_envs": N_ENVS, "args": FINETUNE_ARGS,
          "k2_launches_iteration": 24, "iteration_ms": rows[0]["iteration_s"] * 1e3,
          "capture_envs": kickup.N_EVAL, "capture_steps": CAPTURE_SETTLE,
          "k1_launches_capture": 1 + CAPTURE_SETTLE, "captured_states": len(states),
          "captured_base_height_m": [float(st[0][2]) for st in states],
          "capture_host_seconds": capture_s,
          "transfer_rate": "not run: mujoco is not installed here",
          "seconds": time.time() - t0})
    tmp.cleanup()

    # ---- 36. eval_diag_basin: handstand_eval (seeds 0-2), handstand_diag,
    #      handstand_basin at 256 envs ----
    t0 = time.time()
    zero_launch_counts()
    ev_out = hs_eval.evaluate(kickup.ART, EVAL_SEEDS, device=dev)
    torch.cuda.synchronize()
    only(launch_counts(), "handstand_eval", k1=len(EVAL_SEEDS) * RATES_LAUNCHES)
    zero_launch_counts()
    attempts, diag_envs = diag.diagnose(kickup.ART, DIAG_STEPS, 0, device=dev)
    torch.cuda.synchronize()
    only(launch_counts(), "handstand_diag", k1=1 + DIAG_STEPS)
    zero_launch_counts()
    rate, grid, th0, w0, held = basin.basin(kickup.ART, BASIN_ENVS, BASIN_STEPS,
                                            BASIN_W, BASIN_TH, 0, device=dev)
    torch.cuda.synchronize()
    only(launch_counts(), "handstand_basin", k1=1 + BASIN_STEPS)
    check(th0.shape == w0.shape == held.shape == (BASIN_ENVS,), "basin shapes")
    th_lo, th_hi = BASIN_TH[0] - BASIN_TH_SLACK, BASIN_TH[1] + BASIN_TH_SLACK
    w_lo, w_hi = BASIN_W[0] - BASIN_W_SLACK[0], BASIN_W[1] + BASIN_W_SLACK[1]
    check(bool(((th0 >= th_lo) & (th0 <= th_hi)).all()),
          f"read-back initial th {th0.min():.1f}-{th0.max():.1f} deg outside "
          f"[{th_lo}, {th_hi}]")
    check(bool(((w0 >= w_lo) & (w0 <= w_hi)).all()),
          f"read-back initial w {w0.min():.2f}-{w0.max():.2f} rad/s outside "
          f"[{w_lo}, {w_hi}]")
    check(sum(int(v.split("(")[1].rstrip(")")) for v in grid.values())
          == int(((th0 >= 40) & (th0 < 140) & (w0 >= 0) & (w0 < 14.5)).sum()),
          "basin grid counts")
    emit({"phase": "eval_diag_basin", "eval_seeds": list(EVAL_SEEDS),
          "eval": {k: ev_out[k] for k in ("hold_rate_mean", "conv_rate_mean",
                                          "init_rate_mean")},
          "eval_per_seed": ev_out["per_seed"],
          "diag_steps": DIAG_STEPS, "diag_envs": diag_envs,
          "diag_attempts": len(attempts),
          "diag_attempt_ends": {e: sum(a["end"] == e for a in attempts)
                                for e in ("terminated", "fell_back", "eval_end")},
          "basin_envs": BASIN_ENVS, "basin_steps": BASIN_STEPS, "basin_rate": rate,
          "basin_grid": grid,
          "basin_th0_deg": [float(th0.min()), float(np.median(th0)), float(th0.max())],
          "basin_w0": [float(w0.min()), float(np.median(w0)), float(w0.max())],
          "basin_th_bounds": [th_lo, th_hi], "basin_w_bounds": [w_lo, w_hi],
          "seconds": time.time() - t0})

    # ---- 37. recipe: handstand_recipe.main into a temporary directory, one
    #      iteration a phase ----
    t0 = time.time()
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "go2_handstand")
    torch.cuda.synchronize()
    zero_launch_counts()
    ckpts = recipe.main(out_dir=out, iters=RECIPE_ITERS, log_root=tmp.name, device=dev)
    torch.cuda.synchronize()
    n_phases = len(recipe.PHASES)
    only(launch_counts(), "handstand_recipe",
         k1=n_phases * (1 + 24 * RECIPE_ITERS))
    # the phases chain: each checkpoint's iteration continues the last one's
    payloads = [torch.load(c, map_location="cpu", weights_only=True) for c in ckpts]
    its = [int(p["iteration"]) for p in payloads]
    check(its == [RECIPE_ITERS * (i + 1) for i in range(n_phases)],
          f"recipe checkpoints at iterations {its}: the phases did not chain")
    # the export loads back and holds the last phase's parameters
    exported = kickup.load_holder(out, "cpu").state_dict()
    differ = [k for k, v in payloads[-1]["model"].items()
              if not torch.equal(v.float(), exported[k])]
    check(not differ, f"the exported npz differs from the last phase's "
          f"checkpoint in {differ}")
    policy = nets.load_flat_policy(out, dev)
    obs = torch.randn(64, policy.actor[0].in_features, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        err = float(np.abs(policy.act(obs).cpu().numpy()
                           - NumpyPolicy(out)(obs.cpu().numpy())).max())
    check(err <= PRETRAIN_ATOL, f"the exported policy and NumpyPolicy differ by {err}")
    for f in ("policy.bin", "policy_1.pt", "policy_meta.json", "curves.json"):
        check(os.path.exists(os.path.join(out, f)), f"handstand_recipe wrote no {f}")
    emit({"phase": "recipe", "n_envs": N_ENVS, "phases": [p[0] for p in recipe.PHASES],
          "iterations_each": RECIPE_ITERS,
          "k1_launches": n_phases * (1 + 24 * RECIPE_ITERS),
          "checkpoint_iterations": its, "export_vs_numpy_policy": err,
          "seconds": time.time() - t0})
    tmp.cleanup()
    return launches


# ---------------------------------------------------------------------------
# 38-39. the per-substep ground_fn mode and the per-env vmap formulation
# ---------------------------------------------------------------------------


def physics_mode_phases(torch, dev, k1_entry):
    """Phase 38 (``backend.control_step`` with ``ground_fn`` on go2_terrain:
    K3 on sampled heights, at the reset and after a walk) and phase 39
    (``backend.control_step_vmap`` held against K1 and the plain version at
    go2's and g1's sizes, timed beside K1). Returns phase 38's K3
    launches; adds phase 39's records to ``k1_entry``."""
    from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy
    from unitree_rl_gym_tpu_torch.physics import backend as pb

    def env_of(task, terrain):
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = N_ENVS
        if terrain:
            cfg.terrain.mesh_type = "heightfield"
            cfg.terrain.curriculum = True
        env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
        args = (env.robot.dyn, env.cparams, env.pd, env.cfg.sim.dt,
                env.cfg.control.decimation)
        return env, args

    def inputs(env, state, actions):
        return (state.phys, env._compute_target(actions), state.friction,
                state.mass_scale, env.m_eff_n, env.m_eff_t)

    def seeded_actions(env):
        gen = torch.Generator(device=dev).manual_seed(0)
        return 0.5 * torch.randn(N_ENVS, env.num_actions, device=dev, generator=gen)

    # ---- 38. ground_fn: K3 on the heights of sample_point_heights, at the
    #      reset (seeded actions) and after WALK_STEPS of the pretrained go2
    #      policy (its actions), where feet land between substeps ----
    t0 = time.time()
    env, args = env_of("go2", True)
    ground_fn = env.grid.height_at
    policy = load_flat_policy(os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "resources",
                                           "pre_train", "go2"), dev)
    state, obs = env.reset_all()
    cases = {"reset": inputs(env, state, seeded_actions(env))}
    with torch.no_grad():
        for _ in range(WALK_STEPS):
            state, obs, *_ = env.step(state, policy.act(obs))
        actions = torch.clamp(policy.act(obs), -env.cfg.normalization.clip_actions,
                              env.cfg.normalization.clip_actions)
    cases["walk"] = inputs(env, state, actions)
    records, launches = {}, 0
    for name, x in cases.items():
        torch.cuda.synchronize()
        zero_launch_counts()
        got = flat_outputs(*pb.control_step(*args, *x, ground_fn=ground_fn))
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == {"k4": 0, "k1": 0, "k3": 1, "k2": 0},
              f"control_step(ground_fn=...) at the {name} launched {counts}, "
              "expected K3 once")
        launches += 1
        gh = pb.sample_point_heights(env.robot.dyn, x[0], ground_fn)
        k3 = flat_outputs(*pb.control_step(*args, *x, gh))
        torch.cuda.synchronize()
        differ = [k for k in k3 if not torch.equal(k3[k], got[k])]
        check(not differ, f"K3 via ground_fn differs from K3 on sample_point_heights' "
              f"gh in {differ} at the {name}")
        ref_s, ref_aux = pb.control_step_soa(*args, *x, gh=gh, want_phi=True)
        plain = flat_outputs(ref_s, ref_aux)
        plain_bits = [k for k in got if not torch.equal(got[k], plain[k])]
        s_err, a_err, n_excused, per_output, _ = compare(
            plain, got, ref_aux["min_abs_phi"], torch, name=f"K3 (ground_fn, {name})")
        check_parent_err("K3", s_err)
        # the frozen heights against the per-substep sampling of the plain
        # version: at the reset within the JAX suite's staleness budget in
        # all but STALE_MAX_SHARE of the envs; after the walk the per-substep
        # sampling must change some env (the mode ran), its staleness printed
        sub_s, _ = pb.control_step_soa(*args, *x, ground_fn=ground_fn)
        stale, beyond, n_differ = {}, {}, {}
        for k, atol in STALE_ATOL.items():
            d = (getattr(sub_s, k) - got[k]).abs().amax(dim=1)
            stale[k] = float(d.max())
            beyond[k] = int((d > atol).sum())
            n_differ[k] = int((d > 0).sum())
            if name == "reset":
                check(beyond[k] <= STALE_MAX_SHARE * N_ENVS,
                      f"{beyond[k]} envs beyond the staleness budget {atol} on "
                      f"{k} at the reset, more than {STALE_MAX_SHARE:.0%} of {N_ENVS}")
        if name == "walk":
            check(any(n_differ.values()), "after the walk the per-substep "
                  "ground_fn sampling gave the frozen heights' bits in every env")
        records[name] = {
            "k3_launches": 1, "bit_identical_to_explicit_gh": True,
            "bit_identical_to_plain": not plain_bits,
            "outputs_not_bit_identical_to_plain": plain_bits,
            "max_abs_err_state_vs_plain": s_err, "max_err_aux_normalised_vs_plain": a_err,
            "excused_contact_edge_envs": n_excused,
            "max_errors_by_output_vs_plain": per_output,
            "gh_range_m": [float(gh.min()), float(gh.max())],
            "staleness_max_vs_per_substep": stale,
            "envs_beyond_staleness_atol": beyond,
            "envs_differing_from_per_substep": n_differ}
        del got, k3, plain, sub_s, ref_s, ref_aux
    emit({"phase": "ground_fn", "task": "go2_terrain", "n_envs": N_ENVS,
          "walk_steps": WALK_STEPS, "staleness_atol": STALE_ATOL,
          "max_share_beyond_at_reset": STALE_MAX_SHARE, "cases": records,
          "seconds": time.time() - t0})
    del env, args, cases, state, obs, policy

    # ---- 39. vmap: control_step_vmap against K1 and the plain version ----
    t0 = time.time()
    records = {}
    for task in VMAP_TASKS:
        env, args = env_of(task, False)
        state, _ = env.reset_all()
        x = inputs(env, state, seeded_actions(env))
        ref_s, ref_aux = pb.control_step_soa(*args, *x, want_phi=True)
        k1 = flat_outputs(*pb.control_step(*args, *x))
        got = flat_outputs(*pb.control_step_vmap(*args, *x))
        torch.cuda.synchronize()
        rec = {"n_envs": N_ENVS}
        for ref_name, ref in (("plain", flat_outputs(ref_s, ref_aux)), ("k1", k1)):
            rec[f"vs_{ref_name}"] = compare_vmap(ref, got, ref_aux["min_abs_phi"], torch,
                                                 f"vmap ({task}) vs {ref_name}")
        rec["vmap_ms"] = cuda_ms(torch, lambda: pb.control_step_vmap(*args, *x),
                                 VMAP_REPS, 1)
        rec["k1_ms"] = cuda_ms(torch, lambda: pb.control_step(*args, *x), TIME_LAUNCHES, 3)
        rec["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        records[task] = rec
        del env, args, x, state, ref_s, ref_aux, k1, got
    emit({"phase": "vmap", "tasks": records, "edge": VMAP_EDGE,
          "max_share": VMAP_MAX_SHARE, "excused_cap": VMAP_EXCUSED_CAP,
          "seconds": time.time() - t0})
    k1_entry["vmap_yardstick"] = {t: {k: r[k] for k in ("vmap_ms", "k1_ms")}
                                  for t, r in records.items()}
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
    from unitree_rl_gym_tpu_torch.scripts import play, roofline
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
    # the roofline's FMA probe (phase 29) builds beside the physics libraries
    fma_build = {}
    fma_thread = threading.Thread(target=lambda: fma_build.update(
        path=cuda_step.build_source((roofline.FMA_SOURCE,), cuda_step.NVCC_FLAGS,
                                    "roofline_fma")))
    fma_thread.start()
    libs = cuda_step.build_all([m, m_hs], only=[(mm, "control_step")
                                                for mm in m_hum.values()])
    fma_thread.join()
    check("path" in fma_build, "csrc/roofline_fma.cu did not build")
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
          "build_seconds": build_s, "libraries_built_together": len(libs) + 1,
          "roofline_fma_ptxas": [ln.strip() for ln in cuda_step.BUILD_LOGS.get(
              fma_build["path"], "").splitlines() if "registers" in ln or "spill" in ln],
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

    k1_entry = {
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
    }
    entries = [k1_entry, k3_entry, k2_entry, *k4_entries, *humanoid_entries]

    # ---- 29-33. module 12's tooling and module 5's remainder (K1, the FMA
    #      probe) ----
    tool_launches, fma = tooling_phases(torch, dev, entries)
    k1_entry["launches"] += tool_launches

    # ---- 34-37. module 12's handstand campaign scripts (K1 at the handstand's sizes,
    #      K2) ----
    hs_launches = handstand_campaign_phases(torch, dev)
    # K1 at the handstand's sizes, another instance than the entry's (as in
    # phase 14): kept beside its count
    k1_entry["launches_handstand_sizes_campaign"] = hs_launches["k1"]
    k2_entry["launches"] += hs_launches["k2"]

    # ---- 38-39. the per-substep ground_fn mode (K3) and the per-env vmap
    #      formulation held against K1 and the plain version ----
    k3_entry["launches"] += physics_mode_phases(torch, dev, k1_entry)
    emit({"kernels": entries + [fma]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
