#!/usr/bin/env python3
"""Smoke test of the PyTorch port (video_gcp_torch) on one NVIDIA Hopper GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

1. Build: compiles kernels K1 (GroupNorm+LeakyReLU forward) and K2 (its
   backward), both in video_gcp_torch/csrc/fused_gn.cu, K3 (the
   soft-DTW posterior: both DPs row by row and w in one launch),
   video_gcp_torch/csrc/soft_dtw.cu, and K4 (the evaluation DTW: DP,
   traceback and per-frame match in one launch),
   video_gcp_torch/csrc/dtw_align.cu, with nvcc for
   sm_90a, one nvcc per source, started together; prints the build time and
   the ptxas reports.
2. K1 phase: K1 against its plain PyTorch twin on the card at every
   GroupNorm site of the 9-room GCP-tree (5 encoder, 5 decoder) at batch 16
   and at the CEM batch of 100 candidates, the train step's encoder on its
   1,600 frames, in f32 and bf16, 9room/gcp_sequential's decoder on its
   1,584 frames (16 x 99) in f32, VMPC's simulator call (encoder on 50
   candidates, decoder on 50 x 99 frames), the dist phase's f32 shapes
   (dist_kernel_shapes: the rows each rank of its training runs holds, the
   25-room flagship's 16 x 200 frames and 16 x 255 nodes among them at one
   card, and the split plan call's chunks), the 25room phase's f32 sites
   (ROOM25_K1_SHAPES: the flagship's train step on 16 x 200 frames and 16 x
   255 nodes, the 25-room control path's decoder on 255 n nodes), the long
   phase's f32 sites (LONG_K1_SHAPES: both 500-frame models' train steps on
   16 x 500 frames, the tree's decoder on 16 x 511 nodes, the VRNN's on 16 x
   499 frames; the val, sweep and Evaluator batches of 1), plus the
   largest shape of the repo, [16352, 64, 64, 16] bf16. Prints per shape
   the kernel's time (CUDA events, median of 25), its own device time (torch.profiler, 10 calls,
   one profiler session over every shape, as in the K2 phase),
   the bound, the wrapper's host time per call (best of 3 x 50 calls issued
   back to back) and the max difference, and at each path's top shape
   (K1_COMPARED) the plain twin's time and the time of F.group_norm +
   F.leaky_relu (a yardstick the port never calls); then, per
   path, the sums of the times and bounds over a plan call's, a B=16
   rollout's and a train step's K1 sites, in f32 and in bf16, and over
   gcp_sequential's train step, a 25-room simulator call of 10 candidates,
   the flagship's train step and both 500-frame models' train steps in f32.
3. K2 phase: K2 against its twin at the 15 norm shapes of a training step
   at B=16, T=100 (encoder on 1600 frames and on the 16 start and goal
   frames, decoder on 2032 nodes) in f32 and in bf16, at the 5 decoder
   shapes of 9room/gcp_sequential's train step (1,584 frames) in f32, and
   at the two largest of bench.py's train step in bf16, and at the dist
   phase's training shapes in f32 (dist_kernel_shapes), the 25room
   phase's (ROOM25_K2_SHAPES) and the long phase's (LONG_K2_SHAPES). Inputs
   are moved
   clear of LeakyReLU's kink (fused_gn.clear_of_kink) so that both sign
   tests agree. Prints the same columns and the sums over a train step's
   20 K2 sites in each dtype (and over gcp_sequential's, the flagship's and
   the 500-frame models' 20 in f32); the yardstick is the autograd backward
   of F.group_norm + F.leaky_relu.
4. K3 phase: K3 against its row-order twin on the card at the adaptive
   training shape [16, 127, 100] (B = 16 matrices of 127 nodes x 100
   frames) and at the largest shape the repo names, [16, 511, 500], with
   mixed ends: F and Bk (through the kernel's debug output) within 1e-4 of
   max(1, |D|) with the same finite region, w within 1e-4, and no mass past
   an end. Prints the kernel's time (CUDA events, median of 25, and its own
   device time from torch.profiler), the whole soft_dtw() call's time, the
   twin's time, the bytes bound, the r dependent rows and the device time
   per row, the wrapper's host time per soft_dtw() call and the device
   kernels per call (torch.profiler). First it checks that the kernel's
   branch-free log1p equals the CUDA library's log1pf on every float in
   [0, 1].
4b. K4 phase: `batched_dtw_alignment` on the card (K4) against its twin
   `alignment_reference` run on the CPU, at the 9-room tree's
   [16, 127, 100] and the 500-frame tree's [1, 511, 500] and
   [16, 511, 500] (K4_SHAPES), random costs with mixed ends: the node
   indices, D (the kernel's debug output) and the distances bit for bit.
   Prints the call's time (CUDA events, median of 25), K4's own device time
   (torch.profiler, n/m unless the trace holds one K4 a call), the twin's
   time on the card, the bytes bound, the chain's r + c - 1 DP steps and
   the device µs a step, the wrapper's host time and the device kernels a
   call; at the 500-frame shapes also the DTW's ms in one top-of-100 batch
   of the Evaluator.
5. Slice phase (serving): load_model() of 9room/gcp_tree with the ep74
   weights on the card; two 'test'/'prior' rollouts at B=16 (cold, then
   warm); three planner calls ('plan', predicted length) of 100 candidates
   with fresh latents from a seeded torch.Generator on the card, as the CEM
   loop's n_iters=3 drives the simulator. Checks 15 K1 launches per forward,
   finite outputs, and the first 2 samples of the last rollout and the first
   2 candidates of the last plan call against the same port run on the CPU;
   prints each call's time and the plan calls' peak device memory.
6. Train phase: the trainer on the card, as `python -m
   video_gcp_torch.training.train --path experiments/prediction/9room/gcp_tree
   --resume <ep74 npz> --feed_random_data 1 --num_epochs 1
   --skip_first_val 1 --deterministic 1` runs it: 32 steps at B=16, T=100.
   Checks 20 K1 and 20 K2 launches per step, finite losses, finite
   gradients, and that every parameter with a gradient changed; prints the
   warm ms per step (median of steps 3-31), training frames/s, the peak
   device memory and k2.dy_copies. Then one step of ep74 on 2 examples
   whose order and windows are drawn from SEED (vs_cpu_batch), with the
   same injected noise and the card's LeakyReLU branches at the K1 sites
   (SharedSigns), on the card and on the CPU: every loss term and every
   gradient agree within the tolerances of tests/test_torch_train.py.
   Prints how many branches at the MLPs' LeakyReLUs differ from the card's
   (counted, not shared).
7. Adaptive train phase: the trainer on the card, as `python -m
   video_gcp_torch.training.train --path
   experiments/prediction/9room/gcp_adaptive --feed_random_data 1
   --num_epochs 1 --skip_first_val 1 --deterministic 1` runs it, its 256
   random sequences cut to 64: 8 steps at B=16, T=100 from the port's
   initialisation (no checkpoint). Checks
   20 K1, 20 K2 and 1 K3 launch per step, finite losses and gradients, that
   every parameter with a gradient moved; prints the warm ms per step,
   training frames/s, the peak device memory and the soft-DTW stability gap
   of the first and last step. Then one step of the trained model on the
   first 2 examples of the first batch, card against CPU, as in 6.

8. bf16 phase: load_model() of 9room/gcp_tree with the ep74 weights and
   compute_dtype=torch.bfloat16 (float32 parameters, bf16 compute). First
   3 B=16 rollouts and 3 100-candidate plan calls of the f32 ep74 model,
   then the same of the bf16 model after one cold call each: 15 K1
   launches per bf16 forward, every one on a bf16 x, finite outputs, and
   the first 2 samples of the last bf16 rollout against the port in bf16
   on the CPU (mean |diff| per tree level within tests/test_torch_bf16.py's
   tolerances). Then 8 train_steps (parallel/train_step.py) at B=16,
   T=100 on the same 8 prefetched batches, first of the trainer's f32
   model, then of the bf16 model: 20 K1 and 20 K2 launches per bf16 step
   in bf16, finite losses and gradients, float32 parameters that moved.
   Prints, for f32 and bf16 side by side, the median ms of the warm calls
   and of steps 2-7, and training frames/s. Then one bf16 train step on 2
   examples, card against CPU, as in 6 (TOLS_TRAIN_BF16).
9. Eval phase: the Evaluator (top-of-100, the config's 'basic' scheme) on
   the ep74 model on one B=16, T=100 val batch on the card: 15 K1 launches
   per sampled forward (100 samples and 5 plotted ones), finite metrics,
   the kept best frames scoring the least MSE of the 100 per sequence,
   the channel-first .npy dumps' shapes, and one sample with injected z
   against the CPU. Then 'pruned_dtw' at top-of-10. Prints seconds per
   batch, decoded frames/s (top_of x B x 127 nodes / s) and the DTW warp's
   ms at [16, 127, 100]. Then the greedy schemes at top-of-10,
   'greedy_exist' (ep74's existence predictor) and 'greedy_l2': 15 K1 per
   sampled forward each, finite metrics; prints seconds per batch.
9b. Eval extras phase, over the eval phase's dumps ([16, 99, 3, 32, 32]):
   FVD through I3D at Kinetics-400 width on 224x224 frames and LPIPS(alex),
   from checkpoints synthesized from a seed and named by GCP_I3D_WEIGHTS
   and GCP_LPIPS_WEIGHTS; each held card against CPU on 2 videos x 8
   frames (TOL_I3D, TOL_LPIPS); prints I3D ms per video, LPIPS ms per
   frame, the FVD and LPIPS values and the weight-free proxies' numbers.
9c. Finetune phase: `python -m video_gcp_torch.training.finetune_inv_mdl
   --path experiments/prediction/9room/gcp_tree_widegap --base <ep74 npz>
   --epochs 1 --feed_random_data 1 --val_metric_batches 1` run in-process,
   its random sequences cut to 4 steps at B=16, T=100 and one val batch:
   20 K1 and 20 K2 a step (the whole backward; only inv_mdl stepped),
   55 K1 in the val pass (the val step, the logged prior sample and
   posterior pass), every parameter outside inv_mdl bit-identical to ep74,
   the inverse model moved, and the val pass's image files
   (FINETUNE_IMAGES); prints ms per step.
10. Plan phase: closed-loop visual planning on 9room/gcp_tree with ep74 on
   the card. ep74 as a port checkpoint under the build directory and the
   start/goal configuration 0 of the port's PRM expert
   (experiments/data_gen/nav_9rooms_start_goal, on the CPU) are made once,
   by the first of the baselines and plan phases, and
   planning.run's ControlManager runs the control benchmark's task 0
   (experiments/control/9room/gcp_tree, T=200 env steps) from copies
   of both configs under the build directory. Checks 15 K1 launches per
   simulator call and 5 per closed-loop action and no K2 or K3, finite
   plans with images in [-1, 1], finite actions, the task and score
   pickles and results file and finite compute_control_perf metrics, and
   the first simulator call (every candidate, the same z and end_ind) and
   the first action against the CPU. Prints the candidates of each
   simulator call per _plan, the warm ms per simulator call at each
   candidate count and its bytes to the host, ms per _plan and its
   simulator share, one _plan's host time, device-busy time and idle share
   (torch.profiler), ms per action, env steps/s, seconds per task, and the
   success rate and penalized path cost of the task. The K1 phase
   also holds K1 at the control path's sites (encoder at n = 10, 5, 1,
   decoder at 127 n nodes).

10b. 25room phase (right after the plan phase): the paper's 25-room
   long-horizon path at the published widths, cut in depth only. The port's
   PRM expert makes 33 nav_25rooms trajectories (of the config's 1000;
   experiments/data_gen/nav_25rooms, T=200, 128x128 frames) on the host in
   8 spawned workers seeded 0-7, each read back through data/h5.py; the
   25-room flagship (experiments/prediction/25room/gcp_tree: untied, L=8,
   255 nodes, a 512x3 split_linear TreeLSTM) trains from them through
   ModelTrainer from its initialisation, one epoch of 4 steps at B=16,
   T=200 and its val pass: 20 K1 and 20 K2 a step, 55 K1 in the val pass,
   no K3, finite values, parameters that moved (RAdam's first 5 steps do
   not normalise, so those with the smallest gradients may not), one step
   card vs CPU (TOLS_TRAIN). From that checkpoint, task 0 (of 100) of
   control/25room/gcp_tree (8-level hierarchical CEM, rates [10, 10],
   simulator calls of 10, 10, 5 and 1 candidates a _plan) and of
   control/25room/gcp_sequential (flat CEM over the 255 latents, calls of 5
   and 5) run through planning.run's ControlManager to T=400 env steps,
   from a start/goal configuration that the PRM expert makes in the 25-room
   maze (nav_9rooms_start_goal's config at n_rooms 25 and T=200, written
   under the build directory): 15 K1 a simulator call and 5 a closed-loop
   action, no K2 or K3, the first simulator call (2 candidates) and the
   first action card vs CPU. Prints seconds per generated trajectory, the
   synced ms and t_data of each step, training frames/s, a step's device
   time, the peak device memory, ms per _plan, each simulator call's ms by
   candidates, one profiled _plan's host ms, busy ms and idle share, env
   steps/s, and compute_control_perf at n_rooms 25 with max_seq_len 400
   (the agent's T). The K1 and K2 phases hold the kernels at this path's
   sites (ROOM25_K1_SHAPES, ROOM25_K2_SHAPES).

10c. Long phase (right after the 25room phase): the 500-frame horizon at the
   published widths, cut in depth only. The port's PRM expert makes 17
   nav_25rooms_long trajectories (of the config's 400;
   experiments/data_gen/nav_25rooms_long: T=500, 64x64 frames,
   subsample_factor 0.5, variable lengths padded to 501 frames) in 8 spawned
   workers into the h5 phase's data directory, each read back through
   data/h5.py with its pad mask; 16 train one epoch of 4 steps at B=16 and
   1 is the val split. 25room_long/gcp_tree (tied, L=9, 511 nodes, a 512x3
   split_linear TreeLSTM, the 500-wide length head) trains from them
   through ModelTrainer from its initialisation, one epoch of 4 steps at
   B=16, T=500 and its val pass: 20 K1 and 20 K2 a step, 55 K1 in the val
   pass, no K3, finite values, parameters that moved, one step card vs CPU
   (TOLS_TRAIN). Its checkpoint then runs `--dataset_val_sweep 1` (the
   val split of nav_9rooms at T=100, L=7, and of nav_25rooms_long at T=500,
   L=9: both [dataset sweep] lines, the length head kept fresh at T=100,
   finite val losses, 55 K1 at each horizon, the trainer's own model back
   unchanged) and `--metric 1` (the Evaluator's top-of-100 under
   'pruned_dtw' on the val batch of 1, the only cut: 15 K1 a sampled
   forward, one K4 launch a sampled forward, finite eval/ metrics; the
   DTW at its shapes is phase 4b's).
   25room_long/gcp_sequential (the VRNN over 499 steps) trains likewise:
   20 K1 and 20 K2 a step, 55 K1 in its val pass, one step card vs CPU.
   Prints seconds per generated trajectory and the mean path length, each
   model's synced ms a step, t_data, training frames/s, device-busy ms a
   step and idle share, the peak device memory, the sweep's val losses, the
   Evaluator's seconds a batch and K4 launches, and the seconds of each
   part. The K1 and K2 phases hold the kernels at this path's sites
   (LONG_K1_SHAPES, LONG_K2_SHAPES).

11. h5 phase (run right after the train phase): the port's PRM expert makes
   40 nav_9rooms trajectories on the host (experiments/data_gen/nav_9rooms,
   T=100, 128x128 frames, one a file) into a temporary GCP_DATA_DIR through
   planning.run's ControlManager, from a copy of the config under the build
   directory; every file is read back through video_gcp_torch/data/h5.py
   with its keys, shapes and dtypes. Then 9room/gcp_tree and
   9room/gcp_sequential train from those files at full width through
   ModelTrainer (--resume none, 2 epochs of 4 steps at B=16, T=100 through
   the Nav9Rooms re-renderer, a val pass each epoch): 20 K1 and 20 K2
   launches per step and no K3, finite losses, gradients and val losses,
   every parameter with a gradient moved; one step of each on 2 examples
   card against CPU, as in 6. Prints seconds per generated trajectory, the
   trainer's wait for each batch (t_data) against each synced step, per
   epoch (cold, then warm render cache), a step's device time
   (torch.profiler), and (once, with the first model's dataset) the
   re-render of one batch on the host, cold and warm. The run imports neither h5py nor cv2: both are set to None in
   sys.modules.

12. Baselines phase (right after the h5 phase, from its files): the paper's
   planning baselines in the 9-room maze at the published 9-room widths,
   each a smoke run of one control task (T=200) through planning.run's
   ControlManager. (a) The flat CEM ablation, the published
   experiments/control/9room/gcp_sequential with ep74 (the tree's 127
   latents as flat Gaussians, one call of 5 candidates and the elites'
   re-rollout a _plan): 15 K1 a simulator call and 5 a closed-loop action,
   the first simulator call card vs CPU (TOLS_SLICE). (b) VMPC:
   9room/gcp_sequential with base_configs/vmpc.py's overrides, trained
   through ModelTrainer from its initialisation for one epoch (4 steps)
   and a val pass: 20 K1 and 15 K2 a step (its encoding of the sequence
   reaches no loss), a KL of 0 at every step, one
   step card vs CPU (TOLS_TRAIN); then ImageCEMPolicy(act_cond=True,
   model_cls=SequentialModel) with ImageCEMPlanner and the default
   FlatCEMSampler over [100, 2] action sequences (3 iterations of 50, a
   replan every 50 env steps) scored by ep74's learned cost: 15 K1 a
   simulator call, the first one (its first 10 sequences) card vs CPU.
   (c) Goal-conditioned BC
   (reactive) trained likewise: 10 K1 and 10 K2 a step, one step card vs
   CPU; then BehavioralCloningPolicy on those weights: 10 K1 an action,
   the first one card vs CPU. (d) One B=16, T=100 prior rollout of
   9room/gcp_sequential with use_conv_lstm from the port's
   initialisation, injected z: 15 K1, card vs CPU at B=2. Prints each
   part's seconds, launches and card-vs-CPU differences, ms per _plan,
   candidates per simulator call, env steps/s and the (meaningless)
   success rate of each task.

13. Dist phase: prints torch.cuda.device_count(). (a) `torchrun
   --standalone --nproc_per_node=W` over NCCL, W = min(cards, 4), of this
   script as the trainer's ranks (--dist-rank trainer): ModelTrainer on
   9room/gcp_tree from ep74 (--feed_random_data 1, its random sequences
   cut to 32: 4 steps of the global B=16, T=100), each rank's launch counts reset
   before the run: 20 K1 and 20 K2 a step on every rank, finite losses and
   gradients, one parameter checksum on every rank (an all_reduce of its
   min and max); prints the warm ms per step and training frames/s. (b)
   One data-parallel step of ep74 on 2 ranks (--dist-rank steps, started
   with torchrun's environment beside (a), whose end they wait for before
   any work on the card; they share the card over gloo when there is one,
   else one card each over NCCL), each on its rows of the first batch with the whole batch's
   noise and K1 branches (SharedNoise, SharedSigns), against the
   single-process step on the whole batch (TOLS_TRAIN). (c) On the same
   ranks, two dp x fsdp steps of the 25-room flagship from its
   initialisation (experiments/prediction/25room/gcp_tree: untied, L=8,
   512x3 split_linear TreeLSTM, T=200, B=16; a (data, model) mesh of
   (ranks / 2, 2)): 20 K1 and 20 K2 a step on every rank, finite values;
   prints the peak device memory per rank and the split parameter count.
   (d) A plan call of 100 candidates through GCPSimulator split over the
   cards (["cuda:0", "cuda:0"] on one) against the unsplit call on the
   same inputs: the same lengths, outputs within TOLS_SLICE, 15 K1 a chunk.
   The ranks build no kernel: this process built them.

Prints the seconds of each phase, the per-path sums and the kernels' JSON
lines, the card's name and power limit, and as its last line {"ok": true,
"device": {...}}. Any failure exits non-zero with no result line, as does
a host without CUDA or a directory without the port.

    python3 chip_smoke.py --parent DIR [--kernels-only]

also builds the K1, K2 and K3 of another checkout of the port in DIR (an
earlier commit unpacked with `git archive` under video_gcp_torch/_build/)
and times them in turns with this checkout's at every shape of phases 2 to 4
(new, old, old, new); for K3 it times the whole soft_dtw() calls and
checks that this checkout's F and Bk equal the parent K3's bit for bit and
w is within 1e-6 of the parent's. K4 has no parent kernel: phase 4b times it beside its twin.
--kernels-only stops after phases 2 to 4b and prints their rows as JSON.

    python3 chip_smoke.py --room25-only

builds and runs only the 25room phase (no result line).

    python3 chip_smoke.py --long-only

builds, makes 2 nav_9rooms files for the sweep's val split and runs only
the long phase (no result line).

    python3 chip_smoke.py --flip-probe WINDOWS

builds, makes the h5 data and runs only flip_probe: VMPC trained as in the
baselines phase FLIP_PROBE_MODELS times, and its card-vs-CPU step on WINDOWS
seeded windows of each, the CPU step once with the card's LeakyReLU branches
at the K1 sites only and once with those at the MLPs' LeakyReLUs too.
"""
import contextlib
import functools
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from gcpbench import yardstick
from gcpbench.yardstick import F32_FLOPS_PER_S, HBM_BYTES_PER_S
from video_gcp_torch import tracing
from video_gcp_torch.tracing import COUNTS

T_STARTED = time.time()  # this process's start, for the dist ranks' time line
ROOT = Path(__file__).resolve().parent
CONF = ROOT / "experiments/prediction/9room/gcp_tree"
WEIGHTS = CONF / "pretrained_ep74.npz"
ADAPTIVE_CONF = ROOT / "experiments/prediction/9room/gcp_adaptive"

TOLS_KERNEL = {"float32": 2e-5, "bfloat16": 3e-2}  # bf16: relative to max(1, |y|)
TOLS_SLICE = dict(images=2e-4, e_g_prime=5e-4, timeline_images=2e-4,
                  timeline_latents=5e-4, actions=1e-4, regressed_state=1e-4,
                  existence_logits=1e-3, seq_len_logits=1e-4)  # tests/test_torch_tree.py
SITE_SHAPES = [(16, 16, 16), (8, 8, 32), (4, 4, 64), (2, 2, 128), (1, 1, 256)]
ENC_SITES, DEC_SITES = SITE_SHAPES, SITE_SHAPES[::-1][1:] + [(32, 32, 16)]
N_NODES = 127  # 2^7 - 1 at hierarchy_levels=7
CEM_BATCH, CEM_ITERS, ROLLOUT_BATCH = 100, 3, 16
TRAIN_B, TRAIN_T, TRAIN_STEPS = 16, 100, 32  # 256 / 16 x epoch_cycles_train 2
# the adaptive run's 256 random sequences cut to 64: 64 / 16 x epoch_cycles_train 2
ADAPTIVE_STEPS = 8
NORMS_PER_STEP = 20  # 5 sites x 3 encoder calls (sequence, I_0, I_g) + 5 decoder
# 9room/gcp_sequential's decoder: one frame per step after I_0, B x (T - 1)
SEQ_DEC_BATCH = TRAIN_B * (TRAIN_T - 1)
# K2 at the train step's 15 norm shapes, in f32 and in bf16 (the bf16 path),
# and at the sequential model's 5 decoder shapes in f32 (its encoder's are
# the tree's)
K2_SHAPES = ([((b,) + s, d) for d in ("float32", "bfloat16")
              for b, sites in ((TRAIN_B * TRAIN_T, ENC_SITES), (TRAIN_B, ENC_SITES),
                               (TRAIN_B * N_NODES, DEC_SITES)) for s in sites]
             + [((SEQ_DEC_BATCH,) + s, "float32") for s in DEC_SITES]
             + [((TRAIN_B * N_NODES, 64, 64, 16), "bfloat16"),  # bench.py's train
                ((TRAIN_B * TRAIN_T, 32, 32, 16), "bfloat16")])  # step at 64x64
TOLS_TRAIN = dict(loss=1e-4, grad=2e-3)  # tests/test_torch_train.py, ep74
# bf16 card vs CPU. The heads round their outputs to bf16 (2^-8 relative)
# before the f32 losses, and the two devices may round to neighbouring
# values: one ulp moves an L2 loss whose residual is as large as the
# prediction by ~1.6e-2 (cost_estimation). Gradients wider still, as bf16
# error grows through the tree's recursive LSTM (tests/test_torch_bf16.py).
TOLS_TRAIN_BF16 = dict(loss=5e-2, grad=1e-1)
FLIP_PROBE_MODELS = 4  # --flip-probe: VMPC trainings, each with its windows
# K3: [B, r, c] of the adaptive training step; the largest shape the repo
# names (video_gcp_tpu/ops/pallas_dtw.py:7-9: 511 nodes x 500 frames)
K3_SHAPES = [(TRAIN_B, N_NODES, TRAIN_T), (TRAIN_B, 511, 500)]
# per cell: two DP cells (two maxima, subtract, abs, negate, exp, log1p, two
# adds) and w (three adds, maximum, exp, two compares, select)
K3_OPS_PER_CELL = 26
TOL_K3 = 1e-4  # w absolute (tests/test_torch_soft_dtw.py); D relative to max(1, |D|)
TOL_K3_PARENT = 1e-6  # w against the earlier checkout's K3
# K4: [B, r, c] of the 9-room tree's 'dtw' evaluation and of the 500-frame
# tree's 'pruned_dtw' evaluation (one example, and the benchmark's batch)
K4_SHAPES = [(TRAIN_B, N_NODES, TRAIN_T), (1, 511, 500), (TRAIN_B, 511, 500)]
# bf16: mean |diff| per tree level, tests/test_torch_bf16.py
TOLS_BF16_MEAN = dict(images=3e-3, e_g_prime=1.5e-2)
BF16_STEPS = 8
BF16_WARM = CEM_ITERS  # warm serving calls of each model
BF16_MOVE_GRAD = 1e-6  # a bf16 step's gradient at least this large moves its parameter
TOL_EVAL_METRIC = 1e-4  # tests/test_torch_evaluator.py, relative to max(1, |value|)
GREEDY_TOP_OF = 10  # the greedy eval schemes' samples per sequence
# eval_extras: card vs CPU, relative to the largest value. I3D: f32 through
# ~60 convs (tests/test_torch_fvd.py holds port vs JAX at 1e-4); LPIPS: five
# convs (tests/test_torch_lpips.py, 1e-5)
TOL_I3D, TOL_LPIPS = 1e-4, 1e-5
# the inverse-model fine-tune: 9room/gcp_tree_widegap from ep74; the whole
# backward runs (every gradient is checked, as in the JAX step) and only
# inv_mdl is stepped: a regular step's launches. Its val pass: the val
# step's 20 K1, the logged prior sample's 15 and posterior pass's 20
WIDEGAP_CONF = ROOT / "experiments/prediction/9room/gcp_tree_widegap"
FINETUNE_STEPS = 4
FINETUNE_PER_STEP = (NORMS_PER_STEP, NORMS_PER_STEP, 0)
FINETUNE_VAL_PASS = (NORMS_PER_STEP + 15 + NORMS_PER_STEP, 0, 0)
FINETUNE_IMAGES = ("val_gt_vs_pred", "val_pred_gif", "output_tree", "pruned_pred",
                   "gt_match_overview", "regressed_state_topdown")
ALEXNET_CONVS = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]
EXP_DIR = ROOT / "video_gcp_torch/_build/chip_smoke_exp"  # git-ignored
# the seed of every np.random stream of the control runs and the data
# generation (planning.run --seed): each run of the script makes the same
# data and plans alike
SEED = 0
# the control path's model calls (experiments/control/9room/gcp_tree): the
# simulator's candidates per call (sampling_rates_per_layer [10, 10], then
# n_ll_samples 5, then the chosen one) and one frame per closed-loop action
CONTROL_CANDIDATES = (10, 5, 1)
CONTROL = "experiments/control/9room/gcp_tree/mod_hyper.py"
DATA_GEN = "experiments/data_gen/nav_9rooms_start_goal/mod_hyper.py"
CONTROL_TASKS = 1  # 1 of the benchmark's 100 tasks: the script's time
K1_PER_SIM_CALL, K1_PER_ACTION = 15, 5  # 5 encoder sites x 2 + 5 decoder; 5
# the baselines phase (the paper's planning baselines in the 9-room maze):
# the flat CEM ablation (control/9room/gcp_sequential: ep74, 2^7 - 1 tree
# latents as flat Gaussians, 5 candidates), VMPC (9room/gcp_sequential with
# base_configs/vmpc.py's overrides, CEM over action sequences) and
# goal-conditioned BC, one control task each; the models trained 4 steps
FLAT_CONTROL = "experiments/control/9room/gcp_sequential/mod_hyper.py"
SEQ_CONF = ROOT / "experiments/prediction/9room/gcp_sequential"
BASELINE_TASKS = 1
VMPC_CANDIDATES, VMPC_ITERS, VMPC_REPLAN = 50, 3, 50  # CEM batch, iterations, env steps
BC_NORMS_PER_STEP = K1_PER_BC_ACTION = 10  # the sequence (or I_0) and I_g, no decoder
# a VMPC train step's K2: its encoding of the sequence reaches no loss (the
# posterior head is zero-width, nz_vae = 0, and the auxiliary models read it
# detached), so only I_0's and I_g's 5 + 5 and the decoder's 5 norms get a
# gradient; its forward runs all 20 K1
VMPC_PER_STEP = (NORMS_PER_STEP, 15, 0)
CONV_LSTM_B = 2  # the ConvLSTM forward held card vs CPU
TOL_ACTION = 1e-4  # one closed-loop action, card vs CPU (tests/test_torch_planning.py)
# the dist phase: torchrun of the trainer over NCCL on up to 4 cards
# (9room/gcp_tree with ep74, 4 steps: 32 random sequences x
# epoch_cycles_train 2 / B=16); one data-parallel step and one dp x fsdp
# step of the 25-room flagship (untied, L=8, 512x3 split_linear TreeLSTM,
# T=200) on 2 ranks, which share the card over gloo when there is one; a
# plan call of 100 candidates split over the cards
DIST_MAX_CARDS, DIST_STEPS = 4, 4
FLAGSHIP_CONF = ROOT / "experiments/prediction/25room/gcp_tree"
FLAGSHIP_T, FLAGSHIP_NODES = 200, 2 ** 8 - 1  # its max_seq_len; L=8
DIST_TIMEOUT_S = 300  # each launch of ranks
# the h5 phase: nav_9rooms from the PRM expert (T=100, 128x128 frames, one
# trajectory a file); the global split 0.994 / 0.006 keeps 39 of 40 files
# for training (4 batches of 16 an epoch at epoch_cycles_train 2) and 1 for val
H5_DATA_GEN = "experiments/data_gen/nav_9rooms/mod_hyper.py"
H5_FILES, H5_EPOCHS = 40, 2  # epoch 0 with a cold render cache, epoch 1 warm
H5_CONFS = (("gcp_tree", CONF), ("gcp_sequential", ROOT / "experiments/prediction/9room/gcp_sequential"))
H5_LAYOUT = {"actions": ((100, 2), "float64"), "images": ((101, 1, 128, 128, 3), "uint8"),
             "pad_mask": ((101,), "float64"), "states": ((101, 5), "float64")}
# the 25room phase: the paper's 25-room long-horizon path. nav_25rooms from the
# PRM expert (T=200, 128x128 frames, one trajectory a file, 33 of the
# config's 1000 by ROOM25_GEN_WORKERS spawned workers); the global split 0.994
# / 0.006 keeps 32 files for training (4 batches of 16 at epoch_cycles_train
# 2) and 1 for val. The 25-room flagship (untied, L=8, a 512x3 TreeLSTM)
# trains one epoch from them, then one task (T=400 env steps, of the
# benchmark's 100) of each 25-room control config plans from its checkpoint
ROOM25_DATA_GEN = "experiments/data_gen/nav_25rooms/mod_hyper.py"
ROOM25_CONF = "experiments/prediction/25room/gcp_tree/conf.py"
ROOM25_CONTROL = {"gcp_tree": "experiments/control/25room/gcp_tree/mod_hyper.py",
                  "gcp_sequential": "experiments/control/25room/gcp_sequential/mod_hyper.py"}
# the start/goal configurations of the 25-room tasks: nav_9rooms_start_goal's
# config (the PRM expert, raw PNGs) in the 25-room maze at nav_25rooms' T
ROOM25_START_GOAL = {"'n_rooms': 9,": "'n_rooms': 25,", "T=100,": "T=200,",
                     "'/nav_9rooms/start_goal_configs'": "'/nav_25rooms/start_goal_configs'"}
ROOM25_FILES, ROOM25_GEN_WORKERS, ROOM25_STEPS = 33, 8, 4
ROOM25_ENV_T, ROOM25_N_ROOMS = 400, 25
ROOM25_VAL_PASS = FINETUNE_VAL_PASS  # val step 20, logged prior 15, posterior 20
ROOM25_LAYOUT = {"actions": ((200, 2), "float64"), "images": ((201, 1, 128, 128, 3), "uint8"),
                 "pad_mask": ((201,), "float64"), "states": ((201, 5), "float64")}
ROOM25_VS_CPU_CANDIDATES = 2  # the first simulator call's candidates held card vs CPU
# K1 and K2 at the 25room phase's sites: the flagship's train step (the
# encoder on 16 x 200 frames and on the 16 start and goal frames, the decoder
# on 16 x 255 nodes; its val pass has the same) and the 25-room control
# path's simulator calls (the encoder on n candidates, the decoder on n x 255
# nodes) and actions (n = 1)
ROOM25_K2_SHAPES = ([(n,) + s for n in (TRAIN_B * FLAGSHIP_T, TRAIN_B) for s in ENC_SITES]
                    + [(TRAIN_B * FLAGSHIP_NODES,) + s for s in DEC_SITES])
ROOM25_K1_SHAPES = ROOM25_K2_SHAPES + [
    (n * FLAGSHIP_NODES,) + s for n in CONTROL_CANDIDATES for s in DEC_SITES]
# the long phase: the 500-frame horizon. nav_25rooms_long from the PRM expert
# (T=500, 64x64 frames stored, variable lengths padded to 501, one trajectory
# a file; LONG_FILES of the config's 400): the global split 0.97 / 0.03 keeps
# 16 of 17 files for training, one epoch of 4 batches of 16 at
# epoch_cycles_train 4, and 1 for val, whose batch of 1 is the Evaluator's.
# 25room_long/gcp_tree (tied, L=9, 511 nodes) and 25room_long/gcp_sequential
# (the VRNN over 499 steps) train from them; the tree's checkpoint is swept
# across both horizons (nav_9rooms, the h5 phase's, at T=100 and L=7) and
# evaluated top-of-100 under 'pruned_dtw'
LONG_DATA_GEN = "experiments/data_gen/nav_25rooms_long/mod_hyper.py"
LONG_CONFS = {"gcp_tree": "experiments/prediction/25room_long/gcp_tree/conf.py",
              "gcp_sequential": "experiments/prediction/25room_long/gcp_sequential/conf.py"}
LONG_FILES, LONG_CONFIG_FILES, LONG_STEPS = 17, 400, 4
LONG_T, LONG_NODES = 500, 2 ** 9 - 1  # max_seq_len; L=9
LONG_LAYOUT = {"actions": ((500, 2), "float64"), "images": ((501, 1, 64, 64, 3), "uint8"),
               "pad_mask": ((501,), "float64"), "states": ((501, 5), "float64")}
LONG_EVAL_B = 1  # the val split's one file: the Evaluator's batch
LONG_SWEEP = (("nav_9rooms", 100, 7), ("nav_25rooms_long", LONG_T, 9))  # (name, T, L)
# launches of a val pass: the val step's 20 K1, the logged prior sample's 15
# and the logged posterior pass's 20 (both models); the sweep makes one at
# each horizon
LONG_VAL_PASS = FINETUNE_VAL_PASS
H5_SWEEP_FILES = 2  # --long-only: nav_9rooms files for the sweep's val split of 1
# K1 and K2 at the long phase's sites: both models' train steps (the encoder
# on 16 x 500 frames and on the 16 start and goal frames; the tree's decoder
# on 16 x 511 nodes, the VRNN's on 16 x 499 frames); K1 also at the val and
# Evaluator batch of 1 (the encoder on 500 frames, the decoders on 511 nodes
# and 499 frames) and the sweep's at T=100 (100 frames; 127 nodes)
LONG_K2_SHAPES = ([(n,) + s for n in (TRAIN_B * LONG_T, TRAIN_B) for s in ENC_SITES]
                  + [(n,) + s for n in (TRAIN_B * LONG_NODES, TRAIN_B * (LONG_T - 1))
                     for s in DEC_SITES])
LONG_K1_SHAPES = LONG_K2_SHAPES + [
    (n,) + s for n in (LONG_EVAL_B * LONG_T, LONG_EVAL_B, TRAIN_T) for s in ENC_SITES] + [
    (n,) + s for n in (LONG_EVAL_B * LONG_NODES, LONG_EVAL_B * (LONG_T - 1), N_NODES)
    for s in DEC_SITES]
# the top shape of each path, where the K1 phase also times the plain twin
# and the library call (the rows PERF.md's kernel table cites): the plan
# call, the B=16 rollout, bench.py's bf16 decode, the control path,
# gcp_sequential's training, VMPC's simulator call, the 25-room control
# path's and training's decoders, and the 500-frame tree's decoder
K1_COMPARED = [((n, 32, 32, 16), "float32") for n in (
    CEM_BATCH * N_NODES, ROLLOUT_BATCH * N_NODES, CONTROL_CANDIDATES[0] * N_NODES,
    SEQ_DEC_BATCH, VMPC_CANDIDATES * (TRAIN_T - 1), CONTROL_CANDIDATES[0] * FLAGSHIP_NODES,
    TRAIN_B * FLAGSHIP_NODES, TRAIN_B * LONG_NODES)] + [((32 * 511, 64, 64, 16), "bfloat16")]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_name_and_power_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(torch, fn, reps=25, warmup=3):
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(torch, fn, tags, reps=10, tries=3):
    """The kernel's own device time per call, from torch.profiler: the sum
    over the kernels whose name holds one of `tags` (every kernel for None);
    None when the trace holds no such kernel `tries` times over (the
    profiler drops a trace now and then)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (tags is None or any(t in e.key for t in tags)))
        if us > 0:
            return us / reps / 1e3
    return None


def device_ms_each(torch, calls, n_cases, tags, reps=10, tries=3):
    """Each case's kernel device time per call, from one torch.profiler
    session over all the cases (a session per case took most of the K1
    phase's time): `calls()` yields each case's call, made
    anew from the phase's seed; it runs once to warm up, then `reps` times,
    and the kernels whose name holds one of `tags` (one a call) are split
    in launch order. Nones when a trace lost kernels `tries` times over."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in calls():
                for _ in range(reps + 1):
                    fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and any(t in e.name for t in tags)),
                         key=lambda e: e.time_range.start)
        if len(kernels) == n_cases * (reps + 1):
            return [sum(e.time_range.elapsed_us() for e in kernels[i + 1:i + reps + 1])
                    / reps / 1e3 for i in range(0, len(kernels), reps + 1)]
    return [None] * n_cases


def kernels_per_call(torch, fn, reps=5):
    """Device kernels (and memsets or copies) per call of fn, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def fmt(v):
    return "n/m" if v is None else f"{v:.4f}"


def host_us(torch, fn, reps=50, rounds=3):
    """Host time per call of the wrapper: `reps` calls issued back to back
    and timed without waiting for the card; the best of `rounds`."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return best


def in_turns(torch, new, old, reps=25):
    """Times `new` and `old` in turns (new, old, old, new): the mean of each
    pair."""
    a = time_ms(torch, new, reps)
    b = time_ms(torch, old, reps) + time_ms(torch, old, reps)
    return (a + time_ms(torch, new, reps)) / 2, b / 2


def load_parent(parent, cuda_build, name):
    """The wrapper module `name` (fused_gn or soft_dtw) of another checkout
    of the port (an earlier commit unpacked under video_gcp_torch/_build/),
    for times taken in turns with this one. Its SOURCE becomes the absolute
    path of that checkout's source, so that cuda_build builds and loads the
    kernels from it (here, ahead of the first launch)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"parent_{name}", parent / f"video_gcp_torch/ops/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    mod.SOURCE = str(parent / "video_gcp_torch/csrc" / mod.SOURCE)
    cuda_build.build(mod.SOURCE)
    return mod


# kernel names in profiler traces; an earlier checkout's K2 (--parent) ends
# with a second, reducing kernel
K1_TAGS, K2_TAGS = ("gn_lrelu_fwd",), ("gn_lrelu_bwd", "gn_bwd_param_reduce")
K3_TAGS = ("soft_dtw_kernel",)
K4_TAGS = ("dtw_align_kernel",)


def path_sums(tag, rows, keys, paths):
    """Sums of `keys` over the norm sites of each of `paths`, in f32 and
    (as `<path>_bf16`) in bf16: a plan call's 15 launches, a B=16
    rollout's 15, a train step's 20 (the tree's and the sequential
    model's)."""
    by = {(tuple(r["shape"]), r["dtype"]): r for r in rows}

    def sites(dec_batch, enc_calls):  # enc_calls: (batch, calls) of the encoder
        out = [((b,) + s) for b, k in enc_calls for s in ENC_SITES for _ in range(k)]
        return out + [(dec_batch,) + s for s in DEC_SITES]

    sites_of = dict(plan_call=sites(CEM_BATCH * N_NODES, [(CEM_BATCH, 2)]),
                 rollout=sites(ROLLOUT_BATCH * N_NODES, [(ROLLOUT_BATCH, 2)]),
                 train_step=sites(TRAIN_B * N_NODES, [(TRAIN_B * TRAIN_T, 1), (TRAIN_B, 2)]),
                 train_step_sequential=sites(SEQ_DEC_BATCH,
                                             [(TRAIN_B * TRAIN_T, 1), (TRAIN_B, 2)]),
                 room25_sim_call=sites(CONTROL_CANDIDATES[0] * FLAGSHIP_NODES,
                                       [(CONTROL_CANDIDATES[0], 2)]),
                 train_step_room25=sites(TRAIN_B * FLAGSHIP_NODES,
                                         [(TRAIN_B * FLAGSHIP_T, 1), (TRAIN_B, 2)]),
                 train_step_long=sites(TRAIN_B * LONG_NODES,
                                       [(TRAIN_B * LONG_T, 1), (TRAIN_B, 2)]),
                 train_step_long_sequential=sites(TRAIN_B * (LONG_T - 1),
                                                  [(TRAIN_B * LONG_T, 1), (TRAIN_B, 2)]))
    out = {}
    for path in paths:
        for dtype, name in (("float32", path), ("bfloat16", f"{path}_bf16")):
            have = [by.get((s, dtype)) for s in sites_of[path]]
            if all(have):
                out[name] = {k: sum(r[k] for r in have) for k in keys
                             if all(r.get(k) is not None for r in have)}
                out[name]["launches"] = len(have)
                print(f"{tag} sum over a {path} ({len(have)} launches, {dtype}): "
                      + " ".join(f"{k} {v:.4f}" for k, v in out[name].items()
                                 if k != "launches"))
    return out


def bound_by(bound_s, flops):
    """A bound of gcpbench.yardstick in ms, and what sets it: the kernel's
    `flops` when they take that long, else its bytes."""
    return bound_s * 1e3, "operations" if flops / F32_FLOPS_PER_S >= bound_s else "bytes"


def dist_kernel_shapes(torch):
    """The f32 K1 and K2 shapes of the dist phase, which follow the number
    of cards (dist_layout): the rows per rank of (a) the trainer, (b) the
    data-parallel step and (c) the flagship's dp x fsdp step, each at its
    encoder's sequence (rows x T), I_0 and I_g (rows) and decoder (rows x
    nodes) sites; K1 also at (d)'s split plan call, per chunk. Returns the
    K1 shapes and the K2 (training) shapes."""
    cards, trainer_w, steps_w, _ = dist_layout(torch)
    chunk = -(-CEM_BATCH // (min(cards, DIST_MAX_CARDS) if cards > 1 else 2))
    train = set()
    for rows, t, nodes in ((TRAIN_B // trainer_w, TRAIN_T, N_NODES),
                           (TRAIN_B // steps_w, TRAIN_T, N_NODES),
                           (TRAIN_B // (steps_w // 2), FLAGSHIP_T, FLAGSHIP_NODES)):
        train |= {(n,) + s for n in (rows * t, rows) for s in ENC_SITES}
        train |= {(rows * nodes,) + s for s in DEC_SITES}
    plan = {(chunk,) + s for s in ENC_SITES} | {(chunk * N_NODES,) + s for s in DEC_SITES}
    return sorted(train | plan), sorted(train)


def kernel_phase(torch, F, fused_gn, parent=None):
    cases = []
    for batch in (ROLLOUT_BATCH, CEM_BATCH, TRAIN_B * TRAIN_T):
        cases += [((batch,) + s, d) for s in ENC_SITES for d in ("float32", "bfloat16")]
        if batch != TRAIN_B * TRAIN_T:  # the train step decodes B=16 trees
            cases += [((batch * N_NODES,) + s, d) for s in DEC_SITES
                      for d in ("float32", "bfloat16")]
    cases += [((SEQ_DEC_BATCH,) + s, "float32") for s in DEC_SITES]  # gcp_sequential
    cases.append(((32 * 511, 64, 64, 16), "bfloat16"))  # bench.py top decode level
    for n in CONTROL_CANDIDATES:  # the control path's simulator calls and actions
        cases += [((n,) + s, "float32") for s in ENC_SITES]
        cases += [((n * N_NODES,) + s, "float32") for s in DEC_SITES]
    # VMPC's simulator call: the encoder on its candidates, the decoder on
    # their T - 1 frames each
    cases += [((VMPC_CANDIDATES,) + s, "float32") for s in ENC_SITES]
    cases += [((VMPC_CANDIDATES * (TRAIN_T - 1),) + s, "float32") for s in DEC_SITES]
    cases += [(s, "float32") for s in dict.fromkeys(dist_kernel_shapes(torch)[0]
                                                   + ROOM25_K1_SHAPES + LONG_K1_SHAPES)
              if (s, "float32") not in cases]  # the dist phase's ranks and chunks, 25room, long
    groups = 8

    def inputs(gen, shape, dtype):
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(getattr(torch, dtype))
        scale = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
        return x, scale, torch.randn(c, generator=gen, device="cuda") * 0.1

    def calls():  # the same inputs again, for the device times
        gen = torch.Generator("cuda").manual_seed(0)
        for shape, dtype in cases:
            x, scale, bias = inputs(gen, shape, dtype)
            yield lambda: fused_gn.fused_group_norm_lrelu(x, scale, bias, groups)

    gen = torch.Generator("cuda").manual_seed(0)
    part_s = dict(check=0.0, events=0.0, host=0.0, compared=0.0, free=0.0)  # seconds
    rows = []
    for shape, dtype in cases:
        dt = getattr(torch, dtype)
        t0 = time.perf_counter()
        x, scale, bias = inputs(gen, shape, dtype)
        got = fused_gn.fused_group_norm_lrelu(x, scale, bias, groups)
        want = fused_gn.gn_lrelu_reference(x, scale, bias, groups)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err = err.max().item()
        if dtype == "bfloat16":
            ok = bool((err <= TOLS_KERNEL[dtype] * want.float().abs().clamp(min=1)).all())
        else:
            ok = max_err < TOLS_KERNEL[dtype]
        if not ok:
            fail(f"K1 disagrees with its twin at {shape} {dtype}: max err {max_err}")
        del got, want, err
        x_nchw = x.permute(0, 3, 1, 2)  # the same memory, channels_last
        run = lambda: fused_gn.fused_group_norm_lrelu(x, scale, bias, groups)  # noqa: E731
        row = dict(shape=list(shape), dtype=dtype)
        t1 = time.perf_counter()
        if parent:
            old = lambda: parent.fused_group_norm_lrelu(x, scale, bias, groups)  # noqa: E731
            row["ms"], row["parent_ms"] = in_turns(torch, run, old)
            row["parent_device_ms"] = device_ms(torch, old, K1_TAGS)
            row["parent_host_us"] = host_us(torch, old)
            row["device_ms"] = device_ms(torch, run, K1_TAGS)
        else:
            row["ms"] = time_ms(torch, run)
        t2 = time.perf_counter()
        row["host_us"] = host_us(torch, run)
        t3 = time.perf_counter()
        row["plain_ms"] = row["library_ms"] = None
        if (shape, dtype) in K1_COMPARED:
            row["plain_ms"] = time_ms(torch, lambda: fused_gn.gn_lrelu_reference(
                x, scale, bias, groups))
            row["library_ms"] = time_ms(torch, lambda: F.leaky_relu(
                F.group_norm(x_nchw, groups, scale.to(dt), bias.to(dt), eps=1e-6), 0.2))
        t4 = time.perf_counter()
        row["bound_ms"], row["bound_by"] = bound_by(
            yardstick.k1_bound_s(shape, x.element_size()),
            yardstick.GN_FLOPS_PER_ELEMENT * math.prod(shape))
        row["max_abs_err"] = max_err
        rows.append(row)
        del x, x_nchw
        torch.cuda.empty_cache()
        for part, (a, b) in dict(check=(t0, t1), events=(t1, t2), host=(t2, t3),
                                 compared=(t3, t4), free=(t4, time.perf_counter())).items():
            part_s[part] += b - a
    if not parent:
        t0 = time.perf_counter()
        for row, ms in zip(rows, device_ms_each(torch, calls, len(cases), K1_TAGS)):
            row["device_ms"] = ms
        part_s["profiler"] = time.perf_counter() - t0
    print("K1 gn_lrelu_fwd: shape dtype | ms device_ms plain_ms library_ms bound_ms | "
          "host_us | max_abs_err" + (" | parent: ms device_ms host_us" if parent else ""))
    for row in rows:
        print(f"K1 {row['shape']} {row['dtype']} | {row['ms']:.4f} {fmt(row['device_ms'])} "
              f"{fmt(row['plain_ms'])} {fmt(row['library_ms'])} {row['bound_ms']:.4f} | "
              f"{row['host_us']:.1f} | {row['max_abs_err']:.3e}"
              + (f" | {row['parent_ms']:.4f} {fmt(row['parent_device_ms'])} "
                 f"{row['parent_host_us']:.1f}" if parent else ""))
    sums = path_sums("K1", rows, ("ms", "device_ms", "bound_ms", "parent_ms", "parent_device_ms"),
                     ("plan_call", "rollout", "train_step", "train_step_sequential",
                      "room25_sim_call", "train_step_room25", "train_step_long",
                      "train_step_long_sequential"))
    print(f"K1: {len(rows)} shapes checked against the twin and timed, the twin and "
          f"F.group_norm at the {len(K1_COMPARED)} top shapes only; seconds by part "
          + json.dumps({k: round(v, 2) for k, v in part_s.items()}))
    return rows, sums


def k2_phase(torch, F, fused_gn, parent=None):
    """K2 against its twin, and its times, at the training shapes (the
    dist phase's ranks' among them)."""
    groups = 8
    shapes = K2_SHAPES + [(s, "float32") for s in dict.fromkeys(
        dist_kernel_shapes(torch)[1] + ROOM25_K2_SHAPES + LONG_K2_SHAPES)
        if (s, "float32") not in K2_SHAPES]

    def inputs(gen, shape, dtype):
        dt, c = getattr(torch, dtype), shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dt)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dt)
        scale = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
        bias = torch.randn(c, generator=gen, device="cuda") * 0.1
        return fused_gn.clear_of_kink(x, scale, bias, groups), dy, scale, bias

    def calls():  # the same inputs again, for the device times
        gen = torch.Generator("cuda").manual_seed(1)
        for shape, dtype in shapes:
            x, dy, scale, bias = inputs(gen, shape, dtype)
            yield lambda: fused_gn.gn_lrelu_bwd(x, dy, scale, bias, groups)

    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    for shape, dtype in shapes:
        dt = getattr(torch, dtype)
        x, dy, scale, bias = inputs(gen, shape, dtype)
        got = fused_gn.gn_lrelu_bwd(x, dy, scale, bias, groups)
        want = fused_gn.gn_lrelu_bwd_reference(x, dy, scale, bias, groups)
        torch.cuda.synchronize()
        errs, abs_err = [], 0.0
        for g, w in zip(got, want):
            w = w.float()
            d = (g.float() - w).abs().max().item()
            abs_err = max(abs_err, d)
            errs.append(d / max(1.0, w.abs().max().item()))
        tols = (TOLS_KERNEL[dtype], TOLS_KERNEL["float32"], TOLS_KERNEL["float32"])
        if not all(e < t for e, t in zip(errs, tols)):
            fail(f"K2 disagrees with its twin at {shape} {dtype}: {errs}")
        del got, want
        run = lambda: fused_gn.gn_lrelu_bwd(x, dy, scale, bias, groups)  # noqa: E731
        row = dict(shape=list(shape), dtype=dtype)
        if parent:
            old = lambda: parent.gn_lrelu_bwd(x, dy, scale, bias, groups)  # noqa: E731
            row["ms"], row["parent_ms"] = in_turns(torch, run, old)
            row["parent_device_ms"] = device_ms(torch, old, K2_TAGS)
            row["parent_host_us"] = host_us(torch, old)
            row["device_ms"] = device_ms(torch, run, K2_TAGS)
        else:
            row["ms"] = time_ms(torch, run)
        row["host_us"] = host_us(torch, run)
        row["plain_ms"] = time_ms(torch, lambda: fused_gn.gn_lrelu_bwd_reference(
            x, dy, scale, bias, groups))
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()  # channels_last view
        wl, bl = (p.to(dt).detach().requires_grad_() for p in (scale, bias))
        yl = F.leaky_relu(F.group_norm(xl, groups, wl, bl, eps=1e-6), 0.2)
        dyl = dy.permute(0, 3, 1, 2)
        row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            yl, (xl, wl, bl), dyl, retain_graph=True))
        row["bound_ms"], row["bound_by"] = bound_by(
            yardstick.k2_bound_s(shape, x.element_size()),
            yardstick.K2_FLOPS_PER_ELEMENT * math.prod(shape))
        row["max_abs_err"], row["errs"] = abs_err, errs
        rows.append(row)
        del x, dy, xl, wl, bl, yl, dyl
        torch.cuda.empty_cache()
    if not parent:
        for row, ms in zip(rows, device_ms_each(torch, calls, len(shapes), K2_TAGS)):
            row["device_ms"] = ms
    print("K2 gn_lrelu_bwd: shape dtype | ms device_ms plain_ms library_ms bound_ms | "
          "host_us | max err dx dscale dbias (relative to max(1, |ref|))"
          + (" | parent: ms device_ms host_us" if parent else ""))
    for row in rows:
        errs = row.pop("errs")
        print(f"K2 {row['shape']} {row['dtype']} | {row['ms']:.4f} {fmt(row['device_ms'])} "
              f"{row['plain_ms']:.4f} {row['library_ms']:.4f} {row['bound_ms']:.4f} | "
              f"{row['host_us']:.1f} | {errs[0]:.3e} {errs[1]:.3e} {errs[2]:.3e}"
              + (f" | {row['parent_ms']:.4f} {fmt(row['parent_device_ms'])} "
                 f"{row['parent_host_us']:.1f}" if parent else ""))
    sums = path_sums("K2", rows, ("ms", "device_ms", "bound_ms", "parent_ms", "parent_device_ms"),
                     ("train_step", "train_step_sequential", "train_step_room25",
                      "train_step_long", "train_step_long_sequential"))
    return rows, sums


def k3_bound(b, r, c):
    cells = b * r * c
    t_bytes = 2 * cells * 4 / HBM_BYTES_PER_S  # read C once, write w once
    t_ops = K3_OPS_PER_CELL * cells / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k3_parent_check(torch, parent, cost, ends, got):
    """This checkout's F, Bk and w against the earlier checkout's K3: the DP
    values bit for bit."""
    w_old, f_old, bk_old = parent.k3(cost, ends, return_dp=True)
    torch.cuda.synchronize()
    same = (torch.equal(got[1], f_old), torch.equal(got[2], bk_old))
    w_err = (got[0] - w_old).abs().max().item()
    if not all(same) or not w_err < TOL_K3_PARENT:
        fail(f"K3 at {list(cost.shape)} against the parent: F, Bk bitwise equal {same}, "
             f"w differs by {w_err}")
    return w_err


def k3_phase(torch, soft_dtw, parent=None):
    """K3 against its row twin on the card, and the times of the kernel,
    the whole soft_dtw() call and the twin."""
    bad = soft_dtw.log1p_mismatches("cuda")
    print(f"K3 log1p: {bad} floats in [0, 1] where the kernel's log1p differs from log1pf")
    if bad:
        fail("K3's log1p differs from the CUDA library's log1pf")
    gen = torch.Generator("cuda").manual_seed(2)
    rows_out = []
    print("K3 soft_dtw: [B, r, c] | ms device_ms call_ms plain_ms bound_ms | r us_per_row | "
          "host_us kernels_per_call | max err w, F, Bk (relative to max(1, |D|))"
          + (" | parent soft_dtw(): call_ms device_ms host_us kernels_per_call, "
             "its K3's device_ms, max |w - parent w|" if parent else ""))
    for b, r, c in K3_SHAPES:
        cost = torch.rand(b, r, c, generator=gen, device="cuda") * 2
        ends = torch.tensor([c - 1, int(c * 0.7), int(c * 0.4)], device="cuda")
        ends = ends[torch.arange(b, device="cuda") % 3]  # mixed ends
        got = soft_dtw.k3(cost, ends, return_dp=True)
        want = soft_dtw.soft_dtw_rows_reference(cost, ends, return_dp=True)
        torch.cuda.synchronize()
        d_err = []
        for d, ref in zip(got[1:], want[1:]):
            finite = ref > soft_dtw.NEG_INF / 2
            if not torch.equal(d > soft_dtw.NEG_INF / 2, finite) or not torch.isfinite(d).all():
                fail(f"K3 at {[b, r, c]}: the alignment region differs from the twin's")
            d_err.append(((d - ref).abs()[finite] / ref.abs()[finite].clamp(min=1)).max().item())
        w = got[0]
        w_err = (w - want[0]).abs().max().item()
        past = max(w[k, :, int(ends[k]) + 1:].abs().sum().item() for k in range(b))
        if not (max(d_err) < TOL_K3 and w_err < TOL_K3 and past < 1e-6):
            fail(f"K3 disagrees with its twin at {[b, r, c]}: F, Bk {d_err}, w {w_err}, "
                 f"mass past the ends {past}")
        del got, want
        kernel = lambda: soft_dtw.k3(cost, ends)  # noqa: E731
        call = lambda: soft_dtw.soft_dtw(cost, ends)  # noqa: E731
        row = dict(shape=[b, r, c], dtype="float32")
        if parent:
            row["parent_w_err"] = k3_parent_check(
                torch, parent, cost, ends, soft_dtw.k3(cost, ends, return_dp=True))
            old = lambda: parent.soft_dtw(cost, ends)  # noqa: E731
            row["call_ms"], row["parent_call_ms"] = in_turns(torch, call, old)
            row["parent_kernel_device_ms"] = device_ms(
                torch, lambda: parent.k3(cost, ends), K3_TAGS)
            row["parent_device_ms"] = device_ms(torch, old, None)
            row["parent_host_us"] = host_us(torch, old)
            row["parent_kernels_per_call"] = kernels_per_call(torch, old)
        else:
            row["call_ms"] = time_ms(torch, call)
        row["kernels_per_call"] = kernels_per_call(torch, call)
        row["ms"] = time_ms(torch, kernel)
        row["device_ms"] = device_ms(torch, kernel, K3_TAGS)
        row["host_us"] = host_us(torch, call)
        row["plain_ms"] = time_ms(torch, lambda: soft_dtw.soft_dtw_rows_reference(cost, ends))
        row["library_ms"] = None  # no PyTorch call computes this DP
        row["bound_ms"], row["bound_by"] = k3_bound(b, r, c)
        row["max_abs_err"] = w_err
        row["dependent_rows"] = r
        rows_out.append(row)
        per_row = row["device_ms"] or row["ms"]
        print(f"K3 {[b, r, c]} | {row['ms']:.4f} {fmt(row['device_ms'])} {row['call_ms']:.4f} "
              f"{row['plain_ms']:.4f} {row['bound_ms']:.5f} | {r} {per_row * 1e3 / r:.4f} | "
              f"{row['host_us']:.1f} {row['kernels_per_call']:g} | {w_err:.3e} {d_err[0]:.3e} "
              f"{d_err[1]:.3e}"
              + (f" | {row['parent_call_ms']:.4f} {fmt(row['parent_device_ms'])} "
                 f"{row['parent_host_us']:.1f} {row['parent_kernels_per_call']:g}, "
                 f"{fmt(row['parent_kernel_device_ms'])}, {row['parent_w_err']:.3e}"
                 if parent else ""))
        del cost, ends, w
        torch.cuda.empty_cache()
    return rows_out


def dtw_rows(torch, dtw, shapes, tag):
    """`batched_dtw_alignment` (K4) on the card against the twin on the CPU
    at each [B, r, c] of `shapes`, random costs with mixed ends: node
    indices, D and distances bit for bit; then its times (phase 4b).
    Returns the rows."""
    gen = torch.Generator("cuda").manual_seed(4)
    rows_out = []
    print(f"{tag} batched_dtw_alignment: [B, r, c] | ms device_ms plain_ms bound_ms | "
          "r+c-1 us_per_step | host_us kernels_per_call")
    for b, r, c in shapes:
        cost = torch.rand(b, r, c, generator=gen, device="cuda")
        ends = torch.tensor([c - 1, int(c * 0.806), int(c * 0.434), 0], device="cuda")
        ends = ends[torch.arange(b, device="cuda") % 4]  # mixed ends
        inds, dist, D = (t.cpu() for t in dtw.k4(cost, ends, return_dp=True))
        want_inds, want_dist = dtw.alignment_reference(cost.cpu(), ends.cpu())
        same = dict(inds=torch.equal(inds, want_inds),
                    D=torch.equal(D, dtw.min_cumsum(cost.cpu())), dist=torch.equal(dist, want_dist))
        if not all(same.values()):
            fail(f"{tag}: K4 against its twin at {[b, r, c]}: equal {same}")
        del inds, dist, D, want_inds, want_dist
        call = lambda: dtw.batched_dtw_alignment(cost, ends)  # noqa: E731
        row = dict(shape=[b, r, c], dtype="float32", max_abs_err=0.0, library_ms=None)
        row["ms"] = time_ms(torch, call)
        row["device_ms"], = device_ms_each(torch, lambda: [call], 1, K4_TAGS)
        row["plain_ms"] = time_ms(torch, lambda: dtw.alignment_reference(cost, ends),
                                  reps=3, warmup=1)
        row["host_us"] = host_us(torch, call)
        row["kernels_per_call"] = kernels_per_call(torch, call)
        row["bound_ms"], row["bound_by"] = (
            yardstick.dtw_bytes(b, r, c) / HBM_BYTES_PER_S * 1e3, "bytes")
        row["chain_steps"] = r + c - 1
        rows_out.append(row)
        per_step = (row["device_ms"] or row["ms"]) * 1e3 / row["chain_steps"]
        print(f"{tag} {[b, r, c]} | {row['ms']:.4f} {fmt(row['device_ms'])} "
              f"{row['plain_ms']:.4f} {row['bound_ms']:.5f} | {r + c - 1} {per_step:.4f} | "
              f"{row['host_us']:.1f} {row['kernels_per_call']:g}")
    return rows_out


def k4_phase(torch, dtw):
    from video_gcp_torch.evaluation.evaluator import Evaluator

    rows = dtw_rows(torch, dtw, K4_SHAPES, "K4")
    n_samples = 100 + Evaluator.N_PLOTTED_ELEMENTS
    for row in rows:
        if row["shape"][1:] == [LONG_NODES, LONG_T]:
            print(f"K4 batched_dtw_alignment x {n_samples} in a top-of-100 batch of the "
                  f"Evaluator at B={row['shape'][0]}: {n_samples * row['ms']:.2f} ms")
    return rows


def max_diff(a, b):
    return (a.detach().float().cpu() - b.detach().float().cpu()).abs().max().item()


def check_against_cpu(torch, cpu_model, card_in, card_out, phase, keys):
    """Runs the first 2 samples of `card_in` through the port on the CPU
    and holds `card_out`'s first 2 samples against it (TOLS_SLICE)."""
    cpu_in = {k: card_in[k][:2].cpu() for k in ("I_0", "I_g", "z")}
    cpu_in["end_ind"] = card_out.end_ind[:2].cpu()
    with torch.inference_mode():
        ref = cpu_model(type(card_in)(cpu_in), phase=phase, mode="prior")
    diffs = {}
    for k in keys:
        got = card_out.tree[k] if k in ("images", "e_g_prime") else card_out[k]
        want = ref.tree[k] if k in ("images", "e_g_prime") else ref[k]
        diffs[k] = max_diff(got[:2], want)
        if not diffs[k] < TOLS_SLICE[k]:
            fail(f"card vs CPU ({phase}): {k} differs by {diffs[k]} "
                 f"(tolerance {TOLS_SLICE[k]})")
    decided = ref.existence_logits.abs() > TOLS_SLICE["existence_logits"]
    if not torch.equal(card_out.prune_keep[:2].cpu()[decided], ref.prune_keep[decided]):
        fail(f"card vs CPU ({phase}): prune_keep differs")
    print(f"slice: card vs CPU ({phase}), first 2 samples, max abs diff: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()}))


def slice_phase(torch, fused_gn, load_model, AttrDict):
    t0 = time.perf_counter()
    model = load_model(CONF, weights=WEIGHTS)  # on the card
    print(f"slice: load_model {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters())} params")
    gen = torch.Generator("cuda").manual_seed(0)

    def images(n):
        return torch.randint(0, 256, (n, 32, 32, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    def check_finite(out, keys):
        for k in keys:
            t = out.tree[k] if k in out.tree else out[k]
            if not torch.isfinite(t).all():
                fail(f"non-finite {k}")

    COUNTS["k1.launches"] = COUNTS["k2.launches"] = 0  # the serving path starts
    rollouts, calls, per_forward = [], [], []
    with torch.inference_mode():
        rollout_in = AttrDict(I_0=images(ROLLOUT_BATCH), I_g=images(ROLLOUT_BATCH),
                              end_ind=torch.full((ROLLOUT_BATCH,), 99, device="cuda"))
        for _ in range(2):  # the first call includes cuDNN's set-up
            rollout_in.z = torch.randn(ROLLOUT_BATCH, N_NODES, 256, generator=gen,
                                       device="cuda")
            before = COUNTS["k1.launches"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(rollout_in, phase="test", mode="prior", generator=gen)
            torch.cuda.synchronize()
            rollouts.append(time.perf_counter() - t0)
            per_forward.append(COUNTS["k1.launches"] - before)
            check_finite(out, ("images", "e_g_prime", "existence_logits"))
        if out.tree.images.shape != (ROLLOUT_BATCH, N_NODES, 32, 32, 3):
            fail(f"rollout images shape {tuple(out.tree.images.shape)}")

        start, goal = images(1), images(1)
        # the simulator repeats the current state and goal over the candidates
        plan_in = AttrDict(I_0=start.repeat(CEM_BATCH, 1, 1, 1),
                           I_g=goal.repeat(CEM_BATCH, 1, 1, 1))
        torch.cuda.reset_peak_memory_stats()
        for _ in range(CEM_ITERS):
            plan_in.z = torch.randn(CEM_BATCH, N_NODES, 256, generator=gen, device="cuda")
            before = COUNTS["k1.launches"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = model(plan_in, phase="plan", mode="prior", pred_length=True,
                         generator=gen)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            per_forward.append(COUNTS["k1.launches"] - before)
            check_finite(plan, ("images", "e_g_prime", "timeline_images",
                                "timeline_latents", "actions", "regressed_state"))
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = COUNTS["k1.launches"]
    if per_forward != [15] * (len(rollouts) + CEM_ITERS):
        fail(f"K1 launches per forward {per_forward}, expected 15 each")
    print(f"slice: K1 launches per forward {per_forward}")
    for i, s in enumerate(rollouts):
        print(f"slice: test/prior rollout {i} (B={ROLLOUT_BATCH}): {s * 1e3:.2f} ms, "
              f"{ROLLOUT_BATCH * N_NODES / s:.0f} decoded frames/s")
    for i, s in enumerate(calls):
        print(f"slice: plan call {i} ({CEM_BATCH} candidates): {s * 1e3:.2f} ms, "
              f"{CEM_BATCH * N_NODES / s:.0f} decoded frames/s")
    print(f"slice: peak device memory over the plan calls {peak_gib:.3f} GiB")

    # the last rollout and the last plan call against the port on the CPU
    cpu_model = load_model(CONF, weights=WEIGHTS, device="cpu")
    check_against_cpu(torch, cpu_model, rollout_in, out, "test",
                      ("images", "e_g_prime", "existence_logits"))
    check_against_cpu(torch, cpu_model, plan_in, plan, "plan", TOLS_SLICE)
    return launches, statistics.median(calls), model, cpu_model


def bf16_phase(torch, fused_gn, load_model, AttrDict, train_step_mod, f32_model,
               f32_train_model, dataset, DataLoader):
    """The serving and training paths with bf16 compute over float32
    parameters. The same calls and steps of the f32 models (ep74 from the
    slice phase, and the trainer's model) are timed first, the same way."""
    model = load_model(CONF, weights=WEIGHTS, compute_dtype=torch.bfloat16)
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        fail("bf16: parameters are not all float32")
    norm_dtypes = set()
    for m in model.modules():
        if type(m).__name__ == "GroupNorm":
            m.register_forward_pre_hook(lambda mod, args: norm_dtypes.add(args[0].dtype))
    gen = torch.Generator("cuda").manual_seed(16)

    def images(n):
        return torch.randint(0, 256, (n, 32, 32, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    roll_in = AttrDict(I_0=images(ROLLOUT_BATCH), I_g=images(ROLLOUT_BATCH),
                       end_ind=torch.full((ROLLOUT_BATCH,), 99, device="cuda"))
    plan_in = AttrDict(I_0=images(1).repeat(CEM_BATCH, 1, 1, 1),
                       I_g=images(1).repeat(CEM_BATCH, 1, 1, 1))

    def serve(m, calls):
        """`calls` timed B=16 rollouts, then as many plan calls: the seconds
        of each, the last rollout and K1's launches per forward."""
        secs, per_forward = dict(rollout=[], plan=[]), []
        with torch.inference_mode():
            for name, inp, kw in (("rollout", roll_in, dict(phase="test")),
                                  ("plan", plan_in, dict(phase="plan", pred_length=True))):
                for _ in range(calls):
                    inp.z = torch.randn(inp.I_0.shape[0], N_NODES, 256, generator=gen,
                                        device="cuda")
                    before = COUNTS["k1.launches"]
                    out, sec = timed(lambda: m(inp, mode="prior", generator=gen, **kw))
                    secs[name].append(sec)
                    per_forward.append(COUNTS["k1.launches"] - before)
                    for k in ("images", "e_g_prime"):
                        if out.tree[k].dtype != torch.float32 or not torch.isfinite(
                                out.tree[k]).all():
                            fail(f"{name}: {k} not finite float32")
                    if name == "rollout":
                        last_rollout = out
        return secs, last_rollout, per_forward

    f32_secs = serve(f32_model, BF16_WARM)[0]  # warm since the slice phase
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = 0  # the bf16 serving path starts
    secs, roll_out, per_forward = serve(model, 1 + BF16_WARM)  # cold, then warm
    serve_launches = COUNTS["k1.launches"]
    if per_forward != [15] * (2 + 2 * BF16_WARM) or norm_dtypes != {torch.bfloat16}:
        fail(f"bf16: K1 launches per forward {per_forward}, norm inputs {norm_dtypes}")

    # the last rollout's first 2 samples against the port in bf16 on the CPU
    cpu = load_model(CONF, weights=WEIGHTS, device="cpu", compute_dtype=torch.bfloat16)
    cpu_in = AttrDict({k: roll_in[k][:2].cpu() for k in ("I_0", "I_g", "z", "end_ind")})
    with torch.inference_mode():
        ref = cpu(cpu_in, phase="test", mode="prior")
    worst = {}
    for k, tol in TOLS_BF16_MEAN.items():
        for d in range(7):
            level = slice(2 ** d - 1, 2 ** (d + 1) - 1)
            diff = (roll_out.tree[k][:2, level].cpu() - ref.tree[k][:, level]).abs().mean().item()
            worst[k] = max(worst.get(k, 0.0), diff)
            if not diff < tol:
                fail(f"bf16: card vs CPU {k} level {d}: mean |diff| {diff} (tolerance {tol})")
    print(f"bf16: K1 launches per forward {per_forward}, all on bf16 x; card vs CPU (bf16), "
          f"first 2 samples, worst level's mean |diff|: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    for name, what in (("rollout", f"test/prior rollout (B={ROLLOUT_BATCH})"),
                       ("plan", f"plan call ({CEM_BATCH} candidates)")):
        f32, bf16 = statistics.median(f32_secs[name]), statistics.median(secs[name][1:])
        print(f"bf16: {what}, median of {BF16_WARM} warm calls: f32 {f32 * 1e3:.2f} ms, "
              f"bf16 {bf16 * 1e3:.2f} ms (cold {secs[name][0] * 1e3:.2f}); bf16 "
              f"{ROLLOUT_BATCH if name == 'rollout' else CEM_BATCH} * {N_NODES} / s "
              f"{(ROLLOUT_BATCH if name == 'rollout' else CEM_BATCH) * N_NODES / bf16:.0f} "
              f"decoded frames/s")

    # training: BF16_STEPS steps on the same batches, the f32 model's first
    loader = DataLoader(dataset, TRAIN_B, shuffle=True, n_repeat=2, num_workers=4,
                        device="cuda")
    batches = [b for _, b in zip(range(BF16_STEPS), loader)]

    def train(m):
        m.train()
        named = [(n, p) for n, p in m.named_parameters() if p.requires_grad]
        opt = train_step_mod.make_optimizer([p for _, p in named], "radam", 2e-4)
        steps, secs = [], []
        for i, batch in enumerate(batches):
            k1, k2 = COUNTS["k1.launches"], COUNTS["k2.launches"]
            met, sec = timed(lambda: train_step_mod.train_step(m, opt, batch, i, gen))
            secs.append(sec)
            steps.append((COUNTS["k1.launches"] - k1, COUNTS["k2.launches"] - k2))
            if not bool(met.grads_finite) or not all(torch.isfinite(v).all()
                                                     for v in met.values()):
                fail(f"train ({m.dtype}): non-finite metrics at step {i}")
        return named, steps, secs, met

    f32_secs = train(f32_train_model)[2]
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    before = [p.detach().clone() for _, p in named]
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = 0  # the bf16 training path starts
    norm_dtypes.clear()
    named, steps, secs, met = train(model)
    train_launches = (COUNTS["k1.launches"], COUNTS["k2.launches"])
    if set(steps) != {(NORMS_PER_STEP, NORMS_PER_STEP)} or norm_dtypes != {torch.bfloat16}:
        fail(f"bf16 train: K1/K2 launches per step {steps}, norm inputs {norm_dtypes}")
    if {p.dtype for _, p in named} != {torch.float32} or {
            p.grad.dtype for _, p in named} != {torch.float32}:
        fail("bf16 train: parameters or gradients are not float32")
    # ep74's existence BCE is saturated (~1e-9): its MLP's bf16 gradients are
    # rounding noise, far below RAdam's eps, and move nothing in 8 steps
    static = {n: p.grad.abs().max().item() for (n, p), b in zip(named, before)
              if torch.equal(p.detach(), b)}
    unchanged = [n for n, g in static.items() if g >= BF16_MOVE_GRAD]
    if unchanged:
        fail(f"bf16 train: parameters with a gradient did not change: {unchanged}")
    f32, warm = statistics.median(f32_secs[2:]), statistics.median(secs[2:])
    print(f"bf16 train: {BF16_STEPS} steps of B={TRAIN_B} T={TRAIN_T} on the same prefetched "
          f"batches, K1/K2 launches per step {steps[0]}; median of steps 2-{BF16_STEPS - 1}: "
          f"f32 {f32 * 1e3:.2f} ms, bf16 {warm * 1e3:.2f} ms (step 0 {secs[0] * 1e3:.2f}); "
          f"training frames/s f32 {TRAIN_B * TRAIN_T / f32:.1f}, bf16 "
          f"{TRAIN_B * TRAIN_T / warm:.1f}; total {met.total.item():.6g} at the last step; "
          f"parameters that did not move (largest |gradient| at the last step): "
          + json.dumps({n: float(f"{g:.3g}") for n, g in static.items()}))
    return serve_launches, train_launches


def eval_phase(torch, fused_gn, soft_dtw, model, cpu_model, dataset, DataLoader, AttrDict):
    """The top-of-100 Evaluator on the ep74 model, one B=16 val batch."""
    from video_gcp_torch.core.metrics import mse
    from video_gcp_torch.evaluation.evaluator import Evaluator
    from video_gcp_torch.ops.dtw import batched_dtw_alignment, dtw_warp_sequence
    batch = next(iter(DataLoader(dataset, TRAIN_B, shuffle=False, num_workers=4,
                                 device="cuda")))
    out_dir = EXP_DIR / "eval"
    shutil.rmtree(out_dir, ignore_errors=True)
    ev = Evaluator(model, str(out_dir), {}, TRAIN_T, "basic")
    gen = torch.Generator("cuda").manual_seed(123)
    n_samples = 100 + ev.N_PLOTTED_ELEMENTS
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k3.launches"] = 0  # eval starts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ev.eval(batch, gen)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = COUNTS["k1.launches"]
    if launches != 15 * n_samples or COUNTS["k2.launches"] or COUNTS["k3.launches"]:
        fail(f"eval: {launches} K1 launches for {n_samples} sampled forwards, expected 15 "
             f"each; K2 {COUNTS["k2.launches"]}, K3 {COUNTS["k3.launches"]}")
    for k, v in res.metrics.items():
        if v.shape != (TRAIN_B, 100) or not np.isfinite(v).all():
            fail(f"eval: {k} {v.shape}, finite {np.isfinite(v).all()}")
    # the kept frames score the least MSE of the 100 samples, per sequence
    gt = torch.from_numpy(res.gt_seq)
    t_idx = torch.arange(TRAIN_T)[None]
    end = torch.from_numpy(res.end_ind)
    valid = (t_idx >= 1) & (t_idx <= end[:, None] - 1) & (batch.pad_mask.cpu() > 0)
    best = ((mse(torch.from_numpy(res.best_gen), gt) * valid).sum(1) / valid.sum(1)).numpy()
    least = res.metrics["mse"].min(1)
    if not np.allclose(best, least, rtol=1e-5, atol=1e-7) or not (
            least[:, None] <= res.metrics["mse"]).all():
        fail(f"eval: best frames' mse {best} against the least sample mse {least}")
    summary = ev.dump_results(0)
    shapes = {"gt_seq_0.npy": (TRAIN_B, TRAIN_T - 1, 3, 32, 32),
              "gen_images_0.npy": (TRAIN_B, TRAIN_T - 1, 3, 32, 32),
              "full_gen_seq_0.npy": (TRAIN_B, N_NODES, 3, 32, 32),
              "seq_samples_0.npy": (min(TRAIN_B, ev.N_PLOTTED_ELEMENTS),
                                    ev.N_PLOTTED_ELEMENTS, TRAIN_T, 3, 32, 32)}
    for name, shape in shapes.items():
        got = np.load(out_dir / "metrics" / name, mmap_mode="r").shape
        if got != shape:
            fail(f"eval: {name} has shape {got}, expected {shape}")
    if not (out_dir / "metrics/results_0.txt").is_file():
        fail("eval: no results_0.txt")
    print(f"eval: Evaluator 'basic' top-of-100 on B={TRAIN_B}, T={TRAIN_T}: {sec:.3f} s per "
          f"batch, {100 * TRAIN_B * N_NODES / sec:.0f} decoded frames/s; K1 launches "
          f"{launches} = 15 x {n_samples} sampled forwards; best-of-100 "
          + json.dumps({k: float(f"{v:.6g}") for k, v in summary.items()}))

    # one sample with injected z, card against CPU
    z = torch.randn(2, N_NODES, 256, generator=gen, device="cuda")
    inp = AttrDict({k: batch[k][:2] for k in ("traj_seq", "I_0", "I_g", "end_ind", "pad_mask")})
    inp.traj_seq = inp.traj_seq.float() / 127.5 - 1.0
    inp.z = z
    m, g, _ = ev._eval_sample(inp, None)
    ev_cpu = Evaluator(cpu_model, str(out_dir / "cpu"), {}, TRAIN_T, "basic")
    m_cpu, g_cpu, _ = ev_cpu._eval_sample(AttrDict({k: v.cpu() for k, v in inp.items()}), None)
    img_d = max_diff(g, g_cpu)
    met_d = max(((m[k].cpu() - m_cpu[k]).abs() / m_cpu[k].abs().clamp(min=1)).max().item()
                for k in m)
    if not (img_d < TOLS_SLICE["images"] and met_d < TOL_EVAL_METRIC):
        fail(f"eval: card vs CPU with injected z: frames {img_d}, metrics {met_d}")
    print(f"eval: card vs CPU, one sample with injected z: frames {img_d:.3e}, metrics "
          f"(relative) {met_d:.3e}")

    # 'pruned_dtw', a shorter run of the same protocol
    ev_p = Evaluator(model, str(out_dir / "pruned"), {}, TRAIN_T, "pruned_dtw")
    ev_p._top_of = 10
    COUNTS["k4.launches"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_p = ev_p.eval(batch, gen)
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t0
    if not all(np.isfinite(v).all() for v in res_p.metrics.values()):
        fail("eval: pruned_dtw metrics not finite")
    k4_p = COUNTS["k4.launches"]
    if k4_p != 10 + min(10, ev_p.N_PLOTTED_ELEMENTS):
        fail(f"eval: {k4_p} K4 launches in a 'pruned_dtw' top-of-10 call, expected one a "
             f"sampled forward")
    est = torch.rand(TRAIN_B, N_NODES, 32, 32, 3, generator=gen, device="cuda") * 2 - 1
    tgt = torch.rand(TRAIN_B, TRAIN_T, 32, 32, 3, generator=gen, device="cuda") * 2 - 1
    ends = batch.end_ind
    cost = torch.rand(TRAIN_B, N_NODES, TRAIN_T, generator=gen, device="cuda")
    warp_ms = time_ms(torch, lambda: dtw_warp_sequence(est, tgt, ends), reps=5, warmup=1)
    align_ms = time_ms(torch, lambda: batched_dtw_alignment(cost, ends), reps=5, warmup=1)
    print(f"eval: Evaluator 'pruned_dtw' top-of-10: {sec_p:.3f} s per batch, "
          f"{10 * TRAIN_B * N_NODES / sec_p:.0f} decoded frames/s, mse best "
          f"{res_p.metrics['mse'].min(1).mean():.6g}, K4 launches {k4_p}; DTW warp at "
          f"[{TRAIN_B}, {N_NODES}, {TRAIN_T}] {warp_ms:.3f} ms (alignment alone "
          f"{align_ms:.3f} ms)")

    # the greedy schemes at top-of-10: ep74's existence predictor
    # (greedy_exist) and the root-down least-L2 match (greedy_l2)
    by_path = {"eval": launches}
    for scheme in ("greedy_exist", "greedy_l2"):
        ev_g = Evaluator(model, str(out_dir / scheme), {}, TRAIN_T, scheme)
        ev_g._top_of = GREEDY_TOP_OF
        n_g = GREEDY_TOP_OF + min(ev_g.N_PLOTTED_ELEMENTS, GREEDY_TOP_OF)
        # the scheme starts
        COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k3.launches"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_g = ev_g.eval(batch, gen)
        torch.cuda.synchronize()
        sec_g = time.perf_counter() - t0
        k1 = COUNTS["k1.launches"]
        if k1 != 15 * n_g or COUNTS["k2.launches"] or COUNTS["k3.launches"]:
            fail(f"eval: {scheme}: {k1} K1 launches for {n_g} sampled forwards, expected 15 "
                 f"each; K2 {COUNTS["k2.launches"]}, K3 {COUNTS["k3.launches"]}")
        if not all(np.isfinite(v).all() and v.shape == (TRAIN_B, GREEDY_TOP_OF)
                   for v in res_g.metrics.values()):
            fail(f"eval: {scheme} metrics not finite or not [{TRAIN_B}, {GREEDY_TOP_OF}]")
        if res_g.best_gen.shape != (TRAIN_B, TRAIN_T, 32, 32, 3):
            fail(f"eval: {scheme} frames {res_g.best_gen.shape}")
        by_path[f"eval_{scheme}"] = k1
        print(f"eval: Evaluator '{scheme}' top-of-{GREEDY_TOP_OF}: {sec_g:.3f} s per batch, "
              f"K1 launches {k1} = 15 x {n_g} sampled forwards, mse best "
              f"{res_g.metrics['mse'].min(1).mean():.6g}")
    return by_path


def synthetic_i3d(torch, path, fvd, seed=SEED):
    """A pytorch-i3d checkpoint at Kinetics-400 width from a seed: unit-scale
    BN gammas, positive running_var, and He-scaled conv kernels (std
    sqrt(2 / fan-in)), which keep the logits dependent on the input through
    the ~60 ReLU units."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in fvd.i3d_param_shapes().items():
        if name.endswith("running_var"):
            a = 1.0 + 0.1 * rng.rand(*shape)
        elif name.endswith("bn.weight"):
            a = 1.0 + 0.05 * rng.randn(*shape)
        elif "conv3d.weight" in name:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        else:
            a = 0.05 * rng.randn(*shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    torch.save(sd, path)


def synthetic_alexnet(torch, path, seed=SEED):
    """torchvision AlexNet's feature convs and the lpips 'alex' head, from a
    seed."""
    rng = np.random.RandomState(seed)
    sd = {}
    for i, (idx, (cin, cout, k)) in enumerate(zip((0, 3, 6, 8, 10), ALEXNET_CONVS)):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy((0.05 * rng.randn(cout)).astype(np.float32))
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(rng.rand(1, cout, 1, 1).astype(np.float32))
    torch.save(sd, path)


def i3d_flops(torch, fvd, n_frames, size=224):
    """Multiply-adds x 2 of the I3D convs on one video, from the shapes: the
    forward on meta tensors, each conv counted as it is called."""
    shapes = fvd.i3d_param_shapes()
    params = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    for k in [k for k in shapes if k.endswith(".bn.running_var")]:
        base = k[:-len(".running_var")]
        params[base + ".scale"] = params[base + ".shift"] = torch.empty(shapes[k], device="meta")
    count, real = [0], fvd.F.conv3d

    def counted(x, w, *a, **kw):
        y = real(x, w, *a, **kw)
        count[0] += 2 * y.numel() * w[0].numel()
        return y

    fvd.F.conv3d = counted
    try:
        fvd.i3d_logits(params, torch.empty(1, n_frames, size, size, 3, device="meta"))
    finally:
        fvd.F.conv3d = real
    return count[0]


def eval_extras_phase(torch):
    """FVD (I3D at Kinetics-400 width, 224x224) and LPIPS(alex) over the eval
    phase's dumps on the card, through GCP_I3D_WEIGHTS / GCP_LPIPS_WEIGHTS
    pointed at checkpoints synthesized from a seed; each held card against
    CPU on a cut of 2 videos x 8 frames; the weight-free proxies' numbers."""
    from video_gcp_torch.evaluation import fvd, lpips
    dumps = EXP_DIR / "eval/metrics"
    gt_path, gen_path = str(dumps / "gt_seq_0.npy"), str(dumps / "gen_images_0.npy")
    gt_cf = np.load(gt_path)
    n_videos, n_frames = gt_cf.shape[:2]
    work = EXP_DIR / "eval_extras"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    synthetic_i3d(torch, work / "i3d.pt", fvd)
    synthetic_alexnet(torch, work / "alexnet.pth")
    os.environ[fvd.I3D_WEIGHTS_ENV] = str(work / "i3d.pt")
    os.environ[lpips.LPIPS_WEIGHTS_ENV] = str(work / "alexnet.pth")
    try:
        embed, kind = fvd.default_embed_fn()  # the card
        features, lkind = lpips.default_feature_fn()
    finally:
        del os.environ[fvd.I3D_WEIGHTS_ENV], os.environ[lpips.LPIPS_WEIGHTS_ENV]
    if (kind, lkind) != ("i3d", "alex") or features.lins is None:
        fail(f"eval_extras: the weights' env vars gave {kind} and {lkind}")

    # I3D on the cut, card against CPU; the logits are 400 wide
    cut = (np.transpose(gt_cf[:2, :8], (0, 1, 3, 4, 2)) + 1.0) * 127.5
    card = embed(cut)
    cpu = fvd.i3d_embed_fn(str(work / "i3d.pt"), device="cpu")(cut)
    i3d_d = np.abs(card - cpu).max() / np.abs(cpu).max()
    if card.shape != (2, 400) or not np.isfinite(card).all() or not i3d_d < TOL_I3D:
        fail(f"eval_extras: I3D logits {card.shape}, card vs CPU {i3d_d} (tolerance {TOL_I3D})")
    # one embedding of the 16 dumped videos (a batch), then the whole FVD
    videos = (np.transpose(gt_cf, (0, 1, 3, 4, 2)) + 1.0) * 127.5
    embed(videos)  # warm, at the dumps' length
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embed(videos)
    i3d_s = time.perf_counter() - t0  # embed returns host arrays: synchronized
    t0 = time.perf_counter()
    value = fvd.compute_fvd(gt_path, gen_path, embed_fn=embed)
    fvd_s = time.perf_counter() - t0
    proxy = fvd.compute_fvd(gt_path, gen_path)  # the card's weight-free proxy
    if not (np.isfinite(value) and np.isfinite(proxy)):
        fail(f"eval_extras: FVD {value}, proxy {proxy}")
    flops = i3d_flops(torch, fvd, n_frames)
    bound_ms = flops / F32_FLOPS_PER_S * 1e3
    print(f"eval_extras: I3D (synthesized Kinetics-400 weights, {n_frames} frames resized to "
          f"224x224, 400 logits) {i3d_s * 1e3 / n_videos:.2f} ms per video (a batch of "
          f"{n_videos}); {flops / 1e9:.1f} GFLOP a video, bound {bound_ms:.2f} ms at f32 "
          f"(operations), {flops * n_videos / i3d_s / 1e12:.1f} TFLOP/s; "
          f"FVD of {n_videos} vs {n_videos} videos {value:.6g} in {fvd_s:.3f} s; "
          f"card vs CPU on 2 videos x 8 frames: logits within {i3d_d:.3e} of the largest "
          f"(tolerance {TOL_I3D}); FVD-proxy (the port's own random features, not the JAX "
          f"package's) {proxy:.6g}")

    # LPIPS(alex) likewise
    a = np.transpose(gt_cf[:2, :8], (0, 1, 3, 4, 2)).reshape(-1, 32, 32, 3)
    b = np.transpose(np.load(gen_path)[:2, :8], (0, 1, 3, 4, 2)).reshape(-1, 32, 32, 3)
    d_card = lpips.lpips_distance(a, b, features)
    d_cpu = lpips.lpips_distance(a, b, lpips.alexnet_feature_fn(str(work / "alexnet.pth"),
                                                                "cpu"))
    lp_d = np.abs(d_card - d_cpu).max() / np.abs(d_cpu).max()
    if not (np.isfinite(d_card).all() and lp_d < TOL_LPIPS):
        fail(f"eval_extras: LPIPS card vs CPU {lp_d} (tolerance {TOL_LPIPS})")
    lpips.compute_lpips(gt_path, gen_path, features)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = lpips.compute_lpips(gt_path, gen_path, features)
    torch.cuda.synchronize()
    lp_s = time.perf_counter() - t0
    lp_proxy = lpips.compute_lpips(gt_path, gen_path)
    if not (np.isfinite(lp) and np.isfinite(lp_proxy)):
        fail(f"eval_extras: LPIPS {lp}, proxy {lp_proxy}")
    print(f"eval_extras: LPIPS(alex, synthesized weights) over {n_videos} x {n_frames} frame "
          f"pairs: {lp:.6g} in {lp_s:.3f} s, {lp_s * 1e3 / (n_videos * n_frames):.4f} ms per "
          f"frame; card vs CPU on 16 frames within {lp_d:.3e} (tolerance {TOL_LPIPS}); "
          f"LPIPS-proxy (the port's own random features) {lp_proxy:.6g}")


def finetune_phase(torch, fused_gn, soft_dtw, trainer_mod):
    """The inverse-model fine-tune of 9room/gcp_tree_widegap from ep74 on the
    card (video_gcp_torch.training.finetune_inv_mdl, --feed_random_data 1),
    cut to FINETUNE_STEPS steps at B=16, T=100 and one val pass of one batch
    (--val_metric_batches 1). Checks K1/K2/K3 per step and per val pass,
    every parameter outside inv_mdl bit-identical to ep74 after the steps,
    the inverse model moved, and the val pass's image files."""
    from video_gcp_torch.training import finetune_inv_mdl as ft
    os.environ["GCP_EXP_DIR"] = str(EXP_DIR)
    shutil.rmtree(EXP_DIR / "prediction/9room/gcp_tree_widegap", ignore_errors=True)
    trainer = ft.build(str(WIDEGAP_CONF), str(WEIGHTS), "cuda", [
        "--feed_random_data", "1", "--deterministic", "1", "--val_metric_batches", "1",
        "--verbose_timing", "1"])
    loader = trainer.train_loader
    loader.dataset.n_seqs = FINETUNE_STEPS * TRAIN_B // loader.n_repeat
    trainer.val_loader.dataset.n_seqs = TRAIN_B
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    t0 = time.perf_counter()
    steps, vals, launches, timing = run_counted(torch, fused_gn, soft_dtw, trainer_mod,
                                                trainer, run=lambda: ft.run(trainer, 1))
    step_seconds = timing.seconds("train_step")
    wall = time.perf_counter() - t0
    if len(steps) != FINETUNE_STEPS or len(vals) != 1:
        fail(f"finetune: {len(steps)} steps and {len(vals)} val passes")
    check_steps(torch, "finetune", steps, vals, FINETUNE_PER_STEP)
    stepped = tuple(sum(s[i] for s in steps) for i in range(3))
    val_pass = tuple(a - b for a, b in zip(launches, stepped))
    if val_pass != FINETUNE_VAL_PASS:
        fail(f"finetune: K1/K2/K3 launches in the val pass {val_pass}, expected "
             f"{FINETUNE_VAL_PASS}")
    moved, frozen = 0, []
    for k, v in trainer.model.state_dict().items():
        same = torch.equal(v, before[k])
        if ft.is_trained(k):
            moved += not same
        elif not same:
            frozen.append(k)
    if frozen or not moved:
        fail(f"finetune: frozen parameters that changed {frozen[:5]}; inv_mdl tensors that "
             f"moved {moved}")
    images = Path(trainer.logger.log_dir) / "images"
    written = sorted(p.name for p in images.iterdir()) if images.is_dir() else []
    missing = [t for t in FINETUNE_IMAGES if not any(n.startswith(f"val_{t}_") for n in written)]
    if missing:
        fail(f"finetune: the val pass wrote no {missing} (files: {written})")
    warm = statistics.median(step_seconds[1:])
    print(f"finetune: {WIDEGAP_CONF.name} from ep74, {FINETUNE_STEPS} steps at B={TRAIN_B} "
          f"T={TRAIN_T}, a checkpoint and a val pass in {wall:.2f} s; K1/K2/K3 per step "
          f"{FINETUNE_PER_STEP} (design: the whole backward, only inv_mdl stepped), in the "
          f"val pass {val_pass} (val step, logged prior and posterior passes); synced ms per "
          f"step {[round(t * 1e3, 2) for t in step_seconds]}, median of steps 1-"
          f"{FINETUNE_STEPS - 1} {warm * 1e3:.2f}; {moved} inv_mdl tensors moved, every other "
          f"parameter bit-identical to ep74; images {sorted(FINETUNE_IMAGES)}")
    return {"finetune": stepped, "finetune_val": val_pass}


def rank_rows(a, rows):
    """Block `rows` = (rank, n) of `a`'s leading axis: a data-parallel
    rank's share of a draw or a K1 site, all of which lead with the batch
    (frames and nodes b-major). None: all of `a`."""
    if rows is None:
        return a
    per = a.shape[0] // rows[1]
    return a[rows[0] * per:(rows[0] + 1) * per]


class SharedNoise:
    """Seeded numpy draws in place of the train path's random draws
    (Gaussian.sample and distributions.uniform), recorded on the first run
    and replayed in call order on the next, so the card and the CPU see the
    same noise; with `rows`, a data-parallel rank replays its rows of the
    whole batch's draws."""

    def __init__(self, torch, distributions, draws=None, rows=None):
        self.torch, self.dist = torch, distributions
        self.rng = np.random.RandomState(0)
        self.draws = draws or {"normal": [], "uniform": []}
        self.rows = rows

    def take(self, kind, shape, device):
        queue, i = self.draws[kind], self.pos[kind]
        if i == len(queue):
            make = self.rng.randn if kind == "normal" else self.rng.rand
            queue.append(make(*shape).astype(np.float32))
        draw = rank_rows(queue[i], self.rows)
        if draw.shape != tuple(shape):
            fail(f"noise draw {kind} {i}: shape {tuple(shape)}, recorded {draw.shape}")
        self.pos[kind] += 1
        return self.torch.from_numpy(np.ascontiguousarray(draw)).to(device)

    def run(self, fn):
        Gaussian, saved = self.dist.Gaussian, (self.dist.Gaussian.sample, self.dist.uniform)
        Gaussian.sample = lambda g, gen: g.reparametrize(
            self.take("normal", g.mu.shape, g.mu.device))
        self.dist.uniform = lambda shape, gen, device=None: self.take("uniform", shape, device)
        self.pos = {"normal": 0, "uniform": 0}
        try:
            return fn()
        finally:
            Gaussian.sample, self.dist.uniform = saved
            if any(self.pos[k] != len(q) for k, q in self.draws.items()):
                fail(f"noise draws differ between runs: {self.pos}")


class SharedSigns:
    """The card run's LeakyReLU branch at every element of every K1 site,
    recorded in call order and imposed on the CPU run's twin. Where a
    pre-activation lies within rounding of the kink, the devices may take
    different branches, and one flipped element moves its whole norm
    group's gradient (fused_gn.clear_of_kink): with data drawn anew each
    run, an h5 step's decoder gradient once differed by 5.9e-3 that way.
    Counts the elements whose branch the CPU's own rounding would have
    chosen otherwise (`flips`). With `leaky` (one process) the card's
    branches at the MLPs' and sequence encoders' LeakyReLUs (nets._leaky)
    are recorded too, and the CPU run counts the elements where its own
    branch differs (`leaky_flips`, with the largest such |x| relative to
    its site's largest |x|, `leaky_kink`); it takes the card's branch there
    only with `impose_leaky` (the flip probe, --flip-probe)."""

    def __init__(self, torch, masks=None, rows=None):
        from video_gcp_torch.models import nets
        self.torch, self.nets = torch, nets
        self.masks, self.rows, self.leaky_masks = masks or [], rows, []
        self.reset()

    def reset(self):
        self.flips = self.leaky_flips = 0
        self.leaky_kink = 0.0

    def run(self, fn, record, leaky=False, impose_leaky=False):
        torch, real, pos = self.torch, self.nets.fused_group_norm_lrelu, [0, 0]
        real_leaky = self.nets._leaky

        def recorded(x, scale, bias, groups, eps=1e-6, slope=0.2):
            y = real(x, scale, bias, groups, eps, slope)
            self.masks.append((y >= 0).cpu())
            return y

        def imposed(x, scale, bias, groups, eps=1e-6, slope=0.2):
            pre = real(x, scale, bias, groups, eps, 1.0)  # the norm, no activation
            mask = rank_rows(self.masks[pos[0]], self.rows).to(pre.device)
            pos[0] += 1
            if mask.shape != pre.shape:
                fail(f"K1 site {pos[0]}: {tuple(pre.shape)} replayed, "
                     f"{tuple(mask.shape)} recorded")
            self.flips += int((mask != (pre >= 0)).sum())
            return torch.where(mask, pre, slope * pre)

        def recorded_leaky(x):
            self.leaky_masks.append((x >= 0).cpu())
            return real_leaky(x)

        def replayed_leaky(x):
            mask = self.leaky_masks[pos[1]].to(x.device)
            pos[1] += 1
            if mask.shape != x.shape:
                fail(f"LeakyReLU site {pos[1]}: {tuple(x.shape)} replayed, "
                     f"{tuple(mask.shape)} recorded")
            flipped = mask != (x >= 0)
            if flipped.any():
                self.leaky_flips += int(flipped.sum())
                self.leaky_kink = max(self.leaky_kink, float(
                    x.detach()[flipped].abs().max() / x.detach().abs().max()))
            return torch.where(mask, x, 0.2 * x) if impose_leaky else real_leaky(x)

        self.nets.fused_group_norm_lrelu = recorded if record else imposed
        if leaky:
            self.nets._leaky = recorded_leaky if record else replayed_leaky
        try:
            return fn()
        finally:
            self.nets.fused_group_norm_lrelu, self.nets._leaky = real, real_leaky
            if not record and pos[0] != len(self.masks):
                fail(f"{pos[0]} K1 sites replayed, {len(self.masks)} recorded")
            if leaky and not record and pos[1] != len(self.leaky_masks):
                fail(f"{pos[1]} LeakyReLU sites replayed, {len(self.leaky_masks)} recorded")


def run_counted(torch, fused_gn, soft_dtw, trainer_mod, trainer, run=None):
    """trainer.run() (or `run()`) with the launch counts reset, recording
    each train step's K1, K2 and K3 launches with its metrics and each val
    pass's losses, in a tracing session whose steps wait for the device.
    Returns them, the whole run's launches and the session (its
    'train_step' and 'trainer.data' spans time the steps and the waits for
    their batches)."""
    steps, vals = [], []
    real_step, real_val = trainer_mod.train_step, trainer.val

    def counted_step(*a, **kw):
        k1, k2, k3 = COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"]
        metrics = real_step(*a, **kw)
        steps.append((COUNTS["k1.launches"] - k1, COUNTS["k2.launches"] - k2,
                      COUNTS["k3.launches"] - k3, metrics))
        return metrics

    trainer_mod.train_step = counted_step
    trainer.val = lambda epoch: vals.append(real_val(epoch)) or vals[-1]
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k2.dy_copies"] = 0
    COUNTS["k3.launches"] = 0
    try:
        with tracing.session(synchronize=True) as timing:
            (run or trainer.run)()
    finally:
        trainer_mod.train_step = real_step
        del trainer.val
    torch.cuda.synchronize()
    launches = (COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"])
    return steps, vals, launches, timing


def check_steps(torch, tag, steps, vals, per_step):
    """Every step's (K1, K2, K3) launches `per_step`, its metrics and
    gradients finite, and every val loss finite."""
    got = sorted({s[:3] for s in steps})
    if got != [per_step]:
        fail(f"{tag}: K1/K2/K3 launches per step {got}, expected {per_step}")
    for i, (*_, m) in enumerate(steps):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad or not bool(m["grads_finite"]):
            fail(f"{tag}: non-finite {bad or 'gradients'} at step {i}")
    if not all(np.isfinite(v) for val in vals for v in val.values()):
        fail(f"{tag}: non-finite val losses {vals}")


def unmoved(torch, model, before):
    """Parameters with a gradient that did not move. An attention key bias
    adds q.b to every logit of a query, which the softmax cancels: its
    gradient is rounding noise, too small to move it."""
    return [n for n, p in model.named_parameters()
            if p.grad is not None and p.grad.abs().sum() > 0
            and torch.equal(p.detach(), before[n])
            and not (".attention_layers." in n and n.endswith(".dense.1.bias"))]


def train_phase(torch, fused_gn, soft_dtw, trainer_mod, conf, resume, k3_per_step,
                n_steps=TRAIN_STEPS):
    """The JAX command's training run of `conf` on the card, through
    ModelTrainer, from `resume` (--resume), its random sequences cut to
    `n_steps` steps."""
    tag = "train" if k3_per_step == 0 else "train_adaptive"
    os.environ["GCP_EXP_DIR"] = str(EXP_DIR)
    args = trainer_mod.parse_args([
        "--path", str(conf), "--resume", str(resume), "--feed_random_data", "1",
        "--num_epochs", "1", "--skip_first_val", "1", "--deterministic", "1",
        "--verbose_timing", "1"])
    trainer = trainer_mod.ModelTrainer(args)  # device 'cuda', the default
    loader = trainer.train_loader
    loader.dataset.n_seqs = n_steps * TRAIN_B // loader.n_repeat
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps, _, launches, timing = run_counted(torch, fused_gn, soft_dtw, trainer_mod, trainer)
    wall = time.perf_counter() - t0
    step_seconds = timing.seconds("train_step")
    copies = COUNTS["k2.dy_copies"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    if len(steps) != n_steps or trainer.step != n_steps:
        fail(f"{tag}: {len(steps)} steps, expected {n_steps}")
    per_step = (NORMS_PER_STEP, NORMS_PER_STEP, k3_per_step)
    check_steps(torch, tag, steps, [], per_step)
    unchanged = unmoved(torch, trainer.model, before)
    if unchanged:
        fail(f"{tag}: parameters with a gradient did not change: {unchanged}")
    static = [n for n, p in trainer.model.named_parameters()
              if torch.equal(p.detach(), before[n])]
    warm = statistics.median(step_seconds[3:n_steps])
    first = {k: float(v) for k, v in steps[0][3].items() if v.dim() == 0}
    last = {k: float(v) for k, v in steps[-1][3].items() if v.dim() == 0}
    print(f"{tag}: {conf.name}, {n_steps} steps of B={TRAIN_B} T={TRAIN_T} in "
          f"{wall:.2f} s (checkpoint included); K1/K2/K3 launches per step "
          f"{per_step}, total {launches}")
    print(f"{tag}: step 0 {step_seconds[0] * 1e3:.2f} ms; warm ms per step "
          f"(median of steps 3-{n_steps - 1}) {warm * 1e3:.2f}; training frames/s "
          f"{TRAIN_B * TRAIN_T / warm:.1f}; peak device memory {peak_gib:.3f} GiB; "
          f"k2.dy_copies {copies}")
    print(f"{tag}: parameters that did not move (no gradient): {static}")
    print(f"{tag}: first step " + json.dumps({k: float(f"{v:.6g}") for k, v in first.items()}))
    print(f"{tag}: last step " + json.dumps({k: float(f"{v:.6g}") for k, v in last.items()}))
    if k3_per_step:
        print(f"{tag}: soft-DTW stability gap, first step "
              f"{first['soft_dtw_stability_gap']:.6g}, last step "
              f"{last['soft_dtw_stability_gap']:.6g}")
    return trainer, launches


def vs_cpu_batch(DataLoader, AttrDict, dataset, seed=SEED):
    """The first 2 examples of `dataset` in a loader's order seeded with
    `seed`, their windows drawn in turn from RandomState(seed) by one
    worker: the card-vs-CPU steps compare data that a run can replay."""
    dataset._rng = np.random.RandomState(seed)
    return AttrDict(next(iter(DataLoader(dataset, 2, shuffle=True, n_repeat=2,
                                         num_workers=1, seed=seed))))


def card_vs_cpu_step(torch, make_model, AttrDict, distributions, batch, leaky_passes):
    """One train step of `make_model(device)` on `batch` on the card, then
    on the CPU once for each of `leaky_passes`, with the same injected noise
    (SharedNoise) and the card's LeakyReLU branches at the K1 sites and,
    where the pass is True, at nets._leaky too (SharedSigns; where it is
    False, the branches there that differ are only counted). Returns, for
    each CPU pass, each loss relative to max(1, |CPU loss|), each gradient
    tensor's largest difference relative to its largest CPU gradient, and
    the branches that differ from the card's."""
    noise, signs = SharedNoise(torch, distributions), SharedSigns(torch)

    def step(device, record, impose_leaky=False):
        model = make_model(device).train()
        out = signs.run(lambda: noise.run(lambda: model(
            AttrDict({k: v.to(device) for k, v in batch.items()}),
            phase="train", mode="posterior")), record, True, impose_leaky)
        out.losses.total.value.backward()
        return ({k: float(v.value.detach()) for k, v in out.losses.items()},
                {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
                 for n, p in model.named_parameters() if p.requires_grad})

    card_l, card_g = step("cuda", True)
    passes = []
    for impose_leaky in leaky_passes:
        signs.reset()
        cpu_l, cpu_g = step("cpu", False, impose_leaky)
        grad_d = {n: (card_g[n] - g).abs().max().item() / max(1e-3, g.abs().max().item())
                  for n, g in cpu_g.items()}
        passes.append(AttrDict(
            loss_d={k: abs(card_l[k] - v) / max(1.0, abs(v)) for k, v in cpu_l.items()},
            grad_d=grad_d, worst=max(grad_d, key=grad_d.get), flips=signs.flips,
            sites=sum(m.numel() for m in signs.masks), leaky_flips=signs.leaky_flips,
            leaky_sites=sum(m.numel() for m in signs.leaky_masks),
            leaky_kink=signs.leaky_kink))
    return passes


def train_vs_cpu(torch, make_model, AttrDict, distributions, DataLoader, dataset, tag,
                 tols=TOLS_TRAIN):
    """One train step of `make_model(device)` on 2 examples of `dataset`
    (vs_cpu_batch), card against CPU with the card's branches at the K1
    sites (card_vs_cpu_step): each loss and gradient tensor within `tols`.
    Prints the branches that differ from the card's at nets._leaky too."""
    r, = card_vs_cpu_step(torch, make_model, AttrDict, distributions,
                          vs_cpu_batch(DataLoader, AttrDict, dataset), (False,))
    leaky = (f"{r.leaky_flips} of {r.leaky_sites} at nets._leaky differ from the card's "
             f"(not shared; the largest |x| among them {r.leaky_kink:.3e} of its site's)")
    if max(r.loss_d.values()) >= tols["loss"] or r.grad_d[r.worst] >= tols["grad"]:
        fail(f"{tag}: card vs CPU on the window of seed {SEED} (vs_cpu_batch), losses "
             f"{r.loss_d}, worst gradient {r.worst} {r.grad_d[r.worst]}; LeakyReLU branches: "
             f"{r.flips} of {r.sites} taken from the card at the K1 sites, {leaky}")
    print(f"{tag}: card vs CPU, one step on 2 examples, losses (relative): "
          + json.dumps({k: float(f"{v:.3e}") for k, v in r.loss_d.items()}))
    print(f"{tag}: card vs CPU, gradients of {len(r.grad_d)} tensors, worst "
          f"{r.grad_d[r.worst]:.3e} ({r.worst}, relative to its largest CPU gradient); "
          f"LeakyReLU branches the CPU took from the card: {r.flips} of {r.sites} at the K1 "
          f"sites; {leaky}")


class _Recorder:
    """Wraps the planning classes' methods for one control run: counts and
    times the simulator calls, _plan calls, closed-loop actions and tasks,
    keeps the first simulator call and the first action for the CPU checks,
    checks every plan, and profiles the second _plan with torch.profiler.
    Splits each _plan's host time over the simulator's rollouts (the model
    call with its copies, and the capping after it), the learned-cost calls,
    the tree optimizer's own numpy and the sampler's draws of candidates."""

    def __init__(self, torch, sim_mod, policy_mod, infra_sim_mod, cost_mod,
                 sampler_mod, profiled=1):
        self.torch, self.profiled = torch, profiled  # the index of the profiled _plan
        self.sim, self.plans, self.actions, self.tasks = [], [], [], []
        self.first_sim = self.first_action = self.policy = self.profile = None
        self.host = dict(rollout=0.0, cost=0.0, optimize=0.0, sample=0.0)  # seconds
        self.saved = [(sim_mod.GCPSimulator, "run_model"),
                      (policy_mod.ImageCEMPolicy, "_plan"),
                      (policy_mod.ImageCEMPolicy, "_infer_action"),
                      (infra_sim_mod.Sim, "take_sample")]
        self.saved = [(cls, name, getattr(cls, name)) for cls, name in self.saved]
        for cls, name, orig in self.saved:
            setattr(cls, name, getattr(self, "_" + name.lstrip("_"))(orig))
        for cls, name, key in ((sim_mod.GCPSimulator, "rollout", "rollout"),
                               (cost_mod.LearnedCostEstimate, "__call__", "cost"),
                               (sampler_mod.HierarchicalTreeCEMSampler, "optimize",
                                "optimize"),
                               (sampler_mod.HierarchicalTreeCEMSampler, "sample",
                                "sample")):
            orig = getattr(cls, name)
            self.saved.append((cls, name, orig))
            setattr(cls, name, self._timed(orig, key))

    def _timed(self, orig, key):
        host = self.host

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                host[key] += time.perf_counter() - t0
        return timed

    def restore(self):
        for cls, name, orig in self.saved:
            setattr(cls, name, orig)

    def _run_model(self, orig):
        rec = self

        def run_model(sim, inputs):
            t0 = time.perf_counter()
            out = orig(sim, inputs)  # ends with the copies to the host
            rec.sim.append((inputs.I_0.shape[0], time.perf_counter() - t0,
                            sum(v.nbytes for v in out.values())))
            if rec.first_sim is None:  # z, or a VMPC's actions and pad mask
                rec.first_sim = ({k: v.cpu() for k, v in inputs.items()}, out)
            return out
        return run_model

    def _plan(self, orig):
        rec, torch = self, self.torch

        def plan(policy, state, goal, step):
            rec.policy = policy
            n0, host0 = len(rec.sim), dict(rec.host)
            if len(rec.plans) == rec.profiled:  # a warm _plan: profiled
                # device activity only: host activity too slowed the _plan
                # and took seconds to read back for a VMPC _plan's ~8,000
                # kernels
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    orig(policy, state, goal, step)
                    torch.cuda.synchronize()
                    host_ms = (time.perf_counter() - t0) * 1e3
                device = [e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                busy = sum(e.self_device_time_total for e in device) / 1e3
                kernels = sum(e.count for e in device)
                rec.profile = dict(host_ms=host_ms, device_busy_ms=busy,
                                   idle_share=1 - busy / host_ms, device_ops=kernels)
                ms = None
            else:
                t0 = time.perf_counter()
                orig(policy, state, goal, step)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            host = {k: (rec.host[k] - host0[k]) * 1e3 for k in rec.host}
            sim_ms = sum(t for _, t, _ in rec.sim[n0:]) * 1e3
            # the learned cost is called only from the tree optimizer
            rec.plans.append(dict(ms=ms, schedule=[c for c, _, _ in rec.sim[n0:]],
                                  sim_ms=sim_ms, capping_ms=host["rollout"] - sim_ms,
                                  cost_ms=host["cost"],
                                  optimizer_ms=host["optimize"] - host["cost"],
                                  sample_ms=host["sample"]))
            frames = np.asarray(policy.image_plan)[:, :32 * 32 * 3]
            if not (np.isfinite(policy.image_plan).all() and np.abs(frames).max() <= 1 + 1e-6):
                fail("a plan is not finite or has images outside [-1, 1]")
            if not np.isfinite(np.asarray(policy.latent_plan)).all():
                fail("a plan's latents are not finite")
        return plan

    def _infer_action(self, orig):
        rec = self

        def infer_action(policy, img, target):
            t0 = time.perf_counter()
            action = orig(policy, img, target)  # ends with the copy to the host
            rec.actions.append(time.perf_counter() - t0)
            if not np.isfinite(action).all():
                fail(f"non-finite closed-loop action {action}")
            if rec.first_action is None:
                rec.first_action = (np.array(img), np.array(target), action)
            return action
        return infer_action

    def _take_sample(self, orig):
        rec = self

        def take_sample(sim, index):
            t0 = time.perf_counter()
            out = orig(sim, index)
            rec.tasks.append(time.perf_counter() - t0)
            return out
        return take_sample


def _config_copy(rel):
    """An unchanged copy of an experiment config under the build directory,
    so that the run's logs land there and not in the checkout's
    experiments/ (whose control log/ holds the JAX package's results)."""
    dst = EXP_DIR / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / rel, dst)
    return dst


_SETUP_DONE = []


def control_setup(torch, tag):
    """What the control runs read, made once per run: ep74 as a port
    checkpoint, a copy of the base configs, and start/goal configurations
    0..CONTROL_TASKS-1 from the port's data generation (the PRM expert, on
    the CPU). Points GCP_EXP_DIR and GCP_DATA_DIR at them."""
    from video_gcp_torch.planning.run import ControlManager
    from video_gcp_torch.training.checkpoint import load_model_state

    data_dir = EXP_DIR / "data"
    os.environ["GCP_EXP_DIR"] = str(EXP_DIR)
    os.environ["GCP_DATA_DIR"] = str(data_dir)
    if _SETUP_DONE:
        return
    for d in ("experiments", "control", "data"):
        shutil.rmtree(EXP_DIR / d, ignore_errors=True)
    ckpt = EXP_DIR / "prediction/9room/gcp_tree/weights/weights_ep74"
    ckpt.mkdir(parents=True, exist_ok=True)
    torch.save(dict(model=load_model_state(WEIGHTS), optimizer={}, step=74),
               ckpt / "state.pt")
    shutil.copytree(ROOT / "experiments/prediction/base_configs",
                    EXP_DIR / "experiments/prediction/base_configs")
    t0 = time.perf_counter()
    ControlManager([str(_config_copy(DATA_GEN)), "--device", "cpu", "--start_idx", "0",
                    "--end_idx", str(CONTROL_TASKS - 1), "--seed", str(SEED)]).run()
    print(f"{tag}: start/goal configurations 0-{CONTROL_TASKS - 1} by the PRM expert (CPU) "
          f"in {time.perf_counter() - t0:.2f} s")
    _SETUP_DONE.append(True)


def first_sim_vs_cpu(torch, AttrDict, rec, tag, n=CONTROL_CANDIDATES[0]):
    """The first simulator call of a control run, its first `n` candidates
    with the same inputs and end_ind, card against the planner's copy on the
    CPU (a generator only for a VMPC's zero-width latent draws)."""
    import copy
    cpu_model = copy.deepcopy(rec.policy.planner).cpu()
    first_in, card_out = rec.first_sim
    inputs = AttrDict({k: v[:n] for k, v in first_in.items()},
                      end_ind=torch.from_numpy(card_out.end_ind[:n]))
    with torch.inference_mode():
        ref = cpu_model(inputs, phase="plan", mode="prior",
                        generator=torch.Generator().manual_seed(0))
    diffs = {}
    for k in ("timeline_images", "timeline_latents", "actions", "regressed_state"):
        diffs[k] = float(np.abs(card_out[k][:n] - ref[k].numpy()).max())
        if not diffs[k] < TOLS_SLICE[k]:
            fail(f"{tag}: the first simulator call's {k} differs from the CPU "
                 f"by {diffs[k]} (tolerance {TOLS_SLICE[k]})")
    return cpu_model, diffs


def plan_phase(torch, fused_gn, soft_dtw, AttrDict):
    """Closed-loop visual planning on 9room/gcp_tree with ep74 on the card:
    start/goal configurations from the port's data generation, then the
    control benchmark's tasks 0..CONTROL_TASKS-1 through planning.run's
    ControlManager."""
    from video_gcp_torch.core.attrdict import load_pickle
    from video_gcp_torch.evaluation.compute_control_perf import compute_control_perf
    from video_gcp_torch.planning import planner_policy
    from video_gcp_torch.planning.cem import cost_fcn as cost_mod
    from video_gcp_torch.planning.cem import sampler as sampler_mod
    from video_gcp_torch.planning.cem import simulator as sim_mod
    from video_gcp_torch.planning.infra.sim import simulator as infra_sim_mod
    from video_gcp_torch.planning.run import ControlManager

    control_setup(torch, "plan")
    last = str(CONTROL_TASKS - 1)
    control = _config_copy(CONTROL)
    rec = _Recorder(torch, sim_mod, planner_policy, infra_sim_mod, cost_mod, sampler_mod)
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k3.launches"] = 0  # the control path
    t0 = time.perf_counter()
    try:
        ControlManager([str(control), "--start_idx", "0", "--end_idx", last,
                        "--seed", str(SEED)]).run()
    finally:
        rec.restore()
    run_s = time.perf_counter() - t0
    k1, k2, k3 = COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"]
    n_sim, n_act = len(rec.sim), len(rec.actions)
    want = K1_PER_SIM_CALL * n_sim + K1_PER_ACTION * n_act
    if k1 != want or k2 or k3:
        fail(f"control path: K1/K2/K3 launches {k1}/{k2}/{k3}, expected {want}/0/0 "
             f"({n_sim} simulator calls, {n_act} actions)")
    print(f"plan: control run of {CONTROL_TASKS} tasks in {run_s:.2f} s; K1 launches {k1} "
          f"= {K1_PER_SIM_CALL} x {n_sim} simulator calls + {K1_PER_ACTION} x {n_act} "
          "closed-loop actions; no K2 or K3")

    log = control.parent / "log"
    for name in [f"task_{i}.pkl" for i in range(CONTROL_TASKS)] + [
            f"scores_0to{last}.pkl", f"results_0to{last}.txt"]:
        if not (log / name).is_file():
            fail(f"control run wrote no {name}")
    perf = compute_control_perf(load_pickle(log / f"scores_0to{last}.pkl"))
    if not all(np.isfinite(v) for v in perf.values()):
        fail(f"control metrics not finite: {perf}")

    # the real candidate schedule, and the warm times per call
    schedules = [p["schedule"] for p in rec.plans]
    print(f"plan: {len(rec.plans)} _plan calls; simulator candidates per call in each: "
          f"{schedules}")
    by_count = {}
    for i, (n, s, nbytes) in enumerate(rec.sim):
        by_count.setdefault(n, []).append((s, nbytes))
    sim_ms = {}
    for n, calls in sorted(by_count.items(), reverse=True):
        warm = [s for s, _ in calls[1:]] or [calls[0][0]]
        sim_ms[n] = statistics.median(warm) * 1e3
        print(f"plan: simulator call of {n} candidates: {sim_ms[n]:.2f} ms warm median "
              f"({len(calls)} calls, the first {calls[0][0] * 1e3:.2f} ms), "
              f"{calls[0][1]} bytes to the host")
    if rec.profile is None:
        fail(f"control run made {len(rec.plans)} _plan calls; the second is profiled")
    warm_plans = [p["ms"] for p in rec.plans[2:]]
    plan_ms = statistics.median(warm_plans) if warm_plans else None
    plan_sim_ms = statistics.median(p["sim_ms"] for p in rec.plans[2:]) if warm_plans else None
    act_ms = statistics.median(rec.actions[1:]) * 1e3
    split = {k: statistics.median(p[k] for p in rec.plans[2:]) if warm_plans else None
             for k in ("sim_ms", "capping_ms", "cost_ms", "optimizer_ms", "sample_ms")}
    if warm_plans:
        split["rest_ms"] = statistics.median(
            p["ms"] - p["sim_ms"] - p["capping_ms"] - p["cost_ms"] - p["optimizer_ms"]
            - p["sample_ms"] for p in rec.plans[2:])
    print("plan: host time of a warm _plan, medians over the same calls (ms): "
          + json.dumps({k: None if v is None else round(v, 3) for k, v in split.items()}))
    print(f"plan: _plan {fmt(plan_ms)} ms warm median of {len(warm_plans)}, of which "
          f"simulator calls {fmt(plan_sim_ms)} ms (the first "
          f"{rec.plans[0]['ms']:.2f} ms); profiled _plan: " + json.dumps(
              {k: round(v, 3) for k, v in rec.profile.items()}))
    print(f"plan: closed-loop action {act_ms:.3f} ms warm median of {n_act}; "
          f"{n_act / sum(rec.tasks):.1f} env steps/s over the tasks; "
          f"seconds per task {[round(t, 2) for t in rec.tasks]}")
    print(f"plan: over {CONTROL_TASKS} tasks (a smoke run, not a quality result): success "
          f"rate {perf['success_rate']:.3f}, penalized path cost {perf['penalized_cost']:.3f}, "
          f"Room2Goal {perf['rooms_to_goal_mean']:.3f}")

    # the first simulator call and the first action, card against the CPU
    cpu_model, diffs = first_sim_vs_cpu(torch, AttrDict, rec, "control path")
    diffs["action"] = first_action_vs_cpu(torch, rec, cpu_model, "control path")
    print(f"plan: card vs CPU, the first simulator call ({len(rec.first_sim[0]['z'])} candidates, "
          "same z and end_ind) and the first action, max abs diff: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()}))
    return k1


def first_action_vs_cpu(torch, rec, cpu_model, tag):
    """The first closed-loop action of a control run, card against the
    planner's copy on the CPU (`cpu_model`): the largest difference."""
    import types
    from video_gcp_torch.planning import planner_policy

    img, target, got = rec.first_action
    cpu_policy = types.SimpleNamespace(planner=cpu_model, device=torch.device("cpu"))
    cpu_policy._encode = lambda im: planner_policy.ImageCEMPolicy._encode(cpu_policy, im)
    want = planner_policy.ImageCEMPolicy._infer_action(cpu_policy, img, target)
    diff = float(np.abs(got - want).max())
    if not diff < TOL_ACTION:
        fail(f"{tag}: a closed-loop action differs from the CPU by {diff} "
             f"(tolerance {TOL_ACTION})")
    return diff

def step_busy_ms(torch, trainer, step_fn):
    """Device time of one train step of `trainer` on a resident batch, after
    a warm one: the kernels the profiler records (device activity only,
    which keeps the trace of a step's ~10,000 launches quick to read)."""
    from torch.profiler import ProfilerActivity, profile
    batch = next(iter(trainer.train_loader))

    def step_once():
        step_fn(trainer.model, trainer.optimizer, batch, trainer.step, trainer.generator)

    step_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_once()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 or None


def make_h5_data(n_files=H5_FILES):
    """`n_files` nav_9rooms trajectories by the port's PRM expert, written
    as h5 files under EXP_DIR. Returns their directory and the seconds."""
    from video_gcp_torch.planning.run import ControlManager

    data_dir = EXP_DIR / "h5_data"
    shutil.rmtree(data_dir, ignore_errors=True)
    shutil.rmtree(EXP_DIR / "experiments", ignore_errors=True)
    os.environ["GCP_DATA_DIR"] = str(data_dir)
    os.environ["GCP_EXP_DIR"] = str(EXP_DIR)
    t0 = time.perf_counter()
    ControlManager([str(_config_copy(H5_DATA_GEN)), "--device", "cpu", "--start_idx", "0",
                    "--end_idx", str(n_files - 1), "--seed", str(SEED)]).run()
    return data_dir, time.perf_counter() - t0


def h5_phase(torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
             load_model):
    """nav_9rooms data made on the host by the port's PRM expert and written
    as h5 files through the port's HDF5 module, read back, then 9room/gcp_tree
    and 9room/gcp_sequential trained from them at full width through
    ModelTrainer with a val pass each epoch, and one step of each held card
    against CPU. Returns each model's K1/K2/K3 launches."""
    from video_gcp_torch.data import h5

    data_dir, gen_s = make_h5_data()
    files = sorted((data_dir / "nav_9rooms").glob("*.h5"))
    if len(files) != H5_FILES:
        fail(f"h5: the data generation wrote {len(files)} files, expected {H5_FILES}")
    t0 = time.perf_counter()
    for path in files:
        with h5.File(path, "r") as f:
            if list(f) != ["traj0", "traj_per_file"] or int(f["traj_per_file"][()]) != 1:
                fail(f"h5: {path.name} holds {list(f)}")
            got = {k: (f[f"traj0/{k}"].shape, str(f[f"traj0/{k}"].dtype)) for k in f["traj0"]}
            if got != H5_LAYOUT:
                fail(f"h5: {path.name} traj0 holds {got}, expected {H5_LAYOUT}")
            if not np.isfinite(f["traj0/states"][()]).all():
                fail(f"h5: {path.name} has non-finite states")
    read_s = time.perf_counter() - t0
    print(f"h5: {H5_FILES} nav_9rooms trajectories by the PRM expert (host) in {gen_s:.2f} s, "
          f"{gen_s / H5_FILES:.3f} s per trajectory; every file read back through "
          f"video_gcp_torch/data/h5.py in {read_s:.2f} s with its keys and shapes")
    # the re-render is the same for both models: it is timed on the first
    return {name: h5_train(torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader,
                           AttrDict, load_model, name, conf, probe_render=i == 0)
            for i, (name, conf) in enumerate(H5_CONFS)}


def h5_train(torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
             load_model, name, conf, probe_render):
    tag = f"h5_{name}"
    laps, clock = {}, [time.perf_counter()]

    def lap(what):  # host seconds of each part of this model's run
        now = time.perf_counter()
        laps[what] = round(now - clock[0], 2)
        clock[0] = now

    args = trainer_mod.parse_args([
        "--path", str(conf), "--resume", "none", "--prefix", "h5",
        "--num_epochs", str(H5_EPOCHS), "--deterministic", "1", "--verbose_timing", "1"])
    trainer = trainer_mod.ModelTrainer(args)  # device 'cuda', the default
    lap("build")
    dataset = trainer.train_loader.dataset
    if type(dataset).__name__ != "Nav9Rooms" or len(trainer.val_loader) != 1:
        fail(f"{tag}: dataset {type(dataset).__name__}, {len(trainer.val_loader)} val batches")
    # the re-render alone, on the host: one batch of 16 windows, cold then warm
    render_s = []
    if probe_render:
        probe = type(dataset)(dataset.data_dir, dict(trainer.hp), trainer.data_conf, "train")
        for _ in range(2):
            probe._rng = np.random.RandomState(0)
            t0 = time.perf_counter()
            for i in range(TRAIN_B):
                probe[i]
            render_s.append(time.perf_counter() - t0)
        del probe
        lap("render_probe")
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    steps, vals, launches, timing = run_counted(torch, fused_gn, soft_dtw, trainer_mod, trainer)
    lap("train")
    step_seconds = timing.seconds("train_step")
    per_epoch = len(trainer.train_loader)
    if per_epoch < 2 or len(steps) != H5_EPOCHS * per_epoch or len(vals) != H5_EPOCHS:
        fail(f"{tag}: {len(steps)} steps and {len(vals)} val passes, expected "
             f"{H5_EPOCHS} x {per_epoch} and {H5_EPOCHS}")
    per_step = (NORMS_PER_STEP, NORMS_PER_STEP, 0)
    check_steps(torch, tag, steps, vals, per_step)
    unchanged = unmoved(torch, trainer.model, before)
    if unchanged:
        fail(f"{tag}: parameters with a gradient did not change: {unchanged}")
    trained = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    lap("checks")
    busy = step_busy_ms(torch, trainer, trainer_mod.train_step)
    lap("device_busy")
    # per epoch: the trainer's wait for each batch against its synced steps
    per = {k: [[round(t * 1e3, 2) for t in v[e * per_epoch:(e + 1) * per_epoch]]
               for e in range(H5_EPOCHS)]
           for k, v in (("t_data_ms", timing.seconds("trainer.data")),
                        ("step_ms", step_seconds))}
    sums = {k: [round(sum(e), 1) for e in v] for k, v in per.items()}
    print(f"{tag}: {conf.name} from {H5_FILES} h5 files, {H5_EPOCHS} epochs of {per_epoch} "
          f"steps at B={TRAIN_B} T={TRAIN_T} and a val pass each in {laps['train']:.2f} s; K1/K2 "
          f"launches per step {per_step[:2]}, total K1/K2/K3 {launches}")
    print(f"{tag}: per step and epoch (cold, then warm render cache): " + json.dumps(per))
    print(f"{tag}: sums per epoch, t_data {sums['t_data_ms']} ms against steps "
          f"{sums['step_ms']} ms; median of steps 1-{len(steps) - 1} "
          f"{statistics.median(step_seconds[1:]) * 1e3:.2f} ms; device busy per step "
          f"{fmt(busy)} ms (torch.profiler, a resident batch)")
    if render_s:
        print(f"{tag}: re-render of {TRAIN_B} windows on the host (render + INTER_AREA), "
              f"cold {render_s[0] * 1e3:.1f} ms, warm {render_s[1] * 1e3:.1f} ms")
    print(f"{tag}: val " + json.dumps({k: float(f"{v:.6g}") for k, v in vals[-1].items()}))

    def make_model(device):
        model = load_model(conf, device=device)
        model.load_state_dict(trained)
        return model

    train_vs_cpu(torch, make_model, AttrDict, distributions, DataLoader, dataset, tag)
    lap("vs_cpu")
    print(f"{tag}: host seconds of each part: " + json.dumps(laps))
    return launches


# the baselines phase's configs, written under the build directory: VMPC's
# and BC's training configs beside the experiments' base configs, and their
# control configs (the 9-room control benchmark's agent and env)
VMPC_OVERRIDES = '''
# VMPC: base_configs/vmpc.py's overrides over 9room/gcp_sequential
from experiments.prediction.base_configs import vmpc
model_config.update({k: vmpc.model_config[k] for k in (
    'action_conditioned_pred', 'non_goal_conditioned', 'nz_vae', 'var_inf')})
'''
BC_CONF = '''"""Goal-conditioned behavioral cloning on nav_9rooms at the 9-room widths."""
from video_gcp_tpu.models.bc import BCModel

configuration = {'model': BCModel, 'dataset_name': 'nav_9rooms', 'batch_size': 16,
                 'lr': 2e-4, 'epoch_cycles_train': 2, 'n_rooms': 9}
model_config = {'ngf': 16, 'nz_enc': 128, 'nz_mid': 128, 'n_actions': 2, 'reactive': True}
'''
BASELINE_CONTROL = '''"""One task of the 9-room control benchmark for the MODEL baseline."""
import importlib.util
import os.path

from video_gcp_tpu.core.attrdict import AttrDict
from video_gcp_tpu.planning.infra.agent.general_agent import BenchmarkAgent
from video_gcp_tpu.planning.infra.envs.multiroom2d import TopdownMultiroom2dEnv

current_dir = os.path.dirname(os.path.realpath(__file__))
GCP_EXP_DIR = os.environ['GCP_EXP_DIR']


def train_config(name):
    """The trained model's config, with the dims the trainer merges in from
    nav_9rooms' dataset_spec."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(current_dir, '../../../prediction/9room', name, 'conf.py'))
    conf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conf)
    return AttrDict(conf.model_config, max_seq_len=100, n_actions=2, state_dim=2)


agent = AttrDict(
    type=BenchmarkAgent,
    env=(TopdownMultiroom2dEnv, dict(init_pos=None, goal_pos=None, n_rooms=9,
                                     heading_smoothing=0.1, crop_window=40)),
    T=200, image_height=32, image_width=32,
    start_goal_confs=os.environ['GCP_DATA_DIR'] + '/nav_9rooms/start_goal_configs/raw',
)
POLICY
config = AttrDict(current_dir=current_dir, start_index=0, end_index=0, agent=agent,
                  policy=policy, save_format=['raw'],
                  data_save_dir=GCP_EXP_DIR + '/control/nav_9rooms/MODEL',
                  split_train_val_test=False, traj_per_file=1)
'''
VMPC_POLICY = '''
from video_gcp_tpu.models.sequential import SequentialModel
from video_gcp_tpu.planning.cem.cem_planner import ImageCEMPlanner
from video_gcp_tpu.planning.cem.cost_fcn import ImageWrappedLearnedCostFcn
from video_gcp_tpu.planning.planner_policy import ImageCEMPolicy


class LearnedCost(ImageWrappedLearnedCostFcn):
    """ep74's cost model on the rollouts' latents: the flat planner builds
    its cost from (dense_cost, final_step_weight) alone."""

    def __init__(self, *unused):
        super().__init__(AttrDict(checkpt_path=GCP_EXP_DIR + '/prediction/9room/gcp_tree',
                                  input_dim=128))


# CEM over action sequences (the default FlatCEMSampler); the plan executes
# the best sampled actions and replans every REPLAN env steps
policy = AttrDict(
    type=ImageCEMPolicy, params=train_config('vmpc'), model_cls=SequentialModel,
    act_cond=True, checkpt_path=GCP_EXP_DIR + '/prediction/9room/vmpc',
    cem_planner=ImageCEMPlanner,
    cem_params=AttrDict(horizon=100, action_dim=2, n_iters=ITERS, batch_size=CANDIDATES,
                        elite_frac=0.1, cost_fcn=LearnedCost, use_inferred_actions=False),
    replan_interval=REPLAN,
)
'''
BC_POLICY = '''
from video_gcp_tpu.planning.infra.policy.bc_policy import BehavioralCloningPolicy

policy = AttrDict(type=BehavioralCloningPolicy, params=train_config('bc'),
                  checkpt_path=GCP_EXP_DIR + '/prediction/9room/bc')
'''


def _write(rel, text):
    path = EXP_DIR / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def baseline_train(torch, fused_gn, soft_dtw, trainer_mod, conf, per_step, tag,
                   data_dir=None):
    """`conf` trained from the h5 files under `data_dir` (the h5 phase's
    nav_9rooms unless given) through ModelTrainer from the port's
    initialisation: one epoch and a val pass. Checks `per_step` (K1, K2,
    K3) launches a step, finite losses, gradients and val losses, and that
    some parameter moved. Returns the trainer, each step's metrics, the
    launches and a step's device-busy ms."""
    os.environ["GCP_DATA_DIR"] = str(data_dir or EXP_DIR / "h5_data")
    os.environ["GCP_EXP_DIR"] = str(EXP_DIR)
    args = trainer_mod.parse_args([
        "--path", str(conf), "--resume", "none", "--num_epochs", "1", "--deterministic", "1",
        "--verbose_timing", "1"])
    trainer = trainer_mod.ModelTrainer(args)  # device 'cuda', the default
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    t0 = time.perf_counter()
    steps, vals, launches, timing = run_counted(torch, fused_gn, soft_dtw, trainer_mod, trainer)
    wall = time.perf_counter() - t0
    if len(steps) != len(trainer.train_loader) or len(steps) < 2 or len(vals) != 1:
        fail(f"{tag}: {len(steps)} steps and {len(vals)} val passes")
    check_steps(torch, tag, steps, vals, per_step)
    # RAdam's first 5 steps do not normalise (its rectification starts at
    # step 6): a parameter whose gradient is small moves by less than
    # float32 resolves (all of BC's, whose loss is divided by T*H*W*C)
    with_grad = sum(p.grad is not None and bool(p.grad.abs().sum() > 0)
                    for p in trainer.model.parameters())
    n_unmoved = len(unmoved(torch, trainer.model, before))
    if n_unmoved == with_grad:
        fail(f"{tag}: no parameter with a gradient moved")
    print(f"{tag}: {conf.name} from the h5 files, {len(steps)} steps at "
          f"B={trainer.conf['batch_size']} T={trainer.train_loader.dataset.max_seq_len} and a "
          f"val pass in {wall:.2f} s (checkpoint included); K1/K2/K3 launches per step "
          f"{per_step}, total {launches}; synced ms per step "
          f"{[round(t * 1e3, 1) for t in timing.seconds('train_step')]}; parameters with a "
          f"gradient "
          f"that did not move: {n_unmoved} of {with_grad}")
    busy = step_busy_ms(torch, trainer, trainer_mod.train_step)
    print(f"{tag}: device busy in a step {fmt(busy)} ms (torch.profiler, a resident batch)")
    print(f"{tag}: last step " + json.dumps(
        {k: float(f"{float(v):.6g}") for k, v in steps[-1][3].items() if v.dim() == 0}))
    print(f"{tag}: val " + json.dumps({k: float(f"{v:.6g}") for k, v in vals[0].items()}))
    return trainer, [s[3] for s in steps], launches, busy, timing


def flip_probe(torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
               load_model, windows, models=FLIP_PROBE_MODELS):
    """The baselines phase's VMPC card-vs-CPU step over `models` trainings
    (as baseline_train) x `windows` seeded windows (vs_cpu_batch with seeds
    0..windows-1), each on the CPU twice: with the card's LeakyReLU branches
    at the K1 sites only, and at nets._leaky too. Prints a line for each
    step and how many steps beyond TOLS_TRAIN with the branches at the K1
    sites only had a branch flipped at nets._leaky and pass with it shared."""
    data_dir, gen_s = make_h5_data()
    shutil.copytree(ROOT / "experiments/prediction/base_configs",
                    EXP_DIR / "experiments/prediction/base_configs")
    vmpc_conf = _write("experiments/prediction/9room/vmpc/conf.py",
                       (SEQ_CONF / "conf.py").read_text() + VMPC_OVERRIDES)
    print(f"flip_probe: {H5_FILES} nav_9rooms trajectories in {gen_s:.2f} s")
    rows = []
    for m in range(models):
        trainer, _, _, _, _ = baseline_train(torch, fused_gn, soft_dtw, trainer_mod,
                                          vmpc_conf.parent, VMPC_PER_STEP, "vmpc")
        trained = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}

        def make_model(device):
            model = load_model(vmpc_conf.parent, device=device)
            model.load_state_dict(trained)
            return model

        for w in range(windows):
            k1_only, shared = card_vs_cpu_step(
                torch, make_model, AttrDict, distributions,
                vs_cpu_batch(DataLoader, AttrDict, trainer.train_loader.dataset, seed=w),
                (False, True))
            row = dict(model=m, window=w, k1_flips=k1_only.flips,
                       leaky_flips=shared.leaky_flips, leaky_kink=shared.leaky_kink,
                       k1_only=[k1_only.worst, k1_only.grad_d[k1_only.worst],
                                max(k1_only.loss_d.values())],
                       shared=[shared.worst, shared.grad_d[shared.worst],
                               max(shared.loss_d.values())])
            rows.append(row)
            print(f"flip_probe: model {m} window {w}: flips K1 {k1_only.flips}, nets._leaky "
                  f"{shared.leaky_flips} (|x| {shared.leaky_kink:.2e}); worst gradient, K1 "
                  f"only {row['k1_only'][1]:.3e} {k1_only.worst}, shared "
                  f"{row['shared'][1]:.3e} {shared.worst}")
        del trainer
    beyond = [r for r in rows if r["k1_only"][1] >= TOLS_TRAIN["grad"]
              or r["k1_only"][2] >= TOLS_TRAIN["loss"]]
    print("flip_probe: " + json.dumps(dict(
        steps=len(rows), beyond_tols_k1_only=len(beyond),
        of_them_with_a_leaky_flip=sum(r["leaky_flips"] > 0 for r in beyond),
        of_them_within_tols_shared=sum(r["shared"][1] < TOLS_TRAIN["grad"]
                                       and r["shared"][2] < TOLS_TRAIN["loss"]
                                       for r in beyond),
        steps_with_a_leaky_flip=sum(r["leaky_flips"] > 0 for r in rows),
        worst_k1_only=max(r["k1_only"][1] for r in rows),
        worst_k1_only_with_a_leaky_flip=max(
            [r["k1_only"][1] for r in rows if r["leaky_flips"] > 0], default=None),
        worst_k1_only_without=max(
            [r["k1_only"][1] for r in rows if r["leaky_flips"] == 0], default=None),
        worst_shared=max(r["shared"][1] for r in rows),
        worst_leaky_kink=max(r["leaky_kink"] for r in rows), tols=TOLS_TRAIN)))


def baseline_control(torch, fused_gn, soft_dtw, tag, conf, profiled=None, perf_args=None):
    """One task of a control benchmark (the 9-room one unless `conf` says
    otherwise) from `conf` through planning.run's ControlManager on the
    card, with the planner's calls and the policy's actions recorded, scored
    by compute_control_perf(**perf_args). Returns the recorder, each env
    step's seconds, the BC actions, the launches and the metrics."""
    from video_gcp_torch.core.attrdict import load_pickle
    from video_gcp_torch.evaluation.compute_control_perf import compute_control_perf
    from video_gcp_torch.planning import planner_policy
    from video_gcp_torch.planning.cem import cost_fcn as cost_mod
    from video_gcp_torch.planning.cem import sampler as sampler_mod
    from video_gcp_torch.planning.cem import simulator as sim_mod
    from video_gcp_torch.planning.infra.policy import bc_policy
    from video_gcp_torch.planning.infra.sim import simulator as infra_sim_mod
    from video_gcp_torch.planning.run import ControlManager

    control_setup(torch, tag)
    rec = _Recorder(torch, sim_mod, planner_policy, infra_sim_mod, cost_mod, sampler_mod,
                    profiled)
    env_steps, bc_actions = [], []
    acts = [(planner_policy.ImageCEMPolicy, planner_policy.ImageCEMPolicy.act),
            (bc_policy.BehavioralCloningPolicy, bc_policy.BehavioralCloningPolicy.act)]

    def timed_act(orig):
        @functools.wraps(orig)  # the agent reads act's signature
        def act(policy, *a, **kw):
            t0 = time.perf_counter()
            out = orig(policy, *a, **kw)
            env_steps.append(time.perf_counter() - t0)
            if not np.isfinite(out.actions).all():
                fail(f"{tag}: non-finite action {out.actions}")
            if isinstance(policy, bc_policy.BehavioralCloningPolicy):
                rec.policy = policy
                bc_actions.append((dict(kw), out.actions))
            return out
        return act

    for cls, orig in acts:
        cls.act = timed_act(orig)
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k3.launches"] = 0
    t0 = time.perf_counter()
    try:
        ControlManager([str(conf), "--start_idx", "0", "--end_idx", str(BASELINE_TASKS - 1),
                        "--seed", str(SEED)]).run()
    finally:
        rec.restore()
        for cls, orig in acts:
            cls.act = orig
    run_s = time.perf_counter() - t0
    launches = (COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"])
    log = conf.parent / "log"
    perf = compute_control_perf(load_pickle(log / f"scores_0to{BASELINE_TASKS - 1}.pkl"),
                                **(perf_args or {}))
    if not all(np.isfinite(v) for v in perf.values()):
        fail(f"{tag}: control metrics not finite: {perf}")
    want = (K1_PER_SIM_CALL * len(rec.sim) + K1_PER_ACTION * len(rec.actions)
            + K1_PER_BC_ACTION * len(bc_actions))
    if launches != (want, 0, 0):
        fail(f"{tag}: K1/K2/K3 launches {launches}, expected ({want}, 0, 0): "
             f"{len(rec.sim)} simulator calls, {len(rec.actions)} closed-loop actions, "
             f"{len(bc_actions)} BC actions")
    plan_ms = [p["ms"] for p in rec.plans if p["ms"] is not None]
    print(f"{tag}: {BASELINE_TASKS} task in {run_s:.2f} s, {len(env_steps)} env steps, "
          f"{len(env_steps) / sum(rec.tasks):.1f} env steps/s; K1 launches {launches[0]} = "
          f"{K1_PER_SIM_CALL} x {len(rec.sim)} simulator calls + {K1_PER_ACTION} x "
          f"{len(rec.actions)} closed-loop actions + {K1_PER_BC_ACTION} x {len(bc_actions)} "
          "BC actions; no K2 or K3")
    if rec.plans:
        print(f"{tag}: {len(rec.plans)} _plan calls, ms each {[round(m, 1) for m in plan_ms]} "
              f"(median {statistics.median(plan_ms):.2f}); simulator candidates per call in "
              f"each: {[p['schedule'] for p in rec.plans]}; simulator ms per call "
              f"{[round(t * 1e3, 1) for _, t, _ in rec.sim]}")
    if rec.profile:
        print(f"{tag}: profiled _plan {profiled}: " + json.dumps(
            {k: round(v, 3) for k, v in rec.profile.items()}))
    print(f"{tag}: a smoke run, not a quality result: success rate "
          f"{perf['success_rate']:.3f}, penalized path cost {perf['penalized_cost']:.3f}")
    return rec, env_steps, bc_actions, launches, perf


def baselines_phase(torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader,
                    AttrDict, load_model):
    """The paper's planning baselines in the 9-room maze on the card (see
    the module's docstring, 12). Returns each part's K1/K2/K3 launches."""
    import copy
    from video_gcp_torch.training.config import build_hparams, load_config

    launches, laps, clock = {}, {}, [time.perf_counter()]

    def lap(what):  # seconds of each part
        now = time.perf_counter()
        laps[what] = round(now - clock[0], 2)
        clock[0] = now

    # 1. the flat CEM ablation: the published config with ep74
    control_setup(torch, "baselines")
    lap("setup")
    rec, _, _, launches["flat_cem"], _ = baseline_control(
        torch, fused_gn, soft_dtw, "flat_cem", _config_copy(FLAT_CONTROL))
    sched = {tuple(p["schedule"]) for p in rec.plans}
    if sched != {(5, 5)}:
        fail(f"flat_cem: simulator candidates per _plan {sched}, expected one call of 5 "
             "and the re-rollout of the 5 elites")
    _, diffs = first_sim_vs_cpu(torch, AttrDict, rec, "flat_cem")
    print("flat_cem: card vs CPU, the first simulator call (5 candidates, same z and "
          "end_ind), max abs diff: " + json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()}))
    lap("flat_cem")

    # 2. VMPC: trained 4 steps, then CEM over action sequences
    vmpc_conf = _write("experiments/prediction/9room/vmpc/conf.py",
                       (SEQ_CONF / "conf.py").read_text() + VMPC_OVERRIDES)
    trainer, steps, launches["vmpc_train"], _, _ = baseline_train(
        torch, fused_gn, soft_dtw, trainer_mod, vmpc_conf.parent, VMPC_PER_STEP, "vmpc")
    if any(float(m["kl"]) != 0.0 for m in steps):
        fail(f"vmpc: non-zero KL {[float(m['kl']) for m in steps]} (nz_vae = 0)")
    trained = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}

    def vmpc_model(device):
        model = load_model(vmpc_conf.parent, device=device)
        model.load_state_dict(trained)
        return model

    train_vs_cpu(torch, vmpc_model, AttrDict, distributions, DataLoader,
                 trainer.train_loader.dataset, "vmpc")
    del trainer
    lap("vmpc_train")
    rec, _, _, launches["vmpc_plan"], _ = baseline_control(
        torch, fused_gn, soft_dtw, "vmpc_plan", _write(
            "experiments/control/9room/vmpc/mod_hyper.py",
            BASELINE_CONTROL.replace("POLICY", VMPC_POLICY).replace("MODEL", "vmpc")
            .replace("ITERS", str(VMPC_ITERS)).replace("CANDIDATES", str(VMPC_CANDIDATES))
            .replace("REPLAN", str(VMPC_REPLAN))), profiled=1)
    if rec.first_sim is None or "actions" not in rec.first_sim[0] or "z" in rec.first_sim[0]:
        fail("vmpc_plan: the simulator was not driven by action sequences")
    _, diffs = first_sim_vs_cpu(torch, AttrDict, rec, "vmpc_plan")
    print(f"vmpc_plan: card vs CPU, the first simulator call (the first "
          f"{CONTROL_CANDIDATES[0]} of {VMPC_CANDIDATES} action sequences, no latent, "
          "fixed length), max abs diff: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()}))
    lap("vmpc_plan")

    # 3. goal-conditioned BC (reactive): trained 4 steps, then one task
    bc_conf = _write("experiments/prediction/9room/bc/conf.py", BC_CONF)
    trainer, _, launches["bc_train"], _, _ = baseline_train(
        torch, fused_gn, soft_dtw, trainer_mod, bc_conf.parent,
        (BC_NORMS_PER_STEP, BC_NORMS_PER_STEP, 0), "bc")
    trained = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}

    def bc_model(device):
        model = load_model(bc_conf.parent, device=device)
        model.load_state_dict(trained)
        return model

    train_vs_cpu(torch, bc_model, AttrDict, distributions, DataLoader,
                 trainer.train_loader.dataset, "bc")
    del trainer
    lap("bc_train")
    rec, env_steps, bc_actions, launches["bc_act"], _ = baseline_control(
        torch, fused_gn, soft_dtw, "bc_act", _write(
            "experiments/control/9room/bc/mod_hyper.py",
            BASELINE_CONTROL.replace("POLICY", BC_POLICY).replace("MODEL", "bc")))
    policy = rec.policy
    cpu_model = copy.deepcopy(policy.model).cpu()
    kw, got = bc_actions[0]
    i0 = policy._preprocess_input(kw["images"][kw["t"]])
    ig = policy._preprocess_input(kw["goal_image"][-1] if np.ndim(kw["goal_image"]) > 4
                                  else kw["goal_image"])
    with torch.inference_mode():
        want = cpu_model.act_single(torch.from_numpy(i0), torch.from_numpy(ig))[0].numpy()[0]
    diff = float(np.abs(got - want).max())
    if not diff < TOL_ACTION:
        fail(f"bc_act: the first action differs from the CPU by {diff} (tol {TOL_ACTION})")
    print(f"bc_act: {statistics.median(env_steps[1:]) * 1e3:.3f} ms per env step (median); "
          f"card vs CPU, the first action, max abs diff {diff:.3e}")
    lap("bc_act")

    # 4. 9room/gcp_sequential with use_conv_lstm, from the port's initialisation
    bundle = load_config(SEQ_CONF)
    hp = build_hparams(bundle).overwrite(dict(use_conv_lstm=True))
    torch.manual_seed(0)
    with torch.device("cuda"):  # 71M parameters: initialised on the card
        model = bundle.configuration["model"](hp)
    model = model.to(memory_format=torch.channels_last).eval()
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (TRAIN_B, 2, 32, 32, 3)).astype(np.uint8)
    z = rng.randn(TRAIN_B, TRAIN_T - 1, hp["nz_vae"]).astype(np.float32)

    def inputs(b, device):
        return AttrDict(I_0=torch.from_numpy(frames[:b, 0]).to(device),
                        I_g=torch.from_numpy(frames[:b, 1]).to(device),
                        end_ind=torch.full((b,), TRAIN_T - 1, device=device),
                        z=torch.from_numpy(z[:b]).to(device))

    times = []
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k3.launches"] = 0
    with torch.inference_mode():
        for _ in range(2):  # cold, then warm
            t0 = time.perf_counter()
            out = model(inputs(TRAIN_B, "cuda"), phase="test", mode="prior")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches["conv_lstm"] = (COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"])
    if launches["conv_lstm"] != (2 * K1_PER_SIM_CALL, 0, 0):
        fail(f"conv_lstm: K1/K2/K3 launches {launches['conv_lstm']} in 2 forwards")
    if out.dense_rec.images.shape != (TRAIN_B, TRAIN_T, 32, 32, 3) or not all(
            torch.isfinite(out.dense_rec[k]).all() for k in ("images", "encodings")):
        fail("conv_lstm: the rollout is not finite or not of its shape")
    state = model.cell.lstm.state_size
    with torch.inference_mode():
        card = model(inputs(CONV_LSTM_B, "cuda"), phase="test", mode="prior")
        ref = copy.deepcopy(model).cpu()(inputs(CONV_LSTM_B, "cpu"), phase="test",
                                         mode="prior")
    diffs = {k: float((card.dense_rec[k].cpu() - ref.dense_rec[k]).abs().max())
             for k in ("images", "encodings")}
    if not (diffs["images"] < TOLS_SLICE["images"]
            and diffs["encodings"] < TOLS_SLICE["timeline_latents"]):
        fail(f"conv_lstm: card vs CPU {diffs}")
    print(f"conv_lstm: 9room/gcp_sequential with use_conv_lstm ({sum(p.numel() for p in model.parameters())} "
          f"parameters, packed state {state}), a B={TRAIN_B} T={TRAIN_T} prior rollout with "
          f"injected z: cold {times[0] * 1e3:.1f} ms, warm {times[1] * 1e3:.1f} ms; K1 "
          f"{K1_PER_SIM_CALL} a forward; card vs CPU at B={CONV_LSTM_B}, max abs diff "
          + json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()}))
    del model
    torch.cuda.empty_cache()
    lap("conv_lstm")
    print("baselines: seconds of each part " + json.dumps(laps) + "; K1/K2/K3 launches "
          + json.dumps(launches))
    return launches

# ---------------------------------------------------------------------------
# the 25room phase: the paper's 25-room long-horizon path
# ---------------------------------------------------------------------------

def maze_data(tag, data_gen, data_dir, name, n_files, layout):
    """`n_files` trajectories of the dataset `name` by the port's PRM expert
    from a copy of the config `data_gen`, in ROOM25_GEN_WORKERS spawned
    workers (worker i seeded SEED + i), into `data_dir`/`name`; each file
    read back through data/h5.py: its keys, shapes and dtypes against
    `layout`, its pad mask a prefix of ones, its states finite. Returns the
    trajectories' lengths in frames, the generation's and the read's
    seconds."""
    from video_gcp_torch.data import h5
    from video_gcp_torch.planning.run import ControlManager

    shutil.rmtree(data_dir / name, ignore_errors=True)
    os.environ["GCP_DATA_DIR"] = str(data_dir)
    t0 = time.perf_counter()
    ControlManager([str(_config_copy(data_gen)), "--device", "cpu", "--nworkers",
                    str(ROOM25_GEN_WORKERS), "--start_idx", "0", "--end_idx",
                    str(n_files - 1), "--seed", str(SEED)]).run()
    gen_s = time.perf_counter() - t0
    files = sorted((data_dir / name).glob("*.h5"))
    if len(files) != n_files:
        fail(f"{tag}: the data generation wrote {len(files)} files, expected {n_files}")
    t0 = time.perf_counter()
    lengths = []
    for path in files:
        with h5.File(path, "r") as f:
            got = {k: (f[f"traj0/{k}"].shape, str(f[f"traj0/{k}"].dtype)) for k in f["traj0"]}
            if list(f) != ["traj0", "traj_per_file"] or got != layout:
                fail(f"{tag}: {path.name} holds {list(f)}, traj0 {got}")
            if not np.isfinite(f["traj0/states"][()]).all():
                fail(f"{tag}: {path.name} has non-finite states")
            pad = f["traj0/pad_mask"][()]
            n = int(pad.sum())
            if n < 2 or not (pad[:n] == 1).all():
                fail(f"{tag}: {path.name}'s pad mask is no prefix of ones: {pad}")
            lengths.append(n)
    return lengths, gen_s, time.perf_counter() - t0


def room25_data(tag):
    """ROOM25_FILES nav_25rooms trajectories (maze_data). Returns their
    directory."""
    data_dir = EXP_DIR / "h5_25"
    _, gen_s, read_s = maze_data(tag, ROOM25_DATA_GEN, data_dir, "nav_25rooms", ROOM25_FILES,
                                 ROOM25_LAYOUT)
    print(f"{tag}: {ROOM25_FILES} nav_25rooms trajectories (T={FLAGSHIP_T}, 128x128) by the PRM "
          f"expert (host, {ROOM25_GEN_WORKERS} workers) in {gen_s:.2f} s, "
          f"{gen_s / ROOM25_FILES:.3f} s per trajectory; read back through data/h5.py in "
          f"{read_s:.2f} s")
    return data_dir


def maze_train(torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
               load_model, conf_rel, data_dir, tag, dataset_cls, n_steps, val_pass):
    """The config `conf_rel` (a copy under the build directory) trained
    from the h5 files in `data_dir` (baseline_train: one epoch of `n_steps`
    steps at B=16 and its val pass from the port's initialisation, 20 K1
    and 20 K2 a step, `val_pass` launches in the val pass), then one step
    card vs CPU. Prints the peak device memory, t_data, the warm ms a step,
    training frames/s, the device-busy ms a step and the idle share.
    Returns the launches and the config's directory."""
    conf = _config_copy(conf_rel).parent
    exp = EXP_DIR / conf.relative_to(EXP_DIR / "experiments")
    shutil.rmtree(exp, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    per_step = (NORMS_PER_STEP, NORMS_PER_STEP, 0)
    trainer, _, launches, busy, timing = baseline_train(torch, fused_gn, soft_dtw, trainer_mod,
                                                        conf,
                                                per_step, tag, data_dir=data_dir)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    dataset = trainer.train_loader.dataset
    if type(dataset).__name__ != dataset_cls or len(trainer.train_loader) != n_steps:
        fail(f"{tag}: dataset {type(dataset).__name__}, {len(trainer.train_loader)} steps")
    got_val = tuple(n - n_steps * k for n, k in zip(launches, per_step))
    if got_val != val_pass:
        fail(f"{tag}: K1/K2/K3 launches in the val pass {got_val}, expected {val_pass}")
    ckpt = exp / "weights/weights_ep0/state.pt"
    if not ckpt.is_file():
        fail(f"{tag}: the trainer wrote no {ckpt}")
    trained = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    step_seconds = timing.seconds("train_step")
    warm = statistics.median(step_seconds[1:])
    t = dataset.max_seq_len
    idle = f"{1 - busy / (warm * 1e3):.3f}" if busy else "n/m"
    print(f"{tag}: {sum(v.numel() for v in trained.values())} parameters; K1/K2/K3 launches "
          f"in the val pass {got_val}; t_data ms "
          f"{[round(s * 1e3, 1) for s in timing.seconds('trainer.data')]}; warm ms per step "
          f"(median "
          f"of steps 1-{n_steps - 1}) {warm * 1e3:.2f}; training frames/s "
          f"{TRAIN_B * t / warm:.1f}; device busy {fmt(busy)} ms a step, idle share {idle}; "
          f"peak device memory {peak_gib:.3f} GiB")
    del trainer
    torch.cuda.empty_cache()

    def make_model(device):
        model = load_model(conf, device=device)
        model.load_state_dict(trained)
        return model

    train_vs_cpu(torch, make_model, AttrDict, distributions, DataLoader, dataset, tag)
    return launches, conf


def room25_control(torch, fused_gn, soft_dtw, AttrDict, name):
    """One task of control/25room/`name` on the card from the trained
    checkpoint (baseline_control: T=400 env steps, the second _plan
    profiled), scored at n_rooms 25 with max_seq_len the agent's T. Checks
    the env steps and the candidates of every simulator call; prints ms per
    _plan and per simulator call at each candidate count, env steps/s and
    the metrics. Returns the recorder and the launches."""
    tag = f"room25_{name}"
    rec, env_steps, _, launches, perf = baseline_control(
        torch, fused_gn, soft_dtw, tag, _config_copy(ROOM25_CONTROL[name]), profiled=1,
        perf_args=dict(n_rooms=ROOM25_N_ROOMS, max_seq_len=ROOM25_ENV_T))
    if len(env_steps) != ROOM25_ENV_T or len(rec.actions) != ROOM25_ENV_T:
        fail(f"{tag}: {len(env_steps)} env steps and {len(rec.actions)} closed-loop actions, "
             f"expected {ROOM25_ENV_T}")
    want = {(10, 10, 5, 1)} if name == "gcp_tree" else {(5, 5)}
    if {tuple(p["schedule"]) for p in rec.plans} != want or rec.profile is None:
        fail(f"{tag}: simulator candidates per _plan {[p['schedule'] for p in rec.plans]}, "
             f"expected {want} in each, the second profiled")
    by_count = {}
    for n, s, _ in rec.sim:
        by_count.setdefault(n, []).append(s * 1e3)
    warm = [p["ms"] for p in rec.plans[2:]] or [p["ms"] for p in rec.plans if p["ms"]]
    print(f"{tag}: {len(rec.plans)} _plan calls (one at the start, one each time a plan "
          f"ran out), warm median {statistics.median(warm):.2f} ms; simulator ms per call by "
          "candidates " + json.dumps({n: [round(t, 2) for t in ts]
                                      for n, ts in sorted(by_count.items())})
          + f"; closed-loop action {statistics.median(rec.actions[1:]) * 1e3:.3f} ms (median); "
          f"{len(env_steps) / sum(rec.tasks):.1f} env steps/s over the task")
    if name == "gcp_tree":  # the split times the hierarchical sampler's parts
        split = {k: statistics.median(p[k] for p in rec.plans if p["ms"] is not None)
                 for k in ("sim_ms", "capping_ms", "cost_ms", "optimizer_ms", "sample_ms")}
        print(f"{tag}: host time of a _plan, medians over the unprofiled calls (ms): "
              + json.dumps({k: round(v, 3) for k, v in split.items()}))
    print(f"{tag}: control metrics at n_rooms={ROOM25_N_ROOMS}, max_seq_len={ROOM25_ENV_T} "
          "(one task from 4 training steps: a smoke run, not a quality result) "
          + json.dumps({k: round(v, 4) for k, v in perf.items()}))
    return rec, launches


def room25_phase(torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
                 load_model):
    """The paper's 25-room long-horizon path on the card (see the module's
    docstring, 10b). Returns each part's K1/K2/K3 launches."""
    from video_gcp_torch.planning.run import ControlManager

    launches, laps, clock = {}, {}, [time.perf_counter()]

    def lap(what):  # seconds of each part
        now = time.perf_counter()
        laps[what] = round(now - clock[0], 2)
        clock[0] = now

    control_setup(torch, "room25")  # the base configs' copy, GCP_EXP_DIR
    data_dir = room25_data("room25_data")
    lap("data")
    launches["room25_train"], _ = maze_train(
        torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
        load_model, ROOM25_CONF, data_dir, "room25_train", "Nav25Rooms", ROOM25_STEPS,
        ROOM25_VAL_PASS)
    lap("train")
    os.environ["GCP_DATA_DIR"] = str(EXP_DIR / "data")
    text = (ROOT / DATA_GEN).read_text()
    for old, new in ROOM25_START_GOAL.items():
        if text.count(old) != 1:
            fail(f"room25: {old!r} found {text.count(old)} times in {DATA_GEN}")
        text = text.replace(old, new)
    start_goal = _write("experiments/data_gen/nav_25rooms_start_goal/mod_hyper.py", text)
    t0 = time.perf_counter()
    ControlManager([str(start_goal), "--device", "cpu", "--start_idx", "0", "--end_idx", "0",
                    "--seed", str(SEED)]).run()
    print(f"room25: start/goal configuration 0 of the 25-room maze by the PRM expert (CPU) in "
          f"{time.perf_counter() - t0:.2f} s")
    lap("start_goal")
    rec, launches["room25_gcp_tree"] = room25_control(torch, fused_gn, soft_dtw, AttrDict,
                                                      "gcp_tree")
    cpu_model, diffs = first_sim_vs_cpu(torch, AttrDict, rec, "room25_gcp_tree",
                                        n=ROOM25_VS_CPU_CANDIDATES)
    diffs["action"] = first_action_vs_cpu(torch, rec, cpu_model, "room25_gcp_tree")
    print(f"room25_gcp_tree: card vs CPU, the first simulator call (its first "
          f"{ROOM25_VS_CPU_CANDIDATES} candidates, same z and end_ind) and the first action, "
          "max abs diff: " + json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()}))
    del cpu_model
    lap("gcp_tree")
    _, launches["room25_gcp_sequential"] = room25_control(torch, fused_gn, soft_dtw, AttrDict,
                                                          "gcp_sequential")
    lap("gcp_sequential")
    if any(v[2] for v in launches.values()):
        fail(f"room25: K3 launched {launches}")
    print("room25: seconds of each part " + json.dumps(laps) + "; K1/K2/K3 launches "
          + json.dumps(launches))
    return launches


# ---------------------------------------------------------------------------
# the long phase: the 500-frame horizon
# ---------------------------------------------------------------------------

def long_data(tag, data_dir):
    """LONG_FILES nav_25rooms_long trajectories (maze_data) into `data_dir`,
    beside the nav_9rooms files that the sweep reads."""
    lengths, gen_s, read_s = maze_data(tag, LONG_DATA_GEN, data_dir, "nav_25rooms_long",
                                       LONG_FILES, LONG_LAYOUT)
    print(f"{tag}: {LONG_FILES} nav_25rooms_long trajectories (of the config's "
          f"{LONG_CONFIG_FILES}; T={LONG_T}, 64x64, subsample_factor 0.5) by the PRM expert "
          f"(host, {ROOM25_GEN_WORKERS} workers) in {gen_s:.2f} s, {gen_s / LONG_FILES:.3f} s "
          f"per trajectory; path length {statistics.mean(lengths) - 1:.1f} steps on average "
          f"({min(lengths) - 1}-{max(lengths) - 1}); read back through data/h5.py with their "
          f"pad masks in {read_s:.2f} s")


def _trainer_run(trainer_mod, conf, flags):
    """A ModelTrainer of the checkpoint that the long phase trained, for
    --dataset_val_sweep or --metric."""
    args = trainer_mod.parse_args(["--path", str(conf), "--resume", "latest",
                                   "--deterministic", "1", *flags])
    return trainer_mod.ModelTrainer(args)  # device 'cuda', the default


def _run_captured(trainer):
    """trainer.run(), its printed lines echoed and returned."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            trainer.run()
    finally:
        print(buf.getvalue(), end="")
    return buf.getvalue().splitlines()


def long_sweep(torch, fused_gn, soft_dtw, trainer_mod, conf, tag):
    """`--dataset_val_sweep 1` on the trained tree: its val pass at each of
    LONG_SWEEP's horizons, the model rebuilt at that depth. Checks both
    [dataset sweep] lines, the length head kept fresh at T=100 (its head is
    max_seq_len wide), finite val losses, LONG_VAL_PASS launches at each
    horizon, and the trainer's own model back, unchanged, afterwards.
    Returns the launches."""
    trainer = _trainer_run(trainer_mod, conf, ["--dataset_val_sweep", "1"])
    model, val_loader = trainer.model, trainer.val_loader
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    vals, real_val = [], trainer.val
    trainer.val = lambda epoch: vals.append(real_val(epoch)) or vals[-1]
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k3.launches"] = 0
    t0 = time.perf_counter()
    lines = _run_captured(trainer)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = (COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"])
    for name, t, lv in LONG_SWEEP:
        if f"[dataset sweep] {name} (T={t}, L={lv})" not in lines:
            fail(f"{tag}: no [dataset sweep] line for {name} at T={t}, L={lv}")
    fresh = [ln for ln in lines if "horizon-dependent params kept fresh" in ln]
    if len(fresh) != 1 or "length_pred." not in fresh[0]:
        fail(f"{tag}: the length head was not reported kept fresh once: {fresh}")
    if len(vals) != len(LONG_SWEEP) or not all(np.isfinite(v) for val in vals
                                               for v in val.values()):
        fail(f"{tag}: val losses {vals}")
    want = tuple(len(LONG_SWEEP) * n for n in LONG_VAL_PASS)
    if launches != want:
        fail(f"{tag}: K1/K2/K3 launches {launches}, expected {want}")
    if trainer.model is not model or trainer.val_loader is not val_loader or not all(
            torch.equal(v, before[k]) for k, v in model.state_dict().items()):
        fail(f"{tag}: the trainer's own model is not back unchanged after the sweep")
    print(f"{tag}: {len(LONG_SWEEP)} horizons in {sec:.2f} s; K1/K2/K3 launches {launches} = "
          f"{LONG_VAL_PASS} a val pass; val total loss by horizon "
          + json.dumps({f"T={t}": float(f"{v['total']:.6g}")
                        for (_, t, _), v in zip(LONG_SWEEP, vals)}))
    return launches


def long_eval(torch, fused_gn, soft_dtw, trainer_mod, conf, tag):
    """`--metric 1` on the trained tree: the Evaluator's top-of-100 under
    the config's 'pruned_dtw' on the val split (one batch of LONG_EVAL_B, the
    only cut). Checks 15 K1 and one K4 a sampled forward, no K2 or K3, and
    finite eval/... metrics. Returns the K1/K2/K3/K4 launches."""
    from video_gcp_torch.evaluation.evaluator import Evaluator

    trainer = _trainer_run(trainer_mod, conf, ["--metric", "1"])
    if (trainer.conf["metric_pruning_scheme"], trainer.conf["top_of_100_eval"]) != (
            "pruned_dtw", True):
        fail(f"{tag}: scheme {trainer.conf['metric_pruning_scheme']}, top_of_100 "
             f"{trainer.conf['top_of_100_eval']}")
    if (len(trainer.val_loader), len(trainer.val_loader.dataset)) != (1, LONG_EVAL_B):
        fail(f"{tag}: {len(trainer.val_loader)} val batches of {len(trainer.val_loader.dataset)} "
             f"examples, expected one of {LONG_EVAL_B}")
    summaries, real = [], trainer.run_metric_eval
    trainer.run_metric_eval = lambda: summaries.append(real()) or summaries[-1]
    for k in ("k1.launches", "k2.launches", "k3.launches", "k4.launches"):
        COUNTS[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _run_captured(trainer)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = (COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"],
                COUNTS["k4.launches"])
    n_samples = 100 + Evaluator.N_PLOTTED_ELEMENTS
    if launches != (15 * n_samples, 0, 0, n_samples):
        fail(f"{tag}: K1/K2/K3/K4 launches {launches} for {n_samples} sampled forwards, "
             f"expected 15 K1 and one K4 each")
    summary, = summaries
    if not summary or not all(np.isfinite(v) for v in summary.values()):
        fail(f"{tag}: eval metrics {summary}")
    print(f"{tag}: Evaluator 'pruned_dtw' top-of-100 on a val batch of {LONG_EVAL_B} (the only "
          f"cut), T={LONG_T}, {LONG_NODES} nodes: {sec:.3f} s per batch, "
          f"{100 * LONG_EVAL_B * LONG_NODES / sec:.0f} decoded frames/s; K1 launches "
          f"{launches[0]} = 15 x {n_samples} sampled forwards, K4 {launches[3]}; eval/ "
          + json.dumps({k: float(f"{v:.6g}") for k, v in summary.items()}))
    del trainer
    return launches


def long_phase(torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
               load_model):
    """The 500-frame horizon on the card (see the module's docstring, 10c).
    Returns each part's K1/K2/K3 launches."""
    launches, laps, clock = {}, {}, [time.perf_counter()]

    def lap(what):  # seconds of each part
        now = time.perf_counter()
        laps[what] = round(now - clock[0], 2)
        clock[0] = now

    control_setup(torch, "long")  # the base configs' copy, GCP_EXP_DIR
    data_dir = EXP_DIR / "h5_data"
    if not (data_dir / "nav_9rooms").is_dir():
        fail("long: no nav_9rooms files from the h5 phase for the sweep")
    long_data("long_data", data_dir)
    lap("data")
    launches["long_train"], conf = maze_train(
        torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
        load_model, LONG_CONFS["gcp_tree"], data_dir, "long_train",
        "GlobalSplitVarLenVideoDataset", LONG_STEPS, LONG_VAL_PASS)
    lap("train")
    launches["long_sweep"] = long_sweep(torch, fused_gn, soft_dtw, trainer_mod, conf,
                                        "long_sweep")
    lap("sweep")
    launches["long_eval"] = long_eval(torch, fused_gn, soft_dtw, trainer_mod, conf, "long_eval")
    lap("eval")
    launches["long_sequential"], _ = maze_train(
        torch, fused_gn, soft_dtw, trainer_mod, distributions, DataLoader, AttrDict,
        load_model, LONG_CONFS["gcp_sequential"], data_dir, "long_sequential",
        "GlobalSplitVarLenVideoDataset", LONG_STEPS, LONG_VAL_PASS)
    lap("sequential")
    if any(v[2] for v in launches.values()):
        fail(f"long: K3 launched {launches}")
    print("long: seconds of each part " + json.dumps(laps) + "; K1/K2/K3 launches "
          + json.dumps(launches))
    return launches


# ---------------------------------------------------------------------------
# the dist phase: multi-GPU training and candidate-sharded planning
# ---------------------------------------------------------------------------

def dist_layout(torch):
    """(cards, trainer ranks, step ranks, the step ranks' backend)."""
    cards = torch.cuda.device_count()
    trainer_w = min(cards, DIST_MAX_CARDS)
    steps_w = max(2, 2 * (trainer_w // 2))
    return cards, trainer_w, steps_w, "nccl" if steps_w <= cards else "gloo"


class Ranks:
    """chip_smoke.py --dist-rank `mode` on n ranks, each in a session of
    its own so that `stop` ends every process: under `torchrun --standalone`
    (the trainer, as a user launches it), or started here with the
    environment torchrun gives its ranks (the steps: torchrun's agent
    costs ~8 s a launch)."""

    def __init__(self, n, mode, workdir, torchrun):
        self.n, self.mode, self.workdir = n, mode, workdir
        self.log = workdir / f"{mode}.log"
        script = [str(ROOT / "chip_smoke.py"), "--dist-rank", mode, "--dist-dir", str(workdir)]
        env = dict(os.environ, GCP_EXP_DIR=str(EXP_DIR / "dist"), OMP_NUM_THREADS="2")
        if torchrun:
            cmds = [([sys.executable, "-m", "torch.distributed.run", "--standalone",
                      f"--nproc_per_node={n}"] + script, env)]
        else:
            import socket
            with socket.socket() as sock:  # a free port on this host
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            cmds = [([sys.executable] + script,
                     dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                          LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))) for r in range(n)]
        self.t0, self.launched = time.perf_counter(), time.time()
        with open(self.log, "w") as out:
            self.procs = [subprocess.Popen(cmd, cwd=ROOT, env=e, stdout=out,
                                           stderr=subprocess.STDOUT, start_new_session=True)
                          for cmd, e in cmds]

    def stop(self):
        import signal
        for proc in self.procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()

    def results(self, tag):
        """Each rank's JSON and the launch's wall seconds; the first process
        to fail, or the time limit, stops them all."""
        deadline = time.perf_counter() + DIST_TIMEOUT_S
        while any(p.poll() is None for p in self.procs) and not any(
                p.poll() for p in self.procs) and time.perf_counter() < deadline:
            time.sleep(0.05)
        rcs = [p.poll() for p in self.procs]
        self.stop()
        wall = time.perf_counter() - self.t0
        if any(rc != 0 for rc in rcs):
            print(self.log.read_text()[-12000:], file=sys.stderr)
            fail(f"{tag}: {self.n} ranks ended with {rcs} (None: stopped at the "
                 f"{DIST_TIMEOUT_S} s limit or after another rank failed)")
        ranks = [json.loads((self.workdir / f"{self.mode}_rank{r}.json").read_text())
                 for r in range(self.n)]
        print(f"{tag}: seconds from the launch, rank 0: " + json.dumps(
            {k: round(v - self.launched, 2) for k, v in ranks[0]["marks"].items()}))
        return ranks, wall


def _rank_json(workdir, mode, rank, out):
    (workdir / f"{mode}_rank{rank}.json").write_text(json.dumps(out))


def _checksums(torch, model, mesh=None):
    """The min and max over the ranks of the sum of every parameter in
    float64: equal when every rank holds the same weights. A split
    parameter adds its shards' sums over the 'model' axis (gathering whole
    tensors through DTensor's collectives crashes over gloo on the card)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    dev = torch.cuda.current_device()
    whole = sum(p.detach().double().sum() for p in model.parameters()
                if not isinstance(p, DTensor)).reshape(1).to(dev)
    shards = sum((p.to_local().detach().double().sum() for p in model.parameters()
                  if isinstance(p, DTensor)), torch.zeros((), device=dev)).reshape(1)
    if mesh is not None and "model" in (mesh.mesh_dim_names or ()):
        dist.all_reduce(shards, group=mesh.get_group("model"))
    total = whole + shards
    lo, hi = total.clone(), total.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return float(lo), float(hi)


def rank_trainer(torch, fused_gn, soft_dtw, workdir):
    """(a) on one rank of torchrun: the trainer of 9room/gcp_tree from ep74
    over NCCL, DIST_STEPS steps, each step's launches counted on this rank."""
    import torch.distributed as dist
    from video_gcp_torch.training import trainer as trainer_mod
    args = trainer_mod.parse_args([
        "--path", str(CONF), "--resume", str(WEIGHTS), "--feed_random_data", "1",
        "--num_epochs", "1", "--skip_first_val", "1", "--deterministic", "1",
        "--verbose_timing", "1"])
    marks = dict(started=T_STARTED, main=time.time())
    trainer = trainer_mod.ModelTrainer(args)
    loader = trainer.train_loader
    loader.dataset.n_seqs = DIST_STEPS * TRAIN_B // loader.n_repeat
    marks["trainer_built"] = time.time()
    torch.cuda.reset_peak_memory_stats()
    steps, _, launches, timing = run_counted(torch, fused_gn, soft_dtw, trainer_mod, trainer)
    marks["trained"] = time.time()
    lo, hi = _checksums(torch, trainer.model)
    _rank_json(workdir, "trainer", trainer.dist.rank, dict(
        world=trainer.dist.world_size, backend=dist.get_backend(),
        device=str(trainer.device), card=torch.cuda.get_device_name(trainer.device),
        per_step=[list(s[:3]) for s in steps], launches=list(launches),
        totals=[float(s[3]["total"]) for s in steps],
        finite=[bool(s[3]["grads_finite"]) and all(bool(torch.isfinite(v).all())
                                                     for v in s[3].values()) for s in steps],
        step_seconds=timing.seconds("train_step"), checksum=[lo, hi], marks=marks,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
    dist.destroy_process_group()


def _flagship(torch):
    from video_gcp_torch.data.datasets import RandomVideoDataset
    from video_gcp_torch.training.config import build_hparams, load_config
    bundle = load_config(FLAGSHIP_CONF)
    hp = build_hparams(bundle)
    data = RandomVideoDataset(None, dict(hp), bundle.data_conf, "train")
    return bundle, hp, data


def rank_steps(torch, fused_gn, soft_dtw, workdir):
    """(b) and (c) on one rank: one data-parallel step of ep74
    on this rank's rows of the first batch with the whole batch's noise and
    K1 branches, then one dp x fsdp step of the 25-room flagship."""
    import torch.distributed as dist
    import warnings
    from video_gcp_torch.core import distributions
    from video_gcp_torch.core.attrdict import AttrDict
    from video_gcp_torch.load import load_model
    from video_gcp_torch.parallel.mesh import axis_rank, batch_rows, init_distributed, make_mesh
    from video_gcp_torch.parallel.train_step import (
        broadcast_model, make_optimizer, shard_model, train_step)
    from torch.distributed.tensor import DTensor
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module")  # outputs are views
    marks = dict(started=T_STARTED, main=time.time())
    spec = torch.load(workdir / "spec.pt", weights_only=False)
    info = init_distributed("cuda", backend=spec["backend"])
    rank, world, dev = info.rank, info.world_size, info.device
    marks["group"] = time.time()
    # started beside the trainer's run, whose steps are timed: wait for it
    # to end before any work on the card
    deadline = time.time() + DIST_TIMEOUT_S
    while not (workdir / "trainer_done").exists():
        if time.time() > deadline:
            fail("dist steps: the trainer's run did not end")
        time.sleep(0.05)
    marks["trainer_done"] = time.time()
    out = dict(world=world, backend=dist.get_backend(), device=str(dev),
               card=torch.cuda.get_device_name(dev))

    # (b) data parallel, ep74
    mesh = make_mesh(world, device_type="cuda")
    model = load_model(CONF, weights=WEIGHTS, device=dev).train()
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam", 2e-4)
    rows = batch_rows(rank, world, TRAIN_B)
    batch = AttrDict({k: v[rows].to(dev) for k, v in spec["batch"].items()})
    noise = SharedNoise(torch, distributions, spec["draws"], (rank, world))
    signs = SharedSigns(torch, spec["masks"], (rank, world))
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k3.launches"] = 0
    met = signs.run(lambda: noise.run(lambda: train_step(
        model, opt, batch, 0, torch.Generator(dev), mesh)), record=False)
    torch.cuda.synchronize()
    out["dp"] = dict(rows=[rows.start, rows.stop],
                     launches=[COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"]],
                     metrics={k: float(v) for k, v in met.items() if v.dim() == 0},
                     checksum=list(_checksums(torch, model)))
    if rank == 0:
        torch.save({n: p.grad.detach().cpu() for n, p in model.named_parameters()
                    if p.requires_grad}, workdir / "dp_grads.pt")
    del model, opt, batch
    torch.cuda.empty_cache()
    marks["dp_step"] = time.time()

    # (c) dp x fsdp, the 25-room flagship from its initialisation
    bundle, hp, data = _flagship(torch)
    torch.manual_seed(0)
    with torch.device(dev):  # initialised on the card: 85M parameters
        model = bundle.configuration["model"](hp)
    model.to(memory_format=torch.channels_last)
    n_params = sum(p.numel() for p in model.parameters())
    broadcast_model(model)
    fmesh = make_mesh(world, ("data", "model"), (world // 2, 2), "cuda")
    shard_model(model, fmesh)
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam", 2e-4)
    b = hp["batch_size"]
    rows = batch_rows(axis_rank(fmesh, "data"), world // 2, b)
    items = [data[i] for i in range(rows.start, rows.stop)]
    batch = AttrDict({k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items])).to(dev)
                      for k in items[0]})
    gen = torch.Generator(dev).manual_seed(axis_rank(fmesh, "data"))
    sharded = [p for p in model.parameters() if isinstance(p, DTensor)]
    local = sum(p.to_local().numel() if isinstance(p, DTensor) else p.numel()
                for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    COUNTS["k1.launches"] = COUNTS["k2.launches"] = COUNTS["k3.launches"] = 0
    t0 = time.perf_counter()
    met = train_step(model, opt, batch, 0, gen, fmesh)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = [COUNTS["k1.launches"], COUNTS["k2.launches"], COUNTS["k3.launches"]]
    t0 = time.perf_counter()
    met2 = train_step(model, opt, batch, 1, gen, fmesh)  # warm
    torch.cuda.synchronize()
    marks["fsdp_steps"] = time.time()
    out["fsdp"] = dict(
        mesh=[world // 2, 2], rows=[rows.start, rows.stop], launches=launches,
        metrics={k: float(v) for k, v in met.items() if v.dim() == 0},
        finite=bool(met["grads_finite"]) and bool(met2["grads_finite"]) and all(
            bool(torch.isfinite(v).all()) for m in (met, met2) for v in m.values()),
        params=n_params, sharded_tensors=len(sharded),
        sharded_params=sum(p.numel() for p in sharded),
        local_params=local,
        step_s=[step_s, time.perf_counter() - t0],
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        checksum=list(_checksums(torch, model, fmesh)))
    out["marks"] = marks
    _rank_json(workdir, "steps", rank, out)
    dist.destroy_process_group()


def dist_phase(torch, fused_gn, soft_dtw, ep74, load_model, AttrDict, distributions,
               DataLoader, dataset):
    """Multi-GPU training and candidate-sharded planning: (a) torchrun of
    the trainer over NCCL on min(cards, 4) ranks, (b) a data-parallel step
    against the single-process step on the whole batch, (c) a dp x fsdp step
    of the 25-room flagship, (d) a 100-candidate plan call split over the
    cards against the unsplit one. Returns each path's (K1, K2, K3)
    launches, summed over the ranks."""
    cards, trainer_w, steps_w, backend = dist_layout(torch)
    print(f"dist: torch.cuda.device_count() {cards}; the trainer on {trainer_w} rank(s) "
          f"over nccl, the steps on {steps_w} ranks over {backend}"
          + (" (two ranks share one card)" if steps_w > cards else ""))
    workdir = EXP_DIR / "dist_work"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    torch.cuda.empty_cache()  # the ranks are processes of their own on the card
    launches = {}

    # (b)'s reference: the single-process step on the whole first batch,
    # recording its noise and K1 branches for the ranks
    from video_gcp_torch.parallel.train_step import make_optimizer, train_step
    first = next(iter(DataLoader(dataset, TRAIN_B, shuffle=True, n_repeat=2, num_workers=4)))
    noise, signs = SharedNoise(torch, distributions), SharedSigns(torch)
    model = load_model(CONF, weights=WEIGHTS).train()
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam", 2e-4)
    met = signs.run(lambda: noise.run(lambda: train_step(
        model, opt, AttrDict({k: v.cuda() for k, v in first.items()}), 0,
        torch.Generator("cuda"))), record=True)
    whole = ({k: float(v) for k, v in met.items() if v.dim() == 0},
             {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.requires_grad})
    del model, opt
    torch.cuda.empty_cache()
    torch.save(dict(backend=backend, batch={k: v.cpu() for k, v in first.items()},
                    draws=noise.draws, masks=signs.masks), workdir / "spec.pt")

    # (b) and (c) start up (imports, CUDA, the process group) beside (a) and
    # wait for it to end before any work on the card, as (a)'s steps are timed
    steps = Ranks(steps_w, "steps", workdir, torchrun=False)
    try:
        ranks, wall = Ranks(trainer_w, "trainer", workdir, torchrun=True).results(
            "dist train")
        (workdir / "trainer_done").touch()
        for r, res in enumerate(ranks):
            got = sorted({tuple(s) for s in res["per_step"]})
            if got != [(NORMS_PER_STEP, NORMS_PER_STEP, 0)] or len(res["per_step"]) != DIST_STEPS:
                fail(f"dist train: rank {r} K1/K2/K3 launches per step {res['per_step']}")
            if not all(res["finite"]) or not all(np.isfinite(res["totals"])):
                fail(f"dist train: rank {r} non-finite losses or gradients {res['totals']}")
            if res["checksum"][0] != res["checksum"][1]:
                fail(f"dist train: the ranks' parameters differ, checksums {res['checksum']}")
            print(f"dist train: rank {r} of {res['world']} ({res['backend']}, {res['device']}, "
                  f"{res['card']}): K1/K2/K3 per step {got[0]}, totals "
                  f"{[round(t, 5) for t in res['totals']]}, peak {res['peak_gib']:.3f} GiB")
        warm = statistics.median(max(r["step_seconds"][i] for r in ranks)
                                 for i in range(1, DIST_STEPS))
        print(f"dist train: 9room/gcp_tree from ep74, {DIST_STEPS} steps of the global "
              f"B={TRAIN_B} T={TRAIN_T} on {trainer_w} rank(s); warm ms per step (median of "
              f"steps 1-{DIST_STEPS - 1}, slowest rank) {warm * 1e3:.2f}; training frames/s "
              f"{TRAIN_B * TRAIN_T / warm:.1f}; parameter checksum {ranks[0]['checksum'][0]!r} "
              f"on every rank; torchrun wall {wall:.1f} s")
        launches["dist_train"] = tuple(sum(r["launches"][i] for r in ranks) for i in range(3))
        ranks, wall = steps.results("dist steps")
    finally:
        steps.stop()  # a no-op once they ended
    dp_grads = torch.load(workdir / "dp_grads.pt", weights_only=True)
    for r, res in enumerate(ranks):
        for part, per_step in (("dp", (NORMS_PER_STEP, NORMS_PER_STEP, 0)),
                               ("fsdp", (NORMS_PER_STEP, NORMS_PER_STEP, 0))):
            if tuple(res[part]["launches"]) != per_step:
                fail(f"dist {part}: rank {r} K1/K2/K3 launches {res[part]['launches']}")
            if res[part]["checksum"][0] != res[part]["checksum"][1]:
                fail(f"dist {part}: the ranks' parameters differ {res[part]['checksum']}")
        if not res["fsdp"]["finite"]:
            fail(f"dist fsdp: rank {r} non-finite losses or gradients")
    dp = ranks[0]["dp"]
    loss_d = {k: abs(dp["metrics"][k] - v) / max(1.0, abs(v)) for k, v in whole[0].items()
              if k not in ("grads_finite", "grad_norm")}
    grad_d = {n: (dp_grads[n] - g).abs().max().item() / max(1e-3, g.abs().max().item())
              for n, g in whole[1].items()}
    worst = max(grad_d, key=grad_d.get)
    norm_d = abs(dp["metrics"]["grad_norm"] - whole[0]["grad_norm"]) / whole[0]["grad_norm"]
    if (max(loss_d.values()) >= TOLS_TRAIN["loss"] or grad_d[worst] >= TOLS_TRAIN["grad"]
            or norm_d >= TOLS_TRAIN["grad"]):
        fail(f"dist dp: {steps_w} ranks vs one process: losses {loss_d}, worst gradient "
             f"{worst} {grad_d[worst]}, grad_norm {norm_d}")
    print(f"dist dp: {steps_w} ranks over {ranks[0]['backend']} "
          f"({', '.join(r['device'] for r in ranks)}), rows "
          f"{[r['dp']['rows'] for r in ranks]} of the first batch (B={TRAIN_B}, T={TRAIN_T}), "
          f"the whole batch's noise and K1 branches; against the single-process step on "
          f"the whole batch: losses (relative) max {max(loss_d.values()):.3e}, gradients of "
          f"{len(grad_d)} tensors worst {grad_d[worst]:.3e} ({worst}), grad_norm "
          f"{norm_d:.3e} (TOLS_TRAIN {TOLS_TRAIN}); K1/K2/K3 per rank {tuple(dp['launches'])}")
    fs = ranks[0]["fsdp"]
    print(f"dist fsdp: 25room/gcp_tree (flagship, {fs['params']} params) on a (data, model) "
          f"mesh {tuple(fs['mesh'])} of {steps_w} ranks over {ranks[0]['backend']}: "
          f"{fs['sharded_tensors']} tensors ({fs['sharded_params']} params) split over "
          f"'model', {fs['local_params']} params held by each rank; total "
          f"{fs['metrics']['total']:.5f}, grad_norm {fs['metrics']['grad_norm']:.5f}; step "
          f"{fs['step_s'][0] * 1e3:.1f} ms cold, {fs['step_s'][1] * 1e3:.1f} ms warm; peak "
          f"device memory per rank {[round(r['fsdp']['peak_gib'], 3) for r in ranks]} GiB; "
          f"K1/K2/K3 per rank {tuple(fs['launches'])}; the launch's wall {wall:.1f} s")
    launches["dist_dp_step"] = tuple(sum(r["dp"]["launches"][i] for r in ranks) for i in range(3))
    launches["dist_fsdp_step"] = tuple(sum(r["fsdp"]["launches"][i] for r in ranks)
                                       for i in range(3))

    # (d) a plan call of 100 candidates split over the cards
    from video_gcp_torch.planning.cem.simulator import GCPImageSimulator
    devices = ([f"cuda:{i}" for i in range(min(cards, DIST_MAX_CARDS))] if cards > 1
               else ["cuda:0", "cuda:0"])
    unsplit = GCPImageSimulator(ep74, append_latent=True)
    split = GCPImageSimulator(ep74, append_latent=True, devices=devices)
    rng = np.random.RandomState(SEED)
    state = rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    goal = rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    z = rng.randn(CEM_BATCH, N_NODES, 256).astype(np.float32)
    inputs = unsplit._prep_inputs(state, goal, z, TRAIN_T)
    times = {}
    for name, sim in (("unsplit", unsplit), ("split", split), ("unsplit", unsplit),
                      ("split", split)):
        COUNTS["k1.launches"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_model(inputs)
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        times[name + "_k1"] = COUNTS["k1.launches"]
        if name == "unsplit":
            want = res
        else:
            got = res
    if times["split_k1"] != K1_PER_SIM_CALL * len(devices) or times["unsplit_k1"] != 15:
        fail(f"dist plan: K1 launches {times['unsplit_k1']} unsplit, {times['split_k1']} split")
    if not np.array_equal(got.end_ind, want.end_ind):
        fail("dist plan: the split call drew other lengths than the unsplit one")
    diffs = {k: float(np.abs(got[k] - want[k]).max()) for k in
             ("timeline_images", "timeline_latents", "actions", "regressed_state")}
    bad = {k: v for k, v in diffs.items() if not v < TOLS_SLICE[k]}
    if bad or not all(np.isfinite(got[k]).all() for k in diffs):
        fail(f"dist plan: split vs unsplit {diffs} (TOLS_SLICE)")
    print(f"dist plan: {CEM_BATCH} candidates split over {devices} (pad bucket "
          f"{split._pad_bucket}) against one call: max abs diff "
          + json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()})
          + f" (TOLS_SLICE), the same {len(set(got.end_ind.tolist()))} distinct lengths; "
          f"ms per call (cold, warm) unsplit {[round(t, 2) for t in times['unsplit']]}, "
          f"split {[round(t, 2) for t in times['split']]}; K1 launches {times['split_k1']} "
          f"split, {times['unsplit_k1']} unsplit")
    launches["dist_plan_split"] = (times["split_k1"], 0, 0)
    for d in (workdir, EXP_DIR / "dist"):  # the trainer's checkpoint among them
        shutil.rmtree(d, ignore_errors=True)
    return launches


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit of the port, "
                    "whose K1, K2 and K3 are timed in turns with this one's")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the K1, K2, K3 and K4 phases (no result line)")
    # the dist phase's ranks (Ranks)
    ap.add_argument("--dist-only", action="store_true",
                    help="build, then run only the dist phase (no result line)")
    ap.add_argument("--flip-probe", type=int, metavar="WINDOWS",
                    help="build, then run only flip_probe over WINDOWS windows (no result line)")
    ap.add_argument("--room25-only", action="store_true",
                    help="build, then run only the 25room phase (no result line)")
    ap.add_argument("--long-only", action="store_true",
                    help="build, make the sweep's nav_9rooms files, then run only the long "
                         "phase (no result line)")
    ap.add_argument("--dist-rank", choices=("trainer", "steps"), help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    try:
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    try:
        from video_gcp_torch.core import distributions
        from video_gcp_torch.core.attrdict import AttrDict
        from video_gcp_torch.data.loader import DataLoader
        from video_gcp_torch.load import load_model, set_float32_precision
        from video_gcp_torch.ops import cuda_build, dtw, fused_gn, soft_dtw
        from video_gcp_torch.parallel import train_step as train_step_mod
        from video_gcp_torch.training import trainer as trainer_mod
    except ImportError as e:
        fail(f"video_gcp_torch is not beside chip_smoke.py: {e}")
    banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "video_gcp_tpu")]
    if banned:
        fail(f"JAX modules loaded: {banned}")
    # the port reads and writes h5 files and resizes frames without h5py
    # or OpenCV: stand-ins that fail on import keep it so
    sys.modules["h5py"] = sys.modules["cv2"] = None
    set_float32_precision()
    if args.dist_rank:
        import faulthandler
        faulthandler.enable()  # a crash in a collective shows its Python stack
        {"trainer": rank_trainer, "steps": rank_steps}[args.dist_rank](
            torch, fused_gn, soft_dtw, Path(args.dist_dir))
        return
    start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase_s = {}  # seconds of each phase, printed at the end

    def timed_phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = round(time.perf_counter() - t0, 2)
        return out

    def build():
        with ThreadPoolExecutor(3) as pool:  # one nvcc per source, together
            builds = [pool.submit(cuda_build.load, m.SOURCE, m.ENTRY_POINTS)
                      for m in (fused_gn, soft_dtw, dtw)]
            for b in builds:
                b.result()  # raises (non-zero exit) if nvcc fails

    timed_phase("build", build)
    print(f"build: K1 and K2 ({fused_gn.SOURCE}), K3 ({soft_dtw.SOURCE}), K4 ({dtw.SOURCE}) "
          f"in {phase_s['build']:.1f} s")
    for source in (fused_gn.SOURCE, soft_dtw.SOURCE, dtw.SOURCE):
        print(cuda_build.BUILD_LOGS.get(source, "").strip())
    if args.dist_only:
        from video_gcp_torch.data.datasets import RandomVideoDataset
        from video_gcp_torch.training.config import build_hparams, load_config
        bundle = load_config(CONF)
        dataset = RandomVideoDataset(None, dict(build_hparams(bundle)), bundle.data_conf,
                                     "train", dataset_size=64)
        timed_phase("dist", dist_phase, torch, fused_gn, soft_dtw,
                    load_model(CONF, weights=WEIGHTS), load_model, AttrDict, distributions,
                    DataLoader, dataset)
        print(f"seconds per phase: {json.dumps(phase_s)}")
        print(gpu_name_and_power_limit())
        return
    if args.room25_only:
        timed_phase("room25", room25_phase, torch, fused_gn, soft_dtw, trainer_mod,
                    distributions, DataLoader, AttrDict, load_model)
        print(f"seconds per phase: {json.dumps(phase_s)}")
        print(gpu_name_and_power_limit())
        return
    if args.long_only:
        timed_phase("h5_data", make_h5_data, H5_SWEEP_FILES)
        timed_phase("long", long_phase, torch, fused_gn, soft_dtw, trainer_mod, distributions,
                    DataLoader, AttrDict, load_model)
        print(f"seconds per phase: {json.dumps(phase_s)}")
        print(gpu_name_and_power_limit())
        return
    if args.flip_probe:
        timed_phase("flip_probe", flip_probe, torch, fused_gn, soft_dtw, trainer_mod,
                    distributions, DataLoader, AttrDict, load_model, args.flip_probe)
        print(f"seconds per phase: {json.dumps(phase_s)}")
        print(gpu_name_and_power_limit())
        return
    parent = parent_k3 = None
    if args.parent:
        with ThreadPoolExecutor(2) as pool:
            parent, parent_k3 = pool.map(
                lambda name: load_parent(Path(args.parent).resolve(), cuda_build, name),
                ("fused_gn", "soft_dtw"))
        print(f"parent: K1, K2 and K3 of {args.parent}, timed in turns with this checkout's")
    k1_rows, k1_sums = timed_phase("k1", kernel_phase, torch, F, fused_gn, parent)
    k2_rows, k2_sums = timed_phase("k2", k2_phase, torch, F, fused_gn, parent)
    k3_rows = timed_phase("k3", k3_phase, torch, soft_dtw, parent_k3)
    k4_rows = timed_phase("k4", k4_phase, torch, dtw)
    if args.kernels_only:
        print(json.dumps({"k1": k1_rows, "k2": k2_rows, "k3": k3_rows, "k4": k4_rows,
                          "k1_sums": k1_sums, "k2_sums": k2_sums}))
        print(gpu_name_and_power_limit())
        return
    COUNTS["k3.launches"] = 0  # slice_phase resets K1's and K2's counts
    serve_launches, plan_s, model, cpu_model = timed_phase(
        "serve", slice_phase, torch, fused_gn, load_model, AttrDict)
    if COUNTS["k2.launches"] or COUNTS["k3.launches"]:
        fail("K2 or K3 launched on the serving path")
    trainer, (train_k1, train_k2, _) = timed_phase(
        "train", train_phase, torch, fused_gn, soft_dtw, trainer_mod, CONF, WEIGHTS,
        k3_per_step=0)
    timed_phase("train_vs_cpu", train_vs_cpu, torch,
                lambda d: load_model(CONF, weights=WEIGHTS, device=d), AttrDict,
                distributions, DataLoader, trainer.train_loader.dataset, "train")
    h5_launches = timed_phase("h5_train", h5_phase, torch, fused_gn, soft_dtw, trainer_mod,
                              distributions, DataLoader, AttrDict, load_model)
    base_launches = timed_phase("baselines", baselines_phase, torch, fused_gn, soft_dtw,
                                trainer_mod, distributions, DataLoader, AttrDict, load_model)

    # from the port's initialisation: --resume latest finds no checkpoint
    shutil.rmtree(EXP_DIR / "prediction/9room/gcp_adaptive", ignore_errors=True)
    adaptive, (ad_k1, ad_k2, ad_k3) = timed_phase(
        "train_adaptive", train_phase, torch, fused_gn, soft_dtw, trainer_mod, ADAPTIVE_CONF,
        "latest", k3_per_step=1, n_steps=ADAPTIVE_STEPS)
    trained = {k: v.detach().cpu() for k, v in adaptive.model.state_dict().items()}

    def adaptive_model(device):
        model = load_model(ADAPTIVE_CONF, device=device)
        model.load_state_dict(trained)
        return model

    timed_phase("train_adaptive_vs_cpu", train_vs_cpu, torch, adaptive_model, AttrDict,
                distributions, DataLoader, adaptive.train_loader.dataset, "train_adaptive")
    del adaptive

    COUNTS["k3.launches"] = 0
    serve16_k1, (train16_k1, train16_k2) = timed_phase(
        "bf16", bf16_phase, torch, fused_gn, load_model, AttrDict, train_step_mod, model,
        trainer.model, trainer.train_loader.dataset, DataLoader)
    if COUNTS["k3.launches"]:
        fail("K3 launched on a bf16 path")
    timed_phase("train_bf16_vs_cpu", train_vs_cpu, torch,
                lambda d: load_model(CONF, weights=WEIGHTS, device=d,
                                     compute_dtype=torch.bfloat16),
                AttrDict, distributions, DataLoader, trainer.train_loader.dataset,
                "train_bf16", TOLS_TRAIN_BF16)
    eval_k1 = timed_phase("eval", eval_phase, torch, fused_gn, soft_dtw, model, cpu_model,
                          trainer.val_loader.dataset, DataLoader, AttrDict)
    timed_phase("eval_extras", eval_extras_phase, torch)
    finetune_launches = timed_phase("finetune", finetune_phase, torch, fused_gn, soft_dtw,
                                    trainer_mod)
    plan_k1 = timed_phase("plan", plan_phase, torch, fused_gn, soft_dtw, AttrDict)
    room25_launches = timed_phase("room25", room25_phase, torch, fused_gn, soft_dtw, trainer_mod,
                                  distributions, DataLoader, AttrDict, load_model)
    long_launches = timed_phase("long", long_phase, torch, fused_gn, soft_dtw, trainer_mod,
                                distributions, DataLoader, AttrDict, load_model)
    dist_launches = timed_phase("dist", dist_phase, torch, fused_gn, soft_dtw, model,
                                load_model, AttrDict, distributions, DataLoader,
                                trainer.train_loader.dataset)
    print(f"seconds per phase: {json.dumps(phase_s)}; since the start "
          f"{time.perf_counter() - start:.1f} s")

    def line(name, rows, shape, dtype, replaces, by_path, source=fused_gn.SOURCE):
        top = next(r for r in rows if r["shape"] == shape and r["dtype"] == dtype)
        return dict(name=name, route="cuda", source=f"video_gcp_torch/csrc/{source}",
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path,
                    **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "shape", "dtype")})

    # each kernel's line: the main paths' largest site of that kernel in f32
    kernels = [
        line("gn_lrelu_fwd", k1_rows, [CEM_BATCH * N_NODES, 32, 32, 16], "float32",
             "video_gcp_tpu/ops/fused_gn.py:97",
             dict(serve=serve_launches, train=train_k1, train_adaptive=ad_k1,
                  serve_bf16=serve16_k1, train_bf16=train16_k1, **eval_k1, plan=plan_k1,
                  **{k: v[0] for k, v in finetune_launches.items()},
                  **{f"h5_train_{n}": v[0] for n, v in h5_launches.items()},
                  **{k: v[0] for k, v in base_launches.items()},
                  **{k: v[0] for k, v in room25_launches.items()},
                  **{k: v[0] for k, v in long_launches.items()},
                  **{k: v[0] for k, v in dist_launches.items()})),
        line("gn_lrelu_bwd", k2_rows, [TRAIN_B * N_NODES, 32, 32, 16], "float32",
             "video_gcp_tpu/ops/fused_gn.py:141",
             dict(serve=0, train=train_k2, train_adaptive=ad_k2, serve_bf16=0,
                  train_bf16=train16_k2, **{k: 0 for k in eval_k1}, plan=0,
                  **{k: v[1] for k, v in finetune_launches.items()},
                  **{f"h5_train_{n}": v[1] for n, v in h5_launches.items()},
                  **{k: v[1] for k, v in base_launches.items()},
                  **{k: v[1] for k, v in room25_launches.items()},
                  **{k: v[1] for k, v in long_launches.items()},
                  **{k: v[1] for k, v in dist_launches.items()})),
        line("soft_dtw", k3_rows, list(K3_SHAPES[0]), "float32",
             "video_gcp_tpu/ops/pallas_dtw.py:29",
             dict(serve=0, train=0, train_adaptive=ad_k3, serve_bf16=0, train_bf16=0,
                  **{k: 0 for k in eval_k1}, plan=0,
                  **{k: v[2] for k, v in finetune_launches.items()},
                  **{f"h5_train_{n}": v[2] for n, v in h5_launches.items()},
                  **{k: v[2] for k, v in base_launches.items()},
                  **{k: v[2] for k, v in room25_launches.items()},
                  **{k: v[2] for k, v in long_launches.items()},
                  **{k: v[2] for k, v in dist_launches.items()}),
             source=soft_dtw.SOURCE),
        line("dtw_align", k4_rows, list(K4_SHAPES[-1]), "float32",
             "none (video_gcp_tpu/ops/dtw.py runs XLA scans)",
             dict(long_eval=long_launches["long_eval"][3]), source=dtw.SOURCE),
    ]
    print(f"slice: median plan call {plan_s * 1e3:.2f} ms")
    print(json.dumps({"kernel_path_sums": {"gn_lrelu_fwd": k1_sums, "gn_lrelu_bwd": k2_sums}}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
