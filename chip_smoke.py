#!/usr/bin/env python3
"""Smoke test of the PyTorch port (video_gcp_torch) on one NVIDIA Hopper GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

1. Build: compiles kernels K1 (GroupNorm+LeakyReLU forward) and K2 (its
   backward), both in video_gcp_torch/csrc/fused_gn.cu, and K3 (the
   soft-DTW posterior: both DPs row by row and w in one launch),
   video_gcp_torch/csrc/soft_dtw.cu, with nvcc for
   sm_90a, one nvcc per source, started together; prints the build time and
   both ptxas reports.
2. K1 phase: K1 against its plain PyTorch twin on the card at every
   GroupNorm site of the 9-room GCP-tree (5 encoder, 5 decoder) at batch 16
   and at the CEM batch of 100 candidates, the train step's encoder on its
   1,600 frames, in f32 and bf16, plus the largest shape of the repo,
   [16352, 64, 64, 16] bf16. Prints per shape the kernel's time (CUDA
   events, median of 25), its own device time (torch.profiler, 10 calls),
   the plain twin's time, the time of F.group_norm + F.leaky_relu (a
   yardstick the port never calls), the bound, the wrapper's host time per
   call (best of 3 x 50 calls issued back to back) and the max difference; then, per
   path, the sums of the times and bounds over a plan call's, a B=16
   rollout's and a train step's K1 sites, in f32 and in bf16.
3. K2 phase: K2 against its twin at the 15 norm shapes of a training step
   at B=16, T=100 (encoder on 1600 frames and on the 16 start and goal
   frames, decoder on 2032 nodes) in f32 and in bf16, and at the two
   largest of bench.py's train step in bf16. Inputs are moved clear of
   LeakyReLU's kink (fused_gn.clear_of_kink) so that both sign tests agree.
   Prints the same columns and the sums over a train step's 20 K2 sites
   in each dtype; the yardstick is the autograd backward of F.group_norm +
   F.leaky_relu.
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
   device memory and BWD_DY_COPIES. Then one step of ep74 on the first 2
   examples of the first batch, with the same injected noise, on the card
   and on the CPU: every loss term and every gradient agree within the
   tolerances of tests/test_torch_train.py.
7. Adaptive train phase: the trainer on the card, as `python -m
   video_gcp_torch.training.train --path
   experiments/prediction/9room/gcp_adaptive --feed_random_data 1
   --num_epochs 1 --skip_first_val 1 --deterministic 1` runs it: 32 steps
   at B=16, T=100 from the port's initialisation (no checkpoint). Checks
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
   ms at [16, 127, 100].
10. Plan phase: closed-loop visual planning on 9room/gcp_tree with ep74 on
   the card. ep74 is written as a port checkpoint under the build
   directory, the port's PRM expert writes start/goal configurations 0-2
   (experiments/data_gen/nav_9rooms_start_goal, on the CPU), and
   planning.run's ControlManager runs the control benchmark's tasks 0-2
   (experiments/control/9room/gcp_tree, T=200 env steps each) from copies
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
   success rate and penalized path cost over the 3 tasks. The K1 phase
   also holds K1 at the control path's sites (encoder at n = 10, 5, 1,
   decoder at 127 n nodes).

Prints the seconds of each phase, the per-path sums and the kernels' JSON
lines, the card's name and power limit, and as its last line {"ok": true,
"device": {...}}. Any failure exits non-zero with no result line, as does
a host without CUDA or a directory without the port.

    python3 chip_smoke.py --parent DIR [--kernels-only]

also builds the K1, K2 and K3 of another checkout of the port in DIR (an
earlier commit unpacked with `git archive` under video_gcp_torch/_build/)
and times them in turns with this checkout's at every shape of phases 2 to 4
(new, old, old, new); for K3 it times the whole soft_dtw() calls (the
parent's: dp_rows, its K3 and posterior) and checks that this checkout's F
and Bk equal the parent's DP values bit for bit and w is within 1e-6 of the
parent's. --kernels-only stops after those phases and prints their rows as
JSON.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONF = ROOT / "experiments/prediction/9room/gcp_tree"
WEIGHTS = CONF / "pretrained_ep74.npz"
ADAPTIVE_CONF = ROOT / "experiments/prediction/9room/gcp_adaptive"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
GN_FLOPS_PER_ELEMENT = 10  # sum, square-sum, normalize, affine, activation
TOLS_KERNEL = {"float32": 2e-5, "bfloat16": 3e-2}  # bf16: relative to max(1, |y|)
TOLS_SLICE = dict(images=2e-4, e_g_prime=5e-4, timeline_images=2e-4,
                  timeline_latents=5e-4, actions=1e-4, regressed_state=1e-4,
                  existence_logits=1e-3, seq_len_logits=1e-4)  # tests/test_torch_tree.py
SITE_SHAPES = [(16, 16, 16), (8, 8, 32), (4, 4, 64), (2, 2, 128), (1, 1, 256)]
ENC_SITES, DEC_SITES = SITE_SHAPES, SITE_SHAPES[::-1][1:] + [(32, 32, 16)]
N_NODES = 127  # 2^7 - 1 at hierarchy_levels=7
CEM_BATCH, CEM_ITERS, ROLLOUT_BATCH = 100, 3, 16
TRAIN_B, TRAIN_T, TRAIN_STEPS = 16, 100, 32  # 256 / 16 x epoch_cycles_train 2
NORMS_PER_STEP = 20  # 5 sites x 3 encoder calls (sequence, I_0, I_g) + 5 decoder
# K2 at the train step's 15 norm shapes, in f32 and in bf16 (the bf16 path)
K2_SHAPES = ([((b,) + s, d) for d in ("float32", "bfloat16")
              for b, sites in ((TRAIN_B * TRAIN_T, ENC_SITES), (TRAIN_B, ENC_SITES),
                               (TRAIN_B * N_NODES, DEC_SITES)) for s in sites]
             + [((TRAIN_B * N_NODES, 64, 64, 16), "bfloat16"),  # bench.py's train
                ((TRAIN_B * TRAIN_T, 32, 32, 16), "bfloat16")])  # step at 64x64
K2_FLOPS_PER_ELEMENT = 20  # three passes: stats, sums, dx
TOLS_TRAIN = dict(loss=1e-4, grad=2e-3)  # tests/test_torch_train.py, ep74
# bf16 card vs CPU. The heads round their outputs to bf16 (2^-8 relative)
# before the f32 losses, and the two devices may round to neighbouring
# values: one ulp moves an L2 loss whose residual is as large as the
# prediction by ~1.6e-2 (cost_estimation). Gradients wider still, as bf16
# error grows through the tree's recursive LSTM (tests/test_torch_bf16.py).
TOLS_TRAIN_BF16 = dict(loss=5e-2, grad=1e-1)
# K3: [B, r, c] of the adaptive training step; the largest shape the repo
# names (video_gcp_tpu/ops/pallas_dtw.py:7-9: 511 nodes x 500 frames)
K3_SHAPES = [(TRAIN_B, N_NODES, TRAIN_T), (TRAIN_B, 511, 500)]
# per cell: two DP cells (two maxima, subtract, abs, negate, exp, log1p, two
# adds) and w (three adds, maximum, exp, two compares, select)
K3_OPS_PER_CELL = 26
TOL_K3 = 1e-4  # w absolute (tests/test_torch_soft_dtw.py); D relative to max(1, |D|)
TOL_K3_PARENT = 1e-6  # w against the earlier checkout's K3 and torch posterior
# bf16: mean |diff| per tree level, tests/test_torch_bf16.py
TOLS_BF16_MEAN = dict(images=3e-3, e_g_prime=1.5e-2)
BF16_STEPS = 8
BF16_WARM = CEM_ITERS  # warm serving calls of each model
BF16_MOVE_GRAD = 1e-6  # a bf16 step's gradient at least this large moves its parameter
TOL_EVAL_METRIC = 1e-4  # tests/test_torch_evaluator.py, relative to max(1, |value|)
EXP_DIR = ROOT / "video_gcp_torch/_build/chip_smoke_exp"  # git-ignored
# the control path's model calls (experiments/control/9room/gcp_tree): the
# simulator's candidates per call (sampling_rates_per_layer [10, 10], then
# n_ll_samples 5, then the chosen one) and one frame per closed-loop action
CONTROL_CANDIDATES = (10, 5, 1)
CONTROL = "experiments/control/9room/gcp_tree/mod_hyper.py"
DATA_GEN = "experiments/data_gen/nav_9rooms_start_goal/mod_hyper.py"
CONTROL_TASKS = 3
K1_PER_SIM_CALL, K1_PER_ACTION = 15, 5  # 5 encoder sites x 2 + 5 decoder; 5
TOL_ACTION = 1e-4  # one closed-loop action, card vs CPU (tests/test_torch_planning.py)


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
    """The wrapper module `name` (fused_gn or soft_dtw) and its kernels of
    another checkout of the port (an earlier commit unpacked under
    video_gcp_torch/_build/), built from its own source, for times taken in
    turns with this one."""
    import importlib.util
    import types
    spec = importlib.util.spec_from_file_location(
        f"parent_{name}", parent / f"video_gcp_torch/ops/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    lib = ROOT / f"video_gcp_torch/_build/parent_{name}.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                    str(parent / f"video_gcp_torch/csrc/{name}.cu")],
                   check=True, capture_output=True, text=True)
    mod.cuda_build = types.SimpleNamespace(build=lambda source: lib)
    mod.load_library()
    return mod


# kernel names in profiler traces; an earlier checkout's K2 (--parent) ends
# with a second, reducing kernel
K1_TAGS, K2_TAGS = ("gn_lrelu_fwd",), ("gn_lrelu_bwd", "gn_bwd_param_reduce")
K3_TAGS = ("soft_dtw_kernel",)


def path_sums(tag, rows, keys, paths):
    """Sums of `keys` over the norm sites of each of `paths`, in f32 and
    (as `<path>_bf16`) in bf16: a plan call's 15 launches, a B=16
    rollout's 15, a train step's 20."""
    by = {(tuple(r["shape"]), r["dtype"]): r for r in rows}

    def sites(dec_batch, enc_calls):  # enc_calls: (batch, calls) of the encoder
        out = [((b,) + s) for b, k in enc_calls for s in ENC_SITES for _ in range(k)]
        return out + [(dec_batch,) + s for s in DEC_SITES]

    sites_of = dict(plan_call=sites(CEM_BATCH * N_NODES, [(CEM_BATCH, 2)]),
                 rollout=sites(ROLLOUT_BATCH * N_NODES, [(ROLLOUT_BATCH, 2)]),
                 train_step=sites(TRAIN_B * N_NODES, [(TRAIN_B * TRAIN_T, 1), (TRAIN_B, 2)]))
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


def bound(shape, itemsize):
    numel = 1
    for s in shape:
        numel *= s
    t_bytes = (2 * numel * itemsize + 2 * shape[-1] * 4) / HBM_BYTES_PER_S
    t_ops = GN_FLOPS_PER_ELEMENT * numel / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(torch, F, fused_gn, parent=None):
    cases = []
    for batch in (ROLLOUT_BATCH, CEM_BATCH, TRAIN_B * TRAIN_T):
        cases += [((batch,) + s, d) for s in ENC_SITES for d in ("float32", "bfloat16")]
        if batch != TRAIN_B * TRAIN_T:  # the train step decodes B=16 trees
            cases += [((batch * N_NODES,) + s, d) for s in DEC_SITES
                      for d in ("float32", "bfloat16")]
    cases.append(((32 * 511, 64, 64, 16), "bfloat16"))  # bench.py top decode level
    for n in CONTROL_CANDIDATES:  # the control path's simulator calls and actions
        cases += [((n,) + s, "float32") for s in ENC_SITES]
        cases += [((n * N_NODES,) + s, "float32") for s in DEC_SITES]
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    print("K1 gn_lrelu_fwd: shape dtype | ms device_ms plain_ms library_ms bound_ms | "
          "host_us | max_abs_err" + (" | parent: ms device_ms host_us" if parent else ""))
    for shape, dtype in cases:
        dt = getattr(torch, dtype)
        c, groups = shape[-1], 8
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dt)
        scale = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
        bias = torch.randn(c, generator=gen, device="cuda") * 0.1
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
        if parent:
            old = lambda: parent.fused_group_norm_lrelu(x, scale, bias, groups)  # noqa: E731
            row["ms"], row["parent_ms"] = in_turns(torch, run, old)
            row["parent_device_ms"] = device_ms(torch, old, K1_TAGS)
            row["parent_host_us"] = host_us(torch, old)
        else:
            row["ms"] = time_ms(torch, run)
        row["device_ms"] = device_ms(torch, run, K1_TAGS)
        row["host_us"] = host_us(torch, run)
        row["plain_ms"] = time_ms(torch, lambda: fused_gn.gn_lrelu_reference(
            x, scale, bias, groups))
        row["library_ms"] = time_ms(torch, lambda: F.leaky_relu(
            F.group_norm(x_nchw, groups, scale.to(dt), bias.to(dt), eps=1e-6), 0.2))
        row["bound_ms"], row["bound_by"] = bound(shape, x.element_size())
        row["max_abs_err"] = max_err
        rows.append(row)
        print(f"K1 {list(shape)} {dtype} | {row['ms']:.4f} {fmt(row['device_ms'])} "
              f"{row['plain_ms']:.4f} {row['library_ms']:.4f} {row['bound_ms']:.4f} | "
              f"{row['host_us']:.1f} | {max_err:.3e}"
              + (f" | {row['parent_ms']:.4f} {fmt(row['parent_device_ms'])} "
                 f"{row['parent_host_us']:.1f}" if parent else ""))
        del x, x_nchw
        torch.cuda.empty_cache()
    sums = path_sums("K1", rows, ("ms", "device_ms", "bound_ms", "parent_ms", "parent_device_ms"),
                     ("plan_call", "rollout", "train_step"))
    return rows, sums


def bwd_bound(shape, itemsize):
    numel = 1
    for s in shape:
        numel *= s
    t_bytes = (3 * numel * itemsize + 4 * shape[-1] * 4) / HBM_BYTES_PER_S
    t_ops = K2_FLOPS_PER_ELEMENT * numel / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_phase(torch, F, fused_gn, parent=None):
    """K2 against its twin, and its times, at the training shapes."""
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    print("K2 gn_lrelu_bwd: shape dtype | ms device_ms plain_ms library_ms bound_ms | "
          "host_us | max err dx dscale dbias (relative to max(1, |ref|))"
          + (" | parent: ms device_ms host_us" if parent else ""))
    for shape, dtype in K2_SHAPES:
        dt = getattr(torch, dtype)
        c, groups = shape[-1], 8
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dt)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dt)
        scale = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
        bias = torch.randn(c, generator=gen, device="cuda") * 0.1
        x = fused_gn.clear_of_kink(x, scale, bias, groups)
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
        else:
            row["ms"] = time_ms(torch, run)
        row["device_ms"] = device_ms(torch, run, K2_TAGS)
        row["host_us"] = host_us(torch, run)
        row["plain_ms"] = time_ms(torch, lambda: fused_gn.gn_lrelu_bwd_reference(
            x, dy, scale, bias, groups))
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()  # channels_last view
        wl, bl = (p.to(dt).detach().requires_grad_() for p in (scale, bias))
        yl = F.leaky_relu(F.group_norm(xl, groups, wl, bl, eps=1e-6), 0.2)
        dyl = dy.permute(0, 3, 1, 2)
        row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            yl, (xl, wl, bl), dyl, retain_graph=True))
        row["bound_ms"], row["bound_by"] = bwd_bound(shape, x.element_size())
        row["max_abs_err"] = abs_err
        rows.append(row)
        print(f"K2 {list(shape)} {dtype} | {row['ms']:.4f} {fmt(row['device_ms'])} "
              f"{row['plain_ms']:.4f} {row['library_ms']:.4f} {row['bound_ms']:.4f} | "
              f"{row['host_us']:.1f} | {errs[0]:.3e} {errs[1]:.3e} {errs[2]:.3e}"
              + (f" | {row['parent_ms']:.4f} {fmt(row['parent_device_ms'])} "
                 f"{row['parent_host_us']:.1f}" if parent else ""))
        del x, dy, xl, wl, bl, yl, dyl
        torch.cuda.empty_cache()
    sums = path_sums("K2", rows, ("ms", "device_ms", "bound_ms", "parent_ms", "parent_device_ms"),
                     ("train_step",))
    return rows, sums


def k3_bound(b, r, c):
    cells = b * r * c
    t_bytes = 2 * cells * 4 / HBM_BYTES_PER_S  # read C once, write w once
    t_ops = K3_OPS_PER_CELL * cells / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k3_parent_check(torch, parent, cost, ends, got):
    """This checkout's F, Bk and w against the earlier checkout's K3 (on
    dp_rows' 2B rows) and torch posterior: the DP values bit for bit."""
    b = cost.shape[0]
    comb, begin = parent.dp_rows(cost, ends)
    acc = parent.gak(comb, begin)
    w_old = parent.posterior(acc, comb, ends)
    torch.cuda.synchronize()
    same = (torch.equal(got[1], acc[:b]), torch.equal(got[2], torch.flip(acc[b:], (-1, -2))))
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
            comb, begin = parent.dp_rows(cost, ends)
            row["parent_kernel_device_ms"] = device_ms(
                torch, lambda: parent.gak(comb, begin), ("gak_kernel",))
            del comb, begin
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

    fused_gn.LAUNCHES = fused_gn.BWD_LAUNCHES = 0  # the serving path starts
    rollouts, calls, per_forward = [], [], []
    with torch.inference_mode():
        rollout_in = AttrDict(I_0=images(ROLLOUT_BATCH), I_g=images(ROLLOUT_BATCH),
                              end_ind=torch.full((ROLLOUT_BATCH,), 99, device="cuda"))
        for _ in range(2):  # the first call includes cuDNN's set-up
            rollout_in.z = torch.randn(ROLLOUT_BATCH, N_NODES, 256, generator=gen,
                                       device="cuda")
            before = fused_gn.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(rollout_in, phase="test", mode="prior", generator=gen)
            torch.cuda.synchronize()
            rollouts.append(time.perf_counter() - t0)
            per_forward.append(fused_gn.LAUNCHES - before)
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
            before = fused_gn.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = model(plan_in, phase="plan", mode="prior", pred_length=True,
                         generator=gen)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            per_forward.append(fused_gn.LAUNCHES - before)
            check_finite(plan, ("images", "e_g_prime", "timeline_images",
                                "timeline_latents", "actions", "regressed_state"))
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = fused_gn.LAUNCHES
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
                    before = fused_gn.LAUNCHES
                    out, sec = timed(lambda: m(inp, mode="prior", generator=gen, **kw))
                    secs[name].append(sec)
                    per_forward.append(fused_gn.LAUNCHES - before)
                    for k in ("images", "e_g_prime"):
                        if out.tree[k].dtype != torch.float32 or not torch.isfinite(
                                out.tree[k]).all():
                            fail(f"{name}: {k} not finite float32")
                    if name == "rollout":
                        last_rollout = out
        return secs, last_rollout, per_forward

    f32_secs = serve(f32_model, BF16_WARM)[0]  # warm since the slice phase
    fused_gn.LAUNCHES = fused_gn.BWD_LAUNCHES = 0  # the bf16 serving path starts
    secs, roll_out, per_forward = serve(model, 1 + BF16_WARM)  # cold, then warm
    serve_launches = fused_gn.LAUNCHES
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
            k1, k2 = fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES
            met, sec = timed(lambda: train_step_mod.train_step(m, opt, batch, i, gen))
            secs.append(sec)
            steps.append((fused_gn.LAUNCHES - k1, fused_gn.BWD_LAUNCHES - k2))
            if not bool(met.grads_finite) or not all(torch.isfinite(v).all()
                                                     for v in met.values()):
                fail(f"train ({m.dtype}): non-finite metrics at step {i}")
        return named, steps, secs, met

    f32_secs = train(f32_train_model)[2]
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    before = [p.detach().clone() for _, p in named]
    fused_gn.LAUNCHES = fused_gn.BWD_LAUNCHES = 0  # the bf16 training path starts
    norm_dtypes.clear()
    named, steps, secs, met = train(model)
    train_launches = (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES)
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
    fused_gn.LAUNCHES = fused_gn.BWD_LAUNCHES = soft_dtw.LAUNCHES = 0  # eval starts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ev.eval(batch, gen)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = fused_gn.LAUNCHES
    if launches != 15 * n_samples or fused_gn.BWD_LAUNCHES or soft_dtw.LAUNCHES:
        fail(f"eval: {launches} K1 launches for {n_samples} sampled forwards, expected 15 "
             f"each; K2 {fused_gn.BWD_LAUNCHES}, K3 {soft_dtw.LAUNCHES}")
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_p = ev_p.eval(batch, gen)
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t0
    if not all(np.isfinite(v).all() for v in res_p.metrics.values()):
        fail("eval: pruned_dtw metrics not finite")
    est = torch.rand(TRAIN_B, N_NODES, 32, 32, 3, generator=gen, device="cuda") * 2 - 1
    tgt = torch.rand(TRAIN_B, TRAIN_T, 32, 32, 3, generator=gen, device="cuda") * 2 - 1
    ends = batch.end_ind
    cost = torch.rand(TRAIN_B, N_NODES, TRAIN_T, generator=gen, device="cuda")
    warp_ms = time_ms(torch, lambda: dtw_warp_sequence(est, tgt, ends), reps=5, warmup=1)
    align_ms = time_ms(torch, lambda: batched_dtw_alignment(cost, ends), reps=5, warmup=1)
    print(f"eval: Evaluator 'pruned_dtw' top-of-10: {sec_p:.3f} s per batch, "
          f"{10 * TRAIN_B * N_NODES / sec_p:.0f} decoded frames/s, mse best "
          f"{res_p.metrics['mse'].min(1).mean():.6g}; DTW warp at [{TRAIN_B}, {N_NODES}, "
          f"{TRAIN_T}] {warp_ms:.3f} ms (alignment alone {align_ms:.3f} ms)")
    return launches


class SharedNoise:
    """Seeded numpy draws in place of the train path's random draws
    (Gaussian.sample and distributions.uniform), recorded on the first run
    and replayed in call order on the next, so the card and the CPU see the
    same noise."""

    def __init__(self, torch, distributions):
        self.torch, self.dist = torch, distributions
        self.rng = np.random.RandomState(0)
        self.draws = {"normal": [], "uniform": []}

    def take(self, kind, shape, device):
        queue, i = self.draws[kind], self.pos[kind]
        if i == len(queue):
            make = self.rng.randn if kind == "normal" else self.rng.rand
            queue.append(make(*shape).astype(np.float32))
        if queue[i].shape != tuple(shape):
            fail(f"noise draw {kind} {i}: shape {tuple(shape)}, recorded {queue[i].shape}")
        self.pos[kind] += 1
        return self.torch.from_numpy(queue[i]).to(device)

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


def train_phase(torch, fused_gn, soft_dtw, trainer_mod, conf, resume, k3_per_step):
    """The JAX command's training run of `conf` on the card, through
    ModelTrainer, from `resume` (--resume)."""
    tag = "train" if k3_per_step == 0 else "train_adaptive"
    os.environ["GCP_EXP_DIR"] = str(EXP_DIR)
    args = trainer_mod.parse_args([
        "--path", str(conf), "--resume", str(resume), "--feed_random_data", "1",
        "--num_epochs", "1", "--skip_first_val", "1", "--deterministic", "1",
        "--verbose_timing", "1"])
    trainer = trainer_mod.ModelTrainer(args)  # device 'cuda', the default
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    steps = []
    real_step = trainer_mod.train_step

    def counted_step(*a, **kw):
        k1, k2, k3 = fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES, soft_dtw.LAUNCHES
        metrics = real_step(*a, **kw)
        steps.append((fused_gn.LAUNCHES - k1, fused_gn.BWD_LAUNCHES - k2,
                      soft_dtw.LAUNCHES - k3, metrics))
        return metrics

    trainer_mod.train_step = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_gn.LAUNCHES = fused_gn.BWD_LAUNCHES = fused_gn.BWD_DY_COPIES = 0
    soft_dtw.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        trainer.run()
    finally:
        trainer_mod.train_step = real_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES, soft_dtw.LAUNCHES)
    copies = fused_gn.BWD_DY_COPIES
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    if len(steps) != TRAIN_STEPS or trainer.step != TRAIN_STEPS:
        fail(f"{tag}: {len(steps)} steps, expected {TRAIN_STEPS}")
    per_step = sorted({(a, b, c) for a, b, c, _ in steps})
    if per_step != [(NORMS_PER_STEP, NORMS_PER_STEP, k3_per_step)]:
        fail(f"{tag}: K1/K2/K3 launches per step {per_step}, expected "
             f"{(NORMS_PER_STEP, NORMS_PER_STEP, k3_per_step)}")
    for i, (_, _, _, m) in enumerate(steps):
        if not bool(m["grads_finite"]):
            fail(f"{tag}: non-finite gradients at step {i}")
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f"{tag}: non-finite {bad} at step {i}")
    # an attention key bias adds q.b to every logit of a query, which the
    # softmax cancels: its gradient is rounding noise, too small to move it
    unchanged = [n for n, p in trainer.model.named_parameters()
                 if p.grad is not None and p.grad.abs().sum() > 0
                 and torch.equal(p.detach(), before[n])
                 and not (".attention_layers." in n and n.endswith(".dense.1.bias"))]
    if unchanged:
        fail(f"{tag}: parameters with a gradient did not change: {unchanged}")
    static = [n for n, p in trainer.model.named_parameters()
              if torch.equal(p.detach(), before[n])]
    warm = statistics.median(trainer.step_seconds[3:TRAIN_STEPS])
    first = {k: float(v) for k, v in steps[0][3].items() if v.dim() == 0}
    last = {k: float(v) for k, v in steps[-1][3].items() if v.dim() == 0}
    print(f"{tag}: {conf.name}, {TRAIN_STEPS} steps of B={TRAIN_B} T={TRAIN_T} in "
          f"{wall:.2f} s (checkpoint included); K1/K2/K3 launches per step "
          f"{per_step[0]}, total {launches}")
    print(f"{tag}: step 0 {trainer.step_seconds[0] * 1e3:.2f} ms; warm ms per step "
          f"(median of steps 3-31) {warm * 1e3:.2f}; training frames/s "
          f"{TRAIN_B * TRAIN_T / warm:.1f}; peak device memory {peak_gib:.3f} GiB; "
          f"BWD_DY_COPIES {copies}")
    print(f"{tag}: parameters that did not move (no gradient): {static}")
    print(f"{tag}: first step " + json.dumps({k: float(f"{v:.6g}") for k, v in first.items()}))
    print(f"{tag}: last step " + json.dumps({k: float(f"{v:.6g}") for k, v in last.items()}))
    if k3_per_step:
        print(f"{tag}: soft-DTW stability gap, first step "
              f"{first['soft_dtw_stability_gap']:.6g}, last step "
              f"{last['soft_dtw_stability_gap']:.6g}")
    return trainer, launches


def train_vs_cpu(torch, make_model, AttrDict, distributions, DataLoader, dataset, tag,
                 tols=TOLS_TRAIN):
    """One train step of `make_model(device)` on the first 2 examples of the
    trainer's first batch, with the same injected noise, on the card and on
    the CPU: each loss relative to max(1, |CPU loss|) and each gradient
    tensor's largest difference relative to its largest CPU gradient
    within `tols`."""
    first = next(iter(DataLoader(dataset, TRAIN_B, shuffle=True, n_repeat=2,
                                 num_workers=4)))
    batch = AttrDict({k: v[:2] for k, v in first.items()})
    noise = SharedNoise(torch, distributions)
    results = []
    for device in ("cuda", "cpu"):
        model = make_model(device).train()
        out = noise.run(lambda: model(AttrDict({k: v.to(device) for k, v in batch.items()}),
                                      phase="train", mode="posterior"))
        out.losses.total.value.backward()
        results.append(({k: float(v.value.detach()) for k, v in out.losses.items()},
                        {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
                         for n, p in model.named_parameters() if p.requires_grad}))
    (card_l, card_g), (cpu_l, cpu_g) = results
    loss_d = {k: abs(card_l[k] - v) / max(1.0, abs(v)) for k, v in cpu_l.items()}
    grad_d = {n: (card_g[n] - g).abs().max().item() / max(1e-3, g.abs().max().item())
              for n, g in cpu_g.items()}
    worst = max(grad_d, key=grad_d.get)
    if max(loss_d.values()) >= tols["loss"] or grad_d[worst] >= tols["grad"]:
        fail(f"{tag}: card vs CPU losses {loss_d}, worst gradient {worst} {grad_d[worst]}")
    print(f"{tag}: card vs CPU, one step on 2 examples, losses (relative): "
          + json.dumps({k: float(f"{v:.3e}") for k, v in loss_d.items()}))
    print(f"{tag}: card vs CPU, gradients of {len(grad_d)} tensors, worst "
          f"{grad_d[worst]:.3e} ({worst}, relative to its largest CPU gradient)")


class _Recorder:
    """Wraps the planning classes' methods for one control run: counts and
    times the simulator calls, _plan calls, closed-loop actions and tasks,
    keeps the first simulator call and the first action for the CPU checks,
    checks every plan, and profiles the second _plan with torch.profiler.
    Splits each _plan's host time over the simulator's rollouts (the model
    call with its copies, and the capping after it), the learned-cost calls,
    the tree optimizer's own numpy and the sampler's draws of candidates."""

    def __init__(self, torch, sim_mod, policy_mod, infra_sim_mod, cost_mod,
                 sampler_mod):
        self.torch = torch
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
            rec.sim.append((inputs.z.shape[0], time.perf_counter() - t0, sim.host_bytes))
            if rec.first_sim is None:
                rec.first_sim = ({k: inputs[k].cpu() for k in ("I_0", "I_g", "z")}, out)
            return out
        return run_model

    def _plan(self, orig):
        rec, torch = self, self.torch

        def plan(policy, state, goal, step):
            rec.policy = policy
            n0, host0 = len(rec.sim), dict(rec.host)
            if len(rec.plans) == 1:  # the second, warm _plan: profiled
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    orig(policy, state, goal, step)
                    torch.cuda.synchronize()
                    host_ms = (time.perf_counter() - t0) * 1e3
                busy = sum(e.self_device_time_total for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                kernels = sum(e.count for e in prof.key_averages()
                              if e.device_type == torch.autograd.DeviceType.CUDA)
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


def plan_phase(torch, fused_gn, soft_dtw, AttrDict):
    """Closed-loop visual planning on 9room/gcp_tree with ep74 on the card:
    start/goal configurations from the port's data generation, then the
    control benchmark's tasks 0-2 through planning.run's ControlManager."""
    import copy
    import types
    from video_gcp_torch.core.attrdict import load_pickle
    from video_gcp_torch.evaluation.compute_control_perf import compute_control_perf
    from video_gcp_torch.planning import planner_policy
    from video_gcp_torch.planning.cem import cost_fcn as cost_mod
    from video_gcp_torch.planning.cem import sampler as sampler_mod
    from video_gcp_torch.planning.cem import simulator as sim_mod
    from video_gcp_torch.planning.infra.sim import simulator as infra_sim_mod
    from video_gcp_torch.planning.run import ControlManager
    from video_gcp_torch.training.checkpoint import load_model_state

    shutil.rmtree(EXP_DIR / "experiments", ignore_errors=True)
    shutil.rmtree(EXP_DIR / "control", ignore_errors=True)
    data_dir = EXP_DIR / "data"
    shutil.rmtree(data_dir, ignore_errors=True)
    ckpt = EXP_DIR / "prediction/9room/gcp_tree/weights/weights_ep74"
    ckpt.mkdir(parents=True, exist_ok=True)
    torch.save(dict(model=load_model_state(WEIGHTS), optimizer={}, step=74),
               ckpt / "state.pt")
    os.environ["GCP_EXP_DIR"] = str(EXP_DIR)
    os.environ["GCP_DATA_DIR"] = str(data_dir)
    shutil.copytree(ROOT / "experiments/prediction/base_configs",
                    EXP_DIR / "experiments/prediction/base_configs")
    last = str(CONTROL_TASKS - 1)
    t0 = time.perf_counter()
    ControlManager([str(_config_copy(DATA_GEN)), "--device", "cpu", "--start_idx", "0",
                    "--end_idx", last]).run()
    datagen_s = time.perf_counter() - t0
    print(f"plan: start/goal configurations 0-{last} by the PRM expert (CPU) in "
          f"{datagen_s:.2f} s")

    control = _config_copy(CONTROL)
    rec = _Recorder(torch, sim_mod, planner_policy, infra_sim_mod, cost_mod, sampler_mod)
    fused_gn.LAUNCHES = fused_gn.BWD_LAUNCHES = soft_dtw.LAUNCHES = 0  # the control path
    t0 = time.perf_counter()
    try:
        ControlManager([str(control), "--start_idx", "0", "--end_idx", last]).run()
    finally:
        rec.restore()
    run_s = time.perf_counter() - t0
    k1, k2, k3 = fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES, soft_dtw.LAUNCHES
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
    cpu_model = copy.deepcopy(rec.policy.planner).cpu()
    first_in, card_out = rec.first_sim
    inputs = AttrDict(first_in, end_ind=torch.from_numpy(card_out.end_ind))
    with torch.inference_mode():
        ref = cpu_model(inputs, phase="plan", mode="prior")
    diffs = {}
    for k in ("timeline_images", "timeline_latents", "actions", "regressed_state"):
        diffs[k] = float(np.abs(card_out[k] - ref[k].numpy()).max())
        if not diffs[k] < TOLS_SLICE[k]:
            fail(f"control path: the first simulator call's {k} differs from the CPU "
                 f"by {diffs[k]} (tolerance {TOLS_SLICE[k]})")
    img, target, got = rec.first_action
    cpu_policy = types.SimpleNamespace(planner=cpu_model, device=torch.device("cpu"))
    cpu_policy._encode = lambda im: planner_policy.ImageCEMPolicy._encode(cpu_policy, im)
    want_action = planner_policy.ImageCEMPolicy._infer_action(cpu_policy, img, target)
    diffs["action"] = float(np.abs(got - want_action).max())
    if not diffs["action"] < TOL_ACTION:
        fail(f"control path: a closed-loop action differs from the CPU by "
             f"{diffs['action']} (tolerance {TOL_ACTION})")
    print(f"plan: card vs CPU, the first simulator call ({len(first_in['z'])} candidates, "
          "same z and end_ind) and the first action, max abs diff: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in diffs.items()}))
    return k1



def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit of the port, "
                    "whose K1, K2 and K3 are timed in turns with this one's")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the K1, K2 and K3 phases (no result line)")
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
        from video_gcp_torch.ops import cuda_build, fused_gn, soft_dtw
        from video_gcp_torch.parallel import train_step as train_step_mod
        from video_gcp_torch.training import trainer as trainer_mod
    except ImportError as e:
        fail(f"video_gcp_torch is not beside chip_smoke.py: {e}")
    banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "video_gcp_tpu")]
    if banned:
        fail(f"JAX modules loaded: {banned}")
    set_float32_precision()
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
        with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
            builds = [pool.submit(m.load_library) for m in (fused_gn, soft_dtw)]
            for b in builds:
                b.result()  # raises (non-zero exit) if nvcc fails

    timed_phase("build", build)
    print(f"build: K1 and K2 ({fused_gn.SOURCE}), K3 ({soft_dtw.SOURCE}) in "
          f"{phase_s['build']:.1f} s")
    for source in (fused_gn.SOURCE, soft_dtw.SOURCE):
        print(cuda_build.BUILD_LOGS.get(source, "").strip())

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
    if args.kernels_only:
        print(json.dumps({"k1": k1_rows, "k2": k2_rows, "k3": k3_rows, "k1_sums": k1_sums,
                          "k2_sums": k2_sums}))
        print(gpu_name_and_power_limit())
        return
    soft_dtw.LAUNCHES = 0  # slice_phase resets K1's and K2's counts
    serve_launches, plan_s, model, cpu_model = timed_phase(
        "serve", slice_phase, torch, fused_gn, load_model, AttrDict)
    if fused_gn.BWD_LAUNCHES or soft_dtw.LAUNCHES:
        fail("K2 or K3 launched on the serving path")
    trainer, (train_k1, train_k2, _) = timed_phase(
        "train", train_phase, torch, fused_gn, soft_dtw, trainer_mod, CONF, WEIGHTS,
        k3_per_step=0)
    timed_phase("train_vs_cpu", train_vs_cpu, torch,
                lambda d: load_model(CONF, weights=WEIGHTS, device=d), AttrDict,
                distributions, DataLoader, trainer.train_loader.dataset, "train")

    # from the port's initialisation: --resume latest finds no checkpoint
    shutil.rmtree(EXP_DIR / "prediction/9room/gcp_adaptive", ignore_errors=True)
    adaptive, (ad_k1, ad_k2, ad_k3) = timed_phase(
        "train_adaptive", train_phase, torch, fused_gn, soft_dtw, trainer_mod, ADAPTIVE_CONF,
        "latest", k3_per_step=1)
    trained = {k: v.detach().cpu() for k, v in adaptive.model.state_dict().items()}

    def adaptive_model(device):
        model = load_model(ADAPTIVE_CONF, device=device)
        model.load_state_dict(trained)
        return model

    timed_phase("train_adaptive_vs_cpu", train_vs_cpu, torch, adaptive_model, AttrDict,
                distributions, DataLoader, adaptive.train_loader.dataset, "train_adaptive")
    del adaptive

    soft_dtw.LAUNCHES = 0
    serve16_k1, (train16_k1, train16_k2) = timed_phase(
        "bf16", bf16_phase, torch, fused_gn, load_model, AttrDict, train_step_mod, model,
        trainer.model, trainer.train_loader.dataset, DataLoader)
    if soft_dtw.LAUNCHES:
        fail("K3 launched on a bf16 path")
    timed_phase("train_bf16_vs_cpu", train_vs_cpu, torch,
                lambda d: load_model(CONF, weights=WEIGHTS, device=d,
                                     compute_dtype=torch.bfloat16),
                AttrDict, distributions, DataLoader, trainer.train_loader.dataset,
                "train_bf16", TOLS_TRAIN_BF16)
    eval_k1 = timed_phase("eval", eval_phase, torch, fused_gn, soft_dtw, model, cpu_model,
                          trainer.val_loader.dataset, DataLoader, AttrDict)
    plan_k1 = timed_phase("plan", plan_phase, torch, fused_gn, soft_dtw, AttrDict)
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
                  serve_bf16=serve16_k1, train_bf16=train16_k1, eval=eval_k1, plan=plan_k1)),
        line("gn_lrelu_bwd", k2_rows, [TRAIN_B * N_NODES, 32, 32, 16], "float32",
             "video_gcp_tpu/ops/fused_gn.py:141",
             dict(serve=0, train=train_k2, train_adaptive=ad_k2, serve_bf16=0,
                  train_bf16=train16_k2, eval=0, plan=0)),
        line("soft_dtw", k3_rows, list(K3_SHAPES[0]), "float32",
             "video_gcp_tpu/ops/pallas_dtw.py:29",
             dict(serve=0, train=0, train_adaptive=ad_k3, serve_bf16=0, train_bf16=0,
                  eval=0, plan=0), source=soft_dtw.SOURCE),
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
