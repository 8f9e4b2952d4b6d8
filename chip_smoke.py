#!/usr/bin/env python3
"""Smoke test of the PyTorch port (video_gcp_torch) on one NVIDIA Hopper GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

1. Build: compiles kernels K1 (GroupNorm+LeakyReLU forward) and K2 (its
   backward), both in video_gcp_torch/csrc/fused_gn.cu, and K3 (the
   soft-DTW wavefront), video_gcp_torch/csrc/soft_dtw.cu, with nvcc for
   sm_90a, one nvcc per source, started together; prints the build time and
   both ptxas reports.
2. K1 phase: K1 against its plain PyTorch twin on the card at every
   GroupNorm site of the 9-room GCP-tree (5 encoder, 5 decoder) at batch 16
   and at the CEM batch of 100 candidates, in f32 and bf16, plus the largest
   shape of the repo, [16352, 64, 64, 16] bf16. Prints per shape the kernel's
   time (CUDA events, median of 25), the plain twin's time, the time of
   F.group_norm + F.leaky_relu (a yardstick the port never calls), the bound
   and the max difference.
3. K2 phase: K2 against its twin at the 15 norm shapes of a training step
   at B=16, T=100 in f32 (encoder on 1600 frames and on the 16 start and
   goal frames, decoder on 2032 nodes) and at the two largest of
   bench.py's train step in bf16. Inputs are moved clear of LeakyReLU's kink
   (fused_gn.clear_of_kink) so that both sign tests agree. Prints the same
   times; the yardstick is the autograd backward of F.group_norm +
   F.leaky_relu.
4. K3 phase: K3 against its twin on the card at the adaptive training
   shape [32, 127, 100] (2B rows of 127 nodes x 100 frames) and at the
   largest shape the repo names, [32, 511, 500], with mixed ends: the
   accumulated values within 1e-4 of max(1, |D|), w within 1e-4, and no
   mass past an end. Prints the kernel's and the twin's time (CUDA events,
   median of 25), the bound, the diagonals and the time per diagonal.
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

Prints the kernels' JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}. Any failure exits non-zero with no
result line, as does a host without CUDA or a directory without the port.
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
K2_SHAPES = ([((TRAIN_B * TRAIN_T,) + s, "float32") for s in ENC_SITES]
             + [((TRAIN_B,) + s, "float32") for s in ENC_SITES]
             + [((TRAIN_B * N_NODES,) + s, "float32") for s in DEC_SITES]
             + [((TRAIN_B * N_NODES, 64, 64, 16), "bfloat16"),  # bench.py's train
                ((TRAIN_B * TRAIN_T, 32, 32, 16), "bfloat16")])  # step at 64x64
K2_FLOPS_PER_ELEMENT = 20  # three passes: stats, sums, dx
TOLS_TRAIN = dict(loss=1e-4, grad=2e-3)  # tests/test_torch_train.py, ep74
# K3: 2B rows of the adaptive training step; the largest shape the repo
# names (video_gcp_tpu/ops/pallas_dtw.py:7-9: 511 nodes x 500 frames)
K3_SHAPES = [(2 * TRAIN_B, N_NODES, TRAIN_T), (2 * TRAIN_B, 511, 500)]
K3_OPS_PER_CELL = 10  # two maxima, subtract, abs, exp, log1p, two adds, select
TOL_K3 = 1e-4  # w absolute (tests/test_torch_soft_dtw.py); D relative to max(1, |D|)
EXP_DIR = ROOT / "video_gcp_torch/_build/chip_smoke_exp"  # git-ignored


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


def bound(shape, itemsize):
    numel = 1
    for s in shape:
        numel *= s
    t_bytes = (2 * numel * itemsize + 2 * shape[-1] * 4) / HBM_BYTES_PER_S
    t_ops = GN_FLOPS_PER_ELEMENT * numel / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(torch, F, fused_gn):
    cases = []
    for batch in (ROLLOUT_BATCH, CEM_BATCH):
        cases += [((batch,) + s, d) for s in ENC_SITES for d in ("float32", "bfloat16")]
        cases += [((batch * N_NODES,) + s, d) for s in DEC_SITES
                  for d in ("float32", "bfloat16")]
    cases.append(((32 * 511, 64, 64, 16), "bfloat16"))  # bench.py top decode level
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    print("K1 gn_lrelu_fwd: shape dtype | ms plain_ms library_ms bound_ms | max_abs_err")
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
        ms = time_ms(torch, lambda: fused_gn.fused_group_norm_lrelu(x, scale, bias, groups))
        plain_ms = time_ms(torch, lambda: fused_gn.gn_lrelu_reference(x, scale, bias, groups))
        lib_ms = time_ms(torch, lambda: F.leaky_relu(
            F.group_norm(x_nchw, groups, scale.to(dt), bias.to(dt), eps=1e-6), 0.2))
        bound_ms, bound_by = bound(shape, x.element_size())
        rows.append(dict(shape=list(shape), dtype=dtype, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=max_err))
        print(f"K1 {list(shape)} {dtype} | {ms:.4f} {plain_ms:.4f} {lib_ms:.4f} "
              f"{bound_ms:.4f} | {max_err:.3e}")
        del x, x_nchw
        torch.cuda.empty_cache()
    return rows


def bwd_bound(shape, itemsize):
    numel = 1
    for s in shape:
        numel *= s
    t_bytes = (3 * numel * itemsize + 4 * shape[-1] * 4) / HBM_BYTES_PER_S
    t_ops = K2_FLOPS_PER_ELEMENT * numel / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_phase(torch, F, fused_gn):
    """K2 against its twin, and its times, at the training shapes."""
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    print("K2 gn_lrelu_bwd: shape dtype | ms plain_ms library_ms bound_ms | "
          "max err dx dscale dbias (relative to max(1, |ref|))")
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
        ms = time_ms(torch, lambda: fused_gn.gn_lrelu_bwd(x, dy, scale, bias, groups))
        plain_ms = time_ms(torch, lambda: fused_gn.gn_lrelu_bwd_reference(
            x, dy, scale, bias, groups))
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()  # channels_last view
        wl, bl = (p.to(dt).detach().requires_grad_() for p in (scale, bias))
        yl = F.leaky_relu(F.group_norm(xl, groups, wl, bl, eps=1e-6), 0.2)
        dyl = dy.permute(0, 3, 1, 2)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            yl, (xl, wl, bl), dyl, retain_graph=True))
        bound_ms, bound_by = bwd_bound(shape, x.element_size())
        rows.append(dict(shape=list(shape), dtype=dtype, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=abs_err))
        print(f"K2 {list(shape)} {dtype} | {ms:.4f} {plain_ms:.4f} {lib_ms:.4f} "
              f"{bound_ms:.4f} | {errs[0]:.3e} {errs[1]:.3e} {errs[2]:.3e}")
        del x, dy, xl, wl, bl, yl, dyl
        torch.cuda.empty_cache()
    return rows


def k3_bound(rows, r, c):
    cells = rows * r * c
    t_bytes = 2 * cells * 4 / HBM_BYTES_PER_S  # read C once, write D once
    t_ops = K3_OPS_PER_CELL * cells / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k3_phase(torch, soft_dtw):
    """K3 against its twin on the card, and both times."""
    gen = torch.Generator("cuda").manual_seed(2)
    rows_out = []
    print("K3 soft_dtw_gak: [rows, r, c] | ms plain_ms bound_ms | n_diag us_per_diag | "
          "max err w, D (relative to max(1, |D|))")
    for rows, r, c in K3_SHAPES:
        b = rows // 2
        cost = torch.rand(b, r, c, generator=gen, device="cuda") * 2
        ends = torch.tensor([c - 1, int(c * 0.7), int(c * 0.4)], device="cuda")
        ends = ends[torch.arange(b, device="cuda") % 3]  # mixed ends
        comb, begin = soft_dtw.dp_rows(cost, ends)
        got = soft_dtw.gak(comb, begin)
        want = soft_dtw.gak_reference(comb, begin)
        torch.cuda.synchronize()
        finite = want > soft_dtw.NEG_INF / 2
        if not torch.equal(got > soft_dtw.NEG_INF / 2, finite) or not torch.isfinite(got).all():
            fail(f"K3 at {[rows, r, c]}: the alignment region differs from the twin's")
        d_err = ((got - want).abs()[finite] / want.abs()[finite].clamp(min=1)).max().item()
        w = soft_dtw.posterior(got, comb, ends)
        w_err = (w - soft_dtw.posterior(want, comb, ends)).abs().max().item()
        past = max(w[k, :, int(ends[k]) + 1:].abs().sum().item() for k in range(b))
        if not (d_err < TOL_K3 and w_err < TOL_K3 and past < 1e-6):
            fail(f"K3 disagrees with its twin at {[rows, r, c]}: D {d_err}, w {w_err}, "
                 f"mass past the ends {past}")
        ms = time_ms(torch, lambda: soft_dtw.gak(comb, begin))
        plain_ms = time_ms(torch, lambda: soft_dtw.gak_reference(comb, begin))
        bound_ms, bound_by = k3_bound(rows, r, c)
        n_diag = r + c - 1
        rows_out.append(dict(shape=[rows, r, c], dtype="float32", ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=w_err, n_diag=n_diag))
        print(f"K3 {[rows, r, c]} | {ms:.4f} {plain_ms:.4f} {bound_ms:.5f} | {n_diag} "
              f"{ms * 1e3 / n_diag:.4f} | {w_err:.3e} {d_err:.3e}")
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
    return launches, statistics.median(calls)


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


def train_vs_cpu(torch, make_model, AttrDict, distributions, DataLoader, dataset, tag):
    """One train step of `make_model(device)` on the first 2 examples of the
    trainer's first batch, with the same injected noise, on the card and on
    the CPU."""
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
    if max(loss_d.values()) >= TOLS_TRAIN["loss"] or grad_d[worst] >= TOLS_TRAIN["grad"]:
        fail(f"{tag}: card vs CPU losses {loss_d}, worst gradient {worst} {grad_d[worst]}")
    print(f"{tag}: card vs CPU, one step on 2 examples, losses (relative): "
          + json.dumps({k: float(f"{v:.3e}") for k, v in loss_d.items()}))
    print(f"{tag}: card vs CPU, gradients of {len(grad_d)} tensors, worst "
          f"{grad_d[worst]:.3e} ({worst}, relative to its largest CPU gradient)")


def main():
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
        from video_gcp_torch.training import trainer as trainer_mod
    except ImportError as e:
        fail(f"video_gcp_torch is not beside chip_smoke.py: {e}")
    banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "video_gcp_tpu")]
    if banned:
        fail(f"JAX modules loaded: {banned}")
    set_float32_precision()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        builds = [pool.submit(m.load_library) for m in (fused_gn, soft_dtw)]
        for b in builds:
            b.result()  # raises (non-zero exit) if nvcc fails
    print(f"build: K1 and K2 ({fused_gn.SOURCE}), K3 ({soft_dtw.SOURCE}) in "
          f"{time.perf_counter() - t0:.1f} s")
    for source in (fused_gn.SOURCE, soft_dtw.SOURCE):
        print(cuda_build.BUILD_LOGS.get(source, "").strip())

    k1_rows = kernel_phase(torch, F, fused_gn)
    k2_rows = k2_phase(torch, F, fused_gn)
    k3_rows = k3_phase(torch, soft_dtw)
    soft_dtw.LAUNCHES = 0  # slice_phase resets K1's and K2's counts
    serve_launches, plan_s = slice_phase(torch, fused_gn, load_model, AttrDict)
    if fused_gn.BWD_LAUNCHES or soft_dtw.LAUNCHES:
        fail("K2 or K3 launched on the serving path")
    trainer, (train_k1, train_k2, _) = train_phase(
        torch, fused_gn, soft_dtw, trainer_mod, CONF, WEIGHTS, k3_per_step=0)
    train_vs_cpu(torch, lambda d: load_model(CONF, weights=WEIGHTS, device=d), AttrDict,
                 distributions, DataLoader, trainer.train_loader.dataset, "train")

    # from the port's initialisation: --resume latest finds no checkpoint
    shutil.rmtree(EXP_DIR / "prediction/9room/gcp_adaptive", ignore_errors=True)
    adaptive, (ad_k1, ad_k2, ad_k3) = train_phase(
        torch, fused_gn, soft_dtw, trainer_mod, ADAPTIVE_CONF, "latest", k3_per_step=1)
    trained = {k: v.detach().cpu() for k, v in adaptive.model.state_dict().items()}

    def adaptive_model(device):
        model = load_model(ADAPTIVE_CONF, device=device)
        model.load_state_dict(trained)
        return model

    train_vs_cpu(torch, adaptive_model, AttrDict, distributions, DataLoader,
                 adaptive.train_loader.dataset, "train_adaptive")

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
             dict(serve=serve_launches, train=train_k1, train_adaptive=ad_k1)),
        line("gn_lrelu_bwd", k2_rows, [TRAIN_B * N_NODES, 32, 32, 16], "float32",
             "video_gcp_tpu/ops/fused_gn.py:141",
             dict(serve=0, train=train_k2, train_adaptive=ad_k2)),
        line("soft_dtw_gak", k3_rows, list(K3_SHAPES[0]), "float32",
             "video_gcp_tpu/ops/pallas_dtw.py:29",
             dict(serve=0, train=0, train_adaptive=ad_k3), source=soft_dtw.SOURCE),
    ]
    print(f"slice: median plan call {plan_s * 1e3:.2f} ms")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
