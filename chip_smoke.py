#!/usr/bin/env python3
"""Smoke test of the PyTorch port (video_gcp_torch) on one NVIDIA Hopper GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

1. Build: compiles kernels K1 (GroupNorm+LeakyReLU forward) and K2 (its
   backward), both in video_gcp_torch/csrc/fused_gn.cu, with nvcc for sm_90a
   and prints the build time and the ptxas report.
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
4. Slice phase (serving): load_model() of 9room/gcp_tree with the ep74
   weights on the card; two 'test'/'prior' rollouts at B=16 (cold, then
   warm); three planner calls ('plan', predicted length) of 100 candidates
   with fresh latents from a seeded torch.Generator on the card, as the CEM
   loop's n_iters=3 drives the simulator. Checks 15 K1 launches per forward,
   finite outputs, and the first 2 samples of the last rollout and the first
   2 candidates of the last plan call against the same port run on the CPU;
   prints each call's time and the plan calls' peak device memory.
5. Train phase: the trainer on the card, as `python -m
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

Prints the kernels' JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}. Any failure exits non-zero with no
result line, as does a host without CUDA or a directory without the port.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONF = ROOT / "experiments/prediction/9room/gcp_tree"
WEIGHTS = CONF / "pretrained_ep74.npz"

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


def train_phase(torch, fused_gn, trainer_mod):
    """The JAX command's training run on the card, through ModelTrainer."""
    os.environ["GCP_EXP_DIR"] = str(EXP_DIR)
    args = trainer_mod.parse_args([
        "--path", str(CONF), "--resume", str(WEIGHTS), "--feed_random_data", "1",
        "--num_epochs", "1", "--skip_first_val", "1", "--deterministic", "1",
        "--verbose_timing", "1"])
    trainer = trainer_mod.ModelTrainer(args)  # device 'cuda', the default
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    steps = []
    real_step = trainer_mod.train_step

    def counted_step(*a, **kw):
        k1, k2 = fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES
        metrics = real_step(*a, **kw)
        steps.append((fused_gn.LAUNCHES - k1, fused_gn.BWD_LAUNCHES - k2, metrics))
        return metrics

    trainer_mod.train_step = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_gn.LAUNCHES = fused_gn.BWD_LAUNCHES = fused_gn.BWD_DY_COPIES = 0
    t0 = time.perf_counter()
    try:
        trainer.run()
    finally:
        trainer_mod.train_step = real_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES)
    copies = fused_gn.BWD_DY_COPIES
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    if len(steps) != TRAIN_STEPS or trainer.step != TRAIN_STEPS:
        fail(f"train: {len(steps)} steps, expected {TRAIN_STEPS}")
    per_step = sorted({(a, b) for a, b, _ in steps})
    if per_step != [(NORMS_PER_STEP, NORMS_PER_STEP)]:
        fail(f"train: K1/K2 launches per step {per_step}, expected {NORMS_PER_STEP} each")
    for i, (_, _, m) in enumerate(steps):
        if not bool(m["grads_finite"]):
            fail(f"train: non-finite gradients at step {i}")
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f"train: non-finite {bad} at step {i}")
    unchanged = [n for n, p in trainer.model.named_parameters()
                 if p.grad is not None and p.grad.abs().sum() > 0
                 and torch.equal(p.detach(), before[n])]
    if unchanged:
        fail(f"train: parameters with a gradient did not change: {unchanged}")
    static = [n for n, p in trainer.model.named_parameters()
              if torch.equal(p.detach(), before[n])]
    warm = statistics.median(trainer.step_seconds[3:TRAIN_STEPS])
    first = {k: float(v) for k, v in steps[0][2].items() if v.dim() == 0}
    last = {k: float(v) for k, v in steps[-1][2].items() if v.dim() == 0}
    print(f"train: {TRAIN_STEPS} steps of B={TRAIN_B} T={TRAIN_T} in {wall:.2f} s "
          f"(checkpoint included); K1/K2 launches per step {per_step[0]}, total {launches}")
    print(f"train: step 0 {trainer.step_seconds[0] * 1e3:.2f} ms; warm ms per step "
          f"(median of steps 3-31) {warm * 1e3:.2f}; training frames/s "
          f"{TRAIN_B * TRAIN_T / warm:.1f}; peak device memory {peak_gib:.3f} GiB; "
          f"BWD_DY_COPIES {copies}")
    print(f"train: parameters that did not move (no gradient): {static}")
    print("train: first step " + json.dumps({k: float(f"{v:.6g}") for k, v in first.items()}))
    print("train: last step " + json.dumps({k: float(f"{v:.6g}") for k, v in last.items()}))
    return trainer, launches


def train_vs_cpu(torch, load_model, AttrDict, distributions, DataLoader, dataset):
    """One step of ep74 on the first 2 examples of the trainer's first batch,
    with the same injected noise, on the card and on the CPU."""
    first = next(iter(DataLoader(dataset, TRAIN_B, shuffle=True, n_repeat=2,
                                 num_workers=4)))
    batch = AttrDict({k: v[:2] for k, v in first.items()})
    noise = SharedNoise(torch, distributions)
    results = []
    for device in ("cuda", "cpu"):
        model = load_model(CONF, weights=WEIGHTS, device=device).train()
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
        fail(f"train: card vs CPU losses {loss_d}, worst gradient {worst} {grad_d[worst]}")
    print("train: card vs CPU, one ep74 step on 2 examples, losses (relative): "
          + json.dumps({k: float(f"{v:.3e}") for k, v in loss_d.items()}))
    print(f"train: card vs CPU, gradients of {len(grad_d)} tensors, worst "
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
        from video_gcp_torch.ops import cuda_build, fused_gn
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
    fused_gn.load_library()  # raises (non-zero exit) if nvcc fails
    print(f"build: K1 and K2 ({fused_gn.SOURCE}) in {time.perf_counter() - t0:.1f} s")
    print(cuda_build.BUILD_LOGS.get(fused_gn.SOURCE, "").strip())

    k1_rows = kernel_phase(torch, F, fused_gn)
    k2_rows = k2_phase(torch, F, fused_gn)
    serve_launches, plan_s = slice_phase(torch, fused_gn, load_model, AttrDict)
    if fused_gn.BWD_LAUNCHES:
        fail("K2 launched on the serving path")
    trainer, (train_k1, train_k2) = train_phase(torch, fused_gn, trainer_mod)
    train_vs_cpu(torch, load_model, AttrDict, distributions, DataLoader,
                 trainer.train_loader.dataset)

    def line(name, rows, shape, dtype, replaces, by_path):
        top = next(r for r in rows if r["shape"] == shape and r["dtype"] == dtype)
        return dict(name=name, route="cuda", source="video_gcp_torch/csrc/fused_gn.cu",
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path,
                    **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "shape", "dtype")})

    # each kernel's line: the main paths' largest site of that kernel in f32
    kernels = [
        line("gn_lrelu_fwd", k1_rows, [CEM_BATCH * N_NODES, 32, 32, 16], "float32",
             "video_gcp_tpu/ops/fused_gn.py:97", dict(serve=serve_launches, train=train_k1)),
        line("gn_lrelu_bwd", k2_rows, [TRAIN_B * N_NODES, 32, 32, 16], "float32",
             "video_gcp_tpu/ops/fused_gn.py:141", dict(serve=0, train=train_k2)),
    ]
    print(f"slice: median plan call {plan_s * 1e3:.2f} ms")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
