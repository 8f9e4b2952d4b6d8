#!/usr/bin/env python3
"""Where the time of the PyTorch port's planner call or train step goes, on
one GPU.

    python3 scripts/profile_torch_slice.py [--batch 100] [--cudnn-benchmark]
    python3 scripts/profile_torch_slice.py --train [--batch 16]
    python3 scripts/profile_torch_slice.py --adaptive [--batch 16]

Loads experiments/prediction/9room/gcp_tree with its ep74 weights on the
card, warms up, then traces 5 planner calls ('plan', 'prior', predicted
length, fresh latents from a seeded generator) of `batch` candidates with
torch.profiler; with --train, 5 train steps (RAdam, lr 2e-4) on one batch
of `batch` RandomVideoDataset sequences of 100 frames; with --adaptive, the
same train steps of experiments/prediction/9room/gcp_adaptive from the
port's initialisation (soft-DTW binding, attentive inference, kernel K3).
Prints the host time per call, the device's busy time per call (sum of
kernel times; one stream, so kernels do not overlap) and its idle share,
the 25 kernels with the most device time, with their share and count, and
each hand-written kernel's time and launches.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from video_gcp_torch.core.attrdict import AttrDict  # noqa: E402
from video_gcp_torch.data.datasets import RandomVideoDataset  # noqa: E402
from video_gcp_torch.data.loader import DataLoader  # noqa: E402
from video_gcp_torch.load import load_model  # noqa: E402
from video_gcp_torch.ops import fused_gn, soft_dtw  # noqa: E402
from video_gcp_torch.parallel.train_step import make_optimizer, train_step  # noqa: E402
from video_gcp_torch.training.config import build_hparams, load_config  # noqa: E402

CONF = ROOT / "experiments/prediction/9room/gcp_tree"
ADAPTIVE_CONF = ROOT / "experiments/prediction/9room/gcp_adaptive"
REPS, TOP = 5, 25


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None,
                    help="candidates per planner call (100) or train batch (16)")
    ap.add_argument("--train", action="store_true", help="profile train steps")
    ap.add_argument("--adaptive", action="store_true",
                    help="profile train steps of 9room/gcp_adaptive")
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help="let cuDNN time its algorithms per shape (warm-up calls)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: no CUDA device")
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    args.train = args.train or args.adaptive
    conf = ADAPTIVE_CONF if args.adaptive else CONF
    torch.manual_seed(0)  # the adaptive model's initialisation
    model = load_model(conf, weights=None if args.adaptive else CONF / "pretrained_ep74.npz")
    gen = torch.Generator("cuda").manual_seed(0)
    if args.train:
        args.batch = args.batch or 16
        bundle = load_config(conf)
        dset = RandomVideoDataset(None, dict(build_hparams(bundle)), bundle.data_conf, "train")
        batch = next(iter(DataLoader(dset, args.batch, device="cuda")))
        model.train()
        opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam", 2e-4)
        mode = torch.enable_grad
        call = lambda: train_step(model, opt, batch, 0, gen)  # noqa: E731
    else:
        args.batch = args.batch or 100
        img = lambda: torch.randint(0, 256, (1, 32, 32, 3), generator=gen,  # noqa: E731
                                    device="cuda", dtype=torch.uint8).repeat(args.batch, 1, 1, 1)
        inputs = AttrDict(I_0=img(), I_g=img())
        mode = torch.inference_mode

        def call():
            inputs.z = torch.randn(args.batch, 127, 256, generator=gen, device="cuda")
            return model(inputs, phase="plan", mode="prior", pred_length=True,
                         generator=gen)

    with mode():
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        launches = (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES, soft_dtw.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
            host_s = (time.perf_counter() - t0) / REPS

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels) / REPS
    print(f"batch {args.batch}: host {host_s * 1e3:.3f} ms per "
          f"{'step' if args.train else 'call'}, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e6 / host_s:.3f}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    print("device ms | share | launches | kernel (per call or step)")
    for e in kernels[:TOP]:
        t = e.self_device_time_total / REPS
        print(f"{t / 1e3:9.3f} | {t / busy_us:.3f} | {e.count / REPS:6.1f} | {e.key[:110]}")
    what = "step" if args.train else "call"
    for name, tag, count, before in (("K1", "gn_lrelu_fwd", fused_gn.LAUNCHES, launches[0]),
                                     ("K2", "gn_lrelu_bwd", fused_gn.BWD_LAUNCHES, launches[1]),
                                     ("K3", "gak_kernel", soft_dtw.LAUNCHES, launches[2])):
        t = sum(e.self_device_time_total for e in kernels if tag in e.key) / REPS
        print(f"{name} {tag}: {t / 1e3:.3f} ms/{what}, share {t / busy_us:.3f}, "
              f"launches per {what} {(count - before) / REPS:.1f}")


if __name__ == "__main__":
    main()
