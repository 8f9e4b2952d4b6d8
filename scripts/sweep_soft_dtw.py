#!/usr/bin/env python3
"""K3's launch plan against its columns a lane (V), on one GPU.

    python3 scripts/sweep_soft_dtw.py

For each tuple of `soft_dtw.COLS_PER_LANE` below (the plan takes the first
V that keeps a DP chain within 7 warps), runs K3 at the adaptive training
shape [16, 127, 100] and at [16, 511, 500] with mixed ends, holds w, F and
Bk against the row twin on the card, and prints the plan, the kernel's own
device time (torch.profiler, 10 calls) and its CUDA-event time (median of
25), and the device time per dependent row. The card's name and power
limit come first.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from video_gcp_torch.ops import cuda_build, soft_dtw  # noqa: E402

CHOICES = [(4, 8, 12), (8, 12)]


def main():
    if not torch.cuda.is_available():
        sys.exit("sweep_soft_dtw: no CUDA device")
    print(cs.gpu_name_and_power_limit())
    cuda_build.load(soft_dtw.SOURCE, soft_dtw.ENTRY_POINTS)
    gen = torch.Generator("cuda").manual_seed(2)
    for b, r, c in cs.K3_SHAPES:
        cost = torch.rand(b, r, c, generator=gen, device="cuda") * 2
        ends = torch.tensor([c - 1, int(c * 0.7), int(c * 0.4)], device="cuda")[
            torch.arange(b, device="cuda") % 3]
        want = soft_dtw.soft_dtw_rows_reference(cost, ends, return_dp=True)
        for cols in CHOICES:
            soft_dtw.COLS_PER_LANE = cols
            soft_dtw.launch_plan.cache_clear()
            got = soft_dtw.k3(cost, ends, return_dp=True)
            err = max(((g - w).abs() / w.abs().clamp(min=1)).max().item()
                      for g, w in zip(got, want))
            run = lambda: soft_dtw.k3(cost, ends)  # noqa: E731
            dev = cs.device_ms(torch, run, cs.K3_TAGS)
            ms = cs.time_ms(torch, run)
            plan = soft_dtw.launch_plan(r, c)
            print(f"[{b}, {r}, {c}] V={plan.cols} warps/chain={plan.warps} "
                  f"resident={plan.resident} | device_ms "
                  f"{cs.fmt(dev)} ms {ms:.4f} | us/row {(dev or ms) * 1e3 / r:.4f} | "
                  f"max err {err:.3e}")


if __name__ == "__main__":
    main()
