"""The benchmark's arithmetic: the card's peaks, the kernels' byte bounds at
a configuration's sites, and the gaps that decide `correct`.

Peaks are NVIDIA's published H100 SXM numbers: 67 TFLOP/s in float32
outside the tensor cores (the configurations run float32 with TF32 off) and
3.35 TB/s of HBM. The K1/K2 bounds count each input byte read once and each
output byte written once (the arithmetic of chip_smoke.py's `bound` and
`bwd_bound`, copied here so that no later change to the program moves it).
"""
from __future__ import annotations

import math
import statistics

F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
GN_FLOPS_PER_ELEMENT = 10  # K1: sum, square-sum, normalize, affine, activation
K2_FLOPS_PER_ELEMENT = 20  # K2: three passes, statistics, sums and dx
K1_KERNEL = "gn_lrelu_fwd_kernel"
K2_KERNEL = "gn_lrelu_bwd_kernel"


def k1_bound_s(shape, itemsize: int = 4) -> float:
    """Least seconds of GroupNorm + LeakyReLU forward on NHWC `shape`: read
    x, write y, read scale and bias; or its operations, whichever is more."""
    numel = math.prod(shape)
    return max((2 * numel * itemsize + 2 * shape[-1] * 4) / HBM_BYTES_PER_S,
               GN_FLOPS_PER_ELEMENT * numel / F32_FLOPS_PER_S)


def k2_bound_s(shape, itemsize: int = 4) -> float:
    """Least seconds of its backward: read x and dy, write dx, and the
    parameters and their gradients; or its operations."""
    numel = math.prod(shape)
    return max((3 * numel * itemsize + 4 * shape[-1] * 4) / HBM_BYTES_PER_S,
               K2_FLOPS_PER_ELEMENT * numel / F32_FLOPS_PER_S)


def pyramid(hp: dict):
    """The NHWC shapes [H, W, C] after each level of the conv encoder and
    of the decoder (the GroupNorm sites), from the hparams alone."""
    n = hp.get("n_conv_layers") or int(math.log2(hp["img_sz"]))
    enc = [(hp["img_sz"] >> (i + 1),) * 2 + (min(hp["ngf"] * 2 ** i, 256),)
           for i in range(n)]
    dec = []
    for i in reversed(range(n)):
        ch = min(hp["ngf"] * 2 ** max(i - 1, 0), 256) if i > 0 else hp["ngf"]
        dec.append((hp["img_sz"] >> i,) * 2 + (ch,))
    return enc, dec


def train_gn_sites(hp: dict, batch: int, seq_len: int):
    """The [N, H, W, C] shapes of a GCP-tree train step's GroupNorm sites:
    the encoder on the sequence (B*T), on I_0 and on I_g (B each), and the
    decoder on the B * (2^L - 1) nodes. Each runs K1 forward and K2
    backward once a step."""
    enc, dec = pyramid(hp)
    nodes = 2 ** hp["hierarchy_levels"] - 1
    return ([(batch * seq_len,) + s for s in enc] + [(batch,) + s for s in enc] * 2
            + [(batch * nodes,) + s for s in dec])


def dtw_bytes(batch: int, nodes: int, frames: int, itemsize: int = 4) -> int:
    """The eval DTW's own traffic: read the cost matrix C [B, nodes, frames]
    once and write each frame's matched node (int64)."""
    return batch * nodes * frames * itemsize + batch * frames * 8


# ---------------------------------------------------------------------------
# gaps between the program's readings and the reference's
# ---------------------------------------------------------------------------

def rel_gap(value: float, ref: float) -> float:
    return abs(value - ref) / max(abs(ref), 1e-30)


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between two per-leaf norms: |prog - ref| over
    the larger of the reference's norm of that leaf and of the median leaf.
    `keep` names the leaves that count (all of `ref` by default)."""
    names = sorted(ref if keep is None else keep)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def moving_leaves(ref_grad: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding: at
    least `share` of the median leaf's norm. Under Adam a leaf below it
    (a bias under a softmax) moves by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= share * med]
