"""Evaluation-time min-cost DTW (ops/dtw.py of the JAX package), batched
over B on the device.

Semantics as in the reference: the padded accumulated-cost matrix
D [B, r+1, c+1] with D[0, 0] = 0 and inf borders; transitions (i-1, j-1),
(i-1, j), (i, j-1); the traceback steps to the argmin of (D[i-1, j-1],
D[i-1, j], D[i, j-1]), ties broken in that order; each frame (column) takes
the path cell of least accumulated cost, the smaller node index on a tie;
frames past end_ind repeat the last valid frame's match.

The reference runs this as XLA scans, not as a Pallas kernel. On a CUDA
tensor `batched_dtw_alignment` is kernel K4 (`video_gcp_torch/csrc/
dtw_align.cu`: the DP, the traceback and each frame's node in one launch,
built, bound and launched through `ops/cuda_build.py`; `launch_plan` chooses
its launch shape); it launches K4 or raises. On a CPU tensor it runs the
plain twin `alignment_reference`. The twin's DP walks the r + c - 1
anti-diagonals of the interior, one step over the batch and the diagonal's
cells each, and computes every cell as the JAX scan does,
C + min(diag, min(up, left)): D is the same bit for bit. Its traceback is
r + c batched steps that follow the argmin and record the path; the
per-column choice is then one scatter-min over it. K4 computes each cell
with the same float32 addition and takes the same argmin, so its D, node
indices and distances equal the twin's bit for bit.

K4's bound: B * r * c * 4 + B * c * 8 bytes (read C once, write the
matches), 4.9 us at [16, 511, 500] and 3.35 TB/s; its chain of r + c - 1
dependent DP steps and up to as many traceback steps keeps it far above
that (see the source).
"""
from __future__ import annotations

import functools
from ctypes import c_int, c_void_p
from dataclasses import dataclass
from typing import List, Tuple

import torch

from video_gcp_torch import tracing
from video_gcp_torch.ops import cuda_build
from video_gcp_torch.ops.cdist import batch_cdist

SOURCE = "dtw_align.cu"
MAX_NODES = 8192  # r the kernel takes (kMaxNodes)
MAX_FRAMES = 4096  # c the kernel takes (kMaxFrames)

# Launch plan limits (H100 SXM; the csrc constants in brackets)
ROWS_PER_LANE = 2  # kRowsPerLane
MAX_WARPS = 8  # kMaxWarps: a band of at most 512 rows
CELLS_PER_WORD = 16  # 2-bit choices in a 32-bit word

# the arguments before the stream: C, ends, inds, dist, scratch, dp; b, r, c; plan
ENTRY_POINTS = {"dtw_align_f32": (c_void_p,) * 6 + (c_int,) * 3 + (c_void_p,)}


@functools.lru_cache(maxsize=16)
def _diagonals(r: int, c: int, device: torch.device) -> List[Tuple[torch.Tensor, ...]]:
    """Per anti-diagonal of the interior (i, j >= 1, i + j = d): the flat
    indices into the padded D of its cells and of their diagonal, up and
    left neighbours, and into C of their costs."""
    cw = c + 1
    out = []
    for d in range(2, r + c + 1):
        j = torch.arange(max(1, d - r), min(c, d - 1) + 1)
        i = d - j
        f = i * cw + j
        out.append(tuple(t.to(device) for t in (f, f - cw - 1, f - cw, f - 1,
                                                (i - 1) * c + (j - 1))))
    return out


def min_cumsum(C: torch.Tensor) -> torch.Tensor:
    """Accumulated-cost matrix of batched DTW: C [B, r, c] -> D [B, r+1, c+1]
    (D[1:, 1:] the accumulated costs, row and column 0 inf but D[0, 0] = 0)."""
    b, r, c = C.shape
    D = torch.full((b, (r + 1) * (c + 1)), float("inf"), dtype=C.dtype, device=C.device)
    D[:, 0] = 0.0
    cost = C.reshape(b, r * c)
    for f, diag, up, left, cf in _diagonals(r, c, C.device):
        best = torch.minimum(D[:, diag], torch.minimum(D[:, up], D[:, left]))
        D[:, f] = cost[:, cf] + best
    return D.reshape(b, r + 1, c + 1)


def alignment_reference(C: torch.Tensor, end_inds: torch.Tensor, return_dp: bool = False):
    """Plain PyTorch twin of K4: `batched_dtw_alignment` as batched torch
    steps (module docstring), on any device; with `return_dp` also D, as
    `min_cumsum` gives it."""
    b, r, c = C.shape
    cw = c + 1
    D = min_cumsum(C)
    flat = D.reshape(b, -1)
    end = end_inds.to(device=C.device, dtype=torch.int64)
    rows = torch.arange(b, device=C.device)
    dist = D[rows, r, end + 1] / (r + end.to(C.dtype) + 1.0)

    # the walk from (r, end + 1) to (1, 1): r + c visits, the last ones
    # staying at (1, 1)
    neighbours = torch.tensor([cw + 1, cw, 1], device=C.device)
    moves = torch.tensor([[1, 1], [1, 0], [0, 1]], device=C.device)
    i = torch.full((b,), r, dtype=torch.int64, device=C.device)
    j = end + 1
    path = torch.empty((b, r + c), dtype=torch.int64, device=C.device)
    for s in range(r + c):
        f = i * cw + j
        path[:, s] = f
        step = moves[torch.argmin(flat.gather(1, f[:, None] - neighbours), dim=1)]
        i = torch.clamp(i - step[:, 0], min=1)
        j = torch.clamp(j - step[:, 1], min=1)

    # per column the visited cell of least cost; on a tie the later visit,
    # which is the smaller node index (the JAX scan's running `<=`)
    cost = flat.gather(1, path)
    node = path // cw - 1
    col = torch.clamp(path % cw - 1, 0, c - 1)
    best_cost = torch.full((b, c), float("inf"), dtype=C.dtype, device=C.device)
    best_cost = best_cost.scatter_reduce(1, col, cost, "amin")
    on_best = cost == best_cost.gather(1, col)
    none = r  # above every node index
    best_node = torch.full((b, c), none, dtype=torch.int64, device=C.device)
    best_node = best_node.scatter_reduce(
        1, col, torch.where(on_best, node, torch.full_like(node, none)), "amin")
    best_node = torch.where(best_node == none, torch.zeros_like(best_node), best_node)
    t_idx = torch.arange(c, device=C.device)[None, :]
    inds = best_node.gather(1, torch.minimum(t_idx, end[:, None]))
    return (inds, dist, D) if return_dp else (inds, dist)


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


@dataclass(frozen=True)
class LaunchPlan:
    """How K4 covers one [r, c] matrix: a block of `warps` warps, each lane
    ROWS_PER_LANE rows of a band; `shared`: the cells' choices in shared
    memory (else in a device scratch), `words` 32-bit words of them a row;
    `smem` bytes of dynamic shared memory."""
    warps: int
    shared: int
    words: int
    smem: int


@functools.lru_cache(maxsize=None)
def launch_plan(r: int, c: int) -> LaunchPlan:
    """The launch shape of K4 for [B, r, c] float32 costs. Raises ValueError
    outside 1 <= r <= MAX_NODES, 1 <= c <= MAX_FRAMES."""
    if not (0 < r <= MAX_NODES and 0 < c <= MAX_FRAMES):
        raise ValueError(f"dtw: {r} nodes x {c} frames; the kernel takes 1..{MAX_NODES} "
                         f"nodes and 1..{MAX_FRAMES} frames")
    warps = min(MAX_WARPS, -(-r // (32 * ROWS_PER_LANE)))
    words = -(-c // CELLS_PER_WORD)
    # the warps' edge exchange and the path's length, two rows of D, the
    # path and its costs, a node a column (header_bytes in the csrc)
    header = (_align16(2 * MAX_WARPS * 4 + 4) + _align16(8 * (c + 1))
              + 2 * _align16(4 * (r + c)) + _align16(4 * c))
    choices = 4 * r * words
    if header + choices <= cuda_build.SMEM_LIMIT:
        return LaunchPlan(warps, 1, words, header + choices)
    return LaunchPlan(warps, 0, words, header)


def k4(C: torch.Tensor, end_inds: torch.Tensor, return_dp: bool = False):
    """K4 on a CUDA tensor, its twin on a CPU tensor: (inds, dist) of
    `batched_dtw_alignment` for C [B, r, c] float32 and end_inds [B] on C's
    card, or (inds, dist, D) with `return_dp` (D [B, r+1, c+1], as
    `min_cumsum` gives it). A C that is not contiguous is copied; integer
    end_inds other than int64 are cast. Each launch counts under
    `tracing.COUNTS["k4.launches"]`."""
    if not cuda_build.takes_kernel(C, "dtw"):
        return alignment_reference(C, end_inds, return_dp)
    if C.dtype != torch.float32 or C.dim() != 3:
        raise ValueError(f"dtw: need float32 [B, r, c], got {C.dtype} {tuple(C.shape)}")
    b, r, c = C.shape
    if (end_inds.shape != (b,) or end_inds.device != C.device
            or end_inds.dtype.is_floating_point or end_inds.dtype == torch.bool):
        raise ValueError(f"dtw: end_inds must be integers [{b}] on {C.device}, got "
                         f"{end_inds.dtype} {tuple(end_inds.shape)} on {end_inds.device}")
    plan = launch_plan(r, c)
    C = C.contiguous()
    end_inds = end_inds.to(torch.int64)
    inds = torch.empty((b, c), dtype=torch.int64, device=C.device)
    dist = torch.empty((b,), dtype=torch.float32, device=C.device)
    scratch = (None if plan.shared else
               torch.empty((b, r, plan.words), dtype=torch.int32, device=C.device))
    dp = (torch.empty((b, r + 1, c + 1), dtype=torch.float32, device=C.device)
          if return_dp else None)
    if b:
        cuda_build.launch(SOURCE, ENTRY_POINTS, "dtw_align_f32", C, C.data_ptr(),
                          end_inds.data_ptr(), inds.data_ptr(), dist.data_ptr(),
                          None if scratch is None else scratch.data_ptr(),
                          None if dp is None else dp.data_ptr(), b, r, c,
                          cuda_build.c_plan(plan), counter="k4.launches")
    return (inds, dist, dp) if return_dp else (inds, dist)


@tracing.spanned("dtw")
def batched_dtw_alignment(C: torch.Tensor, end_inds: torch.Tensor):
    """DTW, traceback and per-frame best node, batched: K4 on a CUDA
    tensor (which raises for what it does not take), the twin
    `alignment_reference` on a CPU tensor.

    :param C: [B, n_nodes, T] cost between df-ordered nodes and GT frames.
    :param end_inds: [B] last valid GT frame per example, in [0, T).
    :return: (inds [B, T] int64, for each GT frame the node whose path cell
        costs least, frames past end_ind repeating the last valid match;
        dist [B], the normalized DTW distance D[r, end+1] / (r + end + 1)).
    """
    return k4(C, end_inds)


def dtw_warp_sequence(estimates: torch.Tensor, targets: torch.Tensor,
                      end_inds: torch.Tensor):
    """df-ordered predicted frames [B, N, ...] warped onto the GT timeline
    of targets [B, T, ...] by DTW on the mean squared distance
    (DTWEvalBinding, evaluation_matching.py:123-149). Returns the warped
    predictions [B, T, ...] and the matched node indices [B, T]."""
    inds, _ = batched_dtw_alignment(batch_cdist(estimates, targets, reduction="mean"),
                                    end_inds)
    rows = torch.arange(inds.shape[0], device=inds.device)[:, None]
    return estimates[rows, inds], inds
