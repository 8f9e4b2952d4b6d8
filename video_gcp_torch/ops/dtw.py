"""Evaluation-time min-cost DTW (ops/dtw.py of the JAX package), batched
over B on the device.

Semantics as in the reference: the padded accumulated-cost matrix
D [B, r+1, c+1] with D[0, 0] = 0 and inf borders; transitions (i-1, j-1),
(i-1, j), (i, j-1); the traceback steps to the argmin of (D[i-1, j-1],
D[i-1, j], D[i, j-1]), ties broken in that order; each frame (column) takes
the path cell of least accumulated cost, the smaller node index on a tie;
frames past end_ind repeat the last valid frame's match.

The reference runs this as XLA scans, not as a Pallas kernel, so it is
plain torch here. The DP walks the r + c - 1 anti-diagonals of the interior,
one step over the batch and the diagonal's cells each, and computes every
cell as the JAX scan does, C + min(diag, min(up, left)): D is the same bit
for bit. The traceback is r + c batched steps that follow the argmin and
record the path; the per-column choice is then one scatter-min over it.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from video_gcp_torch import tracing
from video_gcp_torch.ops.cdist import batch_cdist


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


@tracing.spanned("dtw")
def batched_dtw_alignment(C: torch.Tensor, end_inds: torch.Tensor):
    """DTW, traceback and per-frame best node, batched.

    :param C: [B, n_nodes, T] cost between df-ordered nodes and GT frames.
    :param end_inds: [B] last valid GT frame per example.
    :return: (inds [B, T] int64, for each GT frame the node whose path cell
        costs least, frames past end_ind repeating the last valid match;
        dist [B], the normalized DTW distance D[r, end+1] / (r + end + 1)).
    """
    b, r, c = C.shape
    cw = c + 1
    with tracing.span("dtw.dp"):
        D = min_cumsum(C)
    flat = D.reshape(b, -1)
    end = end_inds.to(device=C.device, dtype=torch.int64)
    rows = torch.arange(b, device=C.device)
    dist = D[rows, r, end + 1] / (r + end.to(C.dtype) + 1.0)

    # the walk from (r, end + 1) to (1, 1): r + c visits, the last ones
    # staying at (1, 1)
    with tracing.span("dtw.traceback"):
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
    with tracing.span("dtw.match"):
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
    return inds, dist


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
