"""The plain soft-DTW posterior of the adaptive binding ('nohor'
transitions: every node matches exactly one frame, the alignment moves down
one node a step and stays on its frame or moves one frame on), in float32
torch operations, one row at a time (upstream
gcp/prediction/models/adaptive_binding/probabilistic_dtw.py).

With -C [B, r, c] as the log-potential of a cell (r depth-first nodes, c
frames, r >= c), the forward DP F runs down the rows from the top-left
cell and the backward DP Bk up the rows from each example's last frame:

    F[0, 0]      = -C[0, 0]
    F[i, j]      = -C[i, j] + max(logaddexp(F[i-1, j], F[i-1, j-1]), NEG_INF)
    Bk[r-1, end] = -C[r-1, end]
    Bk[i, j]     = -C[i, j] + max(logaddexp(Bk[i+1, j], Bk[i+1, j+1]), NEG_INF)
    z            = F[r-1, end]
    w            = exp(F + Bk + C - z), 0 where F or Bk holds no path

with F and Bk NEG_INF outside the matrix. Each row is one vector operation
over the frames. Departures from upstream, which runs this DP in float64
over -inf (probabilistic_dtw.py:92) on the anti-diagonals:

- float32, the configurations' precision;
- a finite NEG_INF = -1e30 in place of -inf, so that logaddexp of two
  empty cells stays NEG_INF and never becomes nan; a cell that no path
  reaches is set to 0 in w where F or Bk is at most NEG_INF / 2;
- row by row in place of anti-diagonals (the same cells, the same sums).

Nothing here is differentiated: the binding detaches its cost.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _rows(lp: torch.Tensor, first: torch.Tensor, step) -> list:
    """The DP over the rows of log-potentials lp [B, r, c] in the order
    `range(r)` or reversed: each row takes its predecessor row's cell and
    its neighbour `step` (+1 or -1 frames back); `first` [B, c] marks the
    one cell where the first row starts."""
    b, r, c = lp.shape
    neg = torch.full((b, 1), NEG_INF, dtype=lp.dtype, device=lp.device)
    order = range(r) if step == -1 else range(r - 1, -1, -1)
    prev = neg.expand(b, c)
    out = [None] * r
    for k, i in enumerate(order):
        if step == -1:  # (i - 1, j - 1): the predecessor shifted right
            neighbour = torch.cat([neg, prev[:, :-1]], 1)
        else:  # (i + 1, j + 1): shifted left
            neighbour = torch.cat([prev[:, 1:], neg], 1)
        row = lp[:, i] + torch.clamp(torch.logaddexp(prev, neighbour), min=NEG_INF)
        if k == 0:
            row = torch.where(first, lp[:, i], row)
        out[i] = prev = row
    return out


def soft_dtw(C: torch.Tensor, end_inds: torch.Tensor = None) -> torch.Tensor:
    """w [B, r, c] float32 for the cost C [B, r, c] (r >= c) and each
    example's last frame end_inds [B] (c - 1 when None)."""
    C = C.detach().to(torch.float32)
    b, r, c = C.shape
    if r < c:
        raise ValueError(f"soft_dtw needs at least as many nodes as frames, got {r} "
                         f"nodes for {c} frames")
    if end_inds is None:
        end_inds = torch.full((b,), c - 1)
    end = end_inds.to(device=C.device, dtype=torch.int64)
    lp = -C
    frames = torch.arange(c, device=C.device)
    f = torch.stack(_rows(lp, (frames == 0).expand(b, c), -1), 1)
    bk = torch.stack(_rows(lp, frames[None, :] == end[:, None], +1), 1)
    z = f[torch.arange(b, device=C.device), -1, end][:, None, None]
    w = torch.exp(torch.clamp(f + bk - lp - z, min=NEG_INF))
    unreached = (f <= NEG_INF / 2) | (bk <= NEG_INF / 2)
    return torch.where(unreached, torch.zeros_like(w), w)


def soft_dtw_stability_gap(w: torch.Tensor) -> torch.Tensor:
    """max over nodes of |w summed over frames - 1|: each node matches one
    frame, so the sums are 1 up to rounding (upstream asserts it in
    float64, probabilistic_dtw.py:118-120)."""
    return torch.max(torch.abs(w.sum(2) - 1.0))
