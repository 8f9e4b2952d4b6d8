"""Probabilistic soft-DTW: expected node-frame match frequencies
(ops/soft_dtw.py of the JAX package), computed whole by kernel K3.

Given a cost matrix C [B, r, c] (depth-first nodes x frames), `soft_dtw`
returns w[b, n, t], the posterior probability that node n explains frame t
under a monotone alignment where every node matches exactly one frame
('nohor' transitions). With -C as the log-potential of a cell:

    F[0, 0]       = -C[0, 0]
    F[i, j]       = -C[i, j] + max(logaddexp(F[i-1, j], F[i-1, j-1]), NEG_INF)
    Bk[r-1, end]  = -C[r-1, end]
    Bk[i, j]      = -C[i, j] + max(logaddexp(Bk[i+1, j], Bk[i+1, j+1]), NEG_INF)
    z             = F[r-1, end]
    w             = exp(max(F + Bk - (-C) - z, NEG_INF)), 0 where F or Bk <= NEG_INF/2

with F and Bk = NEG_INF outside the matrix. Row i of F needs only row i - 1,
and row i of Bk only row i + 1: each DP is a chain of r dependent rows.

K3 replaces the Pallas TPU kernel `video_gcp_tpu/ops/pallas_dtw.py:_gak_kernel`
(its pallas_call in `gak_pallas`, reached through `soft_dtw_pallas`) and the
torch around it: one launch computes F, Bk and w (`soft_dtw_pallas` whole).
It is CUDA C++ in `video_gcp_torch/csrc/soft_dtw.cu`, built, bound and
launched through `ops/cuda_build.py`; `launch_plan` chooses its launch shape. On a
CUDA tensor `soft_dtw` launches it or raises; on a CPU tensor it runs the
plain twin `soft_dtw_rows_reference`, which walks the rows as the kernel
does. Each cell gets the same float32 operations on the same operands as in
`gak_reference`, the mirror of the JAX package's anti-diagonal scan
`_gak_scan` (forward rows on -C and backward rows on -C flipped in both axes,
as `dp_rows` lays them out), kept for the parity tests. `NEG_INF` is a
finite -1e30, so logaddexp(NEG_INF, NEG_INF) stays NEG_INF and never becomes
nan.

K3's bound: 2 * B * r * c * 4 bytes (read C once, write w once): 1.63 MB,
0.485 us at 3.35 TB/s, at the 9-room training shape [16, 127, 100]. The
chain of r dependent rows keeps it far above that (see the source).

No gradient flows through the DP: `soft_dtw` detaches its input on both
devices, as the JAX package stops the gradient.
"""
from __future__ import annotations

import functools
from ctypes import c_int, c_void_p
from dataclasses import dataclass

import torch

from video_gcp_torch.ops import cuda_build

SOURCE = "soft_dtw.cu"
NEG_INF = -1e30  # finite stand-in for -inf
MAX_FRAMES = 2457  # the frames (c) the kernel takes

# Launch plan limits and targets (H100 SXM; the csrc constants in brackets)
HEADER_BYTES = 1024  # mbarriers and edge exchange (kHeaderBytes)
MAX_CHUNKS = 64  # C chunks resident in shared memory, one mbarrier each (kMaxBars)
MAX_SLOTS = 4  # C chunks a chain's ring holds when C streams (kMaxSlots)
CHUNK_BYTES = 4096  # bytes of C one copy brings, at least 4 rows
COLS_PER_LANE = (4, 8, 12)  # V: instances in the csrc, the first that fits
MAX_CHAIN_WARPS = 7  # warps a DP chain may span (kMaxChainWarps)
THREADS = 512  # a block: the producer warp, two chains, and the rest join the epilogue

ENTRY_POINTS = {  # the arguments before the stream
    "soft_dtw_f32": (c_void_p,) * 4 + (c_int,) * 3 + (c_void_p,),  # C, ends, w, dp; b, r, c; plan
    "soft_dtw_log1p_mismatches": (c_void_p,),  # the count
}


@dataclass(frozen=True)
class LaunchPlan:
    """How K3 covers one [r, c] matrix per block of THREADS threads: each
    DP chain is `warps` warps with `cols` columns a lane. `resident`: C, F
    and Bk all live in shared memory, C copied in `chunks` chunks of `rows`
    rows; else each chain streams C through a ring of `slots` chunks and F,
    Bk go to a device-memory scratch. `vec`: C's copies are bulk (TMA)
    copies and the epilogue moves 16 bytes a thread; `smem` bytes of
    dynamic shared memory."""
    cols: int
    warps: int
    resident: int
    rows: int
    chunks: int
    slots: int
    vec: int
    smem: int


@functools.lru_cache(maxsize=None)
def launch_plan(r: int, c: int, aligned: bool = True) -> LaunchPlan:
    """The launch shape of K3 for [B, r, c] float32 inputs; `aligned` says
    the tensors' addresses are 16-byte aligned. Raises ValueError outside
    1 <= c <= MAX_FRAMES, r >= c."""
    if not 0 < c <= MAX_FRAMES or r < c:
        raise ValueError(f"soft_dtw: {r} nodes x {c} frames; the kernel takes "
                         f"1..{MAX_FRAMES} frames and at least as many nodes")
    cols = next(v for v in COLS_PER_LANE if -(-c // (32 * v)) <= MAX_CHAIN_WARPS)
    warps = -(-c // (32 * cols))
    vec = int(aligned and r * c % 4 == 0)
    rows = min(4 * max(1, CHUNK_BYTES // (16 * c)), -(-r // 4) * 4)
    chunks = -(-r // rows)
    cells = -(-r * c // 4) * 4  # each array starts 16-byte aligned
    smem = HEADER_BYTES + 3 * cells * 4
    if smem <= cuda_build.SMEM_LIMIT and chunks <= MAX_CHUNKS:
        return LaunchPlan(cols, warps, 1, rows, chunks, 0, vec, smem)
    ring = 2 * rows * c * 4  # one chunk for each chain
    slots = min(MAX_SLOTS, (cuda_build.SMEM_LIMIT - HEADER_BYTES) // ring)
    if slots < 1:
        raise ValueError(f"soft_dtw: {c} frames need {ring} bytes of shared memory")
    return LaunchPlan(cols, warps, 0, rows, chunks, slots, vec, HEADER_BYTES + slots * ring)


def gak_reference(comb: torch.Tensor, begin: torch.Tensor) -> torch.Tensor:
    """The JAX package's anti-diagonal form of the DP (`_gak_scan`): the
    'nohor' log-space DP of every row of comb [rows, r, c] from its source
    cell (0, begin[row]), as a loop over the r + c - 1 anti-diagonals of
    [rows, c]. Returns the accumulated values [rows, r, c]."""
    rows, r, c = comb.shape
    dev = comb.device
    n_diag = r + c - 1
    d_idx = torch.arange(n_diag, device=dev)[:, None]
    j_idx = torch.arange(c, device=dev)[None, :]
    valid = (j_idx <= d_idx) & (d_idx - j_idx <= r - 1)  # [n_diag, c]
    c_diag = comb[:, torch.clamp(d_idx - j_idx, 0, r - 1), j_idx]  # [rows, D, c]
    begin = begin.to(device=dev, dtype=torch.int64)[:, None]
    is_begin = j_idx == begin  # [rows, c]
    neg = torch.full((rows, 1), NEG_INF, device=dev, dtype=comb.dtype)
    prev1 = prev2 = neg.expand(rows, c)
    diagonals = []
    for d in range(n_diag):
        c_row = c_diag[:, d]
        pred_step = torch.cat([neg, prev2[:, :-1]], 1)  # (i-1, j-1) on d-2
        acc = torch.logaddexp(prev1, pred_step)  # with (i-1, j) on d-1
        new = c_row + torch.clamp(acc, min=NEG_INF)
        new = torch.where(is_begin & (begin == d), c_row, new)
        new = torch.where(valid[d], new, neg)
        diagonals.append(new)
        prev1, prev2 = new, prev1
    diag = torch.stack(diagonals, 1)  # [rows, D, c]
    i_idx = torch.arange(r, device=dev)[:, None]
    return diag[:, i_idx + j_idx, j_idx]


def dp_rows(C: torch.Tensor, end_inds: torch.Tensor):
    """`gak_reference`'s 2B rows for C [B, r, c] and ends [B]: the forward
    rows -C from column 0, and the backward rows, -C flipped in both axes,
    from column c - end - 1 (probabilistic_dtw.py:103-107). Returns
    (comb [2B, r, c], begin [2B] int32)."""
    neg_c = -C
    comb = torch.cat([neg_c, torch.flip(neg_c, (-1, -2))], 0).contiguous()
    begin = torch.cat([torch.zeros_like(end_inds), C.shape[2] - end_inds - 1])
    return comb, begin.to(torch.int32)


def soft_dtw_rows_reference(C: torch.Tensor, end_inds: torch.Tensor,
                            return_dp: bool = False):
    """Plain PyTorch twin of K3, in the kernel's order: F top-down and Bk
    bottom-up over the rows of -C, then w (module docstring). C [B, r, c]
    float32, end_inds [B] int64. Returns w, or (w, F, Bk)."""
    b, r, c = C.shape
    neg_c = -C
    neg = torch.full((b, 1), NEG_INF, device=C.device, dtype=C.dtype)
    cols = torch.arange(c, device=C.device)
    forward, backward = [], [None] * r
    prev = neg.expand(b, c)
    for i in range(r):
        acc = torch.logaddexp(prev, torch.cat([neg, prev[:, :-1]], 1))
        row = neg_c[:, i] + torch.clamp(acc, min=NEG_INF)
        if i == 0:
            row = torch.where(cols == 0, neg_c[:, 0], row)
        forward.append(row)
        prev = row
    prev = neg.expand(b, c)
    is_end = cols == end_inds[:, None]
    for i in range(r - 1, -1, -1):
        acc = torch.logaddexp(prev, torch.cat([prev[:, 1:], neg], 1))
        row = neg_c[:, i] + torch.clamp(acc, min=NEG_INF)
        if i == r - 1:
            row = torch.where(is_end, neg_c[:, i], row)
        backward[i] = row
        prev = row
    f, bk = torch.stack(forward, 1), torch.stack(backward, 1)
    z = torch.gather(f[:, -1, :], 1, end_inds[:, None])[:, :, None]
    w = torch.exp(torch.clamp(f + bk - neg_c - z, min=NEG_INF))
    w = torch.where((f <= NEG_INF / 2) | (bk <= NEG_INF / 2), torch.zeros_like(w), w)
    return (w, f, bk) if return_dp else w


def log1p_mismatches(device) -> int:
    """The floats u in [0, 1] where K3's branch-free log1p differs from the
    CUDA library's log1pf, counted on `device` (0 keeps K3's DP values
    those of the library's logaddexp, bit for bit)."""
    count = torch.zeros(1, dtype=torch.int32, device=device)
    cuda_build.launch(SOURCE, ENTRY_POINTS, "soft_dtw_log1p_mismatches", count,
                      count.data_ptr())
    return int(count.item())


def k3(C: torch.Tensor, end_inds: torch.Tensor, return_dp: bool = False):
    """K3 on a CUDA tensor, its twin on a CPU tensor: w for C [B, r, c]
    float32 and end_inds [B] int64, or (w, F, Bk) with `return_dp`; each
    launch counts under `tracing.COUNTS["k3.launches"]`."""
    if not cuda_build.takes_kernel(C, "soft_dtw"):
        return soft_dtw_rows_reference(C, end_inds, return_dp)
    if C.dtype != torch.float32 or C.dim() != 3 or not C.is_contiguous():
        raise ValueError(f"soft_dtw: need contiguous float32 [B, r, c], got "
                         f"{C.dtype} {tuple(C.shape)}")
    b, r, c = C.shape
    if (end_inds.shape != (b,) or end_inds.dtype != torch.int64
            or end_inds.device != C.device):
        raise ValueError(f"soft_dtw: end_inds must be int64 [{b}] on {C.device}, got "
                         f"{end_inds.dtype} {tuple(end_inds.shape)} on {end_inds.device}")
    plan = launch_plan(r, c, C.data_ptr() % 16 == 0)
    w = torch.empty_like(C)
    # F and Bk: device memory when C streams or the caller asks for them
    dp = (torch.empty((b, 2, r, c), dtype=torch.float32, device=C.device)
          if return_dp or not plan.resident else None)
    if b:
        cuda_build.launch(SOURCE, ENTRY_POINTS, "soft_dtw_f32", C, C.data_ptr(),
                          end_inds.data_ptr(), w.data_ptr(),
                          None if dp is None else dp.data_ptr(), b, r, c,
                          cuda_build.c_plan(plan), counter="k3.launches")
    return (w, dp[:, 0], dp[:, 1]) if return_dp else w


def soft_dtw(C: torch.Tensor, end_inds: torch.Tensor = None) -> torch.Tensor:
    """Expected edge frequencies of the monotone alignment posterior.

    :param C: [B, r, c] cost matrix (df nodes x frames), r >= c. Detached
        and cast to float32 here: no gradient flows through the DP.
    :param end_inds: [B] last valid frame per example (later frames get no
        mass); defaults to c - 1.
    :return: [B, r, c] float32 w with w[b].sum(axis=1) ~= 1 per node.
    """
    C = C.detach().to(torch.float32).contiguous()
    b, r, c = C.shape
    if r < c:
        raise ValueError(f"soft_dtw needs at least as many nodes as frames "
                         f"('nohor' transitions), got {r} nodes for {c} frames")
    if end_inds is None:
        end_inds = torch.full((b,), c - 1, device=C.device)
    return k3(C, end_inds.to(device=C.device, dtype=torch.int64))


def soft_dtw_stability_gap(w: torch.Tensor) -> torch.Tensor:
    """max |w.sum(over frames) - 1| over nodes: the f32 drift of the
    forward-backward marginals (probabilistic_dtw.py:118-120)."""
    return torch.max(torch.abs(w.sum(2) - 1.0))
