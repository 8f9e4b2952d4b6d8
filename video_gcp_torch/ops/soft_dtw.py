"""Probabilistic soft-DTW: expected node-frame match frequencies
(ops/soft_dtw.py of the JAX package), with kernel K3 for its DP.

Given a cost matrix C [B, r, c] (depth-first nodes x frames), `soft_dtw`
returns w[b, n, t], the posterior probability that node n explains frame t
under a monotone alignment where every node matches exactly one frame
('nohor' transitions). The log-space DP

    D[i, j] = C[i, j] + max(logaddexp(D[i-1, j], D[i-1, j-1]), NEG_INF)

runs over anti-diagonals d = i + j, from the source cell D[0, begin] =
C[0, begin]. The forward pass runs on -C from column 0, the backward pass
on the doubly flipped -C from column c - end - 1; both go in one call as
2B rows, and w is formed from the two accumulated matrices.

K3 replaces the Pallas TPU kernel `video_gcp_tpu/ops/pallas_dtw.py:_gak_kernel`
(its pallas_call in `gak_pallas`, reached through `soft_dtw_pallas`). It is
CUDA C++ in `video_gcp_torch/csrc/soft_dtw.cu`, built with nvcc at first use
and bound with ctypes. On a CUDA tensor `gak` launches it or raises; on a CPU
tensor it runs the plain twin `gak_reference`, which mirrors the XLA scan
`_gak_scan`. Everything is float32; `NEG_INF` is a finite -1e30, so
logaddexp(NEG_INF, NEG_INF) stays NEG_INF and never becomes nan.

K3's bound: 2 * rows * r * c * 4 bytes (read C once, write D once): 3.25 MB,
0.97 us at 3.35 TB/s, at the 9-room training shape [32, 127, 100]. The DP
is a chain of r + c - 1 dependent steps, so the kernel is latency-bound far
above that (see the source for the design).

No gradient flows through the DP: `soft_dtw` detaches its input on both
devices, as the JAX package stops the gradient.
"""
from __future__ import annotations

import ctypes

import torch

from video_gcp_torch.ops import cuda_build

SOURCE = "soft_dtw.cu"
NEG_INF = -1e30  # finite stand-in for -inf
MAX_FRAMES = 2457  # three diagonals and two staged ones in 48 KB (csrc)

LAUNCHES = 0  # K3 launches since import (or since a caller reset it)

_lib = None


def gak_reference(comb: torch.Tensor, begin: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K3: the 'nohor' log-space DP of every row of
    comb [rows, r, c] from its source cell (0, begin[row]), as a loop over
    the r + c - 1 anti-diagonals of [rows, c] (`_gak_scan` of the JAX
    package). Returns the accumulated values [rows, r, c]."""
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


def load_library():
    """Build (at first use) and bind K3's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_build.build(SOURCE)))
        lib.soft_dtw_gak_f32.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.soft_dtw_gak_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def gak(comb: torch.Tensor, begin: torch.Tensor) -> torch.Tensor:
    """K3 on a CUDA tensor, its twin on a CPU tensor: the DP of every row of
    comb [rows, r, c] float32 from (0, begin[row]); begin [rows] int32."""
    global LAUNCHES
    if comb.device.type == "cpu":
        return gak_reference(comb, begin)
    if comb.device.type != "cuda":
        raise ValueError(f"soft_dtw: no kernel for {comb.device}")
    if comb.dtype != torch.float32 or comb.dim() != 3 or not comb.is_contiguous():
        raise ValueError(f"soft_dtw: need contiguous float32 [rows, r, c], got "
                         f"{comb.dtype} {tuple(comb.shape)}")
    rows, r, c = comb.shape
    if not 0 < c <= MAX_FRAMES:
        raise ValueError(f"soft_dtw: {c} frames, the kernel takes 1..{MAX_FRAMES}")
    if (begin.shape != (rows,) or begin.dtype != torch.int32
            or begin.device != comb.device):
        raise ValueError(f"soft_dtw: begin must be int32 [{rows}] on {comb.device}")
    lib = load_library()
    out = torch.empty_like(comb)
    with torch.cuda.device(comb.device):
        err = lib.soft_dtw_gak_f32(comb.data_ptr(), begin.data_ptr(), out.data_ptr(),
                                   rows, r, c,
                                   torch.cuda.current_stream(comb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft_dtw_gak launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def dp_rows(C: torch.Tensor, end_inds: torch.Tensor):
    """The 2B rows of the DP for C [B, r, c] float32 and ends [B] int64: the
    forward rows -C from column 0, and the backward rows, -C flipped in both
    axes, from column c - end - 1 (probabilistic_dtw.py:103-107). Returns
    (comb [2B, r, c], begin [2B] int32)."""
    neg_c = -C
    comb = torch.cat([neg_c, torch.flip(neg_c, (-1, -2))], 0).contiguous()
    begin = torch.cat([torch.zeros_like(end_inds), C.shape[2] - end_inds - 1])
    return comb, begin.to(torch.int32)


def posterior(accum: torch.Tensor, comb: torch.Tensor,
              end_inds: torch.Tensor) -> torch.Tensor:
    """w from the DP's accumulated values of `dp_rows`: exp(forward +
    backward + C - z), zero outside the alignment region."""
    b = end_inds.shape[0]
    forward = accum[:b]
    backward = torch.flip(accum[b:], (-1, -2))
    # partition function: the forward value at (r - 1, end)
    z = torch.gather(forward[:, -1, :], 1, end_inds[:, None])[:, :, None]
    w = torch.exp(torch.clamp(forward + backward - comb[:b] - z, min=NEG_INF))
    outside = (forward <= NEG_INF / 2) | (backward <= NEG_INF / 2)
    return torch.where(outside, torch.zeros_like(w), w)


def soft_dtw(C: torch.Tensor, end_inds: torch.Tensor = None) -> torch.Tensor:
    """Expected edge frequencies of the monotone alignment posterior.

    :param C: [B, r, c] cost matrix (df nodes x frames), r >= c. Detached
        and cast to float32 here: no gradient flows through the DP.
    :param end_inds: [B] last valid frame per example (later frames get no
        mass); defaults to c - 1.
    :return: [B, r, c] float32 w with w[b].sum(axis=1) ~= 1 per node.
    """
    C = C.detach().to(torch.float32)
    b, r, c = C.shape
    if r < c:
        raise ValueError(f"soft_dtw needs at least as many nodes as frames "
                         f"('nohor' transitions), got {r} nodes for {c} frames")
    if end_inds is None:
        end_inds = torch.full((b,), c - 1, device=C.device)
    end_inds = end_inds.to(device=C.device, dtype=torch.int64)
    comb, begin = dp_rows(C, end_inds)
    return posterior(gak(comb, begin), comb, end_inds)


def soft_dtw_stability_gap(w: torch.Tensor) -> torch.Tensor:
    """max |w.sum(over frames) - 1| over nodes: the f32 drift of the
    forward-backward marginals (probabilistic_dtw.py:118-120)."""
    return torch.max(torch.abs(w.sum(2) - 1.0))
