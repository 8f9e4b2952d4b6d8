"""Batched pairwise squared-L2 distances (ops/cdist.py of the JAX package).

Cost matrices of the adaptive binding and the all-pairs Gaussian likelihood
of its reconstruction loss. Instead of the [B, N, T, F] difference tensor,
||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b, so the dominant cost is one batched
matrix product. It runs in full float32 (float64 for float64 inputs):
`load.set_float32_precision` turns TF32 off on the card, as the JAX package
asks for Precision.HIGHEST.
"""
from __future__ import annotations

import torch


def batch_cdist(a: torch.Tensor, b: torch.Tensor,
                reduction: str = "sum") -> torch.Tensor:
    """Squared L2 distances between all pairs along axis 1.

    :param a: [B, N, ...features]
    :param b: [B, T, ...features]
    :param reduction: 'sum' or 'mean' over the feature dims.
    :return: [B, N, T] float32, or float64 for a float64 input
    """
    if reduction not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {reduction!r}")
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    af = a.reshape(a.shape[:2] + (-1,)).to(acc)
    bf = b.reshape(b.shape[:2] + (-1,)).to(acc)
    sq_a = (af * af).sum(-1)[:, :, None]
    sq_b = (bf * bf).sum(-1)[:, None, :]
    d = torch.clamp(sq_a + sq_b - 2.0 * torch.bmm(af, bf.transpose(1, 2)), min=0.0)
    if reduction == "mean":
        d = d / af.shape[-1]
    return d


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unbatched pairwise squared L2: [N, F] x [M, F] -> [N, M]."""
    return batch_cdist(a[None], b[None])[0]
