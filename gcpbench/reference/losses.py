"""Loss records (core/losses.py of the JAX package; blox.torch.losses).

Every loss returns a `LossTerm` with a scalar `value`, a `weight` read by
`total_loss` (total = sum(weight * value) / prod(traj_seq.shape[1:]),
base_gcp.py:294-304), the per-element `error_mat` and an optional
`breakdown` along one axis for layerwise logging (tree_module.py:159-169).
`value` is the loss summed over all non-batch axes and averaged over the
batch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from .distributions import Gaussian

Scalar = Union[float, torch.Tensor]


@dataclass
class LossTerm:
    value: torch.Tensor
    weight: Scalar = 1.0
    breakdown: Optional[torch.Tensor] = None
    error_mat: Optional[torch.Tensor] = None


def _reduce(error_mat: torch.Tensor, weights: Scalar,
            breakdown_axis: Optional[int]):
    weighted = error_mat * weights
    batch = weighted.shape[0] if weighted.dim() > 0 else 1
    value = weighted.sum() / batch
    breakdown = None
    if breakdown_axis is not None and weighted.dim() > breakdown_axis:
        axes = tuple(i for i in range(weighted.dim()) if i != breakdown_axis)
        breakdown = weighted.sum(dim=axes) / batch
    return value, breakdown


def l2_loss(pred, target, weights: Scalar = 1.0, weight: Scalar = 1.0,
            breakdown: Optional[int] = None) -> LossTerm:
    error_mat = (pred - target) ** 2
    value, bd = _reduce(error_mat, weights, breakdown)
    return LossTerm(value, weight, bd, error_mat)


def kl_divergence_loss(q: Gaussian, p: Gaussian, weights: Scalar = 1.0,
                       weight: Scalar = 1.0, free_nats_per_dim: float = 0.0,
                       breakdown: Optional[int] = 1) -> LossTerm:
    """KL(q||p) with per-dimension free nats (blox KLDivLoss2): each latent
    dimension contributes at least `free_nats_per_dim`."""
    kl = q.kl_divergence(p)
    if free_nats_per_dim > 0.0:
        kl = torch.clamp(kl, min=free_nats_per_dim)
    value, bd = _reduce(kl, weights, breakdown)
    return LossTerm(value, weight, bd, kl)


def bce_logits_loss(logits, target, weights: Scalar = 1.0, weight: Scalar = 1.0,
                    breakdown: Optional[int] = None) -> LossTerm:
    """Binary cross-entropy with logits, max(x, 0) - x t + log(1 + e^-|x|)
    (existence predictor, frame_binding.py:84)."""
    error_mat = (torch.clamp(logits, min=0.0) - logits * target
                 + torch.log1p(torch.exp(-logits.abs())))
    value, bd = _reduce(error_mat, weights, breakdown)
    return LossTerm(value, weight, bd, error_mat)


def ce_logits_loss(logits, target_index, weights: Scalar = 1.0,
                   weight: Scalar = 1.0) -> LossTerm:
    """Softmax cross-entropy against integer targets (length predictor,
    auxilliary_models/misc.py:38-56)."""
    logprobs = F.log_softmax(logits, dim=-1)
    error_mat = -torch.gather(logprobs, -1, target_index.long()[..., None])[..., 0]
    value, bd = _reduce(error_mat, weights, None)
    return LossTerm(value, weight, bd, error_mat)


def penalty_loss(value, weight: Scalar = 1.0, breakdown: Optional[int] = None,
                 reduction: Optional[Sequence[int]] = None) -> LossTerm:
    """Penalty on a precomputed quantity (blox PenaltyLoss; entropy penalty,
    tree_module.py:128). `reduction` sums those axes first."""
    error_mat = value
    if reduction is not None:
        value = value.sum(dim=tuple(reduction))
    bd = None
    if breakdown is not None and error_mat.dim() > breakdown:
        axes = tuple(i for i in range(error_mat.dim()) if i != breakdown)
        bd = error_mat.sum(dim=axes) / error_mat.shape[0]
    batch = value.shape[0] if value.dim() > 0 else 1
    return LossTerm(value.sum() / batch, weight, bd, error_mat)


def gaussian_nll_loss(pred, target, log_sigma: Scalar, weights: Scalar = 1.0,
                      weight: Scalar = 1.0,
                      breakdown: Optional[int] = 1) -> LossTerm:
    """Gaussian decoder NLL with a global (learned) log_sigma
    (BalancedBinding.reconstruction_loss, frame_binding.py:97)."""
    error_mat = (0.5 * ((pred - target) * torch.exp(-log_sigma)) ** 2
                 + log_sigma + 0.5 * math.log(2 * math.pi))
    value, bd = _reduce(error_mat, weights, breakdown)
    return LossTerm(value, weight, bd, error_mat)


def total_loss(losses, per_example_numel: int):
    """Weighted sum over the terms, divided by the per-example element count.
    A term whose weight is a Python number <= 0 is log-only and skipped."""
    total = 0.0
    for term in losses.values():
        w = term.weight
        if isinstance(w, (int, float)) and w <= 0:
            continue
        total = total + term.value * w
    return total / per_example_numel
