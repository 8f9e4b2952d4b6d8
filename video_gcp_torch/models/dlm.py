"""Discretized logistic mixture decoder output (models/dlm.py of the JAX
package): the parameter split, the per-pixel NLL and the mixture mean. Raw
layout on the last axis: [n_mix logits | n_mix*C means | n_mix*C log_scales].
Pixels are in [-1, 1] with 256 bins."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

N_MIX = 10


def n_dlm_channels(n_channels: int, n_mix: int = N_MIX) -> int:
    return n_mix * (1 + 2 * n_channels)


def split_params(raw: torch.Tensor, n_channels: int, n_mix: int = N_MIX
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """raw [..., n_mix*(1+2C)] -> (logits [..., M], means [..., M, C],
    log_scales [..., M, C])."""
    shape = raw.shape[:-1] + (n_mix, n_channels)
    logits = raw[..., :n_mix]
    means = torch.tanh(raw[..., n_mix:n_mix + n_mix * n_channels].reshape(shape))
    log_scales = torch.clamp(
        raw[..., n_mix + n_mix * n_channels:].reshape(shape), -7.0, 3.0)
    return logits, means, log_scales


def mean(raw: torch.Tensor, n_channels: int, n_mix: int = N_MIX) -> torch.Tensor:
    """Mixture mean: the deterministic decode for planning and logging."""
    logits, means, _ = split_params(raw, n_channels, n_mix)
    return torch.sum(torch.softmax(logits, -1)[..., None] * means, dim=-2)


def nll(raw: torch.Tensor, target: torch.Tensor, n_mix: int = N_MIX) -> torch.Tensor:
    """Per-pixel negative log-likelihood: raw [..., H, W, n_mix*(1+2C)],
    target [..., H, W, C] -> [..., H, W], summed over channels. The edge bins
    (|x| > 0.999) integrate the tails; a bin whose mass is at most 1e-5 takes
    the mid-bin density instead (the reference's numerical floor)."""
    c = target.shape[-1]
    logits, means, log_scales = split_params(raw, c, n_mix)
    x = target[..., None, :]  # [..., 1, C] against [..., M, C]
    inv_s = torch.exp(-log_scales)
    half_bin = 1.0 / 255.0
    plus = inv_s * (x - means + half_bin)
    minus = inv_s * (x - means - half_bin)
    log_cdf_plus = plus - F.softplus(plus)  # log sigmoid(plus)
    log_one_minus_cdf_minus = -F.softplus(minus)
    cdf_delta = torch.sigmoid(plus) - torch.sigmoid(minus)
    mid = inv_s * (x - means)
    log_pdf_mid = mid - log_scales - 2.0 * F.softplus(mid)
    log_prob_bin = torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_minus,
                    torch.where(cdf_delta > 1e-5,
                                torch.log(torch.clamp(cdf_delta, min=1e-12)),
                                log_pdf_mid - math.log(127.5))))
    log_probs = log_prob_bin.sum(-1) + F.log_softmax(logits, -1)
    return -torch.logsumexp(log_probs, dim=-1)
