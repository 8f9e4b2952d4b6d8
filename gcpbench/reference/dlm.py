"""Discretized logistic mixture decoder output (models/dlm.py of the JAX
package): the parameter split, the per-pixel NLL, the mixture mean and the
ancestral sample. Raw layout on the last axis: [n_mix logits | n_mix*C
means | n_mix*C log_scales]. Pixels are in [-1, 1] with 256 bins."""
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


def sample_with(raw: torch.Tensor, idx: torch.Tensor, u: torch.Tensor,
                n_channels: int, n_mix: int = N_MIX) -> torch.Tensor:
    """The ancestral sample from given draws: `idx` [...] the mixture
    component of each pixel, `u` [..., C] uniforms in (0, 1) for the
    logistic noise; clipped to [-1, 1]."""
    _, means, log_scales = split_params(raw, n_channels, n_mix)
    sel = F.one_hot(idx.long(), n_mix).to(means.dtype)[..., None]
    mu = torch.sum(sel * means, -2)
    log_s = torch.sum(sel * log_scales, -2)
    x = mu + torch.exp(log_s) * (torch.log(u) - torch.log(1 - u))
    return torch.clamp(x, -1.0, 1.0)


def sample(raw: torch.Tensor, generator: torch.Generator, n_channels: int,
           n_mix: int = N_MIX) -> torch.Tensor:
    """Ancestral sample (JAX dlm.py:92): a mixture component per pixel from
    its logits, then logistic noise from uniforms in [1e-5, 1 - 1e-5]. The
    draws come from `generator`, so they are not JAX's."""
    logits = raw[..., :n_mix]
    idx = torch.multinomial(torch.softmax(logits.reshape(-1, n_mix).float(), -1), 1,
                            generator=generator).reshape(logits.shape[:-1])
    u = torch.rand(raw.shape[:-1] + (n_channels,), generator=generator,
                   device=raw.device, dtype=raw.dtype) * (1 - 2e-5) + 1e-5
    return sample_with(raw, idx, u, n_channels, n_mix)
