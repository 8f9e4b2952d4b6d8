"""The plain operations the reference uses where the program launches its own
kernels: GroupNorm + LeakyReLU as autograd over torch operations, and no
soft-DTW (no configuration of the benchmark uses the adaptive binding)."""
from __future__ import annotations

import torch


def fused_group_norm_lrelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           num_groups: int, eps: float = 1e-6,
                           slope: float = 0.2) -> torch.Tensor:
    """flax.linen.GroupNorm then LeakyReLU on NHWC x [..., H, W, C]:
    statistics in float32 (float64 for a float64 x), the variance
    E[x^2] - E[x]^2 clipped at 0, y = (x - mean) * rsqrt(var + eps) * scale
    + bias cast to x's dtype, then max(y, slope * y)."""
    h, w, c = x.shape[-3:]
    acc = torch.promote_types(x.dtype, torch.float32)
    xg = x.to(acc).reshape(-1, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = (y * scale.to(acc) + bias.to(acc)).to(x.dtype)
    return torch.where(y >= 0, y, slope * y)


def soft_dtw(*args, **kwargs):
    raise NotImplementedError("the reference holds no soft-DTW: no configuration "
                              "of the benchmark uses the adaptive binding")


soft_dtw_stability_gap = soft_dtw


def heartbeat() -> None:
    """The planner's watchdog touch: nothing to touch here."""
