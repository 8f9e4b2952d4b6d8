"""Image quality metrics (core/metrics.py of the JAX package): MSE, PSNR and
SSIM over NHWC images in [-1, 1] with any leading axes, batched on the
device."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from video_gcp_torch.ops.tree_index import device_table


def _to01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def to_float_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]; floats pass through unchanged."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 127.5 - 1.0
    return x


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image mean squared error in the [0, 1] range: reduces the trailing
    (H, W, C) axes and keeps the leading ones."""
    return ((_to01(pred) - _to01(target)) ** 2).mean(dim=(-1, -2, -3))


def psnr(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Peak signal-to-noise ratio, peak 1.0 after the [0, 1] mapping."""
    return -10.0 * torch.log10(mse(pred, target) + eps)


def _gaussian_window(size: int, sigma: float, dtype: torch.dtype) -> torch.Tensor:
    """The [size, size] window on the host, computed in float32."""
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g).to(dtype)


def ssim(pred: torch.Tensor, target: torch.Tensor, kernel_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity (Wang et al., 11x11 Gaussian window, 'VALID'),
    per image over the trailing (H, W, C) axes: [..., H, W, C] -> [...].

    The window is a depthwise F.conv2d. Its precision matters: the variance
    terms E[x^2] - E[x]^2 cancel, so the JAX package runs this conv at
    Precision.HIGHEST. On the card it must be full float32 with TF32 off,
    which `load.set_float32_precision()` sets (load_model, the trainer and
    the Evaluator call it)."""
    p, t = _to01(pred), _to01(target)
    lead = p.shape[:-3]
    h, w, c = p.shape[-3:]
    p = p.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    t = t.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    window = device_table(_gaussian_window, p.device, kernel_size, sigma, p.dtype)
    window = window.expand(c, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(x, window, groups=c)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_p, mu_t = filt(p), filt(t)
    var_p = filt(p * p) - mu_p ** 2
    var_t = filt(t * t) - mu_t ** 2
    cov = filt(p * t) - mu_p * mu_t
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    return ssim_map.mean(dim=(1, 2, 3)).reshape(lead)
