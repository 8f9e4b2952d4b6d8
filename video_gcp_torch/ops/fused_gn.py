"""Fused GroupNorm + LeakyReLU for the conv pyramids: forward kernel K1 and
backward kernel K2, wired as one `torch.autograd.Function`.

K1 replaces the Pallas TPU kernel `video_gcp_tpu/ops/fused_gn.py:_gn_lrelu_kernel`
(its pallas_call in `_gn_lrelu_pallas`), K2 replaces `_gn_lrelu_bwd_kernel`
(its pallas_call in `_gn_lrelu_bwd_pallas`). Both are CUDA C++ in
`video_gcp_torch/csrc/fused_gn.cu`, built with nvcc at first use and bound
with ctypes.

Numerics follow flax.linen.GroupNorm: float32 statistics with the fast
variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6 (not torch's 1e-5),
y = (x - mean) * rsqrt(var + eps) * scale + bias, cast to the storage type,
then LeakyReLU(0.2).

K1's bound: memory, 2 * N*H*W*C * sizeof(dtype) bytes (read x once, write y once).
At 3.35 TB/s that is 0.50 ms for the CEM batch's top decoder level
[12700, 32, 32, 16] in f32 and 1.28 ms for the largest shape of the repo,
[16352, 64, 64, 16] in bf16. The kernel runs one thread block per sample:
a coalesced statistics pass, then a normalize pass that re-reads the sample
mostly from L2 (see the source for the design). K2's bound: memory,
3 * N*H*W*C * sizeof(dtype) bytes (read x and dy once, write dx once); it
recomputes the statistics from x instead of keeping them from the forward.

Layout: activations are NHWC, as in the JAX package. The conv layers see the
same memory as an NCHW tensor in `torch.channels_last`, so no copy is made
around the norm. On a CUDA tensor the wrappers launch the kernels or raise;
on a CPU tensor they compute the plain twins `gn_lrelu_reference` and
`gn_lrelu_bwd_reference`. The gradient that reaches the norm comes from the
next conv's cuDNN dgrad or from a `torch.cat` (decoder skips), whose layouts
are not guaranteed: the backward copies a dy that is not NHWC-contiguous and
counts the copy in `BWD_DY_COPIES` (2 per step of the 9-room training run
on an H100; PERF.md).
"""
from __future__ import annotations

import ctypes

import torch

from video_gcp_torch.ops import cuda_build

SOURCE = "fused_gn.cu"
MAX_GROUPS = 8  # per-group statistics live in registers (csrc kMaxGroups)
MAX_BWD_CHANNELS = 256  # K2: one thread per channel (csrc kMaxChannels)

LAUNCHES = 0  # K1 launches since import (or since a caller reset it)
BWD_LAUNCHES = 0  # K2 launches
BWD_DY_COPIES = 0  # dy copied to NHWC-contiguous before a K2 launch

_lib = None


def gn_lrelu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       num_groups: int, eps: float = 1e-6,
                       slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, on x [..., H, W, C]; mirrors
    `video_gcp_tpu/ops/fused_gn.py:gn_lrelu_reference`. Statistics are
    float32, or float64 for a float64 x."""
    shape = x.shape
    h, w, c = shape[-3:]
    gs = c // num_groups
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc).reshape(-1, h, w, num_groups, gs)
    mean = xf.mean(dim=(1, 2, 4))  # [N, G]
    var = torch.clamp((xf * xf).mean(dim=(1, 2, 4)) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mean = mean.repeat_interleave(gs, dim=-1).reshape(-1, 1, 1, c)
    rstd = rstd.repeat_interleave(gs, dim=-1).reshape(-1, 1, 1, c)
    y = (xf.reshape(-1, h, w, c) - mean) * rstd * scale.to(acc) + bias.to(acc)
    y = y.to(x.dtype)
    y = torch.where(y >= 0, y, slope * y)
    return y.reshape(shape)


def gn_lrelu_bwd_reference(x: torch.Tensor, dy: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           num_groups: int, eps: float = 1e-6,
                           slope: float = 0.2):
    """Plain PyTorch twin of K2: the GroupNorm + LeakyReLU backward written
    out (not autograd), as `_gn_lrelu_bwd_kernel` computes it. Recomputes the
    statistics from x; the activation's sign is taken from the float32
    pre-activation. Returns (dx in x's dtype, dscale, dbias in the params'
    dtypes)."""
    shape = x.shape
    h, w, c = shape[-3:]
    gs = c // num_groups
    m = h * w * gs
    acc = torch.promote_types(x.dtype, torch.float32)
    xg = x.to(acc).reshape(-1, h, w, num_groups, gs)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(1, 2, 4), keepdim=True) - mean * mean,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    sc = scale.to(acc).reshape(num_groups, gs)
    xhat = (xg - mean) * rstd
    y_pre = xhat * sc + bias.to(acc).reshape(num_groups, gs)
    g = dy.to(acc).reshape(xg.shape)
    dyp = torch.where(y_pre >= 0, g, slope * g)
    dxhat = dyp * sc
    s1 = dxhat.sum(dim=(1, 2, 4), keepdim=True)
    s2 = (dxhat * xhat).sum(dim=(1, 2, 4), keepdim=True)
    dx = rstd * (dxhat - s1 / m - xhat * (s2 / m))
    dscale = (dyp * xhat).sum(dim=(0, 1, 2)).reshape(c)
    dbias = dyp.sum(dim=(0, 1, 2)).reshape(c)
    return (dx.reshape(shape).to(x.dtype), dscale.to(scale.dtype),
            dbias.to(bias.dtype))


def load_library():
    """Build (at first use) and bind the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_build.build(SOURCE)))
        for fn in (lib.gn_lrelu_fwd_f32, lib.gn_lrelu_fwd_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.gn_lrelu_bwd_f32, lib.gn_lrelu_bwd_bf16):
            fn.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           num_groups: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_group_norm_lrelu: dtype {x.dtype} not supported")
    if x.dim() < 4:
        raise ValueError(f"fused_group_norm_lrelu: need [..., H, W, C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_group_norm_lrelu: x must be NHWC-contiguous "
                         "(a channels_last conv output permuted to NHWC)")
    c = x.shape[-1]
    if not 0 < num_groups <= MAX_GROUPS or c % num_groups:
        raise ValueError(f"fused_group_norm_lrelu: {num_groups} groups for {c} channels")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.device != x.device:
            raise ValueError(f"fused_group_norm_lrelu: {name} must be [{c}] on {x.device}")


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_group_norm_lrelu: no kernel for {x.device}")
    return x.device.type


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def gn_lrelu_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 num_groups: int, eps: float = 1e-6,
                 slope: float = 0.2) -> torch.Tensor:
    """K1 on a CUDA tensor, its twin on a CPU tensor; no autograd."""
    global LAUNCHES
    if _device(x) == "cpu":
        return gn_lrelu_reference(x, scale, bias, num_groups, eps, slope)
    _check(x, scale, bias, num_groups)
    lib = load_library()
    h, w, c = x.shape[-3:]
    per_sample = h * w * c
    n = x.numel() // per_sample
    y = torch.empty_like(x)
    scale32 = scale.detach().to(torch.float32).contiguous()
    bias32 = bias.detach().to(torch.float32).contiguous()
    fn = lib.gn_lrelu_fwd_f32 if x.dtype == torch.float32 else lib.gn_lrelu_fwd_bf16
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(),
                 y.data_ptr(), n, per_sample, c, num_groups, eps, slope,
                 _stream(x))
    if err != 0:
        raise RuntimeError(f"gn_lrelu_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def gn_lrelu_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, num_groups: int, eps: float = 1e-6,
                 slope: float = 0.2):
    """K2 on CUDA tensors, its twin on CPU tensors: (dx, dscale, dbias)."""
    global BWD_LAUNCHES, BWD_DY_COPIES
    if _device(x) == "cpu":
        return gn_lrelu_bwd_reference(x, dy, scale, bias, num_groups, eps, slope)
    _check(x, scale, bias, num_groups)
    c = x.shape[-1]
    if c > MAX_BWD_CHANNELS:
        raise ValueError(f"gn_lrelu_bwd: {c} channels, the kernel takes at most "
                         f"{MAX_BWD_CHANNELS}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"gn_lrelu_bwd: dy {tuple(dy.shape)} {dy.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        BWD_DY_COPIES += 1
    lib = load_library()
    h, w = x.shape[-3:-1]
    n = x.numel() // (h * w * c)
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    ws = torch.empty((n, 2, c), **f32)
    dscale, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
    scale32 = scale.detach().to(torch.float32).contiguous()
    bias32 = bias.detach().to(torch.float32).contiguous()
    fn = lib.gn_lrelu_bwd_f32 if x.dtype == torch.float32 else lib.gn_lrelu_bwd_bf16
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), scale32.data_ptr(),
                 bias32.data_ptr(), dx.data_ptr(), ws.data_ptr(),
                 dscale.data_ptr(), dbias.data_ptr(), n, h * w, c, num_groups,
                 eps, slope, _stream(x))
    if err != 0:
        raise RuntimeError(f"gn_lrelu_bwd launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype)


class GNLReLUFunction(torch.autograd.Function):
    """GroupNorm + LeakyReLU with K1 forward and K2 backward on the card, and
    the two twins on the CPU, so both devices take the same autograd route.
    The forward keeps x (not y) for the backward, which recomputes the
    statistics, as the TPU kernel pair does."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, slope):
        ctx.save_for_backward(x, scale, bias)
        ctx.config = (num_groups, eps, slope)
        return gn_lrelu_fwd(x, scale, bias, num_groups, eps, slope)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = gn_lrelu_bwd(x, dy, scale, bias, *ctx.config)
        return dx, dscale, dbias, None, None, None


def fused_group_norm_lrelu(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, num_groups: int,
                           eps: float = 1e-6, slope: float = 0.2) -> torch.Tensor:
    """GroupNorm + LeakyReLU over NHWC x [..., H, W, C], differentiable in x,
    scale and bias."""
    return GNLReLUFunction.apply(x, scale, bias, num_groups, eps, slope)


def clear_of_kink(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  num_groups: int, margin: float = 1e-4,
                  eps: float = 1e-6) -> torch.Tensor:
    """x moved, element by element, until every float32 pre-activation
    (x - mean) * rstd * scale + bias lies at least `margin` from LeakyReLU's
    kink at 0. There the sign tests of K2 and of its twin, whose statistics
    differ by rounding, may disagree, and one flipped element shifts its
    whole group's dx by ~0.8 |dy| / group size. For holding K2 against the
    twin at large shapes; bf16 values move by at least one bf16 step."""
    h, w, c = x.shape[-3:]
    gs = c // num_groups
    sc = scale.detach().float()
    for _ in range(8):
        xg = x.float().reshape(-1, h, w, num_groups, gs)
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 2, 4), keepdim=True) - mean * mean,
                          min=0.0)
        rstd = torch.rsqrt(var + eps)
        y_pre = (xg - mean) * rstd * sc.reshape(num_groups, gs) + bias.detach().float(
        ).reshape(num_groups, gs)
        near = (y_pre.abs() < margin).reshape(x.shape)
        if not near.any():
            return x
        away = torch.where(y_pre >= 0, 1.0, -1.0).reshape(x.shape) * torch.sign(sc)
        step = (2 * margin / (rstd * sc.reshape(num_groups, gs).abs())).expand_as(
            xg).reshape(x.shape)
        if x.dtype == torch.bfloat16:
            step = torch.maximum(step, x.float().abs() * 2.0 ** -7 + 1e-30)
        x = torch.where(near, x.float() + away * step, x.float()).to(x.dtype)
    raise RuntimeError("clear_of_kink: pre-activations stay near 0")
