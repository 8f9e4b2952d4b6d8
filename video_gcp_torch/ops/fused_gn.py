"""Fused GroupNorm + LeakyReLU for the conv pyramids: forward kernel K1 and
backward kernel K2, wired as one `torch.autograd.Function`.

K1 replaces the Pallas TPU kernel `video_gcp_tpu/ops/fused_gn.py:_gn_lrelu_kernel`
(its pallas_call in `_gn_lrelu_pallas`), K2 replaces `_gn_lrelu_bwd_kernel`
(its pallas_call in `_gn_lrelu_bwd_pallas`). Both are CUDA C++ in
`video_gcp_torch/csrc/fused_gn.cu`, built, bound and launched through
`ops/cuda_build.py`.

Numerics follow flax.linen.GroupNorm: float32 statistics with the fast
variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6 (not torch's 1e-5),
y = (x - mean) * rsqrt(var + eps) * scale + bias, cast to the storage type,
then LeakyReLU(0.2).

K1's bound: memory, 2 * N*H*W*C * sizeof(dtype) bytes (read x once, write y once).
At 3.35 TB/s that is 0.50 ms for the CEM batch's top decoder level
[12700, 32, 32, 16] in f32 and 1.28 ms for the largest shape of the repo,
[16352, 64, 64, 16] in bf16. K2's bound: memory, 3 * N*H*W*C * sizeof(dtype)
bytes (read x and dy once, write dx once); it recomputes the statistics from
x instead of keeping them from the forward. Both kernels read each element
once: a CTA keeps its samples, or its slice of one sample in a thread-block
cluster, in shared memory between the statistics and the output (see the
source for the design). `launch_plan` chooses the launch shape.

Layout: activations are NHWC, as in the JAX package. The conv layers see the
same memory as an NCHW tensor in `torch.channels_last`, so no copy is made
around the norm. On a CUDA tensor the wrappers launch the kernels or raise;
on a CPU tensor they compute the plain twins `gn_lrelu_reference` and
`gn_lrelu_bwd_reference`. The gradient that reaches the norm comes from the
next conv's cuDNN dgrad or from a `torch.cat` (decoder skips), whose layouts
are not guaranteed: the backward copies a dy that is not NHWC-contiguous and
counts the copy in `tracing.COUNTS["k2.dy_copies"]` (2 per step of the
9-room training run on an H100; PERF.md). K1 and K2 launches count under
"k1.launches" and "k2.launches".
"""
from __future__ import annotations

import functools
import math
from ctypes import c_float, c_int, c_int64, c_void_p
from dataclasses import dataclass

import torch

from video_gcp_torch import tracing
from video_gcp_torch.ops import cuda_build

SOURCE = "fused_gn.cu"
MAX_GROUPS = 8  # csrc kMaxGroups
MAX_BWD_CHANNELS = 256  # K2's parameter-gradient rows stay small

# Launch plan limits and targets (H100 SXM; the csrc constants in brackets)
SM_COUNT = 132
MAX_THREADS = 512  # threads a CTA (kMaxThreads)
MAX_CLUSTER = 8  # CTAs a sample may span (kMaxCluster), the portable limit
CTA_CACHE_BYTES = 64 * 1024  # samples a CTA caches: three CTAs share an SM
VECS_PER_THREAD = 16  # 16-byte vectors a thread takes per pass
PACKED_THREADS = 256  # CTA size when small samples are packed
FIN_ONE_LEVEL_BYTES = 32 * 1024  # K2: one CTA sums all dscale/dbias rows up to this

# The C entry points' arguments before the stream: the tensors (x, scale,
# bias, y; or x, dy, scale, bias, dx, ws, tickets), then n, per_sample, c,
# groups, eps, slope and the plan
_SIZES = (c_int64, c_int64, c_int, c_int, c_float, c_float, c_void_p)
ENTRY_POINTS = {
    **dict.fromkeys(("gn_lrelu_fwd_f32", "gn_lrelu_fwd_bf16"), (c_void_p,) * 4 + _SIZES),
    **dict.fromkeys(("gn_lrelu_bwd_f32", "gn_lrelu_bwd_bf16"), (c_void_p,) * 7 + _SIZES),
}
_tickets: dict = {}  # (device index, stream) -> int32 K2 tickets, zero between launches


@dataclass(frozen=True)
class LaunchPlan:
    """How K1 or K2 covers [n, H, W, C]: CTAs of `threads` threads hold
    `spb` samples, one team of `team` threads each, or (cluster > 1) one
    `cluster`-th of a sample; `vec` elements per access (16 bytes, or 1 for
    the narrow instance); lanes `shfl` apart share channels; `smem` bytes of
    dynamic shared memory; K2 sums its per-CTA dscale/dbias rows in groups
    of `fin_group` CTAs, then the group sums; `ctas` in the grid."""
    vec: int
    threads: int
    team: int
    spb: int
    cluster: int
    shfl: int
    smem: int
    fin_group: int
    ctas: int


@functools.lru_cache(maxsize=None)
def launch_plan(shape: tuple, itemsize: int, groups: int, bwd: bool,
                aligned: bool = True) -> LaunchPlan:
    """The launch shape of K1 (bwd False) or K2 for an NHWC tensor of
    `shape`; `aligned` says the tensors' addresses are 16-byte aligned.
    Raises ValueError for a sample that eight CTAs cannot hold or a channel
    count no team size keeps on fixed channels."""
    *lead, h, w, c = shape
    n, per = math.prod(lead), h * w * c
    nin = 2 if bwd else 1
    vec = 16 // itemsize if aligned and per * itemsize % 16 == 0 else 1

    def splits(cl):  # slices of whole pixels and whole vectors
        return per % cl == 0 and (per // cl) % c == 0 and (per // cl) % vec == 0

    def cache(cl):
        return nin * (per // cl) * itemsize

    cluster = 1
    while cluster < MAX_CLUSTER and splits(2 * cluster) and cache(cluster) > CTA_CACHE_BYTES:
        cluster *= 2
    length = per // cluster
    unit = math.lcm(32, c // math.gcd(c, vec))  # team * vec must be a multiple of C
    if unit > MAX_THREADS:
        raise ValueError(f"fused_group_norm_lrelu: no team size for {c} channels")
    want = -(-length // vec // VECS_PER_THREAD)
    team = min(-(-want // unit) * unit, MAX_THREADS // unit * unit)
    spb = 1
    if cluster == 1:
        spb = max(1, min(PACKED_THREADS // team, -(-n // (2 * SM_COUNT)),
                         CTA_CACHE_BYTES // cache(1)))
    threads = team * spb
    shfl = next(p for p in (1, 2, 4, 8, 16, 32) if p == 32 or p * vec % c == 0)
    floats = (2 * (threads // 32) * shfl * vec + 2 * spb * c + 4 * spb * groups
              + 4 * groups + (max(4 * threads, 2 * c) if bwd else 0))
    smem = -(-nin * spb * length * itemsize // 16) * 16 + 4 * floats
    if smem > cuda_build.SMEM_LIMIT:
        raise ValueError(f"fused_group_norm_lrelu: a sample of {tuple(shape[-3:])} needs "
                         f"{smem} bytes of shared memory in each of {cluster} CTAs")
    ctas = -(-n // spb) * cluster
    # one level of row sums when all rows are small, else ~sqrt(ctas) a group
    fin_group = (max(ctas, 1) if ctas * 2 * c * 4 <= FIN_ONE_LEVEL_BYTES
                 else math.isqrt(ctas - 1) + 1)
    return LaunchPlan(vec, threads, team, spb, cluster, shfl, smem, fin_group, ctas)


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


def _f32(p: torch.Tensor) -> torch.Tensor:
    """A parameter as the kernels read it: float32, contiguous (no copy when
    it is already)."""
    if p.dtype == torch.float32 and p.is_contiguous():
        return p
    return p.detach().to(torch.float32).contiguous()


def _plan(x: torch.Tensor, num_groups: int, bwd: bool, *others) -> LaunchPlan:
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return launch_plan(tuple(x.shape), x.element_size(), num_groups, bwd, aligned)


def gn_lrelu_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 num_groups: int, eps: float = 1e-6,
                 slope: float = 0.2) -> torch.Tensor:
    """K1 on a CUDA tensor, its twin on a CPU tensor; no autograd."""
    if not cuda_build.takes_kernel(x, "fused_group_norm_lrelu"):
        return gn_lrelu_reference(x, scale, bias, num_groups, eps, slope)
    _check(x, scale, bias, num_groups)
    plan = _plan(x, num_groups, False)
    y = torch.empty_like(x)
    if plan.ctas == 0:
        return y
    h, w, c = x.shape[-3:]
    scale32, bias32 = _f32(scale), _f32(bias)
    entry = "gn_lrelu_fwd_f32" if x.dtype == torch.float32 else "gn_lrelu_fwd_bf16"
    cuda_build.launch(SOURCE, ENTRY_POINTS, entry, x,
                      x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
                      x.numel() // (h * w * c), h * w * c, c, num_groups, eps, slope,
                      cuda_build.c_plan(plan), counter="k1.launches")
    return y


def bwd_workspace_floats(plan: LaunchPlan, c: int) -> int:
    """K2's float32 buffer: a dscale|dbias row per CTA, one per group of
    `plan.fin_group` CTAs, and the result (dscale then dbias) last."""
    return (plan.ctas + -(-plan.ctas // plan.fin_group) + 1) * 2 * c


def _bwd_tickets(x: torch.Tensor, stream: int, count: int) -> torch.Tensor:
    """K2's zeroed int32 tickets for launches on `stream`; the kernel leaves
    them zero."""
    key = (x.device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 64), dtype=torch.int32, device=x.device)
        _tickets[key] = t
    return t


def gn_lrelu_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, num_groups: int, eps: float = 1e-6,
                 slope: float = 0.2):
    """K2 on CUDA tensors, its twin on CPU tensors: (dx, dscale, dbias)."""
    if not cuda_build.takes_kernel(x, "fused_group_norm_lrelu"):
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
        tracing.count("k2.dy_copies")
    plan = _plan(x, num_groups, True, dy)
    dx = torch.empty_like(x)
    if plan.ctas == 0:
        zero = torch.zeros(c, dtype=torch.float32, device=x.device)
        return dx, zero.to(scale.dtype), zero.to(bias.dtype)
    h, w = x.shape[-3:-1]
    ws = torch.empty(bwd_workspace_floats(plan, c), dtype=torch.float32, device=x.device)
    scale32, bias32 = _f32(scale), _f32(bias)
    tickets = _bwd_tickets(x, cuda_build.stream(x), -(-plan.ctas // plan.fin_group) + 1)
    entry = "gn_lrelu_bwd_f32" if x.dtype == torch.float32 else "gn_lrelu_bwd_bf16"
    cuda_build.launch(SOURCE, ENTRY_POINTS, entry, x,
                      x.data_ptr(), dy.data_ptr(), scale32.data_ptr(), bias32.data_ptr(),
                      dx.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
                      x.numel() // (h * w * c), h * w * c, c, num_groups, eps, slope,
                      cuda_build.c_plan(plan), counter="k2.launches")
    dscale, dbias = ws[-2 * c:-c], ws[-c:]
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        dscale, dbias = dscale.to(scale.dtype), dbias.to(bias.dtype)
    return dx, dscale, dbias


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
