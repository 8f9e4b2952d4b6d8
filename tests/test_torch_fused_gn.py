"""Kernels K1 and K2 of the PyTorch port (video_gcp_torch/ops/fused_gn.py).

On the CPU the wrappers compute the plain twins. K1's twin is held against
the JAX package's Pallas kernel in interpret mode and against its jnp
reference, at the shapes of tests/test_fused_gn.py and at the 10 GroupNorm
sites of the 9-room GCP-tree (5 encoder, 5 decoder) at small N. Tolerances:
f32 2e-5 (reduction order), bf16 3e-2 (one bf16 rounding step at |y| up to
~4). K2's twin is held against the Pallas backward in interpret mode
(`_gn_lrelu_bwd_pallas`) at the shapes of tests/test_fused_gn.py:84-104 and
at the 15 norm calls of a training step (5 sites x 3 encoder calls plus 5
decoder sites) at small N: f32 within 2e-5 of max(1, max |ref|), as
tests/test_fused_gn.py checks the JAX kernel; bf16 within 3e-2 of the same.
It is also held against autograd of the K1 twin, and the autograd Function
that wires K1 and K2 passes gradcheck in float64. The CUDA kernels
themselves are held against the twins on the card by tests/test_torch_cuda.py
and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.ops import fused_gn as t_gn
from video_gcp_torch.tracing import COUNTS
from video_gcp_torch.models.nets import GroupNorm
from video_gcp_tpu.ops.fused_gn import _gn_lrelu_bwd_pallas as j_bwd_pallas
from video_gcp_tpu.ops.fused_gn import fused_group_norm_lrelu as j_fused
from video_gcp_tpu.ops.fused_gn import gn_lrelu_reference as j_reference

TOLS = {"float32": 2e-5, "bfloat16": 3e-2}

SHAPES = [
    ((5, 16, 16, 64), 8),  # tests/test_fused_gn.py shapes
    ((3, 64, 64, 16), 8),
    ((130, 2, 2, 256), 8),
    ((4, 1, 4, 32), 8),
    ((2, 16, 16, 16), 8),  # encoder sites (I_0 / I_g batch)
    ((2, 8, 8, 32), 8),
    ((2, 4, 4, 64), 8),
    ((2, 2, 2, 128), 8),
    ((2, 1, 1, 256), 8),
    ((6, 2, 2, 128), 8),  # decoder sites (B * nodes folded)
    ((6, 4, 4, 64), 8),
    ((6, 8, 8, 32), 8),
    ((6, 16, 16, 16), 8),
    ((6, 32, 32, 16), 8),
]


def _inputs(shape, dtype):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    sc = (rng.randn(shape[-1]) * 0.5 + 1).astype(np.float32)
    bi = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, sc, bi


def _port(x, sc, bi, groups, dtype):
    out = t_gn.fused_group_norm_lrelu(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(sc),
        torch.from_numpy(bi), groups)
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_twin_matches_jax_kernel(shape, groups, dtype):
    x, sc, bi = _inputs(shape, dtype)
    launches = COUNTS["k1.launches"]
    got = _port(x, sc, bi, groups, dtype)
    assert COUNTS["k1.launches"] == launches  # CPU tensors never reach the kernel
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = j_fused(xj, jnp.asarray(sc), jnp.asarray(bi), groups, interpret=True)
    d = np.max(np.abs(got - np.asarray(want.astype(jnp.float32))))
    assert d < TOLS[dtype], (shape, dtype, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((4, 8, 8, 32), 8), ((3, 4, 4, 12), 4),
                                          ((2, 5, 3, 6), 2)])
def test_twin_matches_jax_reference(shape, groups, dtype):
    """Includes shapes the TPU kernel does not take (W*C % 128 != 0)."""
    x, sc, bi = _inputs(shape, dtype)
    got = _port(x, sc, bi, groups, dtype)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = j_reference(xj, jnp.asarray(sc), jnp.asarray(bi), groups)
    d = np.max(np.abs(got - np.asarray(want.astype(jnp.float32))))
    assert d < TOLS[dtype], (shape, dtype, d)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 4, 4, 16)
    sc, bi = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError):
        t_gn._check(x.permute(0, 2, 1, 3), sc, bi, 8)  # not NHWC-contiguous
    with pytest.raises(ValueError):
        t_gn._check(x, sc, bi, 16)  # more groups than the kernel keeps
    with pytest.raises(ValueError):
        t_gn._check(x, torch.ones(8), bi, 8)
    with pytest.raises(TypeError):
        t_gn._check(x.half(), sc, bi, 8)
    with pytest.raises(ValueError):
        t_gn.fused_group_norm_lrelu(x.to("meta"), sc.to("meta"), bi.to("meta"), 8)



# --- K2: the backward ---------------------------------------------------------

BWD_SHAPES = [
    (5, 16, 16, 64), (3, 64, 64, 16), (130, 2, 2, 256), (4, 1, 4, 32),  # test_fused_gn
    (6, 16, 16, 16), (6, 8, 8, 32), (6, 4, 4, 64), (6, 2, 2, 128),  # encoder on the
    (6, 1, 1, 256),  # sequence (B*T folded)
    (2, 16, 16, 16), (2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128),  # encoder on I_0
    (2, 1, 1, 256),
    (3, 16, 16, 16), (3, 8, 8, 32), (3, 4, 4, 64), (3, 2, 2, 128),  # encoder on I_g
    (3, 1, 1, 256),
    (14, 2, 2, 128), (14, 4, 4, 64), (14, 8, 8, 32), (14, 16, 16, 16),  # decoder
    (14, 32, 32, 16),  # (B * nodes folded)
]


def _bwd_inputs(shape, dtype):
    rng = np.random.RandomState(sum(shape) + 1)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    sc = (rng.randn(shape[-1]) * 0.5 + 1).astype(np.float32)
    bi = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        dy = np.array(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))
    return x, dy, sc, bi


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_twin_matches_jax_kernel(shape, dtype):
    x, dy, sc, bi = _bwd_inputs(shape, dtype)
    tdt = getattr(torch, dtype)
    before = (COUNTS["k1.launches"], COUNTS["k2.launches"])
    got = t_gn.gn_lrelu_bwd(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
                            torch.from_numpy(sc), torch.from_numpy(bi), 8)
    assert (COUNTS["k1.launches"], COUNTS["k2.launches"]) == before  # CPU: the twin
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    jdt = getattr(jnp, dtype)
    want = j_bwd_pallas(jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt),
                        jnp.asarray(sc), jnp.asarray(bi), 8, 1e-6, 0.2, True)
    tol = TOLS[dtype]
    for g, w, name in zip(got, want, ("dx", "dscale", "dbias")):
        d = _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert d < tol, (name, shape, dtype, d)


@pytest.mark.parametrize("shape,groups", [((4, 8, 8, 32), 8), ((3, 4, 4, 12), 4),
                                          ((2, 5, 3, 6), 2), ((6, 32, 32, 16), 8)])
def test_bwd_twin_matches_autograd_of_forward_twin(shape, groups):
    x, dy, sc, bi = (torch.from_numpy(a) for a in _bwd_inputs(shape, "float32"))
    xs, scs, bis = (a.clone().requires_grad_() for a in (x, sc, bi))
    want = torch.autograd.grad(t_gn.gn_lrelu_reference(xs, scs, bis, groups),
                               (xs, scs, bis), dy)
    got = t_gn.gn_lrelu_bwd_reference(x, dy, sc, bi, groups)
    for g, w, name in zip(got, want, ("dx", "dscale", "dbias")):
        assert _rel(g.numpy(), w.numpy()) < 2e-5, name


@pytest.mark.parametrize("shape,groups", [((3, 4, 4, 16), 8), ((2, 3, 5, 6), 2),
                                          ((2, 1, 1, 8), 4)])
def test_autograd_function_gradcheck(shape, groups):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape) * 2 + 0.5).requires_grad_()
    sc = torch.from_numpy(rng.randn(shape[-1]) * 0.5 + 1).requires_grad_()
    bi = torch.from_numpy(rng.randn(shape[-1]) * 0.1).requires_grad_()
    before = (COUNTS["k1.launches"], COUNTS["k2.launches"])
    assert torch.autograd.gradcheck(
        lambda a, b, c: t_gn.fused_group_norm_lrelu(a, b, c, groups), (x, sc, bi))
    assert (COUNTS["k1.launches"], COUNTS["k2.launches"]) == before


@pytest.mark.parametrize("grad_of", ["input", "params", "none"])
def test_group_norm_output_has_grad_fn(grad_of):
    """The norm stays in the autograd graph whenever its input or its
    parameters need a gradient (K1's output alone has no grad_fn)."""
    norm = GroupNorm(8, 16)
    norm.requires_grad_(grad_of == "params")
    x = torch.randn(2, 4, 4, 16, requires_grad=grad_of == "input")
    y = norm(x)
    assert (y.grad_fn is not None) == (grad_of != "none")
    if grad_of != "none":
        y.square().sum().backward()
        grads = [x.grad] if grad_of == "input" else [norm.weight.grad, norm.bias.grad]
        assert all(g is not None and g.abs().sum() > 0 for g in grads)


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 4, 4, 16)
    sc, bi = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError):
        t_gn.gn_lrelu_bwd(x.to("meta"), x.to("meta"), sc.to("meta"), bi.to("meta"), 8)
    assert t_gn.MAX_BWD_CHANNELS == 256


# --- launch plans of K1 and K2 ---------------------------------------------------

_SITES = [(16, 16, 16), (8, 8, 32), (4, 4, 64), (2, 2, 128), (1, 1, 256)]
_DEC_SITES = _SITES[::-1][1:] + [(32, 32, 16)]
PLAN_SHAPES = (
    [(16,) + s for s in _SITES] + [(16 * 127,) + s for s in _DEC_SITES]  # B=16
    + [(100,) + s for s in _SITES] + [(100 * 127,) + s for s in _DEC_SITES]  # CEM
    + [(1600,) + s for s in _SITES]  # the train step's encoder on B*T frames
    + [(16352, 64, 64, 16), (2032, 64, 64, 16), (1600, 32, 32, 16)]  # bench tops
    + [(5, 16, 16, 64), (3, 64, 64, 16), (130, 2, 2, 256), (4, 1, 4, 32),  # card tests
       (6, 32, 32, 16), (14, 32, 32, 16), (3, 4, 4, 12), (2, 5, 3, 6)]
    + [(1, 32, 32, 16), (1, 64, 64, 16), (1, 1, 1, 256), (1, 5, 3, 6)])  # N = 1


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_is_legal(shape, itemsize, bwd, aligned):
    c = shape[-1]
    groups = 8 if c % 8 == 0 else 2
    p = t_gn.launch_plan(shape, itemsize, groups, bwd, aligned)
    n, per = shape[0], shape[1] * shape[2] * c
    assert p.threads <= min(1024, t_gn.MAX_THREADS) and p.threads % 32 == 0
    assert p.threads == p.team * p.spb and p.smem <= 232448
    assert p.cluster in (1, 2, 4, 8) and p.ctas % p.cluster == 0
    assert p.cluster == 1 or p.spb == 1
    assert 1 <= p.fin_group <= max(p.ctas, 1)
    length = per // p.cluster
    assert length * p.cluster == per and length % c == 0
    assert p.vec in (1, 16 // itemsize) and (p.vec == 1 or aligned)
    assert (per * itemsize) % (p.vec * itemsize) == 0 and length % p.vec == 0
    assert (p.team * p.vec) % c == 0  # each thread stays on the same channels
    assert p.smem >= (2 if bwd else 1) * p.spb * length * itemsize  # the cache
    # every (sample, slice) is covered by exactly one CTA
    cta = np.arange(p.ctas)
    rank, first = cta % p.cluster, cta // p.cluster * p.spb
    count = np.zeros((n, p.cluster), int)
    for t in range(p.spb):
        s = first + t
        np.add.at(count, (s[s < n], rank[s < n]), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("shape,itemsize,bwd,cluster,spb", [
    ((12700, 32, 32, 16), 4, False, 1, 1),  # one 64 KB sample a CTA
    ((16352, 64, 64, 16), 2, False, 2, 1),  # 128 KB: a cluster of 2
    ((2032, 64, 64, 16), 2, True, 4, 1),  # x + dy 256 KB: a cluster of 4
    ((2032, 32, 32, 16), 4, True, 2, 1),
    ((12700, 16, 16, 16), 4, False, 1, 4),  # small samples packed
    ((1600, 1, 1, 256), 2, True, 1, 7),
])
def test_launch_plan_splits_and_packs(shape, itemsize, bwd, cluster, spb):
    p = t_gn.launch_plan(shape, itemsize, 8, bwd)
    assert (p.cluster, p.spb, p.vec) == (cluster, spb, 16 // itemsize)
    assert p.smem <= t_gn.CTA_CACHE_BYTES + 4096  # three CTAs share an SM


def test_launch_plan_rejects_what_eight_ctas_cannot_hold():
    with pytest.raises(ValueError):
        t_gn.launch_plan((2, 256, 256, 16), 4, 8, True)
    big = t_gn.launch_plan((2032, 32, 32, 16), 4, 8, True)  # 4064 CTAs: two levels
    assert big.fin_group == 64
    assert t_gn.bwd_workspace_floats(big, 16) == (4064 + 64 + 1) * 32
    small = t_gn.launch_plan((100, 8, 8, 32), 4, 8, True)  # 100 rows of 64 floats: one
    assert small.fin_group == small.ctas == 100
