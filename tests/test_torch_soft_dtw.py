"""Soft-DTW and cdist of the PyTorch port against the JAX package, on the CPU.

On a CPU tensor `video_gcp_torch.ops.soft_dtw.soft_dtw` runs K3's plain twin
`soft_dtw_rows_reference` (the DPs row by row, as the kernel walks them); the
card tests (tests/test_torch_cuda.py) hold K3 itself against that twin.

- `soft_dtw` against JAX's `soft_dtw(..., backend="xla")` (the XLA scan) and
  `soft_dtw_pallas(..., interpret=True)` (the Pallas kernel K3 replaces),
  atol 1e-4 on w as tests/test_pallas.py holds the two JAX versions, at the
  shapes of tests/test_pallas.py and at the 9-room training shape
  [16, 127, 100] with mixed ends.
- Against the float64 oracle of tests/test_ops.py (a copy below), rtol 1e-3,
  atol 1e-4: the f32 DP against the reference's float64 one.
- The row twin's F and Bk against `gak_reference` (the JAX package's
  anti-diagonal scan on the 2B rows of `dp_rows`): bit for bit at
  [16, 127, 100]; within 1e-6 of max(1, |D|) at small shapes, where torch's
  CPU logaddexp takes its scalar path for a tensor's last elements and its
  vector path for the rest (measured: at most 1.9e-7), and cell by cell
  against the float64 DP.
- `launch_plan` at c = 1, 9, 100, 128, 129, 500, 2457 and r in {c, 127, 511}:
  the shared-memory regime, the warps a chain, the limits.
- Row sums, no mass past the end, the stability gap, r < c raises, and a
  cost that requires grad gives a w without grad_fn.
- `batch_cdist` against JAX at 1e-5 relative to max(1, |d|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.ops import cuda_build
from video_gcp_torch.ops import soft_dtw as t_sd
from video_gcp_torch.ops.cdist import batch_cdist, cdist
from video_gcp_torch.tracing import COUNTS
from video_gcp_tpu.ops.cdist import batch_cdist as j_batch_cdist
from video_gcp_tpu.ops.pallas_dtw import soft_dtw_pallas
from video_gcp_tpu.ops.soft_dtw import soft_dtw as j_soft_dtw
from video_gcp_tpu.ops.soft_dtw import soft_dtw_stability_gap as j_gap


def np_fast_gak(C, begin_inds):
    """Reference fast_gak oracle in float64 (probabilistic_dtw.py:11-73);
    a copy of tests/test_ops.py:np_fast_gak."""
    b, r, c = C.shape
    D = np.full_like(C, -np.inf)
    for k in range(b):
        D[k, 0, begin_inds[k]] = C[k, 0, begin_inds[k]]
    for i in range(1, r + c):
        ids = np.arange(i + 1)[::-1]
        jds = np.arange(i + 1)
        sel = slice(max(0, i - r + 1), c)
        ids, jds = ids[sel], jds[sel]
        ids, jds = ids[::-1], jds[::-1]
        skip = D[:, ids - 1, jds]
        step = D[:, ids - 1, jds - 1]
        with np.errstate(over="ignore", invalid="ignore"):
            add = np.logaddexp(skip, step)
        new_cost = C[:, ids, jds] + add
        mask = D[:, ids, jds] != -np.inf
        new_cost[mask] = D[:, ids, jds][mask]
        D[:, ids, jds] = new_cost
    return D


def np_soft_dtw(C, end_inds):
    """Reference soft_dtw oracle (probabilistic_dtw.py:82-122); a copy of
    tests/test_ops.py:np_soft_dtw."""
    C = (-C).astype(np.float64)
    batch, r, c = C.shape
    comb_C = np.concatenate([C, C[:, ::-1, ::-1]], 0)
    comb_begin = np.concatenate([np.zeros_like(end_inds), c - end_inds - 1], 0)
    accum = np_fast_gak(comb_C, comb_begin)
    forward = accum[:batch]
    backward = accum[batch:][:, ::-1, ::-1]
    z = forward[np.arange(batch), -1, end_inds][:, None, None]
    e = forward + backward - C
    with np.errstate(invalid="ignore"):
        w = np.exp(e - z)
    w[~np.isfinite(e)] = 0.0
    return w


def _cost(seed, shape, ends=None):
    rng = np.random.RandomState(seed)
    C = (rng.rand(*shape) * 2).astype(np.float32)
    b, _, c = shape
    if ends is None:  # mixed ends, as the training data has
        ends = rng.choice([c - 1, int(c * 0.7), int(c * 0.4)], b)
    return C, np.asarray(ends, np.int64)


def _port(C, ends):
    return t_sd.soft_dtw(torch.from_numpy(C), torch.from_numpy(ends)).numpy()


CASES = [(0, (3, 31, 20), [19, 18, 10]), (1, (3, 15, 9), [8, 7, 4]),
         (2, (16, 127, 100), None)]


@pytest.mark.parametrize("seed,shape,ends", CASES)
def test_twin_matches_jax_xla_scan(seed, shape, ends):
    C, ends = _cost(seed, shape, ends)
    want = np.array(j_soft_dtw(jnp.asarray(C), jnp.asarray(ends), backend="xla"))
    got = _port(C, ends)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    print(shape, "max |port - xla|", np.abs(got - want).max())


@pytest.mark.parametrize("seed,shape,ends", CASES)
def test_twin_matches_pallas_interpret(seed, shape, ends):
    C, ends = _cost(seed, shape, ends)
    want = np.array(soft_dtw_pallas(jnp.asarray(C), jnp.asarray(ends), interpret=True))
    got = _port(C, ends)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    print(shape, "max |port - pallas|", np.abs(got - want).max())


@pytest.mark.parametrize("seed,shape,ends", [
    (0, (3, 7, 5), [4, 3, 2]), (1, (3, 15, 9), [8, 7, 6]),
    (2, (3, 31, 20), [19, 18, 17]), (3, (16, 127, 100), None)])
def test_twin_matches_float64_oracle(seed, shape, ends):
    C, ends = _cost(seed, shape, ends)
    want = np_soft_dtw(C, ends)
    got = _port(C, ends)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    print(shape, "max |port - f64|", np.abs(got - want).max())


def test_gak_twin_matches_dp_cell_by_cell():
    """The twin's accumulated values (the function K3 computes) against the
    float64 DP, where the DP is finite; NEG_INF elsewhere. No begin is
    c - 1: there the oracle's numpy index j - 1 = -1 at column 0 wraps
    around to the source cell (w, which the oracle zeroes there, is not
    affected)."""
    rng = np.random.RandomState(5)
    comb = -(rng.rand(4, 12, 9) * 2).astype(np.float32)
    begin = np.array([0, 1, 3, 7], np.int32)
    got = t_sd.gak_reference(torch.from_numpy(comb), torch.from_numpy(begin)).numpy()
    want = np_fast_gak(comb.astype(np.float64), begin)
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)
    assert np.all(got[~finite] <= t_sd.NEG_INF / 2) and np.isfinite(got).all()


@pytest.mark.parametrize("seed,shape,ends,exact", [
    (0, (3, 7, 5), [0, 1, 4], False), (1, (3, 15, 9), [1, 3, 8], False),
    (2, (4, 12, 9), [0, 1, 3, 8], False), (3, (16, 127, 100), None, True)])
def test_row_twin_matches_gak_reference(seed, shape, ends, exact):
    """F and Bk of the row twin against the forward rows and the flipped
    backward rows of the anti-diagonal twin: the same float32 operations on
    the same operands in every cell."""
    C, ends = _cost(seed, shape, ends)
    C, ends = torch.from_numpy(C), torch.from_numpy(ends)
    _, f, bk = t_sd.soft_dtw_rows_reference(C, ends, return_dp=True)
    acc = t_sd.gak_reference(*t_sd.dp_rows(C, ends))
    b = shape[0]
    for got, want in ((f, acc[:b]), (bk, torch.flip(acc[b:], (-1, -2)))):
        if exact:
            assert torch.equal(got, want)
        assert torch.equal(got <= t_sd.NEG_INF / 2, want <= t_sd.NEG_INF / 2)
        rel = ((got - want).abs() / want.abs().clamp(min=1)).max().item()
        assert rel <= 1e-6, rel


def test_row_twin_matches_dp_cell_by_cell():
    """F and Bk against the float64 DP of the oracle on -C (forward from
    column 0, backward on the flipped matrix from c - end - 1) where it is
    finite; NEG_INF elsewhere. No end is 0 (a backward source in the last
    column, where the oracle's index wraps around)."""
    C, ends = _cost(5, (4, 12, 9), [1, 3, 5, 7])
    _, f, bk = t_sd.soft_dtw_rows_reference(torch.from_numpy(C), torch.from_numpy(ends),
                                            return_dp=True)
    neg = -C.astype(np.float64)
    fwd = np_fast_gak(neg, np.zeros(4, np.int64))
    bwd = np_fast_gak(neg[:, ::-1, ::-1].copy(), 9 - ends - 1)[:, ::-1, ::-1]
    for got, want in ((f.numpy(), fwd), (bk.numpy(), bwd)):
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)
        assert np.all(got[~finite] <= t_sd.NEG_INF / 2) and np.isfinite(got).all()


def test_k3_on_the_cpu_is_the_row_twin():
    C, ends = _cost(9, (3, 15, 9), [8, 5, 2])
    C, ends = torch.from_numpy(C), torch.from_numpy(ends)
    got = t_sd.k3(C, ends, return_dp=True)
    for g, w in zip(got, t_sd.soft_dtw_rows_reference(C, ends, return_dp=True)):
        assert torch.equal(g, w)
    assert torch.equal(t_sd.soft_dtw(C, ends.to(torch.int32)), got[0])
    with pytest.raises(ValueError, match="no kernel for meta"):
        t_sd.k3(torch.empty(2, 5, 5, device="meta"), torch.zeros(2, dtype=torch.int64))


PLAN_FRAMES = [1, 9, 100, 128, 129, 500, 2457]


@pytest.mark.parametrize("c", PLAN_FRAMES)
@pytest.mark.parametrize("r", ["c", 127, 511])
def test_launch_plan(r, c):
    r = c if r == "c" else r
    if r < c:
        with pytest.raises(ValueError, match="at least as many nodes"):
            t_sd.launch_plan(r, c)
        return
    plan = t_sd.launch_plan(r, c)
    cells = -(-r * c // 4) * 4
    resident = t_sd.HEADER_BYTES + 12 * cells <= cuda_build.SMEM_LIMIT
    assert plan.resident == resident
    assert plan.cols == (4 if c <= 896 else 8 if c <= 1792 else 12)
    assert plan.warps <= t_sd.MAX_CHAIN_WARPS and plan.warps * 32 * plan.cols >= c
    assert (plan.warps - 1) * 32 * plan.cols < c  # no warp without a column
    assert 32 * (1 + 2 * plan.warps) <= t_sd.THREADS
    assert plan.rows % 4 == 0 and plan.chunks == -(-r // plan.rows)
    assert plan.rows * c * 4 <= max(t_sd.CHUNK_BYTES, 16 * c)
    assert plan.vec == (r * c % 4 == 0)
    assert t_sd.launch_plan(r, c, aligned=False).vec == 0
    assert plan.smem <= cuda_build.SMEM_LIMIT
    if resident:
        assert plan.chunks <= t_sd.MAX_CHUNKS and plan.smem == t_sd.HEADER_BYTES + 12 * cells
    else:
        assert 1 <= plan.slots <= t_sd.MAX_SLOTS
        assert plan.smem == t_sd.HEADER_BYTES + 8 * plan.slots * plan.rows * c


def test_launch_plan_main_shapes_and_limits():
    train = t_sd.launch_plan(127, 100)  # the adaptive step, 3 x 50.8 KB resident
    assert (train.resident, train.warps, train.cols, train.vec) == (1, 1, 4, 1)
    assert train.smem == 1024 + 3 * 127 * 100 * 4
    big = t_sd.launch_plan(511, 500)  # the largest shape named: C streams
    assert (big.resident, big.warps, big.cols, big.rows, big.slots) == (0, 4, 4, 4, 4)
    for r, c in ((2457, 2458), (3000, 2458), (4, 0)):
        with pytest.raises(ValueError, match="the kernel takes"):
            t_sd.launch_plan(r, c)


def test_rows_sum_to_one_and_no_mass_past_end():
    C, ends = _cost(4, (4, 15, 10), [9, 7, 3, 5])
    w = _port(C, ends)
    np.testing.assert_allclose(w.sum(2), 1.0, atol=1e-2)
    for k, e in enumerate(ends):
        assert np.abs(w[k, :, e + 1:]).max(initial=0.0) < 1e-6
    C, ends = _cost(4, (1, 7, 6), [3])  # tests/test_ops.py:test_no_mass_past_end
    assert np.abs(_port(C, ends)[0, :, 4:]).max() < 1e-6


def test_stability_gap_matches_jax():
    C, ends = _cost(6, (16, 127, 100))
    w = _port(C, ends)
    got = float(t_sd.soft_dtw_stability_gap(torch.from_numpy(w)))
    want = float(j_gap(jnp.asarray(w), jnp.asarray(ends)))
    assert got == pytest.approx(want, abs=1e-7)
    assert got < 1e-3


def test_fewer_nodes_than_frames_raises():
    with pytest.raises(ValueError, match="at least as many nodes"):
        t_sd.soft_dtw(torch.rand(2, 5, 7), torch.tensor([6, 4]))


def test_no_gradient_through_the_dp():
    cost = torch.rand(2, 7, 5, requires_grad=True)
    temp = torch.tensor(0.5, requires_grad=True)
    w = t_sd.soft_dtw(cost / temp, torch.tensor([4, 3]))
    assert w.grad_fn is None and not w.requires_grad


def test_one_call_is_one_twin_run_on_the_cpu():
    """On a CPU tensor no kernel launches: "k3.launches" counts card launches."""
    before = COUNTS["k3.launches"]
    _port(*_cost(7, (2, 9, 6), [5, 4]))
    assert COUNTS["k3.launches"] == before


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_batch_cdist_matches_jax(reduction):
    rng = np.random.RandomState(8)
    a = (rng.rand(3, 15, 8, 8, 3) * 2 - 1).astype(np.float32)
    b = (rng.rand(3, 10, 8, 8, 3) * 2 - 1).astype(np.float32)
    want = np.array(j_batch_cdist(jnp.asarray(a), jnp.asarray(b), reduction))
    got = batch_cdist(torch.from_numpy(a), torch.from_numpy(b), reduction).numpy()
    assert got.shape == (3, 15, 10)
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * np.maximum(1.0, np.abs(want)))
    naive = ((a[:, :, None] - b[:, None]) ** 2).reshape(3, 15, 10, -1)
    naive = naive.sum(-1) if reduction == "sum" else naive.mean(-1)
    np.testing.assert_allclose(got, naive, rtol=1e-4, atol=1e-4)


def test_cdist_and_unknown_reduction():
    a, b = torch.rand(4, 6), torch.rand(5, 6)
    np.testing.assert_allclose(cdist(a, b).numpy(), (torch.cdist(a, b) ** 2).numpy(),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unknown reduction"):
        batch_cdist(a[None], b[None], "max")
