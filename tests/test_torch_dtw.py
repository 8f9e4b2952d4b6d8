"""The port's evaluation DTW (video_gcp_torch/ops/dtw.py) against the JAX
package's ops/dtw.py and against a plain numpy DP with traceback, on the
CPU.

- min_cumsum: D equal to JAX's bit for bit (each cell is computed as the
  JAX scan computes it).
- batched_dtw_alignment: node indices exactly equal, distance within 1e-6,
  on random costs and on integer-valued costs full of ties, with mixed
  end_ind down to 0.
- dtw_warp_sequence: node indices and warped frames equal to JAX's and to
  the numpy reference's on the same cost.
- K4's launch plan: the choices in shared memory at the 500-frame tree's
  [511, 500] (and the repo's other shapes), in a device scratch past 227 KB
  of them, a raise past the kernel's limits; on a CPU tensor the twin runs
  and no K4 launch is counted.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.ops import cuda_build
from video_gcp_torch.ops import dtw as t_dtw
from video_gcp_torch.ops.cdist import batch_cdist
from video_gcp_torch.tracing import COUNTS
from video_gcp_tpu.ops import dtw as j_dtw

DIST_TOL = 1e-6
SHAPES = [(3, 7, 5), (5, 15, 10), (4, 31, 20), (16, 127, 100)]


def _costs(seed, shape, ties):
    rng = np.random.RandomState(seed)
    if ties:  # integer costs: many equal paths and equal cells
        return rng.randint(0, 3, shape).astype(np.float32)
    return rng.rand(*shape).astype(np.float32)


def _ends(seed, b, c):
    end = np.random.RandomState(seed + 100).randint(0, c, b)
    end[0], end[-1] = c - 1, 0
    return end


def numpy_dtw(C, end):
    """One example: the padded DP, the traceback from (r, end + 1) with ties
    broken (i-1, j-1), (i-1, j), (i, j-1), and per column the visited cell
    of least cost (the smaller node on a tie)."""
    r, c = C.shape
    D = np.full((r + 1, c + 1), np.inf, C.dtype)
    D[0, 0] = 0
    for i in range(1, r + 1):
        for j in range(1, c + 1):
            D[i, j] = C[i - 1, j - 1] + min(D[i - 1, j - 1], D[i - 1, j], D[i, j - 1])
    best_cost, best_node = np.full(c, np.inf), np.zeros(c, np.int64)
    i, j = r, end + 1
    while True:
        if D[i, j] <= best_cost[j - 1]:
            best_cost[j - 1], best_node[j - 1] = D[i, j], i - 1
        if i == 1 and j == 1:
            break
        tb = int(np.argmin([D[i - 1, j - 1], D[i - 1, j], D[i, j - 1]]))
        i, j = max(i - (tb in (0, 1)), 1), max(j - (tb in (0, 2)), 1)
    inds = best_node[np.minimum(np.arange(c), end)]
    return inds, D[r, end + 1] / (r + end + 1.0), D


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ties", [False, True])
def test_min_cumsum_matches_jax_bitwise(shape, ties):
    C = _costs(0, shape, ties)
    got = t_dtw.min_cumsum(torch.from_numpy(C)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_dtw.min_cumsum(jnp.asarray(C))))
    np.testing.assert_array_equal(got[0], numpy_dtw(C[0], shape[2] - 1)[2])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ties", [False, True])
def test_alignment_matches_jax_and_numpy(shape, ties):
    b, r, c = shape
    C, end = _costs(1, shape, ties), _ends(1, b, c)
    inds, dist = t_dtw.batched_dtw_alignment(torch.from_numpy(C), torch.from_numpy(end))
    j_inds, j_dist = j_dtw.batched_dtw_alignment(jnp.asarray(C),
                                                 jnp.asarray(end.astype(np.int32)))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(j_inds))
    assert np.abs(dist.numpy() - np.asarray(j_dist)).max() < DIST_TOL
    for k in range(min(b, 6)):
        want_inds, want_dist, _ = numpy_dtw(C[k], int(end[k]))
        np.testing.assert_array_equal(inds[k].numpy(), want_inds)
        assert abs(float(dist[k]) - want_dist) < DIST_TOL
    assert inds.dtype == torch.int64 and inds.shape == (b, c)


def test_warp_sequence_matches_jax_and_numpy():
    rng = np.random.RandomState(2)
    b, n, t = 4, 31, 20
    est = (rng.rand(b, n, 8, 8, 3) * 2 - 1).astype(np.float32)
    tgt = (rng.rand(b, t, 8, 8, 3) * 2 - 1).astype(np.float32)
    end = _ends(2, b, t)
    warped, inds = t_dtw.dtw_warp_sequence(torch.from_numpy(est), torch.from_numpy(tgt),
                                           torch.from_numpy(end))
    j_warped, j_inds = j_dtw.dtw_warp_sequence(jnp.asarray(est), jnp.asarray(tgt),
                                               jnp.asarray(end.astype(np.int32)))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(j_inds))
    np.testing.assert_array_equal(warped.numpy(), np.asarray(j_warped))
    cost = batch_cdist(torch.from_numpy(est), torch.from_numpy(tgt), "mean").numpy()
    for k in range(b):
        want = numpy_dtw(cost[k], int(end[k]))[0]
        np.testing.assert_array_equal(inds[k].numpy(), want)
        np.testing.assert_array_equal(warped[k].numpy(), est[k][want])


@pytest.mark.parametrize("r,c,warps", [(511, 500, 8), (127, 100, 2), (255, 200, 4),
                                       (499, 499, 8), (1, 7, 1), (9, 1, 1)])
def test_launch_plan_keeps_the_choices_in_shared_memory(r, c, warps):
    plan = t_dtw.launch_plan(r, c)
    assert (plan.warps, plan.shared, plan.words) == (warps, 1, -(-c // 16))
    assert 4 * r * plan.words < plan.smem <= cuda_build.SMEM_LIMIT


def test_launch_plan_moves_the_choices_to_a_scratch_and_raises_past_the_limit():
    plan = t_dtw.launch_plan(2000, 1000)  # 504 KB of choices
    assert (plan.warps, plan.shared, plan.words) == (8, 0, 63)
    assert plan.smem < 4 * 2000 * 63 and plan.smem <= cuda_build.SMEM_LIMIT
    big = t_dtw.launch_plan(t_dtw.MAX_NODES, t_dtw.MAX_FRAMES)
    assert not big.shared and big.smem <= cuda_build.SMEM_LIMIT
    for r, c in ((t_dtw.MAX_NODES + 1, 10), (10, t_dtw.MAX_FRAMES + 1), (0, 5), (5, 0)):
        with pytest.raises(ValueError, match="the kernel takes"):
            t_dtw.launch_plan(r, c)


def test_launch_plan_at_the_shared_memory_limit():
    """Choices in shared memory up to the limit itself, the header (with the
    path's length) counted in it, and a scratch one row or column past it."""
    full = t_dtw.launch_plan(876, 929)
    assert full.shared and full.smem == cuda_build.SMEM_LIMIT
    for r, c in ((877, 929), (876, 930), (892, 913)):
        plan = t_dtw.launch_plan(r, c)
        assert not plan.shared and plan.smem < cuda_build.SMEM_LIMIT
    for r in range(1, t_dtw.MAX_NODES + 1, 37):
        for c in (1, 16, 97, 500, 929, t_dtw.MAX_FRAMES):
            assert t_dtw.launch_plan(r, c).smem <= cuda_build.SMEM_LIMIT


def test_cpu_tensors_take_the_twin():
    """On a CPU tensor no kernel launches: "k4.launches" counts card launches."""
    C, end = _costs(3, (2, 9, 6), False), _ends(3, 2, 6)
    before = COUNTS["k4.launches"]
    inds, dist = t_dtw.batched_dtw_alignment(torch.from_numpy(C), torch.from_numpy(end))
    want = t_dtw.alignment_reference(torch.from_numpy(C), torch.from_numpy(end))
    assert COUNTS["k4.launches"] == before
    assert torch.equal(inds, want[0]) and torch.equal(dist, want[1])
