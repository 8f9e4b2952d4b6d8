"""The port's tree-to-timeline schemes (video_gcp_torch/evaluation/
eval_binding.py) against the JAX package's `tree_dense_sample` on the same
tree outputs, on the CPU: 'basic', 'dtw' and 'pruned_dtw' give the same
frames exactly (they gather the same nodes); the schemes not ported raise
NotImplementedError naming their ROADMAP item."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.evaluation import eval_binding as t_eb
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.evaluation import eval_binding as j_eb


def _case(seed, depth=5, b=4, t=20, img=8):
    rng = np.random.RandomState(seed)
    n = 2 ** depth - 1
    images = (rng.rand(b, n, img, img, 3) * 2 - 1).astype(np.float32)
    keep = rng.rand(b, n) < 0.4
    keep[:, 0] = True
    keep[1] = False  # only the first node kept
    keep[1, 0] = True
    traj = (rng.rand(b, t, img, img, 3) * 2 - 1).astype(np.float32)
    end = rng.randint(2, t, b)
    end[0] = t - 1
    return images, keep, traj, end


def _both(images, keep, traj, end):
    t_out = AttrDict(tree=AttrDict(images=torch.from_numpy(images)),
                     prune_keep=torch.from_numpy(keep), end_ind=torch.from_numpy(end))
    t_in = AttrDict(traj_seq=torch.from_numpy(traj), end_ind=torch.from_numpy(end))
    j_out = JAttrDict(tree=JAttrDict(images=jnp.asarray(images)),
                      prune_keep=jnp.asarray(keep), end_ind=jnp.asarray(end.astype(np.int32)))
    j_in = JAttrDict(traj_seq=jnp.asarray(traj), end_ind=jnp.asarray(end.astype(np.int32)))
    return (t_out, t_in), (j_out, j_in)


@pytest.mark.parametrize("scheme", ["basic", "dtw", "pruned_dtw"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_dense_sample_matches_jax(scheme, seed):
    images, keep, traj, end = _case(seed)
    (t_out, t_in), (j_out, j_in) = _both(images, keep, traj, end)
    t_max = traj.shape[1]
    got = t_eb.dense_sample(t_out, t_in, scheme, t_max).numpy()
    want = np.asarray(j_eb.tree_dense_sample(j_out, j_in, scheme, t_max))
    assert got.shape == want.shape == traj.shape
    np.testing.assert_array_equal(got, want)


def test_pruned_dtw_uses_only_kept_nodes():
    images, keep, traj, end = _case(3)
    (t_out, t_in), _ = _both(images, keep, traj, end)
    got = t_eb.dense_sample(t_out, t_in, "pruned_dtw", traj.shape[1]).numpy()
    from video_gcp_torch.ops.tree_index import breadthfirst2depthfirst
    df = breadthfirst2depthfirst(torch.from_numpy(images)).numpy()
    keep_df = keep  # prune_keep is over df nodes
    for k in range(images.shape[0]):
        kept = {df[k, i].tobytes() for i in np.flatnonzero(keep_df[k])}
        assert all(frame.tobytes() in kept for frame in got[k])
    assert (got[1] == df[1, 0]).all()  # one kept node fills the timeline


@pytest.mark.parametrize("scheme", ["greedy_exist", "greedy_l2"])
def test_deferred_schemes_raise(scheme):
    images, keep, traj, end = _case(0)
    (t_out, t_in), _ = _both(images, keep, traj, end)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7.4"):
        t_eb.dense_sample(t_out, t_in, scheme, traj.shape[1])
    with pytest.raises(ValueError, match="unknown pruning scheme"):
        t_eb.dense_sample(t_out, t_in, "nearest", traj.shape[1])


def test_sequential_dense_sample_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        t_eb.dense_sample(AttrDict(dense_rec=AttrDict()), AttrDict(), "basic", 10)
