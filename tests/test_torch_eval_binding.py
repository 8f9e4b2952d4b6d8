"""The port's tree-to-timeline schemes (video_gcp_torch/evaluation/
eval_binding.py) against the JAX package's `tree_dense_sample` on the same
tree outputs, on the CPU: 'basic', 'dtw' and 'pruned_dtw' give the same
frames exactly (they gather the same nodes), and so do 'greedy_exist' and
'greedy_l2' (the JAX package's reading of the reference's intent; the
reference's own greedy_l2 calls a function that does not exist). The
sequential model's
'basic' and 'dtw' against the JAX package's `sequential_dense_sample`."""
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


def _with_existence(seed, images, keep, traj, end):
    """_both's outputs plus df existence logits, with ties among them."""
    logits = np.random.RandomState(seed + 10).randn(*keep.shape).astype(np.float32)
    logits[:, 3:9] = logits[:, 3:4]  # equal probabilities: the first index wins
    (t_out, t_in), (j_out, j_in) = _both(images, keep, traj, end)
    t_out.existence_logits = torch.from_numpy(logits)
    j_out.existence_logits = jnp.asarray(logits)
    return (t_out, t_in), (j_out, j_in)


@pytest.mark.parametrize("scheme", ["greedy_exist", "greedy_l2"])
def test_deferred_schemes_raise(scheme):
    """The two greedy schemes, once deferred, now run: the frames equal the
    JAX package's; an unknown scheme still raises, and greedy_exist without
    an existence predictor raises as in JAX."""
    images, keep, traj, end = _case(0)
    (t_out, t_in), (j_out, j_in) = _with_existence(0, images, keep, traj, end)
    got = t_eb.dense_sample(t_out, t_in, scheme, traj.shape[1]).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_eb.tree_dense_sample(j_out, j_in, scheme, traj.shape[1])))
    with pytest.raises(ValueError, match="unknown pruning scheme"):
        t_eb.dense_sample(t_out, t_in, "nearest", traj.shape[1])
    del t_out["existence_logits"]
    if scheme == "greedy_exist":
        with pytest.raises(ValueError, match="existence predictor"):
            t_eb.dense_sample(t_out, t_in, scheme, traj.shape[1])


@pytest.mark.parametrize("scheme", ["greedy_exist", "greedy_l2"])
@pytest.mark.parametrize("seed, depth, t", [(1, 5, 20), (2, 4, 20), (3, 3, 12)])
def test_greedy_schemes_match_jax(scheme, seed, depth, t):
    """Depths whose node count is below, near and above the timeline's
    length; the selection masks and matches themselves, then the frames."""
    images, keep, traj, end = _case(seed, depth=depth, t=t)
    (t_out, t_in), (j_out, j_in) = _with_existence(seed, images, keep, traj, end)
    got = t_eb.dense_sample(t_out, t_in, scheme, t).numpy()
    want = np.asarray(j_eb.tree_dense_sample(j_out, j_in, scheme, t))
    assert got.shape == want.shape == traj.shape
    np.testing.assert_array_equal(got, want)
    if scheme == "greedy_exist":
        p = np.random.RandomState(seed).rand(*keep.shape).astype(np.float32)
        p[:, :4] = 0.5
        np.testing.assert_array_equal(
            t_eb.greedy_exist_select(torch.from_numpy(p), torch.from_numpy(end), t).numpy(),
            np.asarray(j_eb.greedy_exist_select(jnp.asarray(p), jnp.asarray(end), t)))
    else:
        cost = np.random.RandomState(seed).rand(images.shape[0], images.shape[1], t)
        cost = cost.astype(np.float32)
        got_m, got_v = t_eb.greedy_l2_match(torch.from_numpy(cost), torch.from_numpy(end), depth)
        want_m, want_v = j_eb.greedy_l2_match(jnp.asarray(cost), jnp.asarray(end), depth)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_greedy_exist_empty_frontier_takes_index_zero():
    """A row whose frontier is empty (every score masked to -inf) still
    takes argmax index 0, and that pick is masked out: both packages select
    nothing more once the tree is exhausted."""
    p = np.full((2, 7), 0.5, np.float32)
    end = np.array([9, 2])  # more pops than the 7 nodes; fewer
    got = t_eb.greedy_exist_select(torch.from_numpy(p), torch.from_numpy(end), 12).numpy()
    want = np.asarray(j_eb.greedy_exist_select(jnp.asarray(p), jnp.asarray(end), 12))
    np.testing.assert_array_equal(got, want)
    assert got[0].all() and got[1].sum() == 3
    scores = torch.full((1, 7), -float("inf"))
    assert int(torch.argmax(scores, 1)[0]) == int(jnp.argmax(jnp.asarray(scores.numpy()), 1)[0]) == 0


def test_sequential_dense_sample_raises():
    """The sequential model's dense sample: 'basic' and 'dtw' equal the
    JAX package's; a tree-only scheme raises."""
    _, _, traj, end = _case(0)
    rollout = (np.random.RandomState(1).rand(*traj.shape) * 2 - 1).astype(np.float32)
    t_out = AttrDict(dense_rec=AttrDict(images=torch.from_numpy(rollout)),
                     end_ind=torch.from_numpy(end))
    t_in = AttrDict(traj_seq=torch.from_numpy(traj), end_ind=torch.from_numpy(end))
    j_out = JAttrDict(dense_rec=JAttrDict(images=jnp.asarray(rollout)),
                      end_ind=jnp.asarray(end.astype(np.int32)))
    j_in = JAttrDict(traj_seq=jnp.asarray(traj), end_ind=jnp.asarray(end.astype(np.int32)))
    for scheme in ("basic", "dtw"):
        got = t_eb.dense_sample(t_out, t_in, scheme, traj.shape[1]).numpy()
        want = np.asarray(j_eb.dense_sample(j_out, j_in, scheme, traj.shape[1]))
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, rollout)  # 'dtw' warped the frames
    with pytest.raises(ValueError, match="for the sequential model"):
        t_eb.dense_sample(t_out, t_in, "pruned_dtw", traj.shape[1])
