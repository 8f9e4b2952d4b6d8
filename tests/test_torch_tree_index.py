"""Tree index algebra of the PyTorch port against the JAX package: the df/bf
permutations, layer split, interleave, balanced timesteps, balanced match
distributions and the basic timeline index, by exact equality at L=1..7.

The constant tables on a device (`tree_index.device_table`): the permutations
and the balanced fractions equal the numpy ones at L=1..10, the top-bias mask
and SSIM's window the ones built per call before the tables; a second call
returns the same tensor and counts a hit; tables first made under
`torch.inference_mode()` serve a training forward and backward whose
gradients equal those of a fresh process bit for bit."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.evaluation import eval_binding as t_eval
from video_gcp_torch.models import binding as t_binding
from video_gcp_torch.ops import tree_index as t_ti
from video_gcp_tpu.evaluation import eval_binding as j_eval
from video_gcp_tpu.models import binding as j_binding
from video_gcp_tpu.ops import tree_index as j_ti

DEPTHS = range(1, 8)


def _end_inds(depth, max_seq_len, seed):
    rng = np.random.RandomState(seed)
    # short, long and boundary lengths (collisions happen when end < 2^depth)
    return np.concatenate([[0, 1, 2, max_seq_len - 1],
                           rng.randint(0, max_seq_len, 4)]).astype(np.int32)


@pytest.mark.parametrize("depth", DEPTHS)
def test_perms_layers_interleave(depth):
    np.testing.assert_array_equal(t_ti.df2bf_perm(depth), j_ti.df2bf_perm(depth))
    np.testing.assert_array_equal(t_ti.bf2df_perm(depth), j_ti.bf2df_perm(depth))
    n = 2 ** depth - 1
    x = np.random.RandomState(depth).randn(3, n, 5).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(t_ti.breadthfirst2depthfirst(xt).numpy(),
                                  np.asarray(j_ti.breadthfirst2depthfirst(jnp.asarray(x))))
    np.testing.assert_array_equal(t_ti.depthfirst2breadthfirst(xt).numpy(),
                                  np.asarray(j_ti.depthfirst2breadthfirst(jnp.asarray(x))))
    for a, b in zip(t_ti.depthfirst2layers(xt),
                    j_ti.depthfirst2layers(jnp.asarray(x)), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = x[:, ::-1].copy()
    np.testing.assert_array_equal(
        t_ti.interleave(xt, torch.from_numpy(y)).numpy(),
        np.asarray(j_ti.interleave(jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("depth", DEPTHS)
def test_balanced_schedule(depth):
    t_max = 100
    end = _end_inds(depth, t_max, depth)
    end_t, end_j = torch.from_numpy(end), jnp.asarray(end)
    np.testing.assert_array_equal(t_ti.balanced_timesteps(depth, end_t).numpy(),
                                  np.asarray(j_ti.balanced_timesteps(depth, end_j)))
    np.testing.assert_array_equal(
        t_binding.balanced_match_dists(depth, end_t, t_max).numpy(),
        np.asarray(j_binding.balanced_match_dists(depth, end_j, t_max)))
    np.testing.assert_array_equal(
        t_eval.basic_timeline_index(depth, end_t, t_max).numpy(),
        np.asarray(j_eval.basic_timeline_index(depth, end_j, t_max)))


TABLE_DEPTHS = range(1, 11)
COUNTERS = ("tree_index.table_uploads", "tree_index.table_hits")


def _counts():
    return tuple(tracing.COUNTS[k] for k in COUNTERS)


@pytest.fixture
def no_tables(monkeypatch):
    """An empty table cache for the test; the process's own afterwards."""
    monkeypatch.setattr(t_ti, "_TABLES", {})


@pytest.mark.parametrize("depth", TABLE_DEPTHS)
def test_device_tables_are_the_permutations(depth, no_tables):
    n = 2 ** depth - 1
    for perm in (t_ti.df2bf_perm, t_ti.bf2df_perm):
        table = t_ti.device_table(perm, torch.device("cpu"), depth)
        assert table.dtype == torch.int64 and not table.is_inference()
        np.testing.assert_array_equal(table.numpy(), perm(depth))
    x = torch.from_numpy(np.random.RandomState(depth).randn(2, n, 3).astype(np.float32))
    np.testing.assert_array_equal(t_ti.breadthfirst2depthfirst(x).numpy(),
                                  x.numpy()[:, t_ti.df2bf_perm(depth)])
    np.testing.assert_array_equal(t_ti.depthfirst2breadthfirst(x, dim=1).numpy(),
                                  x.numpy()[:, t_ti.bf2df_perm(depth)])


@pytest.mark.parametrize("depth", TABLE_DEPTHS)
def test_balanced_timesteps_from_the_table_are_the_numpy_ones(depth, no_tables):
    rng = np.random.RandomState(depth)
    for dtype in (np.int32, np.int64):
        end = np.concatenate([[0, 1, 2, 2 ** depth - 2, 499],
                              rng.randint(0, 500, 6)]).astype(dtype)
        # the fractions as every call built them before the table
        alpha = np.concatenate([(2 * np.arange(2 ** d, dtype=np.float32) + 1) / 2 ** (d + 1)
                                for d in range(depth)])
        want = -1.0 + (torch.from_numpy(end).to(torch.float32)[:, None] + 2.0) * \
            torch.as_tensor(alpha)[None, :]
        got = t_ti.balanced_timesteps(depth, torch.from_numpy(end))
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


@pytest.mark.parametrize("depth,n_top_layers", [(3, 1), (5, 2), (9, 3)])
def test_top_bias_mask_from_the_table_is_the_numpy_one(depth, n_top_layers, no_tables):
    n = 2 ** depth - 1
    m = np.ones(n, dtype=np.float32)  # as every call built it before the table
    for l in range(n_top_layers):
        m[2 ** (depth - l - 1) - 1::2 ** (depth - l)] = 0.3
    got = t_ti.device_table(t_binding._top_bias_mask_df, torch.device("cpu"), n,
                            n_top_layers, 0.3)
    assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_ssim_window_from_the_table_is_the_one_built_per_call(dtype, no_tables):
    from video_gcp_torch.core import metrics
    x = torch.arange(11, dtype=torch.float32) - 5.0  # as every call built it before
    g = torch.exp(-(x ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    got = t_ti.device_table(metrics._gaussian_window, torch.device("cpu"), 11, 1.5, dtype)
    assert got.dtype == dtype and torch.equal(got, torch.outer(g, g).to(dtype))
    assert t_ti.device_table(metrics._gaussian_window, torch.device("cpu"), 11, 1.5,
                             dtype) is got


def test_a_second_call_returns_the_same_table_and_counts_a_hit(no_tables):
    cpu = torch.device("cpu")
    before = _counts()
    first = t_ti.device_table(t_ti.df2bf_perm, cpu, 5)
    assert _counts() == (before[0] + 1, before[1])
    second = t_ti.device_table(t_ti.df2bf_perm, cpu, 5)
    assert second is first and second.untyped_storage().data_ptr() == \
        first.untyped_storage().data_ptr()
    assert _counts() == (before[0] + 1, before[1] + 1)
    x = torch.zeros(3, 31, 2)
    t_ti.breadthfirst2depthfirst(x)  # the same table: a hit
    assert _counts() == (before[0] + 1, before[1] + 2)
    t_ti.depthfirst2breadthfirst(x)  # another table: an upload
    assert _counts() == (before[0] + 2, before[1] + 2)


# A small balanced tree's gradients of one training forward and backward,
# run in this process and, as it stands, in a fresh one.
_TREE_GRADS = """
import sys

import numpy as np
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.models.tree import TreeModel

B, T, IMG = 2, 8, 8


def small_tree():
    hp = default_hparams()
    hp.overwrite(dict(batch_size=B, max_seq_len=T, img_sz=IMG, hierarchy_levels=3,
                      matching_type="balanced", regress_length=True, attach_inv_mdl=True,
                      inv_mdl_params=dict(n_actions=2), n_actions=2,
                      tree_lstm="split_linear", lstm_init="mlp", n_lstm_layers=1,
                      nz_enc=8, nz_mid=8, nz_vae=4, nz_mid_lstm=8, ngf=4))
    torch.manual_seed(0)
    model = TreeModel(dict(hp))
    rng = np.random.RandomState(0)
    seq = torch.tensor((rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32))
    end = torch.tensor([T - 1, 5])
    batch = dict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[torch.arange(B), end], end_ind=end,
                 pad_mask=(torch.arange(T)[None] <= end[:, None]).float(),
                 actions=torch.tensor(rng.randn(B, T - 1, 2).astype(np.float32)))
    return model, batch


def grads(model, batch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = model(AttrDict(batch), phase="train", mode="posterior",
                    generator=torch.Generator().manual_seed(1))
        out.losses.total.value.backward()
    finally:
        torch.set_num_threads(threads)
    return {name: p.grad.clone() for name, p in model.named_parameters()
            if p.grad is not None}


if __name__ == "__main__":
    torch.save(grads(*small_tree()), sys.argv[1])
"""


def test_tables_made_in_inference_mode_serve_a_training_backward(no_tables, tmp_path):
    ns = {"__name__": "tree_grads"}
    exec(_TREE_GRADS, ns)
    model, batch = ns["small_tree"]()
    before = _counts()
    with torch.inference_mode():  # an evaluation makes the tables
        model(AttrDict({k: batch[k] for k in ("I_0", "I_g", "end_ind")}), phase="test",
              mode="prior", generator=torch.Generator().manual_seed(2))
        t_ti.balanced_timesteps(3, batch["end_ind"])
    made = _counts()
    assert made[0] - before[0] == len(t_ti._TABLES) == 2
    assert not any(t.is_inference() for t in t_ti._TABLES.values())
    got = ns["grads"](model, batch)
    after = _counts()
    assert after[0] == made[0] and after[1] > made[1]  # served from the tables
    path = tmp_path / "grads.pt"
    subprocess.run([sys.executable, "-c", _TREE_GRADS, str(path)], check=True,
                   cwd=Path(__file__).resolve().parents[1], timeout=300)
    want = torch.load(path)
    assert got.keys() == want.keys() and len(got) > 0
    for name, g in want.items():
        assert torch.equal(got[name], g), name
