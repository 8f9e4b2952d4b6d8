"""The 500-frame horizon (experiments/prediction/25room_long and
experiments/data_gen/nav_25rooms_long) in the port against the JAX package,
on the CPU, at the configs' depth and horizon and at small widths.

- Both 25room_long configs, as the trainers build their hparams, cut in
  width only (WIDTHS): the tree keeps tied levels, hierarchy_levels 9 (511
  nodes) and max_seq_len 500 with its 500-wide length head; the VRNN keeps
  T = 500 (499 steps). B = 2, one example ending at frame 499 and one at 217.
  Weights come from a seed in the flax structure of a training init and are
  carried across by `flax_to_torch`.
- The L=9 tree's 'test'/'prior' rollout with injected z: images and
  e_g_prime per tree level, existence and length logits within
  tests/test_torch_tree.py's TOLS.
- One train step of each model: every loss term (LOSS_TOL), every gradient
  (GRAD_TOL) and the parameters after the RAdam step of JAX's
  make_train_step (PARAM_TOL), with `StepNoise` for every draw
  (tests/test_torch_train.py's tolerances).
- 'pruned_dtw' (the tree config's metric_pruning_scheme) at [2, 511, 500]:
  the kept nodes' D bit for bit, the same node indices and the same warped
  frames as the JAX package's `tree_dense_sample`.
- nav_25rooms_long: the PRM expert's trajectories at the data_gen config's
  settings (n_rooms 25, T=500, subsample_factor 0.5, 64x64), read from both
  packages' loads of the config, equal exactly; and the variable-length
  dataset at max_seq_len 500 (64x64 frames resized to img_sz 32, pad
  masks) on the same h5 files, equal exactly.

Widths: ngf 8 at img_sz 8. At ngf 4 the encoder's 1x1 GroupNorm holds 2
values a group, whose f32 gradient is ill-conditioned in both packages:
against a float64 run of the port, the port's f32 encoder gradients were
8.0e-4 off and JAX's 1.19e-2 (GRAD_TOL is 1e-4). At ngf 8 (4 values a
group) the worst difference was 3.0e-5 (the JAX reduction of the Gaussian
decoder's log_sigma gradient, 3.0e-5 off float64; the port's 1.1e-7).
Torch runs on one thread, as the suite's other files do.
"""
import copy
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import video_gcp_tpu.data.configs.nav_25rooms_long as j_long_data
import video_gcp_torch.data.configs.nav_25rooms_long as t_long_data
from test_torch_sequential import StepNoise
from test_torch_train import (
    GRAD_TOL,
    KEY,
    LOSS_TOL,
    LR,
    PARAM_TOL,
    _compare_grads,
    _compare_losses,
    _compare_params,
    _jax_batch,
    _jax_grad_fn,
    _seeded_params,
    _torch_batch,
)
from test_torch_tree import TOLS, _max_diff
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.data import datasets as t_ds
from video_gcp_torch.evaluation import eval_binding as t_eb
from video_gcp_torch.ops import dtw as t_dtw
from video_gcp_torch.ops.cdist import batch_cdist
from video_gcp_torch.ops.tree_index import breadthfirst2depthfirst
from video_gcp_torch.parallel.train_step import make_optimizer, train_step
from video_gcp_torch.planning.run import load_control_config as p_load_control_config
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_torch.training.config import build_hparams, load_config
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.data import datasets as j_ds
from video_gcp_tpu.evaluation import eval_binding as j_eb
from video_gcp_tpu.models.sequential import SequentialModel as JSeq
from video_gcp_tpu.models.tree import TreeModel as JTree
from video_gcp_tpu.ops import dtw as j_dtw
from video_gcp_tpu.parallel import train_step as j_train_step
from video_gcp_tpu.planning.run import load_control_config as j_load_control_config

REPO = Path(__file__).resolve().parent.parent
CONFS = {"gcp_tree": REPO / "experiments/prediction/25room_long/gcp_tree",
         "gcp_sequential": REPO / "experiments/prediction/25room_long/gcp_sequential"}
DATA_GEN = "experiments/data_gen/nav_25rooms_long/mod_hyper.py"
B, T, L, IMG, NZ = 2, 500, 9, 8, 8
N_NODES = 2 ** L - 1
END_IND = np.array([T - 1, 217], np.int32)
WIDTHS = dict(img_sz=IMG, ngf=8, nz_mid_lstm=16, nz_mid=16, nz_enc=16, nz_vae=NZ,
              n_lstm_layers=2, batch_size=B)
DIST_TOL = 1e-6  # tests/test_torch_dtw.py


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hp(name):
    """The trainer's hparams of the config (build_hparams), cut in width."""
    hp = build_hparams(load_config(CONFS[name]))
    hp.overwrite(WIDTHS)
    return dict(hp)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    seq = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    pad = (np.arange(T)[None] <= END_IND[:, None]).astype(np.float32)
    return dict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[np.arange(B), END_IND], end_ind=END_IND,
                pad_mask=pad, actions=(rng.randn(B, T - 1, 2) * 0.1).astype(np.float32),
                traj_seq_states=rng.rand(B, T, 2).astype(np.float32))


def _pair(name):
    """The JAX model with seeded params, and the port's twin of it."""
    hp = _hp(name)
    jmodel = (JTree if name == "gcp_tree" else JSeq)(hp=hp)
    params = _seeded_params(jmodel, _jax_batch(_batch()))
    tmodel = load_config(CONFS[name]).configuration["model"](hp)
    tmodel.load_state_dict(flax_to_torch(params), strict=True)  # no key left over
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def tree():
    return _pair("gcp_tree")


def test_configs_keep_depth_and_horizon():
    tree_hp, seq_hp = _hp("gcp_tree"), _hp("gcp_sequential")
    assert (tree_hp["hierarchy_levels"], tree_hp["max_seq_len"], tree_hp["untied_layers"],
            tree_hp["matching_type"], tree_hp["regress_length"]) == (L, T, False, "balanced", True)
    assert (seq_hp["hierarchy_levels"], seq_hp["max_seq_len"]) == (0, T)
    conf = load_config(CONFS["gcp_tree"]).configuration
    assert conf["metric_pruning_scheme"] == "pruned_dtw"
    assert [(s["dataset_name"], s["max_seq_len"]) for s in conf["dataset_sweep_specs"]] == [
        ("nav_9rooms", 100), ("nav_25rooms_long", T)]


def test_l9_prior_rollout_matches_jax(tree):
    """The tied L=9 tree's 'test'/'prior' rollout with 511 injected latents
    per example, per tree level (the JAX error grows with depth)."""
    jmodel, params, tmodel = tree
    batch = _batch()
    inputs = dict(I_0=batch["I_0"], I_g=batch["I_g"], end_ind=END_IND,
                  z=np.random.RandomState(1).randn(B, N_NODES, NZ).astype(np.float32))
    j_out = jax.jit(lambda p, i: jmodel.apply(p, i, "test", "prior", False,
                                              rngs={"sample": KEY}))(params, _jax_batch(inputs))
    with torch.no_grad():
        t_out = tmodel.eval()(_torch_batch(inputs), phase="test", mode="prior")
    assert t_out.tree.images.shape == (B, N_NODES, IMG, IMG, 3)
    assert t_out.seq_len_logits.shape == (B, T)
    per_level = {}
    for k in ("images", "e_g_prime"):
        got, want = t_out.tree[k], np.asarray(j_out.tree[k])
        per_level[k] = [_max_diff(got[:, 2 ** lv - 1:2 ** (lv + 1) - 1],
                                  want[:, 2 ** lv - 1:2 ** (lv + 1) - 1]) for lv in range(L)]
        assert max(per_level[k]) < TOLS[k], (k, per_level[k])
    for k in ("existence_logits", "seq_len_logits"):
        per_level[k] = _max_diff(t_out[k], j_out[k])
        assert per_level[k] < TOLS[k], (k, per_level[k])
    print("L=9 prior rollout, max abs diff", per_level)


def _step_matches_jax(monkeypatch, jmodel, params, tmodel, expected):
    """One train step of the port (train_step) against JAX's loss, gradients
    and make_train_step's RAdam update on them, with StepNoise."""
    batch = _batch()
    noise = StepNoise(monkeypatch)
    (j_total, j_losses), j_grads = _jax_grad_fn(jmodel)(params, _jax_batch(batch))
    j_calls = len(noise.calls)
    opt = make_optimizer([p for p in tmodel.parameters() if p.requires_grad],
                         "radam", LR, None, 0, 0.9)
    t_met = train_step(tmodel.train(), opt, _torch_batch(batch), 0, torch.Generator())
    assert set(j_losses) == expected
    diffs = _compare_losses({k: t_met[k] for k in expected}, j_losses, LOSS_TOL)
    assert abs(float(t_met.total) - float(j_total)) <= LOSS_TOL * max(1.0, abs(float(j_total)))
    grad_d, worst = _compare_grads(tmodel, j_grads, GRAD_TOL)
    tx = j_train_step.make_optimizer("radam", LR, None, 0, 0.9)
    step = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    param_d = _compare_params(tmodel, step(j_grads, params), opt, 1)
    assert param_d < PARAM_TOL
    print("losses", max(diffs.values()), "worst gradient", grad_d, worst, "parameters", param_d)
    return noise.calls[:j_calls], noise.calls[j_calls:]


def test_l9_tree_train_step_matches_jax(monkeypatch, tree):
    jmodel, params, tmodel = tree
    j_calls, t_calls = _step_matches_jax(
        monkeypatch, jmodel, params, copy.deepcopy(tmodel),  # the step moves its weights
        {"dense_img_rec", "kl", "entropy", "existence_predictor", "seq_len", "nll", "total"})
    assert j_calls == t_calls == ["normal"] * L  # one posterior draw per level


def test_vrnn_t500_train_step_matches_jax(monkeypatch):
    j_calls, t_calls = _step_matches_jax(
        monkeypatch, *_pair("gcp_sequential"), {"dense_img_rec", "kl", "seq_len", "nll", "total"})
    assert t_calls == ["normal"] * (T - 1)  # one draw a step; the JAX scan traced its cell
    assert set(j_calls) == {"normal"}


def test_pruned_dtw_at_511_nodes_and_500_frames_matches_jax():
    rng = np.random.RandomState(2)
    images = (rng.rand(B, N_NODES, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    keep = rng.rand(B, N_NODES) < 0.6
    keep[:, 0] = True
    traj = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    t_out = AttrDict(tree=AttrDict(images=torch.from_numpy(images)),
                     prune_keep=torch.from_numpy(keep), end_ind=torch.from_numpy(END_IND))
    t_in = AttrDict(traj_seq=torch.from_numpy(traj), end_ind=torch.from_numpy(END_IND))
    j_out = JAttrDict(tree=JAttrDict(images=jnp.asarray(images)),
                      prune_keep=jnp.asarray(keep), end_ind=jnp.asarray(END_IND))
    j_in = JAttrDict(traj_seq=jnp.asarray(traj), end_ind=jnp.asarray(END_IND))
    got = t_eb.dense_sample(t_out, t_in, "pruned_dtw", T).numpy()
    want = np.asarray(j_eb.tree_dense_sample(j_out, j_in, "pruned_dtw", T))
    assert got.shape == (B, T, IMG, IMG, 3)
    np.testing.assert_array_equal(got, want)
    # the DTW under it: the kept nodes (df order, compacted) against the frames
    kept = t_eb._compact_selected_df(breadthfirst2depthfirst(t_out.tree.images),
                                     t_out.prune_keep)
    assert kept.shape[1] == N_NODES
    cost = batch_cdist(kept, t_in.traj_seq, "mean")
    np.testing.assert_array_equal(t_dtw.min_cumsum(cost).numpy(),
                                  np.asarray(j_dtw.min_cumsum(jnp.asarray(cost.numpy()))))
    inds, dist = t_dtw.batched_dtw_alignment(cost, t_in.end_ind)
    j_inds, j_dist = j_dtw.batched_dtw_alignment(jnp.asarray(cost.numpy()), j_in.end_ind)
    np.testing.assert_array_equal(inds.numpy(), np.asarray(j_inds))
    assert np.abs(dist.numpy() - np.asarray(j_dist)).max() < DIST_TOL


def _expert_rollout(load, seed):
    """One trajectory of the data_gen config's agent and PRM policy."""
    conf = load(str(REPO / DATA_GEN))
    agent_conf = dict(conf["agent"])
    agent = agent_conf.pop("type")(agent_conf)
    policy = conf["policy"]
    policy_conf = {k: v for k, v in policy.items() if k != "type"}
    np.random.seed(seed)
    return agent.sample(policy["type"](dict(agent._hp), policy_conf,
                                       **agent.env.env_policy_params()), 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_prm_expert_nav_25rooms_long_trajectory_equals_jax(seed):
    _, p_obs, p_out = _expert_rollout(p_load_control_config, seed)
    _, j_obs, j_out = _expert_rollout(j_load_control_config, seed)
    assert 1 < len(p_out) == len(j_out) <= T
    assert np.array_equal(np.stack([o["actions"] for o in p_out]),
                          np.stack([o["actions"] for o in j_out]))
    for key in ("images", "state", "qpos_full"):
        assert np.array_equal(p_obs[key], j_obs[key]), key
    assert p_obs["images"].shape == (len(p_out) + 1, 1, 64, 64, 3)


def _write_long_files(root, n_files=6):
    """Variable-length trajectories as the data generation writes them: one
    a file, 64x64 frames, padded to T + 1 frames with a pad mask, the
    shortest 104 frames long and the longest T + 1."""
    rng = np.random.RandomState(0)
    for i in range(n_files):
        n = 104 + (T + 1 - 104) * i // (n_files - 1)
        pad = (np.arange(T + 1) < n).astype(np.float64)
        with h5py.File(root / f"traj_{i}.h5", "w") as f:
            f.create_dataset("traj_per_file", data=1)
            f.create_dataset("traj0/images", data=rng.randint(
                0, 256, (T + 1, 1, 64, 64, 3), np.uint8) * pad[:, None, None, None, None].astype(
                np.uint8))
            f.create_dataset("traj0/states", data=rng.uniform(-0.4, 0.4, (T + 1, 5)) * pad[:, None])
            f.create_dataset("traj0/actions", data=rng.randn(T, 2) * 0.1 * pad[1:, None])
            f.create_dataset("traj0/pad_mask", data=pad)


@pytest.mark.parametrize("phase, randomize", [("train", False), ("train", True),
                                              ("val", False)])
def test_nav_25rooms_long_dataset_matches_jax(tmp_path, phase, randomize):
    """GlobalSplitVarLenVideoDataset with both packages' nav_25rooms_long
    configs unchanged (max_seq_len 500, split 0.97 / 0.03: 5 of the 6 files
    in train, 1 in val) at the trainer's img_sz 32."""
    _write_long_files(tmp_path)
    mpar = dict(img_sz=32, randomize_length=randomize, randomize_start=randomize)
    jset = j_ds.GlobalSplitVarLenVideoDataset(str(tmp_path), dict(mpar), j_long_data.config,
                                              phase)
    tset = t_ds.GlobalSplitVarLenVideoDataset(str(tmp_path), dict(mpar), t_long_data.config,
                                              phase)
    jset._rng, tset._rng = np.random.RandomState(7), np.random.RandomState(7)
    assert jset.filenames == tset.filenames
    assert len(tset) == (5 if phase == "train" else 1)
    for i in range(len(tset)):
        jex, tex = jset[i], tset[i]
        assert set(jex) == set(tex)
        for k in jex:
            j, t = np.asarray(jex[k]), np.asarray(tex[k])
            assert j.shape == t.shape and j.dtype == t.dtype, (k, j.shape, t.shape)
            np.testing.assert_array_equal(j, t, err_msg=k)
        assert tex.traj_seq.shape == (T, 32, 32, 3)
        assert tex.pad_mask.sum() == tex.end_ind + 1
