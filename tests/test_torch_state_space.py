"""`use_convs=False` state-space models of the PyTorch port against the JAX
package, on the CPU: flat state vectors [..., input_nc] in place of images,
encoded and decoded by `MLPEncoder` and `MLPDecoder` (JAX
models/base.py:38-60) in the tree and in the sequential VRNN.

- `MLPEncoder` and `MLPDecoder` alone on seeded weights.
- The bridge: the flax parameters of both models load strictly, the MLPs'
  `encoder/MLP_0/Dense_k` as `encoder.mlp.0.dense.k`.
- The prior rollout with injected z ('test' and 'plan').
- One train step with the same noise (`SharedNoise` for the tree,
  `StepNoise` for the VRNN): every loss term and every gradient.
- The Evaluator with `use_images=False`: one sample's per-frame vector MSE,
  dense prediction and nodes, then the protocol (one sample, 'basic') to
  its summary and results file, with no sequence dumps.
- The trainer on a state-space config: no image metrics in validation.

Tolerances (f32): outputs 1e-5 absolute; loss terms 1e-5 relative to
max(1, |value|); gradients 1e-4 relative to max(1e-3, max |jax|) per
parameter (tests/test_torch_train.py's); metrics 1e-5 relative to
max(1, |value|).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sequential import REPO, StepNoise, _experiments
from test_torch_train import KEY, SharedNoise, _jax_batch, _seeded_params, _torch_batch
from test_torch_variants import _max_diff, _train_step_matches
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.evaluation.evaluator import Evaluator
from video_gcp_torch.models.base import MLPDecoder, MLPEncoder
from video_gcp_torch.models.sequential import SequentialModel as TorchSeq
from video_gcp_torch.models.tree import TreeModel as TorchTree
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.evaluation.evaluator import Evaluator as JEvaluator
from video_gcp_tpu.models import base as j_base
from video_gcp_tpu.models.hyperparameters import default_hparams
from video_gcp_tpu.models.sequential import SequentialModel as JaxSeq
from video_gcp_tpu.models.tree import TreeModel as JaxTree

B, T, D, NZ_VAE, L = 2, 8, 2, 4, 3
OUT_TOL = 1e-5
METRIC_TOL = 1e-5
COMMON = dict(batch_size=B, max_seq_len=T, use_convs=False, input_nc=D, state_dim=D,
              nz_enc=16, nz_mid=32, nz_vae=NZ_VAE, nz_mid_lstm=32, n_lstm_layers=2,
              decoder_distribution="gaussian", regress_length=True,
              attach_inv_mdl=True, inv_mdl_params=dict(n_actions=2), n_actions=2)
MODELS = {
    "tree": (JaxTree, TorchTree, dict(hierarchy_levels=L, matching_type="balanced",
                                      seq_enc="conv", tree_lstm="split_linear",
                                      lstm_init="mlp")),
    "sequential": (JaxSeq, TorchSeq, dict(hierarchy_levels=0, one_step_planner="continuous",
                                          dense_rec_type="svg")),
}


def _hp(kind, **over):
    hp = default_hparams()
    hp.overwrite(COMMON)
    hp.overwrite(MODELS[kind][2])
    hp.overwrite(over)
    return dict(hp)


def _batch(seed=0):
    """State sequences: a random walk in [0, 1]^2, the second one shorter."""
    rng = np.random.RandomState(seed)
    seq = np.cumsum(rng.randn(B, T, D) * 0.1, axis=1).astype(np.float32) + 0.5
    end_ind = np.array([T - 1, T - 3], np.int32)
    pad = (np.arange(T)[None] <= end_ind[:, None]).astype(np.float32)
    return dict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[np.arange(B), end_ind],
                end_ind=end_ind, pad_mask=pad,
                actions=(rng.randn(B, T - 1, 2) * 0.1).astype(np.float32),
                traj_seq_states=seq.copy())


def _pair(kind, batch, **over):
    jcls, tcls, _ = MODELS[kind]
    hp = _hp(kind, **over)
    jmodel = jcls(hp=hp)
    params = _seeded_params(jmodel, _jax_batch(batch))
    tmodel = tcls(hp)
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    return jmodel, params, tmodel


def _z(kind, seed=3):
    n = 2 ** L - 1 if kind == "tree" else T
    return np.random.RandomState(seed).randn(B, n, NZ_VAE).astype(np.float32)


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_mlp_encoder_and_decoder_match_flax(which):
    hp = _hp("tree")
    rng = np.random.RandomState(0)
    if which == "encoder":
        jmod, port, x = j_base.MLPEncoder(hp), MLPEncoder(hp), rng.randn(5, D)
    else:
        jmod, port, x = j_base.MLPDecoder(hp), MLPDecoder(hp), rng.randn(5, hp["nz_enc"])
    x = x.astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(KEY, jnp.asarray(x)))
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1])))).astype(
            np.float32), shapes)
    port.load_state_dict(flax_to_torch(params), strict=True)
    want = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if which == "encoder":
        assert got[1] is None and want[1] is None
        got, want = got[0], want[0]
    assert got.shape == (5, hp["nz_enc"] if which == "encoder" else D)
    assert _max_diff(got, want) < OUT_TOL


@pytest.mark.parametrize("kind", list(MODELS))
def test_bridge_loads_the_jax_state_space_parameters_strictly(kind):
    jmodel, params, tmodel = _pair(kind, _batch())
    names = set(tmodel.state_dict())
    assert {"encoder.mlp.0.dense.0.weight", "decoder.mlp.0.dense.3.bias"} <= names
    assert not any(n.startswith(("encoder.", "decoder.")) and ("conv" in n or "group_norm" in n)
                   for n in names)
    assert isinstance(tmodel.encoder, MLPEncoder) and isinstance(tmodel.decoder, MLPDecoder)
    assert not tmodel.use_dlm  # Gaussian, whatever decoder_distribution says
    want = flax_to_torch(params)
    for k, v in tmodel.state_dict().items():
        if not k.endswith("bias_ih"):
            assert torch.equal(v, want[k].reshape(v.shape)), k
    # decoder_distribution is ignored without convs, as in the JAX package
    _, _, dlm = _pair(kind, _batch(), decoder_distribution="discrete_logistic_mixture")
    assert not dlm.use_dlm and isinstance(dlm.decoder, MLPDecoder)


@pytest.mark.parametrize("kind", list(MODELS))
@pytest.mark.parametrize("phase", ["test", "plan"])
def test_prior_rollout_with_injected_z_matches_jax(kind, phase):
    batch = _batch()
    jmodel, params, tmodel = _pair(kind, batch)
    inputs = dict({k: batch[k] for k in ("I_0", "I_g", "end_ind")}, z=_z(kind))
    j_out = jax.jit(lambda p, b: jmodel.apply(p, b, phase, "prior", rngs={"sample": KEY}))(
        params, _jax_batch(inputs))
    with torch.no_grad():
        t_out = tmodel(_torch_batch(inputs), phase=phase, mode="prior",
                       generator=torch.Generator().manual_seed(0))
    if kind == "tree":
        assert t_out.tree.images.shape == (B, 2 ** L - 1, D)
        for k in ("images", "e_g_prime"):
            assert _max_diff(t_out.tree[k], j_out.tree[k]) < OUT_TOL, k
    else:
        assert t_out.dense_rec.images.shape == (B, T, D)
        for k in ("images", "encodings"):
            assert _max_diff(t_out.dense_rec[k], j_out.dense_rec[k]) < OUT_TOL, k
    if phase == "plan":
        for k in ("timeline_images", "timeline_latents", "actions"):
            assert _max_diff(t_out[k], j_out[k]) < OUT_TOL, k


@pytest.mark.parametrize("kind", list(MODELS))
def test_train_step_matches_jax(monkeypatch, kind):
    batch = _batch()
    jmodel, params, tmodel = _pair(kind, batch)
    t_met, j_losses = _train_step_matches(
        monkeypatch, jmodel, params, tmodel, batch,
        SharedNoise if kind == "tree" else StepNoise)
    assert {"dense_img_rec", "kl", "total"} <= set(j_losses)
    worst = max(abs(float(t_met[k]) - float(v.value)) / max(1.0, abs(float(v.value)))
                for k, v in j_losses.items())
    print(kind, "worst loss term", worst)
    assert bool(t_met.grads_finite) and float(t_met.grad_norm) > 0


def _eval_batch(kind):
    batch = _batch(1)
    return dict({k: batch[k] for k in ("traj_seq", "I_0", "I_g", "end_ind", "pad_mask")},
                z=_z(kind, 4))


@pytest.mark.parametrize("kind", list(MODELS))
def test_evaluator_without_images_matches_jax(kind, tmp_path):
    batch = _eval_batch(kind)
    jmodel, params, tmodel = _pair(kind, _batch())
    tmodel.eval()
    ev = Evaluator(tmodel, str(tmp_path / "t"), {}, T, "basic", top_of_100=False,
                   use_images=False)
    j_ev = JEvaluator(jmodel, str(tmp_path / "j"), {}, T, "basic", top_of_100=False,
                      use_images=False)
    t_in = AttrDict({k: torch.from_numpy(v) for k, v in batch.items()})
    j_in = JAttrDict({k: jnp.asarray(v) for k, v in batch.items()})
    m, gen, full = ev._eval_sample(t_in, torch.Generator().manual_seed(0))
    j_m, j_gen, j_full = j_ev._eval_sample(params, j_in, KEY)
    assert set(m) == set(j_m) == {"mse"} and m.mse.shape == (B,)
    assert gen.shape == (B, T, D)
    assert _max_diff(gen, j_gen) < OUT_TOL and _max_diff(full, j_full) < OUT_TOL
    want = np.asarray(j_m["mse"], np.float64)
    assert (np.abs(m.mse.numpy() - want) / np.maximum(1.0, np.abs(want))).max() < METRIC_TOL

    # the protocol: one sample per sequence, the summary and results file
    ev.eval(t_in, torch.Generator().manual_seed(0))
    j_ev.eval(params, j_in, KEY)
    got, want = ev.dump_results(0), j_ev.dump_results(0)
    assert set(got) == set(want) == {"mse"}
    assert abs(got["mse"] - want["mse"]) < METRIC_TOL * max(1.0, abs(want["mse"]))
    files = sorted(os.listdir(tmp_path / "t" / "metrics"))
    assert files == sorted(os.listdir(tmp_path / "j" / "metrics"))
    assert "results_0.txt" in files and not any(f.endswith(".npy") for f in files)


def test_trainer_skips_image_metrics_for_state_space_models(monkeypatch, tmp_path, capsys):
    """A use_convs=False tree trains through ModelTrainer on the random
    data's state sequences, and its val pass logs losses, no PSNR."""
    from video_gcp_torch.training.trainer import ModelTrainer, parse_args
    conf = _experiments(tmp_path, "state_tree", (
        (REPO / "experiments/prediction/toy_random/gcp_tree/conf.py").read_text()
        + "model_config.update(dict(use_convs=False, input_nc=2, nz_mid_lstm=16))\n"))
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    trainer = ModelTrainer(parse_args([
        "--path", str(conf), "--feed_random_data", "1", "--num_epochs", "1",
        "--deterministic", "1", "--device", "cpu", "--resume", "none"]))
    assert isinstance(trainer.model.encoder, MLPEncoder)
    trainer.train_loader.dataset.n_seqs = 8  # 256 random sequences cut to 2 steps
    trainer.val_loader.dataset.n_seqs = 4
    trainer.run()
    out = capsys.readouterr().out
    assert "[val] epoch 0" in out and "psnr" not in out
    assert trainer.step == 2
