"""The adaptive GCP-tree of the PyTorch port (soft-DTW binding, attentive
inference) against the JAX package, in f32 on the CPU, with the same
parameters, the same batch and the same noise (`SharedNoise` of
tests/test_torch_train.py: seeded numpy draws replace `Gaussian.sample` and
the uniform draws on both sides).

- The small adaptive tree of tests/test_models.py (L=4, dtw_image, attentive
  inference, conv seq_enc, tree_lstm='sum', 16x16 images, T=10), with a
  length predictor as the 9-room config has, and its variants: dtw_latent;
  the learned matching temperature; the segment-masked attention; two heads
  and two attention layers; top and leaves biases. Held: gt_match_dists and
  the attention weights gamma (1e-5 absolute), the distance logits (1e-5 of
  max(1, |x|)), prune_keep where decided, every loss term with the
  stability gap (1e-5 relative to max(1, |value|)), and the gradient of
  every parameter (1e-4 of each tensor's largest). Parameters after 1 and 6
  RAdam steps within 1e-6 beyond RAdam's stated eps term
  (tests/test_torch_train.py:_compare_params).
- The JAX package cannot build a model with learn_matching_temp=True: its
  AdaptiveBinding.matching_temp calls `self.param` outside setup, which
  flax refuses (ROADMAP.md section 3). That variant is held against the JAX
  model with the same temperature as a constant, which is what the learned
  one computes: the DP is detached, so log_temp gets no gradient.
- A 'test'/'prior' rollout with injected z.
- The 9-room gcp_adaptive config at full width through the port's
  load_config, a seeded JAX init loaded with strict=True, one train step at
  B=2, T=100 against JAX's value_and_grad: losses 1e-4 relative,
  gradients 2e-3 of each tensor's largest (the ep74 tolerances of
  tests/test_torch_train.py), gt_match_dists 1e-4 absolute. Both f32
  gradients are also held against the port in float64 (2e-3), and the
  largest departure of the port's is located in encoder conv 3's output.
- gcp_adaptive_dlm (loaded through the port's load_config, although its
  conf loads its base by path): adaptive binding with the DLM decoder
  raises in both packages.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (
    GRAD_TOL,
    GRAD_TOL_EP74,
    KEY,
    LOSS_TOL_EP74,
    SharedNoise,
    _compare_grads,
    _compare_losses,
    _compare_params,
    _jax_batch,
    _seeded_params,
    _torch_batch,
)
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.tree import TreeModel as TorchTree
from video_gcp_torch.parallel.train_step import make_optimizer, train_step
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_torch.training.config import build_hparams, load_config
from video_gcp_tpu.data.datasets import RandomVideoDataset as JRandomVideoDataset
from video_gcp_tpu.models.hyperparameters import default_hparams
from video_gcp_tpu.models.tree import TreeModel as JaxTree
from video_gcp_tpu.parallel import train_step as j_train_step

B, T, IMG, DEPTH, LR = 2, 10, 16, 4, 1e-3
OUT_TOL = 1e-5  # gt_match_dists and gamma (absolute), distance logits
SMALL = dict(batch_size=B, max_seq_len=T, img_sz=IMG, hierarchy_levels=DEPTH,
             matching_type="dtw_image", attentive_inference=True,
             learn_matching_temp=False, seq_enc="conv", tree_lstm="sum",
             regress_length=True, decoder_distribution="gaussian")
VARIANTS = {
    "dtw_image": {},
    "dtw_latent": dict(matching_type="dtw_latent"),
    "learned_temp": dict(learn_matching_temp=True, matching_temp=0.5),
    "masked_attention": dict(mask_inf_attention=True),
    "two_heads_two_layers": dict(n_attention_heads=2, n_attention_layers=2),
    "biases": dict(top_bias=0.5, n_top_bias_nodes=3, leaves_bias=0.1),
}


def _small_hp(variant, jax_side=False):
    hp = default_hparams()
    hp.overwrite(SMALL)
    over = dict(VARIANTS[variant])
    if jax_side and over.get("learn_matching_temp"):
        over["learn_matching_temp"] = False  # the constant it learns from
    hp.overwrite(over)
    return dict(hp)


def _small_batch(seed=0):
    rng = np.random.RandomState(seed)
    seq = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    end_ind = np.array([T - 1, 6], np.int32)
    pad = (np.arange(T)[None] <= end_ind[:, None]).astype(np.float32)
    return dict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[np.arange(B), end_ind],
                end_ind=end_ind, start_ind=np.zeros(B, np.int32), pad_mask=pad)


def _pair(variant, batch):
    """The JAX model with seeded params, and the port's twin of it."""
    jmodel = JaxTree(hp=_small_hp(variant, jax_side=True))
    params = _seeded_params(jmodel, _jax_batch(batch))
    hp = _small_hp(variant)
    tmodel = TorchTree(hp)
    state = flax_to_torch(params)
    if hp["learn_matching_temp"]:
        state["binding.log_temp"] = torch.tensor(math.log(hp["matching_temp"]))
    tmodel.load_state_dict(state, strict=True)
    return jmodel, params, tmodel


def _jax_outputs_fn(model, phase="train", mode="posterior"):
    def loss_fn(params, batch):
        out = model.apply(params, batch, phase, mode, rngs={"sample": KEY})
        return out.losses.total.value, (
            out.losses, out.gt_match_dists, out.tree.gamma,
            out.distance_logits, out.prune_keep)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _check_prune(t_logits, t_keep, j_logits, j_keep):
    t_logits = t_logits.detach().numpy()
    np.testing.assert_array_less(np.abs(t_logits - np.asarray(j_logits)),
                                 OUT_TOL * np.maximum(1.0, np.abs(j_logits)))
    decided = np.abs(np.asarray(j_logits)) > 1e-4  # sigmoid(l) > 0.5 <=> l > 0
    np.testing.assert_array_equal(t_keep.numpy()[:, 1:][decided],
                                  np.asarray(j_keep)[:, 1:][decided])
    assert t_keep[:, 0].all() and bool(np.asarray(j_keep)[:, 0].all())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_small_adaptive_step_matches_jax(monkeypatch, variant):
    batch = _small_batch()
    jmodel, params, tmodel = _pair(variant, batch)
    noise = SharedNoise(monkeypatch)
    (j_total, (j_losses, j_w, j_gamma, j_dist, j_keep)), j_grads = noise.run(
        _jax_outputs_fn(jmodel), params, _jax_batch(batch))
    out = noise.run(lambda: tmodel(_torch_batch(batch), phase="train",
                                   mode="posterior", generator=torch.Generator()))
    out.losses.total.value.backward()

    t_values = {k: v.value for k, v in out.losses.items()}
    assert set(t_values) == {"dense_img_rec", "kl", "entropy", "distance_predictor",
                             "soft_dtw_stability_gap", "seq_len", "nll", "total"}
    loss_d = _compare_losses(t_values, j_losses)
    assert out.losses.soft_dtw_stability_gap.weight == 0.0
    w = out.gt_match_dists.numpy()
    np.testing.assert_allclose(w, np.asarray(j_w), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(w.sum(1)[0], 1.0, atol=1e-3)  # frames up to end
    np.testing.assert_allclose(w.sum(1)[1, 7:], 0.0, atol=1e-6)  # past end 6
    gamma = out.tree.gamma.detach().numpy()
    assert gamma.shape == (B, 2 ** DEPTH - 1, T)
    np.testing.assert_allclose(gamma, np.asarray(j_gamma), atol=OUT_TOL, rtol=0)
    _check_prune(out.distance_logits, out.prune_keep, j_dist, j_keep)

    if "learn_matching_temp" in VARIANTS[variant]:
        # no gradient reaches log_temp through the detached DP
        assert tmodel.binding.log_temp.grad is None
        tmodel.binding.log_temp.grad = torch.zeros(())
        j_grads["params"]["binding"] = dict(j_grads["params"]["binding"],
                                            log_temp=np.zeros((), np.float32))
    grad_d, name = _compare_grads(tmodel, j_grads, GRAD_TOL)
    print(variant, "loss", max(loss_d.values()), "grad", grad_d, name,
          "w", np.abs(w - np.asarray(j_w)).max())
    assert [len(noise.draws[k]) for k in ("normal", "uniform")] == [DEPTH, 0]


def test_small_adaptive_steps_match_jax(monkeypatch):
    """Parameters after 1 and after 6 RAdam steps (6 pass RAdam's rho > 5
    switch); the losses of every step."""
    batch = _small_batch()
    jmodel, params, tmodel = _pair("two_heads_two_layers", batch)
    noise = SharedNoise(monkeypatch)
    state = j_train_step.TrainState.create(
        params, j_train_step.make_optimizer("radam", LR, None, 0, 0.9))
    j_step = j_train_step.make_train_step(jmodel)
    opt = make_optimizer([p for p in tmodel.parameters() if p.requires_grad],
                         "radam", LR, None, 0, 0.9)
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    gen = torch.Generator().manual_seed(0)
    diffs = {}
    for i in range(6):
        if i == 0:  # the jitted step draws while it is traced
            state, j_met = noise.run(j_step, state, jb, KEY)
        else:
            state, j_met = j_step(state, jb, KEY)
        t_met = noise.run(train_step, tmodel, opt, tb, i, gen)
        j_met = jax.device_get(j_met)
        _compare_losses(t_met, {k: v for k, v in j_met.items()
                                if np.ndim(v) == 0 and k != "grads_finite"})
        assert bool(t_met.grads_finite) and bool(j_met["grads_finite"])
        if i in (0, 5):
            diffs[i + 1] = _compare_params(tmodel, state.params, opt, i + 1)
    print("param diff after 1 and 6 steps", diffs)


def test_small_adaptive_prior_rollout_with_injected_z():
    batch = _small_batch()
    jmodel, params, tmodel = _pair("dtw_image", batch)
    rng = np.random.RandomState(3)
    z = rng.randn(B, 2 ** DEPTH - 1, default_hparams()["nz_vae"]).astype(np.float32)
    inputs = dict(I_0=batch["I_0"], I_g=batch["I_g"], end_ind=batch["end_ind"], z=z)
    j_out = jax.jit(lambda p, i: jmodel.apply(p, i, "test", "prior",
                                              rngs={"sample": KEY}))(
        params, _jax_batch(inputs))
    with torch.no_grad():
        t_out = tmodel(_torch_batch(inputs), phase="test", mode="prior")
    assert len(t_out.losses) == 0 and "gamma" not in t_out.tree
    for k in ("images", "e_g_prime"):
        np.testing.assert_allclose(t_out.tree[k].numpy(), np.asarray(j_out.tree[k]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_out.tree.match_timesteps.numpy(),
                               np.asarray(j_out.tree.match_timesteps), atol=1e-6)
    _check_prune(t_out.distance_logits, t_out.prune_keep, j_out.distance_logits,
                 j_out.prune_keep)


def test_too_few_nodes_raises_at_build():
    hp = default_hparams()
    hp.overwrite(dict(SMALL, hierarchy_levels=3))  # 7 nodes for 10 frames
    with pytest.raises(ValueError, match="max_seq_len"):
        TorchTree(dict(hp))


# ---------------------------------------------------------------------------
# the 9-room adaptive model at full width
# ---------------------------------------------------------------------------

CONF = "experiments/prediction/9room/gcp_adaptive"


def _nav_batch(hp, data_conf):
    dset = JRandomVideoDataset(None, dict(hp), data_conf, "train")
    items = [dset[i] for i in (0, 1)]
    return {k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]}


def test_gcp_adaptive_train_step_matches_jax(monkeypatch):
    bundle = load_config(CONF)
    hp = build_hparams(bundle)
    assert (hp["matching_type"], hp["attentive_inference"], hp["hierarchy_levels"],
            hp["learn_matching_temp"]) == ("dtw_image", True, 7, False)
    tmodel = bundle.configuration["model"](hp)
    jmodel = JaxTree(hp=dict(hp))
    batch = _nav_batch(hp, bundle.data_conf)
    assert batch["traj_seq"].shape == (2, 100, 32, 32, 3)
    assert list(batch["end_ind"]) != [99, 99]  # mixed ends reach the DP
    params = _seeded_params(jmodel, _jax_batch(batch))
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    tmodel.train()
    model64 = bundle.configuration["model"](hp)
    model64.load_state_dict(flax_to_torch(params), strict=True)
    model64 = model64.to(torch.float64).train()
    seq_grads = {}  # gradient at encoder conv 3's output for the 200 frames
    for model in (tmodel, model64):
        def keep(mod, args, out, dtype=model.dtype):
            if out.shape[0] == batch["traj_seq"].shape[0] * batch["traj_seq"].shape[1]:
                out.register_hook(lambda g: seq_grads.__setitem__(dtype, g.double()))
        model.encoder.conv[3].register_forward_hook(keep)

    noise = SharedNoise(monkeypatch)
    (j_total, (j_losses, j_w, j_gamma, _, _)), j_grads = noise.run(
        _jax_outputs_fn(jmodel), params, _jax_batch(batch))
    out = noise.run(lambda: tmodel(_torch_batch(batch), phase="train",
                                   mode="posterior", generator=torch.Generator()))
    out.losses.total.value.backward()
    t_values = {k: v.value for k, v in out.losses.items()}
    loss_d = _compare_losses(t_values, j_losses, LOSS_TOL_EP74)
    grad_d, name = _compare_grads(tmodel, j_grads, GRAD_TOL_EP74)
    w_d = np.abs(out.gt_match_dists.numpy() - np.asarray(j_w)).max()
    gamma_d = np.abs(out.tree.gamma.detach().numpy() - np.asarray(j_gamma)).max()
    print("gcp_adaptive losses", {k: float(v.detach()) for k, v in t_values.items()})
    print("gcp_adaptive loss rel diffs", loss_d, "grad", grad_d, name,
          "gt_match_dists", w_d, "gamma", gamma_d)
    assert w_d < 1e-4 and gamma_d < 1e-4
    assert np.isfinite(float(j_total))

    # both f32 gradients against the port in float64, with the same noise:
    # each framework's own f32 error, and where the port's is largest
    out64 = noise.run(lambda: model64(_torch_batch(batch), phase="train",
                                      mode="posterior", generator=torch.Generator()))
    out64.losses.total.value.backward()
    want_j = flax_to_torch(jax.device_get(j_grads))
    ref = dict(model64.named_parameters())
    err = {}
    for n, p in tmodel.named_parameters():
        g64 = ref[n].grad
        if g64 is None:  # unused, such as the last layer's query refinement
            assert p.grad is None, n
        else:
            scale = max(1e-3, float(g64.abs().max()))
            err[n] = (float((p.grad.double() - g64).abs().max()) / scale,
                      float((want_j[n].double() - g64).abs().max()) / scale)
    port_w = max(err, key=lambda n: err[n][0])
    jax_w = max(err, key=lambda n: err[n][1])
    d = (seq_grads[torch.float32] - seq_grads[torch.float64]).abs()
    d = d / seq_grads[torch.float64].abs().max()
    groups = d.reshape(d.shape[0], 8, -1).amax(-1)  # 8 GroupNorm groups of 16 ch
    top = groups.flatten().topk(2)
    print(f"f32 gradients vs the port in float64 (relative to each tensor's largest): "
          f"port worst {err[port_w][0]:.3g} ({port_w}, JAX there {err[port_w][1]:.3g}), "
          f"JAX worst {err[jax_w][1]:.3g} ({jax_w})")
    print(f"encoder conv 3 output, sequence frames: port f32 vs f64 worst group "
          f"{top.values[0].item():.3g} (frame, group "
          f"{divmod(top.indices[0].item(), 8)}, "
          f"{int((d > 1e-3).sum())} elements above 1e-3), next group "
          f"{top.values[1].item():.3g}")
    assert err[port_w][0] < GRAD_TOL_EP74 and err[jax_w][1] < GRAD_TOL_EP74


def test_gcp_adaptive_dlm_raises_in_both():
    """The adaptive reconstruction loss needs the Gaussian decoder: the JAX
    package asserts it (binding.py:266-268), the port raises ValueError."""
    bundle = load_config("experiments/prediction/9room/gcp_adaptive_dlm")
    # its conf loads gcp_adaptive/conf.py by path: still the port's model
    assert bundle.configuration["model"] is TorchTree
    hp = build_hparams(bundle)
    assert hp["decoder_distribution"] == "discrete_logistic_mixture"
    model = bundle.configuration["model"](hp)
    batch = {k: v[:1] for k, v in _nav_batch(hp, bundle.data_conf).items()}
    with pytest.raises(ValueError, match="decoder_distribution='gaussian'"):
        model(_torch_batch(batch), phase="train", mode="posterior",
              generator=torch.Generator())

    hp_small = default_hparams()
    hp_small.overwrite(dict(SMALL, decoder_distribution="discrete_logistic_mixture"))
    jmodel = JaxTree(hp=dict(hp_small))
    with pytest.raises(AssertionError, match="gaussian"):
        jax.eval_shape(lambda b: jmodel.init({"params": KEY, "sample": KEY}, b,
                                             "train", "posterior"),
                       _jax_batch(_small_batch()))
    with torch.no_grad():  # the prior rollout needs no reconstruction loss
        out = TorchTree(dict(hp_small))(AttrDict(
            I_0=torch.zeros(1, IMG, IMG, 3), I_g=torch.zeros(1, IMG, IMG, 3),
            end_ind=torch.tensor([T - 1])), phase="test", mode="prior",
            generator=torch.Generator())
    assert out.distance_logits.shape == (1, 2 ** DEPTH - 2)


def test_trainer_runs_gcp_adaptive_on_the_cpu(tmp_path, monkeypatch):
    """The trainer on 9room/gcp_adaptive with `--device cpu`: `--resume
    latest` without a checkpoint starts from the port's initialisation; two
    steps of 2 sequences (in place of the 32 of 16 the card runs) train,
    log the stability gap with the other losses, and write weights_ep0."""
    from video_gcp_torch.data.loader import DataLoader
    from video_gcp_torch.training.trainer import ModelTrainer, parse_args

    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path))
    trainer = ModelTrainer(parse_args([
        "--path", CONF, "--feed_random_data", "1", "--num_epochs", "1",
        "--skip_first_val", "1", "--deterministic", "1", "--device", "cpu",
        "--resume", "latest", "--log_outputs_interval", "1"]))
    assert trainer.step == 0 and trainer.start_epoch == 0
    small = DataLoader(trainer.train_loader.dataset, 2, shuffle=False, num_workers=1)
    trainer.train_loader = [batch for _, batch in zip(range(2), small)]
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.run()
    exp = tmp_path / "prediction/9room/gcp_adaptive"
    assert (exp / "weights/weights_ep0/state.pt").is_file() and trainer.step == 2
    events = [json.loads(line) for line in open(exp / "events/events.jsonl")]
    gaps = [e["value"] for e in events if e["tag"] == "train_soft_dtw_stability_gap_loss"]
    totals = [e["value"] for e in events if e["tag"] == "train_total_loss"]
    assert len(gaps) == 2 and all(0 <= g < 1e-3 for g in gaps)
    assert len(totals) == 2 and all(np.isfinite(totals))
    assert any(not torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
