"""The GCP-tree prior rollout of the PyTorch port against the JAX TreeModel,
in f32 on the CPU, with the same weights and the same injected latents z.

- A small model (L=3, 16x16 images, narrow widths) in several configurations
  (tied/untied levels, each TreeLSTM fusion, MLP subgoal predictor), with
  weights drawn from a seed into the flax parameter structure.
- The 9-room GCP-tree at full width with the trained ep74 weights, batch 2,
  loaded strictly through `video_gcp_torch.load.load_model`.

The JAX side runs under jax.jit: on a CPU the full-width model then compiles
and runs about eight times faster than eagerly. Torch cannot replay JAX's
random stream, so both sides get z; the predicted length is compared through
its logits and the argmax path (no generator on the port's side).

Tolerances (absolute, f32): differences come from rounding and grow with
tree depth through the recursive LSTM. Against the port run in float64, the
JAX model's own f32 error in e_g_prime reaches ~2.3e-4 at level 6 of ep74
and the port's ~2.6e-5 (checked below), so latents are compared at 5e-4 and
decoded images at 2e-4. Logits are compared at 1e-3 against magnitudes up to
~35. PERF.md lists the measured maxima.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.load import load_model
from video_gcp_torch.models.tree import TreeModel as TorchTree
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.models.hyperparameters import default_hparams
from video_gcp_tpu.models.tree import TreeModel as JaxTree
from video_gcp_tpu.training import checkpoint as j_ckpt
from video_gcp_tpu.training.config import load_config as j_load_config

KEY = jax.random.PRNGKey(0)
CONF = "experiments/prediction/9room/gcp_tree"
WEIGHTS = CONF + "/pretrained_ep74.npz"

TOLS = dict(images=2e-4, e_g_prime=5e-4, timeline_images=2e-4,
            timeline_latents=5e-4, actions=1e-4, regressed_state=1e-4,
            existence_logits=1e-3, seq_len_logits=1e-4)


def _max_diff(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.max(np.abs(a.astype(np.float64) - np.asarray(b, np.float64))))


def _jax_plan(model, params, inputs):
    f = jax.jit(lambda p, i: model.apply(p, i, "plan", "prior", False,
                                         rngs={"sample": KEY}))
    return f(params, JAttrDict({k: jnp.asarray(v) for k, v in inputs.items()}))


def _torch_inputs(inputs):
    return AttrDict({k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()})


def _compare(t_out, j_out, plan=True):
    diffs = {}
    for k in ("images", "e_g_prime"):
        diffs[k] = _max_diff(t_out.tree[k], j_out.tree[k])
    keys = ["existence_logits", "seq_len_logits"]
    if plan:
        keys += ["timeline_images", "timeline_latents", "actions", "regressed_state"]
    for k in keys:
        assert t_out[k].shape == j_out[k].shape, k
        diffs[k] = _max_diff(t_out[k], j_out[k])
    for k, d in diffs.items():
        assert d < TOLS[k], (k, d)
    # keep-mask: equal wherever the logit is not within tolerance of 0
    logits = np.asarray(j_out.existence_logits)
    decided = np.abs(logits) > TOLS["existence_logits"]
    keep_t, keep_j = t_out.prune_keep.numpy(), np.asarray(j_out.prune_keep)
    assert (keep_t[decided] == keep_j[decided]).all()
    assert keep_t[:, 0].all()
    return diffs


# ---------------------------------------------------------------------------
# small model, several configurations
# ---------------------------------------------------------------------------

B, T, IMG, DEPTH = 2, 10, 16, 3
SMALL = dict(batch_size=B, max_seq_len=T, img_sz=IMG, hierarchy_levels=DEPTH,
             matching_type="balanced", regress_length=True,
             attach_state_regressor=True, state_dim=2, attach_inv_mdl=True,
             inv_mdl_params=dict(n_actions=2), attach_cost_mdl=True,
             n_actions=2, seq_enc="conv", one_step_planner="sh_pred",
             decoder_distribution="discrete_logistic_mixture")
VARIANTS = {
    "split_linear_tied": dict(tree_lstm="split_linear", lstm_init="mlp",
                              n_lstm_layers=2),
    "split_linear_untied": dict(tree_lstm="split_linear", lstm_init="mlp",
                                untied_layers=True),
    "linear_zero_init": dict(tree_lstm="linear", lstm_init="zero",
                             separate_cnn_start_goal_encoder=True),
    "sum_untied_gaussian": dict(tree_lstm="sum", untied_layers=True,
                                decoder_distribution="gaussian"),
    "mlp_fixed_prior": dict(tree_lstm="", prior_type="fixed",
                            context_every_step=False, var_inf="deterministic"),
}


def _seeded_params(model, inputs):
    """Weights from a seed in the flax parameter structure of a training
    init (so the inference and cost-model weights exist too)."""
    shapes = jax.eval_shape(
        lambda i: model.init({"params": KEY, "sample": KEY}, i, "train",
                             "posterior"), inputs)
    rng = np.random.RandomState(0)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.randn(*s.shape).astype(np.float32) / np.sqrt(fan_in)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return np.asarray(0.1 * rng.randn(*s.shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _small_inputs(seed=0):
    rng = np.random.RandomState(seed)
    seq = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    return dict(
        traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, -1],
        end_ind=np.array([T - 1, 4], np.int32),
        pad_mask=np.ones((B, T), np.float32),
        actions=rng.rand(B, T - 1, 2).astype(np.float32),
        traj_seq_states=rng.rand(B, T, 2).astype(np.float32),
        z=rng.randn(B, 2 ** DEPTH - 1, 32).astype(np.float32))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_small_tree_matches_jax(variant):
    hp = default_hparams()
    hp.overwrite(SMALL)
    hp.overwrite(VARIANTS[variant])
    jmodel = JaxTree(hp=dict(hp))
    inputs = _small_inputs()
    params = _seeded_params(jmodel, JAttrDict(  # no z: inference weights too
        {k: jnp.asarray(v) for k, v in inputs.items() if k != "z"}))
    plan_inputs = {k: inputs[k] for k in ("I_0", "I_g", "end_ind", "z")}
    j_out = _jax_plan(jmodel, params, plan_inputs)

    tmodel = TorchTree(dict(hp))
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    tmodel.eval()
    with torch.inference_mode():
        t_plan = tmodel(_torch_inputs(plan_inputs), phase="plan")
        # 'test' with the sequence given: same tree, no planner outputs
        t_test = tmodel(_torch_inputs(inputs), phase="test")
    print(variant, _compare(t_plan, j_out))
    _compare(t_test, j_out, plan=False)
    assert "timeline_images" not in t_test and len(t_test.losses) == 0
    assert t_plan.tree.images.shape == (B, 2 ** DEPTH - 1, IMG, IMG, 3)


def test_small_tree_sampling_uses_the_generator():
    hp = default_hparams()
    hp.overwrite(SMALL)
    hp.overwrite(VARIANTS["split_linear_tied"])
    model = TorchTree(dict(hp)).eval()
    inputs = _torch_inputs({k: v for k, v in _small_inputs().items()
                            if k in ("I_0", "I_g")})

    def run(seed):
        with torch.inference_mode():
            return model(inputs, phase="plan", pred_length=True,
                         generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a.tree.images, b.tree.images)
    assert torch.equal(a.end_ind, b.end_ind)
    assert not torch.equal(a.tree.z, c.tree.z)
    assert ((a.end_ind >= 2) & (a.end_ind < T)).all()
    with pytest.raises(ValueError):  # no latents injected, no generator
        model(AttrDict(inputs, end_ind=a.end_ind), phase="test")
    for phase, mode in (("train", "posterior"), ("test", "posterior")):
        with pytest.raises(ValueError, match="traj_seq"):  # posterior needs the sequence
            model(inputs, phase=phase, mode=mode)


def test_non_goal_conditioned_preprocessing():
    """The goal image and the sequence's goal frame are zeroed
    (base_gcp.py:163-175). Not held against JAX through the model: a zero
    image makes every first-level GroupNorm group constant, where the fast
    variance leaves only rounding noise for rsqrt(var + 1e-6) to amplify."""
    hp = default_hparams()
    hp.overwrite(SMALL)
    hp.overwrite(dict(tree_lstm="sum", non_goal_conditioned=True))
    model = TorchTree(dict(hp)).eval()
    inputs = _small_inputs()
    out = model.preprocess_inputs(_torch_inputs(
        {k: inputs[k] for k in ("traj_seq", "I_0", "I_g", "end_ind")}))
    assert not out.I_g.any()
    seq = torch.from_numpy(inputs["traj_seq"])
    for b, end in enumerate(inputs["end_ind"]):
        assert not out.traj_seq[b, end].any()
        assert torch.equal(out.traj_seq[b, :end], seq[b, :end])
    np.testing.assert_array_equal(out.start_ind.numpy(), 0)


# ---------------------------------------------------------------------------
# the trained 9-room model at full width
# ---------------------------------------------------------------------------


def _jax_ep74():
    bundle = j_load_config(CONF)
    hp = default_hparams()
    mc = dict(bundle.model_config)
    mc.setdefault("batch_size", bundle.configuration["batch_size"])
    mc.pop("dataset_class", None)
    hp.override({k: v for k, v in mc.items() if k in hp})
    hp.overwrite({k: v for k, v in mc.items() if k not in hp})
    return bundle.configuration["model"](hp=dict(hp)), j_ckpt.load_pretrained_npz(WEIGHTS)


def test_ep74_full_width_matches_jax():
    tmodel = load_model(CONF, weights=WEIGHTS, device="cpu")  # strict load
    assert len(flax_to_torch(j_ckpt.load_pretrained_npz(WEIGHTS))) == len(
        tmodel.state_dict())
    rng = np.random.RandomState(74)
    b, depth = 2, 7
    inputs = dict(I_0=rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8),
                  I_g=rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8),
                  z=rng.randn(b, 2 ** depth - 1, 256).astype(np.float32))
    with torch.inference_mode():
        # predicted length without a generator: the argmax path
        t_out = tmodel(_torch_inputs(inputs), phase="plan", pred_length=True)
    end_ind = t_out.end_ind.numpy().astype(np.int32)

    jmodel, params = _jax_ep74()
    j_out = _jax_plan(jmodel, params, dict(inputs, end_ind=end_ind))
    logits = np.asarray(j_out.seq_len_logits)
    top2 = np.sort(logits, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > TOLS["seq_len_logits"]).all()  # no tie
    np.testing.assert_array_equal(end_ind, np.maximum(logits.argmax(-1), 2))
    print("ep74", _compare(t_out, j_out))  # max abs diffs, listed in PERF.md
    assert t_out.timeline_images.shape == (b, 100, 32, 32, 3)
    assert t_out.actions.shape == (b, 99, 2)

    # both f32 runs against the port in float64: per tree level, the port's
    # f32 error stays below the reference's own, which sets the tolerances
    model64 = load_model(CONF, weights=WEIGHTS, device="cpu", dtype=torch.float64)
    inputs64 = _torch_inputs(dict(inputs, end_ind=end_ind))
    inputs64.z = inputs64.z.double()
    with torch.inference_mode():
        e64 = model64(inputs64, phase="plan").tree.e_g_prime.numpy()
    e_t, e_j = t_out.tree.e_g_prime.numpy(), np.asarray(j_out.tree.e_g_prime)
    for d in range(depth):
        level = slice(2 ** d - 1, 2 ** (d + 1) - 1)
        err_t = _max_diff(e_t[:, level], e64[:, level])
        err_j = _max_diff(e_j[:, level], e64[:, level])
        print(f"level {d}: |port f32 - f64| {err_t:.2e}  |jax f32 - f64| {err_j:.2e}")
        assert err_t < 1e-4 and err_t <= err_j, (d, err_t, err_j)
