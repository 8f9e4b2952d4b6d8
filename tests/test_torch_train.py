"""The GCP-tree train step of the PyTorch port against the JAX package's
`make_train_step`, in f32 on the CPU, with the same parameters, the same
batch and the same noise.

Torch cannot replay JAX's random stream. The train path draws one normal per
tree level (`Gaussian.sample`), two uniforms for the inverse model's index
pair and two for the cost model's targets. `SharedNoise` replaces exactly
these on both sides with monkeypatch: JAX's `Gaussian.sample` and
`jax.random.uniform`, the port's `Gaussian.sample` and
`distributions.uniform`. The arrays are drawn from a seed with numpy the
first time a draw is made, in call order, and replayed for every later run;
each run must make the same draws, in the same order and shapes, and no
other. The JAX side runs under jax.jit, so its draws happen while tracing.

- Small models (L=3, 16x16 images, narrow widths; DLM and Gaussian decoders;
  tied and untied levels): every loss term, the total, the gradient of every
  parameter, and the parameters after 1 and 6 RAdam steps (6 steps pass
  RAdam's rho > 5 switch, so both of its branches run). Also grads_finite,
  grad_norm and the layerwise KL means.
- A batch with a NaN image: both sides zero every gradient and still step.
- The 9-room GCP-tree at full width from the ep74 weights, B=2, T=100.

Tolerances (f32, reduction orders differ): loss terms 1e-5 relative to
max(1, |value|); gradients max |port - jax| <= 1e-4 * max(1e-3, max |jax|)
per parameter for the small models; parameters after the steps 1e-6
absolute (the update is lr-scaled), except where RAdam's eps placement
differs (see `_compare_params`). ep74: see GRAD_TOL_EP74 below. PERF.md
lists the measured maxima.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import video_gcp_torch.core.distributions as t_dist
import video_gcp_tpu.core.distributions as j_dist
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.load import load_model
from video_gcp_torch.models.tree import TreeModel as TorchTree
from video_gcp_torch.parallel.train_step import make_optimizer, train_step
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.data.datasets import RandomVideoDataset as JRandomVideoDataset
from video_gcp_tpu.models.hyperparameters import default_hparams
from video_gcp_tpu.models.tree import TreeModel as JaxTree
from video_gcp_tpu.parallel import train_step as j_train_step
from video_gcp_tpu.training import checkpoint as j_ckpt
from video_gcp_tpu.training.config import load_config as j_load_config

KEY = jax.random.PRNGKey(0)
LOSS_TOL = 1e-5  # relative to max(1, |value|)
GRAD_TOL = 1e-4  # relative to max(1e-3, max |grad|) of the parameter
PARAM_TOL = 1e-6  # absolute, after the optimizer steps


class SharedNoise:
    """Seeded numpy draws fed to both frameworks in call order."""

    def __init__(self, monkeypatch, seed=0):
        self.rng = np.random.RandomState(seed)
        self.draws = {"normal": [], "uniform": []}
        self.pos = None
        noise = self

        def j_sample(g, key):
            return g.mu + g.sigma * jnp.asarray(noise.take("normal", g.mu.shape))

        def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
            assert (minval, maxval) == (0.0, 1.0)
            return jnp.asarray(noise.take("uniform", shape), dtype)

        def t_sample(g, generator):
            return g.reparametrize(torch.from_numpy(noise.take("normal", g.mu.shape)))

        def t_uniform(shape, generator, device=None):
            return torch.from_numpy(noise.take("uniform", shape))

        monkeypatch.setattr(j_dist.Gaussian, "sample", j_sample)
        monkeypatch.setattr(jax.random, "uniform", j_uniform)
        monkeypatch.setattr(t_dist.Gaussian, "sample", t_sample)
        monkeypatch.setattr(t_dist, "uniform", t_uniform)

    def take(self, kind, shape):
        assert self.pos is not None, f"{kind} draw outside a run"
        queue, i = self.draws[kind], self.pos[kind]
        if i == len(queue):
            make = self.rng.randn if kind == "normal" else self.rng.rand
            queue.append(make(*shape).astype(np.float32))
        assert queue[i].shape == tuple(shape), (kind, i, queue[i].shape, shape)
        self.pos[kind] += 1
        return queue[i]

    def run(self, fn, *args):
        """Call fn with the cursors at 0; every recorded draw must be used."""
        self.pos = {"normal": 0, "uniform": 0}
        try:
            out = fn(*args)
        finally:
            pos, self.pos = self.pos, None
        for kind, queue in self.draws.items():
            assert pos[kind] == len(queue), (kind, pos[kind], len(queue))
        return out


def _jax_batch(batch):
    return JAttrDict({k: jnp.asarray(v) for k, v in batch.items()})


def _torch_batch(batch):
    return AttrDict({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def _rel_diff(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b), initial=0.0))


def _compare_losses(t_metrics, j_losses, tol=LOSS_TOL):
    assert set(t_metrics) >= set(j_losses), (sorted(t_metrics), sorted(j_losses))
    diffs = {}
    for k, term in j_losses.items():
        want = float(term.value if hasattr(term, "value") else term)
        got = float(t_metrics[k].detach())
        diffs[k] = abs(got - want) / max(1.0, abs(want))
        assert diffs[k] < tol, (k, got, want)
    return diffs


def _compare_grads(model, j_grads, tol):
    want = flax_to_torch(jax.device_get(j_grads))
    worst = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:  # LSTM bias_ih: zeros, not a flax parameter
            assert name.endswith("bias_ih") and not p.any()
            continue
        w = want[name].numpy()
        scale = max(1e-3, float(np.abs(w).max()))
        worst[name] = _rel_diff(p.grad, w) / scale
    name = max(worst, key=worst.get)
    assert worst[name] < tol, (name, worst[name])
    assert len(worst) == len(want) - sum(k.endswith("bias_ih") for k in want)
    return worst[name], name


def _compare_params(model, j_params, opt=None, n_steps=1):
    """Parameters after the steps, within PARAM_TOL. One known difference
    is allowed on top: in its rectified steps (rho > 5, from step 6 on)
    torch's RAdam divides by sqrt(v) + eps before the bias correction, i.e.
    by sqrt(v_hat) + eps / sqrt(1 - b2^t), and optax by sqrt(v_hat) + eps.
    That moves a weight by at most 2 lr eps / (sqrt(1 - b2^t) (sqrt(v_hat) +
    eps)) more per such step (capped at 2 lr): visible only on weights whose
    gradients vanish (sqrt(v_hat) near 1e-8)."""
    want = flax_to_torch(jax.device_get(j_params))
    named = dict(model.named_parameters())
    n_rect = max(0, n_steps - 5)
    worst = 0.0
    for k, v in model.state_dict().items():
        d = np.abs(v.numpy().astype(np.float64) - want[k].numpy())
        p = named.get(k)
        if n_rect and p is not None and p.requires_grad:
            st = opt.state[p]
            bc2 = 1 - 0.999 ** float(st["step"])
            v_hat = (st["exp_avg_sq"] / bc2).double().sqrt().numpy()
            eps_gap = np.minimum(2 * LR, 2 * LR * 1e-8 / (np.sqrt(bc2) * (v_hat + 1e-8)))
            d = d - n_rect * eps_gap
        worst = max(worst, d.max(initial=0.0))
    assert worst < PARAM_TOL, worst
    return worst


# ---------------------------------------------------------------------------
# small models
# ---------------------------------------------------------------------------

B, T, IMG, DEPTH, LR = 2, 10, 16, 3, 1e-3
SMALL = dict(batch_size=B, max_seq_len=T, img_sz=IMG, hierarchy_levels=DEPTH,
             matching_type="balanced", regress_length=True,
             attach_state_regressor=True, state_dim=2, attach_inv_mdl=True,
             inv_mdl_params=dict(n_actions=2), attach_cost_mdl=True,
             n_actions=2, seq_enc="conv", one_step_planner="sh_pred",
             decoder_distribution="discrete_logistic_mixture")
VARIANTS = {
    "dlm_split_linear_tied": dict(tree_lstm="split_linear", lstm_init="mlp",
                                  n_lstm_layers=2),
    "dlm_split_linear_untied": dict(tree_lstm="split_linear", lstm_init="mlp",
                                    untied_layers=True, free_nats=0.05),
    "gaussian_sum_untied": dict(tree_lstm="sum", untied_layers=True,
                                decoder_distribution="gaussian",
                                kl_weight_burn_in=4),
    "gaussian_linear_tied": dict(tree_lstm="linear", lstm_init="zero",
                                 decoder_distribution="gaussian",
                                 entropy_weight=0.1,
                                 inv_mdl_params=dict(n_actions=2, temp_dist=3)),
}


def _small_hp(variant):
    hp = default_hparams()
    hp.overwrite(SMALL)
    hp.overwrite(VARIANTS[variant])
    return dict(hp)


def _small_batch(seed=0):
    rng = np.random.RandomState(seed)
    seq = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    end_ind = np.array([T - 1, 6], np.int32)
    pad = (np.arange(T)[None] <= end_ind[:, None]).astype(np.float32)
    return dict(traj_seq=seq, I_0=seq[:, 0],
                I_g=seq[np.arange(B), end_ind], end_ind=end_ind, pad_mask=pad,
                actions=rng.randn(B, T - 1, 2).astype(np.float32) * 0.1,
                traj_seq_states=rng.rand(B, T, 2).astype(np.float32))


def _seeded_params(model, batch):
    """Weights from a seed in the flax structure of a training init."""
    shapes = jax.eval_shape(
        lambda b: model.init({"params": KEY, "sample": KEY}, b, "train",
                             "posterior"), batch)
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


def _jax_grad_fn(model, step=0):
    def loss_fn(params, batch):
        out = model.apply(params, batch, "train", "posterior", step=step,
                          rngs={"sample": KEY})
        return out.losses.total.value, out.losses

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _pair(variant, batch):
    """The JAX model with seeded params, and the port's twin of it."""
    hp = _small_hp(variant)
    jmodel = JaxTree(hp=hp)
    params = _seeded_params(jmodel, _jax_batch(batch))
    tmodel = TorchTree(hp)
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    return jmodel, params, tmodel


def _run_steps(monkeypatch, variant, n_steps, batch=None):
    """n_steps of both train steps from the same params; returns the per-step
    port metrics and JAX metrics, and both final states."""
    batch = _small_batch() if batch is None else batch
    jmodel, params, tmodel = _pair(variant, batch)
    noise = SharedNoise(monkeypatch)
    state = j_train_step.TrainState.create(
        params, j_train_step.make_optimizer("radam", LR, None, 0, 0.9))
    j_step = j_train_step.make_train_step(jmodel)
    opt = make_optimizer([p for p in tmodel.parameters() if p.requires_grad],
                         "radam", LR, None, 0, 0.9)
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    gen = torch.Generator().manual_seed(0)
    history = []
    for i in range(n_steps):
        if i == 0:  # the jitted step draws while it is traced
            state, j_met = noise.run(j_step, state, jb, KEY)
        else:
            state, j_met = j_step(state, jb, KEY)
        t_met = noise.run(train_step, tmodel, opt, tb, i, gen)
        history.append((t_met, jax.device_get(j_met)))
    return history, state, tmodel, opt, noise


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_small_train_step_losses_and_grads_match_jax(monkeypatch, variant):
    batch = _small_batch()
    jmodel, params, tmodel = _pair(variant, batch)
    noise = SharedNoise(monkeypatch)
    (j_total, j_losses), j_grads = noise.run(
        _jax_grad_fn(jmodel), params, _jax_batch(batch))
    out = noise.run(lambda: tmodel(_torch_batch(batch), phase="train",
                                   mode="posterior", generator=torch.Generator()))
    out.losses.total.value.backward()
    t_values = {k: v.value for k, v in out.losses.items()}
    diffs = _compare_losses(t_values, j_losses)
    assert abs(float(t_values["total"].detach()) - float(j_total)) <= LOSS_TOL * max(
        1.0, abs(float(j_total)))
    expected = {"dense_img_rec", "kl", "entropy", "existence_predictor",
                "seq_len", "action_reconst", "cost_estimation",
                "state_regression", "nll", "total"}
    assert set(t_values) == expected
    grad_d, name = _compare_grads(tmodel, j_grads, GRAD_TOL)
    print(variant, "loss", max(diffs.values()), "grad", grad_d, name)
    # noise reached both sides: 3 tree levels, 2 + 2 uniform draws
    assert [len(noise.draws[k]) for k in ("normal", "uniform")] == [DEPTH, 4]


@pytest.mark.parametrize("variant,n_steps", [
    ("dlm_split_linear_tied", 1), ("dlm_split_linear_tied", 6),
    ("gaussian_sum_untied", 1), ("gaussian_sum_untied", 6)])
def test_small_train_steps_match_jax(monkeypatch, variant, n_steps):
    history, state, tmodel, opt, _ = _run_steps(monkeypatch, variant, n_steps)
    for t_met, j_met in history:
        _compare_losses(t_met, {k: v for k, v in j_met.items()
                                if np.ndim(v) == 0 and k != "grads_finite"})
        assert bool(t_met.grads_finite) and bool(j_met["grads_finite"])
        assert abs(float(t_met.grad_norm) - float(j_met["grad_norm"])) <= (
            1e-4 * float(j_met["grad_norm"]))
        np.testing.assert_allclose(t_met.kl_layerwise.numpy(),
                                   j_met["kl_layerwise"], rtol=1e-5, atol=1e-6)
    d = _compare_params(tmodel, state.params, opt, n_steps)
    print(variant, n_steps, "param diff", d)
    assert int(state.step) == n_steps
    # the optimizer stepped every trained parameter each time, as optax does
    steps = {float(opt.state[p]["step"]) for p in tmodel.parameters() if p.requires_grad}
    assert steps == {float(n_steps)}


def test_nan_batch_zeroes_grads_and_still_steps(monkeypatch):
    """A NaN frame makes every gradient non-finite: both sides zero them and
    step anyway, so the second step moves the parameters only through the
    decayed Adam moments of the first."""
    good = _small_batch()
    bad = dict(good, traj_seq=good["traj_seq"].copy())
    bad["traj_seq"][0, 3, 2, 2, 0] = np.nan
    jmodel, params, tmodel = _pair("dlm_split_linear_tied", good)
    noise = SharedNoise(monkeypatch)
    state = j_train_step.TrainState.create(
        params, j_train_step.make_optimizer("radam", LR, None, 0, 0.9))
    j_step = j_train_step.make_train_step(jmodel)
    opt = make_optimizer([p for p in tmodel.parameters() if p.requires_grad],
                         "radam", LR, None, 0, 0.9)
    gen = torch.Generator()
    state, _ = noise.run(j_step, state, _jax_batch(good), KEY)
    noise.run(train_step, tmodel, opt, _torch_batch(good), 0, gen)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    state, j_met = j_step(state, _jax_batch(bad), KEY)
    t_met = noise.run(train_step, tmodel, opt, _torch_batch(bad), 1, gen)
    assert not bool(j_met["grads_finite"]) and not bool(t_met.grads_finite)
    assert float(t_met.grad_norm) == 0.0 == float(j_met["grad_norm"])
    assert not np.isfinite(float(t_met.total))
    assert all(float((p.grad != 0).sum()) == 0 for p in tmodel.parameters()
               if p.requires_grad)
    moved = [k for k, v in tmodel.state_dict().items() if not torch.equal(v, before[k])]
    assert moved  # the step was applied
    _compare_params(tmodel, state.params, opt, 2)


def test_gradient_clip_matches_optax(monkeypatch):
    """gradient_clip: global-norm clipping before the update, as optax's
    chain(clip_by_global_norm, sgd). SGD keeps the update linear in the
    gradient, so the parameters show the clipping alone."""
    batch = _small_batch()
    jmodel, params, tmodel = _pair("gaussian_linear_tied", batch)
    noise = SharedNoise(monkeypatch)
    clip = 0.01
    state = j_train_step.TrainState.create(
        params, j_train_step.make_optimizer("sgd", 1.0, clip, 0, 0.9))
    opt = make_optimizer([p for p in tmodel.parameters() if p.requires_grad],
                         "sgd", 1.0, clip, 0, 0.9)
    state, j_met = noise.run(j_train_step.make_train_step(jmodel), state,
                             _jax_batch(batch), KEY)
    t_met = noise.run(train_step, tmodel, opt, _torch_batch(batch), 0,
                      torch.Generator())
    assert float(j_met["grad_norm"]) > clip  # the clip binds
    _compare_params(tmodel, state.params, opt, 1)
    total = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in tmodel.parameters() if p.requires_grad]))
    assert abs(float(total) - clip) < 1e-6 and float(t_met.grad_norm) > clip


def test_port_draws_through_the_generator():
    """Without the shared noise, the port's train step is a function of its
    generator's seed."""
    batch = _torch_batch(_small_batch())

    def run(seed):
        torch.manual_seed(0)
        model = TorchTree(_small_hp("dlm_split_linear_tied"))
        out = model(batch, phase="train", mode="posterior",
                    generator=torch.Generator().manual_seed(seed))
        return out.tree.z, out.losses.cost_estimation.value

    (z1, c1), (z2, c2), (z3, _) = run(1), run(1), run(2)
    assert torch.equal(z1, z2) and torch.equal(c1, c2)
    assert not torch.equal(z1, z3)


# ---------------------------------------------------------------------------
# the 9-room model at full width from ep74
# ---------------------------------------------------------------------------

CONF = "experiments/prediction/9room/gcp_tree"
WEIGHTS = CONF + "/pretrained_ep74.npz"
# f32 through 200 encoder frames and 254 decoded nodes, DLM NLL summed over
# 100 x 32 x 32 pixels: loss terms 1e-5 relative; gradients relative to each
# parameter's largest JAX gradient (see PERF.md for the measured maxima)
GRAD_TOL_EP74 = 2e-3
LOSS_TOL_EP74 = 1e-4  # port vs JAX, relative to max(1, |value|)
F64_TOL_EP74 = 2e-5  # port f32 vs port f64, the same measure


def test_ep74_train_step_matches_jax(monkeypatch):
    bundle = j_load_config(CONF)
    hp = default_hparams()
    mc = dict(bundle.model_config)
    mc.setdefault("batch_size", bundle.configuration["batch_size"])
    mc.pop("dataset_class", None)
    hp.override({k: v for k, v in mc.items() if k in hp})
    hp.overwrite({k: v for k, v in mc.items() if k not in hp})
    jmodel = bundle.configuration["model"](hp=dict(hp))
    params = j_ckpt.load_pretrained_npz(WEIGHTS)
    dset = JRandomVideoDataset(None, dict(hp), bundle.data_conf, "train")
    items = [dset[i] for i in (0, 1)]
    batch = {k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]}
    assert batch["traj_seq"].shape == (2, 100, 32, 32, 3)

    noise = SharedNoise(monkeypatch)
    (j_total, j_losses), j_grads = noise.run(
        _jax_grad_fn(jmodel, step=0), {"params": params["params"]}, _jax_batch(batch))
    tmodel = load_model(CONF, weights=WEIGHTS, device="cpu").train()
    out = noise.run(lambda: tmodel(_torch_batch(batch), phase="train",
                                   mode="posterior", generator=torch.Generator()))
    out.losses.total.value.backward()
    t_values = {k: v.value for k, v in out.losses.items()}
    diffs = _compare_losses(t_values, j_losses, LOSS_TOL_EP74)
    grad_d, name = _compare_grads(tmodel, j_grads, GRAD_TOL_EP74)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    print("ep74 losses", {k: float(v) for k, v in t_values.items()})
    print("ep74 loss rel diffs", diffs, "grad", grad_d, name, "flax leaves", n_leaves)
    assert n_leaves == 173 and np.isfinite(float(j_total))

    # both f32 runs against the port in float64: the loss tolerance is set by
    # the reference's own f32 error (1.9e-5 in the DLM NLL sum)
    model64 = load_model(CONF, weights=WEIGHTS, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        out64 = noise.run(lambda: model64(_torch_batch(batch), phase="train",
                                          mode="posterior",
                                          generator=torch.Generator()))
    for k, term in out64.losses.items():
        ref = float(term.value)
        err_t = abs(float(t_values[k].detach()) - ref) / max(1.0, abs(ref))
        err_j = abs(float(j_losses[k].value) - ref) / max(1.0, abs(ref))
        print(f"{k}: |port f32 - f64| {err_t:.2e}  |jax f32 - f64| {err_j:.2e}")
        assert err_t < F64_TOL_EP74, (k, err_t, err_j)
