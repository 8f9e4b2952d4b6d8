"""bf16 compute over float32 parameters in the PyTorch port, against the JAX
TreeModel(dtype=jnp.bfloat16) on the CPU: the 9-room GCP-tree at full width
with the ep74 weights, B=2.

- `load_model(..., compute_dtype=torch.bfloat16)` keeps every parameter in
  float32; the networks run in bf16 (K1 gets a bf16 x with float32 scale
  and bias); the latents, images and losses come back in float32.
- A prior rollout with injected z, level by level.
- One train step (RAdam) with the same noise on both sides: the losses and
  the update of the float32 parameters.

Both frameworks are held against the port run in float64 as well, because
bf16 error grows through the tree's recursive LSTM: a few nodes of the
deepest levels differ by up to ~0.6 in a latent in [-1, 1] on either side
(chaotic amplification of rounding), while the mean error stays at bf16's
scale. So the rollout is compared per level by the mean absolute
difference, and each level's error against float64 must not exceed the
reference's own.

Tolerances (bf16 rounds to 8 bits, 3.9e-3 relative):
- rollout, port vs JAX, mean |diff| per level: images 3e-3, e_g_prime
  1.5e-2 (measured up to 1.5e-3 and 7.4e-3); the root level also by its
  maximum: images 5e-2, e_g_prime 1e-1 (measured 1.8e-2, 4.1e-2);
- train step: losses 1e-2 relative to max(1, |value|) (measured up to
  3.2e-3); the parameter update, ||port - JAX|| / ||JAX|| over all
  parameters 0.2 (measured 0.102), and the port's distance to the float64
  update at most the reference's (measured 1.9e-5 against 4.1e-4). Most of
  the JAX update's gap is in the conv biases' gradients, sums over 204,800
  positions that XLA accumulates in bf16 (decoder.conv.0.bias: 87% of its
  float64 norm, the port's 0.4%); the weights' errors are alike on both
  sides. PERF.md lists the measured values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.load import load_model
from video_gcp_torch.parallel.train_step import make_optimizer, train_step
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_tpu.data.datasets import RandomVideoDataset as JRandomVideoDataset
from video_gcp_tpu.models.tree import TreeModel as JaxTree
from video_gcp_tpu.parallel import train_step as j_train_step
from video_gcp_tpu.training.config import load_config as j_load_config

from test_torch_tree import CONF, WEIGHTS, _jax_ep74, _jax_plan, _torch_inputs
from test_torch_train import KEY, SharedNoise, _jax_batch, _torch_batch

DEPTH, B, LR = 7, 2, 1e-3
MEAN_TOL = dict(images=3e-3, e_g_prime=1.5e-2)
ROOT_MAX_TOL = dict(images=5e-2, e_g_prime=1e-1)
LOSS_TOL = 1e-2
UPDATE_TOL = 0.2


def _mean_diff(a, b):
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _np(t):
    return t.detach().float().numpy()


def _jax_bf16():
    jmodel, params = _jax_ep74()
    return JaxTree(hp=jmodel.hp, dtype=jnp.bfloat16), params


def test_compute_dtype_keeps_float32_parameters():
    model = load_model(CONF, weights=WEIGHTS, device="cpu",
                       compute_dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.dtype == torch.bfloat16 and model.param_dtype == torch.float32
    seen = []
    model.encoder.group_norm[0].register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, mod.weight.dtype, out.dtype)))
    rng = np.random.RandomState(0)
    inputs = _torch_inputs(dict(
        I_0=rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
        I_g=rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
        z=rng.randn(B, 2 ** DEPTH - 1, 256).astype(np.float32),
        end_ind=np.array([99, 50])))
    with torch.inference_mode():
        out = model(inputs, phase="plan")
    assert seen[0] == (torch.bfloat16, torch.float32, torch.bfloat16)
    for t in (out.tree.images, out.tree.e_g_prime, out.tree.z, out.existence_logits,
              out.timeline_images, out.actions, out.regressed_state):
        assert t.dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        load_model(CONF, device="cpu", dtype=torch.bfloat16)
    # the default computes in the parameters' dtype, float64 included
    assert load_model(CONF, device="cpu", dtype=torch.float64).dtype == torch.float64


def test_bf16_rollout_matches_jax_per_level():
    rng = np.random.RandomState(74)
    inputs = dict(I_0=rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
                  I_g=rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
                  z=rng.randn(B, 2 ** DEPTH - 1, 256).astype(np.float32),
                  end_ind=np.array([99, 60], np.int32))
    tmodel = load_model(CONF, weights=WEIGHTS, device="cpu",
                        compute_dtype=torch.bfloat16)
    model64 = load_model(CONF, weights=WEIGHTS, device="cpu", dtype=torch.float64)
    with torch.inference_mode():
        t_out = tmodel(_torch_inputs(inputs), phase="plan")
        in64 = _torch_inputs(inputs)
        in64.z = in64.z.double()
        ref = model64(in64, phase="plan")
    jmodel, params = _jax_bf16()
    j_out = _jax_plan(jmodel, params, inputs)
    assert np.asarray(j_out.tree.images).dtype == np.float32

    for k in ("images", "e_g_prime"):
        t, j, r = _np(t_out.tree[k]), np.asarray(j_out.tree[k]), ref.tree[k].numpy()
        for d in range(DEPTH):
            level = slice(2 ** d - 1, 2 ** (d + 1) - 1)
            d_tj = _mean_diff(t[:, level], j[:, level])
            err_t = _mean_diff(t[:, level], r[:, level])
            err_j = _mean_diff(j[:, level], r[:, level])
            print(f"{k} level {d}: mean |port - jax| {d_tj:.2e}, |port - f64| "
                  f"{err_t:.2e}, |jax - f64| {err_j:.2e}")
            assert d_tj < MEAN_TOL[k] and err_t <= err_j, (k, d, d_tj, err_t, err_j)
        root_max = float(np.abs(t[:, 0] - j[:, 0]).max())
        assert root_max < ROOT_MAX_TOL[k], (k, root_max)
    for k in ("timeline_images", "actions", "regressed_state"):
        d_tj = _mean_diff(_np(t_out[k]), j_out[k])
        assert d_tj < MEAN_TOL["images"], (k, d_tj)


def test_bf16_train_step_matches_jax(monkeypatch):
    jmodel, params = _jax_bf16()
    params = {"params": params["params"]}
    dset = JRandomVideoDataset(None, dict(jmodel.hp), j_load_config(CONF).data_conf,
                               "train")
    items = [dset[i] for i in (0, 1)]
    batch = {k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]}
    noise = SharedNoise(monkeypatch)
    state = j_train_step.TrainState.create(
        params, j_train_step.make_optimizer("radam", LR, None, 0, 0.9))
    state, j_met = noise.run(j_train_step.make_train_step(jmodel), state,
                             _jax_batch(batch), KEY)
    j_after = flax_to_torch(jax.device_get(state.params))
    assert bool(j_met["grads_finite"])

    updates, metrics = {}, {}
    for name, kw in (("bf16", dict(compute_dtype=torch.bfloat16)),
                     ("f64", dict(dtype=torch.float64))):
        model = load_model(CONF, weights=WEIGHTS, device="cpu", **kw).train()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer([p for p in model.parameters() if p.requires_grad],
                             "radam", LR, None, 0, 0.9)
        metrics[name] = noise.run(train_step, model, opt, _torch_batch(batch), 0,
                                  torch.Generator())
        if name == "bf16":
            assert {p.dtype for p in model.parameters()} == {torch.float32}
            assert {p.grad.dtype for p in model.parameters()
                    if p.grad is not None} == {torch.float32}
        updates[name] = {k: (v - before[k]).double().numpy()
                         for k, v in model.state_dict().items()}
    assert bool(metrics["bf16"].grads_finite)
    # the JAX update, against the same float32 starting point
    start = flax_to_torch(params)
    upd_j = {k: j_after[k].double().numpy() - start[k].double().numpy() for k in start}

    for k in j_met:
        if np.ndim(j_met[k]) == 0 and k != "grads_finite":
            want, got = float(j_met[k]), float(metrics["bf16"][k])
            rel = abs(got - want) / max(1.0, abs(want))
            assert rel < LOSS_TOL, (k, got, want)

    def dist(a, b):
        return np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b))

    norm_j = dist(upd_j, {k: np.zeros_like(v) for k, v in upd_j.items()})
    d_tj = dist(updates["bf16"], upd_j) / norm_j
    err_t = dist(updates["bf16"], updates["f64"])
    err_j = dist(upd_j, updates["f64"])
    print(f"update: ||port - jax|| / ||jax|| {d_tj:.3e}; ||port - f64|| {err_t:.3e}, "
          f"||jax - f64|| {err_j:.3e}, ||jax|| {norm_j:.3e}")
    moved = [k for k, v in updates["bf16"].items() if np.abs(v).max() > 0]
    assert len(moved) > 0.9 * len(upd_j)
    assert d_tj < UPDATE_TOL and err_t <= err_j, (d_tj, err_t, err_j)
