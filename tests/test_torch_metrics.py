"""The port's image metrics (video_gcp_torch/core/metrics.py) against the
JAX package's and against the committed float64 goldens, on the CPU.

- mse, psnr and ssim on random float and uint8-derived images with leading
  axes [B, T]: within 1e-5 of JAX (psnr relative to max(1, |value|); f32,
  reduction orders differ).
- The evaluator protocol's per-sequence means (first and last frames
  cropped) on the reference-layout fixtures of tests/test_parity_fixtures.py
  within 1e-4 of its float64 goldens, as the JAX metrics are held there.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.core import metrics as t_metrics
from video_gcp_tpu.core import metrics as j_metrics

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-5
GOLDEN_TOL = 1e-4


def _images(seed, kind, shape=(2, 3, 32, 32, 3)):
    rng = np.random.RandomState(seed)
    if kind == "uint8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    return (rng.rand(*shape) * 2.2 - 1.1).astype(np.float32)  # some clipped


@pytest.mark.parametrize("name", ["mse", "psnr", "ssim"])
@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_metric_matches_jax(name, kind):
    pred, target = _images(0, kind), _images(1, kind)
    t_pred = t_metrics.to_float_images(torch.from_numpy(pred))
    t_target = t_metrics.to_float_images(torch.from_numpy(target))
    j_pred = j_metrics.to_float_images(jnp.asarray(pred))
    j_target = j_metrics.to_float_images(jnp.asarray(target))
    np.testing.assert_array_equal(t_pred.numpy(), np.asarray(j_pred))
    got = getattr(t_metrics, name)(t_pred, t_target).numpy()
    want = np.asarray(getattr(j_metrics, name)(j_pred, j_target))
    assert got.shape == want.shape == pred.shape[:2]
    err = np.abs(got.astype(np.float64) - want) / np.maximum(1.0, np.abs(want))
    assert err.max() < TOL, (name, err.max())


def test_ssim_of_an_image_with_itself_is_one():
    x = torch.from_numpy(_images(2, "float", (4, 16, 16, 3)))
    np.testing.assert_allclose(t_metrics.ssim(x, x).numpy(), 1.0, atol=1e-5)
    assert t_metrics.mse(x, x).abs().max() == 0


@pytest.mark.parametrize("name", ["mse", "psnr", "ssim"])
def test_metric_protocol_matches_goldens(name):
    gt = np.load(os.path.join(FIXDIR, "gt_seq.npy")).transpose(0, 1, 3, 4, 2)
    gen = np.load(os.path.join(FIXDIR, "gen_images.npy")).transpose(0, 1, 3, 4, 2)
    end_ind = np.load(os.path.join(FIXDIR, "end_ind.npy"))
    golden = np.load(os.path.join(FIXDIR, "golden_metrics.npz"))[name]
    per_frame = getattr(t_metrics, name)(torch.from_numpy(gen), torch.from_numpy(gt)).numpy()
    t_idx = np.arange(per_frame.shape[1])[None, :]
    valid = (t_idx >= 1) & (t_idx <= end_ind[:, None] - 1)
    ours = (per_frame * valid).sum(1) / valid.sum(1)
    np.testing.assert_allclose(ours, golden, atol=GOLDEN_TOL, rtol=GOLDEN_TOL)
