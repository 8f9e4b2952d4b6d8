"""The port's LPIPS (video_gcp_torch/evaluation/lpips.py) against the JAX
package's (video_gcp_tpu/evaluation/lpips.py) on the CPU, with one
synthesized torchvision-layout AlexNet checkpoint and the lpips 'alex' head
(torch.save), read as one file and as a directory of two; the weight-free
proxy with the JAX-drawn weights passed in (torch cannot replay JAX's PRNG).

Tolerances: loaded weights exactly (a transpose); feature maps and
distances 1e-5 relative to their largest magnitude (f32 convs in another
order); compute_lpips 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.evaluation import lpips as t_lp
from video_gcp_tpu.evaluation import lpips as j_lp

CHANS = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]


def _alexnet(tmp_path, split):
    """The backbone (and the lin head): one file, or two files in a
    directory when `split`."""
    rng = np.random.RandomState(0)
    backbone, head = {}, {}
    for idx, (cin, cout, k) in zip((0, 3, 6, 8, 10), CHANS):
        backbone[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(np.float32))
        backbone[f"features.{idx}.bias"] = torch.from_numpy(
            (0.05 * rng.randn(cout)).astype(np.float32))
    for i, (_, c, _) in enumerate(CHANS):
        head[f"lin{i}.model.1.weight"] = torch.from_numpy(rng.rand(1, c, 1, 1).astype(np.float32))
    if not split:
        torch.save(dict(backbone, **head), tmp_path / "alex.pth")
        return str(tmp_path / "alex.pth")
    torch.save(backbone, tmp_path / "alexnet.pth")
    torch.save(head, tmp_path / "lpips_alex.pt")
    return str(tmp_path)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _images(n, size, seed):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("split", [False, True])
def test_loader_and_features_match_jax(tmp_path, split):
    path = _alexnet(tmp_path, split)
    got, want = t_lp.load_lpips_params(path), j_lp.load_lpips_params(path)
    for (w, b), (jw, jb) in zip(got["convs"], want["convs"], strict=True):
        np.testing.assert_array_equal(w.numpy().transpose(2, 3, 1, 0), jw)
        np.testing.assert_array_equal(b.numpy(), jb)
    for lin, jlin in zip(got["lins"], want["lins"], strict=True):
        np.testing.assert_array_equal(lin.numpy(), jlin)
    x = _images(2, 64, 1)
    feats = t_lp.alexnet_feature_fn(path, device="cpu")(torch.from_numpy(x).permute(0, 3, 1, 2))
    j_feats = j_lp.alexnet_feature_fn(path)(jnp.asarray(x))
    assert len(feats) == len(j_feats) == 5
    for f, jf in zip(feats, j_feats):
        assert _rel(f.permute(0, 2, 3, 1), jf) < 1e-5


@pytest.mark.parametrize("with_lins", [True, False])
def test_distance_matches_jax(tmp_path, with_lins):
    """With the lin head (LPIPS) and with the backbone alone."""
    path = _alexnet(tmp_path, split=False)
    fn, j_fn = t_lp.alexnet_feature_fn(path, device="cpu"), j_lp.alexnet_feature_fn(path)
    if not with_lins:
        fn.lins = j_fn.lins = None
    a, b = _images(3, 48, 2), _images(3, 48, 3)
    got = t_lp.lpips_distance(a, b, fn)
    assert got.shape == (3,)
    assert _rel(got, j_lp.lpips_distance(a, b, feature_fn=j_fn)) < 1e-5
    np.testing.assert_allclose(t_lp.lpips_distance(a, a, fn), 0.0, atol=1e-6)


def _jax_proxy_weights(seed=0):
    """The kernels JAX's _random_features draws (lpips.py:43-49)."""
    key, out, ch = jax.random.PRNGKey(seed), [], 3
    for out_ch in (32, 64, 128):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (3, 3, ch, out_ch)) / np.sqrt(9 * ch)))
        ch = out_ch
    return out


def test_proxy_and_compute_lpips_match_jax(tmp_path, monkeypatch, capsys):
    """The proxy on JAX's draw, then compute_lpips over channel-first dumps
    with padded (all-black) frames left out, and the CLI with the weights
    from GCP_LPIPS_WEIGHTS."""
    fn = t_lp.random_feature_fn(_jax_proxy_weights(), device="cpu")
    a, b = _images(4, 16, 4), _images(4, 16, 5)
    assert _rel(t_lp.lpips_distance(a, b, fn), j_lp.lpips_distance(a, b)) < 1e-5
    rng = np.random.RandomState(6)
    gt = np.tanh(rng.randn(3, 5, 3, 32, 32)).astype(np.float32)
    gen = np.clip(gt + 0.2 * rng.randn(*gt.shape), -1, 1).astype(np.float32)
    gt[0, 3:] = 0.0
    np.save(tmp_path / "gt_seq_0.npy", gt)
    np.save(tmp_path / "gen_images_0.npy", gen)
    paths = str(tmp_path / "gt_seq_0.npy"), str(tmp_path / "gen_images_0.npy")
    got = t_lp.compute_lpips(*paths, feature_fn=fn)
    want = j_lp.compute_lpips(*paths, feature_fn=j_lp._random_features)
    assert abs(got - want) <= 1e-5 * abs(want)
    weights = tmp_path / "w"
    weights.mkdir()
    monkeypatch.setenv(t_lp.LPIPS_WEIGHTS_ENV, _alexnet(weights, split=True))
    t_lp.main([str(tmp_path), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("gt_seq_0.npy: LPIPS = ")
    want = j_lp.compute_lpips(*paths, feature_fn=j_lp.default_feature_fn()[0])
    assert abs(float(line.split("= ")[1]) - want) <= 1e-5 * abs(want) + 5e-6
