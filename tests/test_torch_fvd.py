"""The port's FVD (video_gcp_torch/evaluation/fvd.py) against the JAX
package's (video_gcp_tpu/evaluation/fvd.py) on the CPU: the I3D checkpoint
table and loader on one synthesized pytorch-i3d checkpoint (torch.save,
positive running_var), the InceptionI3d forward at full Kinetics-400 width,
XLA's "SAME" padding of strided convs and pools, the 224x224 resize up and
down, the Frechet distance and the whole compute_fvd with the proxy's
JAX-drawn weights passed in (torch cannot replay JAX's PRNG).

Tolerances: the folded BN scale and shift 1e-6 relative (the same f32
arithmetic in another order); I3D logits 1e-4 of their largest magnitude
(f32 through ~60 convs); single convs and pools 1e-5; the resize 5e-5
(measured 1.8e-7 up from 32; down 1.2e-7 from 448 and 1.9e-5 from 300,
where the two libraries' antialiased weights round apart); the Frechet
distance on the same features exactly (the same numpy and scipy code); embeddings 1e-5; the FVD
scalar 1e-4 relative with more videos than feature dimensions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.evaluation import fvd as t_fvd
from video_gcp_torch.models.nets import pad_same
from video_gcp_tpu.evaluation import fvd as j_fvd


def _i3d_ckpt(path, seed=0):
    """A pytorch-i3d checkpoint of random values at the real shapes."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in t_fvd.i3d_param_shapes().items():
        if name.endswith("running_var"):
            a = 1.0 + 0.1 * rng.rand(*shape)
        elif name.endswith("bn.weight"):
            a = 1.0 + 0.05 * rng.randn(*shape)
        elif "conv3d.weight" in name:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.05 * rng.randn(*shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    torch.save(sd, path)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _i3d_ckpt(str(tmp_path_factory.mktemp("i3d") / "i3d.pt"))


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_param_table_and_checkpoint_round_trip(ckpt):
    assert t_fvd.i3d_param_shapes() == j_fvd.i3d_param_shapes()
    assert t_fvd.i3d_param_shapes(7)["logits.conv3d.weight"] == (7, 1024, 1, 1, 1)
    got, want = t_fvd.load_i3d_params(ckpt), j_fvd.load_i3d_params(ckpt)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        if k.endswith("conv3d.weight"):  # the port keeps OIDHW; JAX has DHWIO
            g = g.transpose(2, 3, 4, 1, 0)
        assert _rel(g, v) < 1e-6, k


def test_i3d_logits_full_width(ckpt):
    x = np.tanh(np.random.RandomState(1).randn(1, 8, 32, 32, 3)).astype(np.float32)
    want = j_fvd._i3d_logits(j_fvd.load_i3d_params(ckpt), jnp.asarray(x))
    got = t_fvd.i3d_logits(t_fvd.load_i3d_params(ckpt), torch.from_numpy(x))
    assert got.shape == want.shape == (1, 400)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("size, kernel, stride", [((8, 10, 12), (7, 7, 7), (2, 2, 2)),
                                                  ((7, 9, 6), (3, 3, 3), (2, 2, 2)),
                                                  ((4, 12, 11), (1, 3, 3), (1, 2, 2)),
                                                  ((6, 6, 6), (2, 2, 2), (2, 2, 2))])
def test_same_padding_strided(size, kernel, stride):
    """XLA's "SAME" puts an odd pad's extra element at the end: a k=7
    stride-2 conv on an even length pads (2, 3). Conv and -inf max-pool."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, *size, 3).astype(np.float32)
    w = rng.randn(*kernel, 3, 4).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), stride, "SAME",
                                        dimension_numbers=("NTHWC", "THWIO", "NTHWC"))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = t_fvd._conv3d(xt, torch.from_numpy(w).permute(4, 3, 0, 1, 2), stride)
    assert _rel(got.permute(0, 2, 3, 4, 1), want) < 1e-5
    got_p = t_fvd._max_pool3d(xt, kernel, stride).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(j_fvd._max_pool3d(
        jnp.asarray(x), kernel, stride)))
    assert pad_same(torch.zeros(1, 8), (7,), (2,)).shape == (1, 13)  # (2, 3)


@pytest.mark.parametrize("size", [32, 300, 448])
def test_resize_to_224(size):
    """Up from the dumps' 32x32 and down (jax.image.resize antialiases a
    downscale, as F.interpolate(antialias=True) does)."""
    v = np.random.RandomState(3).rand(2, 3, size, size, 3).astype(np.float32) * 2 - 1
    want = jax.image.resize(jnp.asarray(v), (2, 3, 224, 224, 3), "bilinear")
    got = t_fvd.resize_frames(torch.from_numpy(v))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-5


def test_frechet_distance_on_the_same_features():
    rng = np.random.RandomState(4)
    a, b = rng.randn(20, 6), rng.randn(20, 6) + 0.3
    assert t_fvd.frechet_distance(a, b) == j_fvd.frechet_distance(a, b)


def _jax_proxy_weights(dim, seed=0):
    """The weights JAX's _random_conv_embed draws (fvd.py:58-74)."""
    key, convs, ch = jax.random.PRNGKey(seed), [], 3
    for out_ch in (32, 64, 128):
        key, k = jax.random.split(key)
        convs.append(np.asarray(jax.random.normal(k, (3, 3, 3, ch, out_ch)) / np.sqrt(27 * ch)))
        ch = out_ch
    key, k = jax.random.split(key)
    return dict(convs=convs, proj=np.asarray(jax.random.normal(k, (ch, dim)) / np.sqrt(ch)))


def _dumps(tmp_path, b=12, t=6, seed=5):
    """Channel-first dumps in [-1, 1]; some sequences end early (black)."""
    rng = np.random.RandomState(seed)
    gt = np.tanh(rng.randn(b, t, 3, 8, 8)).astype(np.float32)
    gen = np.clip(gt + 0.3 * rng.randn(*gt.shape), -1, 1).astype(np.float32)
    gt[:3, 4:] = 0.0
    np.save(tmp_path / "gt_seq_0.npy", gt)
    np.save(tmp_path / "gen_images_0.npy", gen)
    return str(tmp_path / "gt_seq_0.npy"), str(tmp_path / "gen_images_0.npy")


def test_compute_fvd_with_jax_proxy_weights(tmp_path, capsys):
    """12 videos against an 8-wide embedding: the covariances have full
    rank, so the FVD scalar is well conditioned."""
    dim = 8
    gt_path, gen_path = _dumps(tmp_path)
    np.testing.assert_array_equal(t_fvd.detect_lengths(np.load(gt_path)),
                                  j_fvd.detect_lengths(np.load(gt_path)))
    embed = t_fvd.random_conv_embed_fn(_jax_proxy_weights(dim), device="cpu")
    videos = np.random.RandomState(6).rand(3, 5, 8, 8, 3).astype(np.float32) * 255
    assert _rel(embed(videos), j_fvd._random_conv_embed(videos, dim=dim)) < 1e-5
    want = j_fvd.compute_fvd(gt_path, gen_path,
                             embed_fn=lambda v: j_fvd._random_conv_embed(v, dim=dim))
    got = t_fvd.compute_fvd(gt_path, gen_path, embed_fn=embed)
    assert abs(got - want) <= 1e-4 * abs(want)
    # the port's own proxy: its own draw, a finite number through the CLI
    t_fvd.main([str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "gt_seq_0.npy: FVD-proxy(random-feat) = " in out
    assert np.isfinite(float(out.split("= ")[-1]))


def test_i3d_embedding_through_the_env(ckpt, monkeypatch):
    """GCP_I3D_WEIGHTS: the checkpoint read, 16x16 frames resized to 224x224,
    the 400 logits; against JAX's i3d_embed_fn on the same videos."""
    monkeypatch.setenv(t_fvd.I3D_WEIGHTS_ENV, ckpt)
    embed, kind = t_fvd.default_embed_fn("cpu")
    assert kind == "i3d"
    videos = np.random.RandomState(7).randint(0, 255, (2, 4, 16, 16, 3)).astype(np.float32)
    got, want = embed(videos), j_fvd.i3d_embed_fn(ckpt)(videos)
    assert got.shape == (2, 400) and _rel(got, want) < 1e-4
    assert np.abs(got[0] - got[1]).max() > 0
