"""Network blocks of the PyTorch port against flax (models/nets.py), in f32
on the CPU. Each flax module is initialized at a small size, its parameters
go through the port's weight bridge (training/checkpoint.py:flax_to_torch)
and load strictly into the torch module; both get the same numpy inputs.

Tolerance 2e-5 absolute unless stated: float32 with different reduction
orders (XLA vs ATen), on outputs of order 1."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.models import aux_models as t_aux
from video_gcp_torch.models import inference as t_inference
from video_gcp_torch.models import nets as t_nets
from video_gcp_torch.models.dlm import n_dlm_channels
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_tpu.models import aux_models as j_aux
from video_gcp_tpu.models import inference as j_inference
from video_gcp_tpu.models import nets as j_nets

TOL = 2e-5
KEY = jax.random.PRNGKey(0)
HP = dict(img_sz=16, input_nc=3, ngf=4, nz_enc=32, use_skips=True,
          skips_stride=2, conv_inf_enc_kernel_size=3, conv_inf_enc_layers=2)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(module, variables):
    module.load_state_dict(flax_to_torch(variables), strict=True)
    return module.eval()


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    d = np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)))
    assert d < tol, d


def _perturb(variables, seed=1):
    """Non-trivial GroupNorm affine / biases (flax inits them to 1 and 0)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), variables)


def test_conv_transpose_mapping():
    """Flax ConvTranspose(k=4, s=2, 'SAME') == ConvTranspose2d(padding=1) with
    the kernel flipped in H, W and HWIO -> (in, out, kh, kw)."""
    x = _randn(2, 5, 6, 7)
    ct = nn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME")
    v = _perturb(ct.init(KEY, jnp.asarray(x)))
    want = ct.apply(v, jnp.asarray(x))
    tmod = torch.nn.ConvTranspose2d(7, 3, 4, stride=2, padding=1)
    tmod.load_state_dict({k.split(".", 2)[-1]: t for k, t in
                          flax_to_torch({"ConvTranspose_0": v["params"]}).items()})
    got = t_nets.conv_nhwc(tmod, torch.from_numpy(x))
    assert got.shape == want.shape == (2, 10, 12, 3)
    _close(got, want)


def test_conv_encoder():
    img = np.tanh(_randn(3, 16, 16, 3))
    enc = j_nets.ConvEncoder(HP)
    v = _perturb(enc.init(KEY, jnp.asarray(img)))
    e_j, skips_j = enc.apply(v, jnp.asarray(img))
    e_t, skips_t = _port(t_nets.ConvEncoder(HP), v)(torch.from_numpy(img))
    _close(e_t, e_j)
    for a, b in zip(skips_t, skips_j, strict=True):
        assert a.is_contiguous()  # NHWC, as the fused GroupNorm kernel reads it
        _close(a, b)


@pytest.mark.parametrize("out_channels,tanh_out", [(None, True),
                                                   (n_dlm_channels(3), False)])
def test_conv_decoder_with_skips(out_channels, tanh_out):
    """Skips of 2 examples broadcast over 2 x 3 folded nodes."""
    img = np.tanh(_randn(2, 16, 16, 3))
    e = _randn(6, 32, seed=2)
    enc = j_nets.ConvEncoder(HP)
    _, skips = enc.apply(enc.init(KEY, jnp.asarray(img)), jnp.asarray(img))
    dec = j_nets.ConvDecoder(HP, out_channels=out_channels, tanh_out=tanh_out)
    v = _perturb(dec.init(KEY, jnp.asarray(e), skips))
    want = dec.apply(v, jnp.asarray(e), skips)
    tdec = _port(t_nets.ConvDecoder(HP, out_channels, tanh_out), v)
    got = tdec(torch.from_numpy(e), [torch.from_numpy(np.array(s)) for s in skips])
    assert got.shape == want.shape == (6, 16, 16, out_channels or 3)
    _close(got, want)


def test_mlp_and_gaussian_head():
    a, b = _randn(4, 5, 6), _randn(4, 5, 3, seed=1)
    mlp = j_nets.MLP(7, 16, 3, final_activation="tanh")
    v = mlp.init(KEY, jnp.asarray(a), jnp.asarray(b))
    got = _port(t_nets.MLP(9, 7, 16, 3, final_activation="tanh"), v)(
        torch.from_numpy(a), torch.from_numpy(b))
    _close(got, mlp.apply(v, jnp.asarray(a), jnp.asarray(b)))

    head = j_nets.GaussianHead(4, 16, 2)
    v = head.init(KEY, jnp.asarray(a), jnp.asarray(b))
    want = head.apply(v, jnp.asarray(a), jnp.asarray(b))
    got = _port(t_nets.GaussianHead(9, 4, 16, 2), v)(
        torch.from_numpy(a), torch.from_numpy(b))
    _close(got.mu, want.mu)
    _close(got.log_sigma, want.log_sigma)
    eps = _randn(4, 5, 4, seed=3)
    _close(got.reparametrize(torch.from_numpy(eps)),
           want.reparametrize(jnp.asarray(eps)))


def test_lstm_stack_packed_state():
    size, layers = 16, 3
    x = _randn(2, 4, 10)
    state = _randn(2, 4, layers * 2 * size, seed=1)
    stack = j_nets.LSTMStack(size, layers)
    v = _perturb(stack.init(KEY, jnp.asarray(state), jnp.asarray(x)))
    s_j, o_j = stack.apply(v, jnp.asarray(state), jnp.asarray(x))
    s_t, o_t = _port(t_nets.LSTMStack(10, size, layers), v)(
        torch.from_numpy(state), torch.from_numpy(x))
    _close(s_t, s_j)
    _close(o_t, o_j)


@pytest.mark.parametrize("var_inf", ["standard", "deterministic"])
def test_matched_inference(var_inf):
    """q(z | e_l, e_r, e~) with e~ gathered at truncated, clipped timesteps."""
    hp = dict(nz_enc=8, nz_vae=6, nz_mid=16, n_processing_layers=2, var_inf=var_inf)
    seq, e_l, e_r = _randn(2, 9, 8), _randn(2, 4, 8, seed=1), _randn(2, 4, 8, seed=2)
    ts = np.array([[-1.0, 0.5, 3.7, 12.0], [8.9, 2.0, 4.5, -0.4]], np.float32)
    args = (seq, e_l, e_r, ts)
    inf = j_inference.MatchedInference(hp)
    v = inf.init(KEY, *map(jnp.asarray, args))
    want = inf.apply(v, *map(jnp.asarray, args)).q_z
    got = _port(t_inference.MatchedInference(hp), v)(*map(torch.from_numpy, args)).q_z
    assert got.mu.shape == want.mu.shape == (2, 4, 6)
    _close(got.mu, want.mu)
    _close(got.log_sigma, want.log_sigma)


def test_cost_model():
    a, b = _randn(3, 8), _randn(3, 8, seed=1)
    p = dict(nz_mid=16, n_processing_layers=2)
    cost = j_aux.CostModel(p)
    v = cost.init(KEY, jnp.asarray(a), jnp.asarray(b))
    got = _port(t_aux.CostModel(p, 8), v)(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, cost.apply(v, jnp.asarray(a), jnp.asarray(b)))


def test_conv_seq_encoder():
    seq = _randn(2, 9, 32)
    enc = j_nets.ConvSeqEncoder(HP)
    v = _perturb(enc.init(KEY, jnp.asarray(seq)))
    got = _port(t_nets.build_seq_encoder(dict(HP, seq_enc="conv")), v)(
        torch.from_numpy(seq))
    _close(got, enc.apply(v, jnp.asarray(seq)))


@pytest.mark.parametrize("kind, kernel", [("conv", 2), ("conv", 4), ("lstm", 3),
                                          ("bi-lstm", 3)])
def test_seq_encoders(kind, kernel):
    """The even-kernel conv encoder (XLA's 'SAME' pads one more at the end)
    and the recurrent encoders, one LSTM or a reversed second pass kept in
    time order and merged by a Dense (flax nn.RNN(OptimizedLSTMCell),
    reverse=True, keep_order=True)."""
    hp = dict(HP, seq_enc=kind, conv_inf_enc_kernel_size=kernel)
    seq = _randn(2, 9, 32)
    enc = (j_nets.ConvSeqEncoder(hp) if kind == "conv"
           else j_nets.RecurrentSeqEncoder(hp, bidirectional=kind == "bi-lstm"))
    v = _perturb(enc.init(KEY, jnp.asarray(seq)))
    port = _port(t_nets.build_seq_encoder(hp), v)
    got = port(torch.from_numpy(seq))
    assert got.shape == (2, 9, 32)
    _close(got, enc.apply(v, jnp.asarray(seq)))
    # flax's cell has no input bias: the port's stays zero and frozen
    assert not any(n.endswith("bias_ih") for n, p in port.named_parameters()
                   if p.requires_grad)


def test_conv_blocks_without_normalization():
    """normalization='none': conv + LeakyReLU(0.2), no GroupNorm parameters
    and so no fused-norm call (JAX nets.py:66-77)."""
    hp = dict(HP, normalization="none")
    img = np.tanh(_randn(3, 16, 16, 3))
    enc, dec = j_nets.ConvEncoder(hp), j_nets.ConvDecoder(hp)
    ve = _perturb(enc.init(KEY, jnp.asarray(img)))
    e_j, skips_j = enc.apply(ve, jnp.asarray(img))
    vd = _perturb(dec.init(KEY, e_j, skips_j))
    t_enc, t_dec = _port(t_nets.ConvEncoder(hp), ve), _port(t_nets.ConvDecoder(hp), vd)
    assert not any("group_norm" in n for n, _ in
                   list(t_enc.named_parameters()) + list(t_dec.named_parameters()))
    e_t, skips_t = t_enc(torch.from_numpy(img))
    _close(e_t, e_j)
    _close(t_dec(e_t, skips_t), dec.apply(vd, e_j, skips_j))


def test_dlm_sample_with_jax_draws():
    """dlm.sample's deterministic core on JAX's own draws (dlm.py:96-101):
    the mixture indices and the uniforms of the same key."""
    from video_gcp_torch.models import dlm as t_dlm
    from video_gcp_tpu.models import dlm as j_dlm

    raw = _randn(2, 4, 4, n_dlm_channels(3))
    key = jax.random.PRNGKey(3)
    want = j_dlm.sample(jnp.asarray(raw), key, 3)
    k1, k2 = jax.random.split(key)
    logits = jnp.asarray(raw)[..., :t_dlm.N_MIX]
    idx = jax.random.categorical(k1, logits, axis=-1)
    u = jax.random.uniform(k2, raw.shape[:-1] + (3,), minval=1e-5, maxval=1 - 1e-5)
    got = t_dlm.sample_with(torch.from_numpy(raw), torch.from_numpy(np.array(idx)),
                            torch.from_numpy(np.array(u)), 3)
    _close(got, want)
    drawn = t_dlm.sample(torch.from_numpy(raw), torch.Generator().manual_seed(0), 3)
    assert drawn.shape == (2, 4, 4, 3) and bool(drawn.abs().max() <= 1)
