"""Tests of the PyTorch port that need an NVIDIA GPU (sm_90a) and nvcc.

They skip on a host without CUDA. This file imports neither jax nor the JAX
package, so on a machine with the card and without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

- Kernel K1 against its plain twin on the card, at the shapes of
  tests/test_torch_fused_gn.py. f32 2e-5 absolute; bf16 3e-2 relative to
  max(1, |y|) (a bf16 rounding step flips where the f32 sums differ).
- A small GCP-tree on the card against the same model on the CPU: K1 runs
  once per GroupNorm site, and the outputs agree in f32.
- Kernel K2 against its plain twin on the card: dx within 2e-5 of
  max(1, max |dx|) in f32 and 3e-2 in bf16, dscale and dbias within 2e-5 of
  max(1, max |ref|); a dy that is not NHWC-contiguous is copied and counted.
- Gradients reach the conv weights before a norm on the card, and one train
  step of a small GCP-tree on the card matches the CPU with the same noise
  (losses 1e-5 relative, gradients 1e-4 of each parameter's largest).
- Kernel K3 (soft-DTW wavefront) against its plain twin on the card at the
  9-room training shape [32, 127, 100] and at small shapes: the accumulated
  values within 1e-4 of max(1, |D|) where finite, NEG_INF where the twin
  has it, and w within 1e-4 absolute; `soft_dtw` on a CUDA tensor launches
  K3 once; a small adaptive train step launches K3 once and matches the CPU.
"""
import numpy as np
import pytest
import torch

from video_gcp_torch.core import distributions
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.load import set_float32_precision
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.models.tree import TreeModel
from video_gcp_torch.models.nets import ConvEncoder
from video_gcp_torch.ops import fused_gn
from video_gcp_torch.ops import soft_dtw as sdtw
from video_gcp_torch.parallel.train_step import make_optimizer, train_step

pytestmark = pytest.mark.cuda

SHAPES = [((5, 16, 16, 64), 8), ((3, 64, 64, 16), 8), ((130, 2, 2, 256), 8),
          ((4, 1, 4, 32), 8), ((6, 32, 32, 16), 8), ((3, 4, 4, 12), 4),
          ((2, 5, 3, 6), 2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    set_float32_precision()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_twin(card, dtype):
    gen = torch.Generator(card).manual_seed(0)
    for shape, groups in SHAPES:
        x = (torch.randn(shape, generator=gen, device=card) * 3 + 1).to(dtype)
        sc = torch.randn(shape[-1], generator=gen, device=card) * 0.5 + 1
        bi = torch.randn(shape[-1], generator=gen, device=card) * 0.1
        launches = fused_gn.LAUNCHES
        got = fused_gn.fused_group_norm_lrelu(x, sc, bi, groups)
        torch.cuda.synchronize()
        assert fused_gn.LAUNCHES == launches + 1
        assert got.dtype == dtype and got.shape == x.shape
        want = fused_gn.gn_lrelu_reference(x, sc, bi, groups).float()
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert err.max().item() < 2e-5, shape
        else:
            assert (err <= 3e-2 * want.abs().clamp(min=1)).all(), shape


def test_kernel_rejects_non_nhwc(card):
    x = torch.randn(2, 8, 4, 4, device=card).permute(0, 2, 3, 1)  # NCHW memory
    with pytest.raises(ValueError):
        fused_gn.fused_group_norm_lrelu(x, torch.ones(8, device=card),
                                        torch.zeros(8, device=card), 8)


def test_small_tree_on_card_matches_cpu(card):
    hp = default_hparams()
    hp.overwrite(dict(max_seq_len=10, img_sz=16, hierarchy_levels=3,
                      matching_type="balanced", regress_length=True,
                      attach_state_regressor=True, state_dim=2,
                      attach_inv_mdl=True, inv_mdl_params=dict(n_actions=2),
                      n_actions=2, seq_enc="conv", tree_lstm="split_linear",
                      lstm_init="mlp", one_step_planner="sh_pred",
                      decoder_distribution="discrete_logistic_mixture"))
    torch.manual_seed(0)
    cpu = TreeModel(dict(hp)).eval()
    gpu = TreeModel(dict(hp)).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(card, memory_format=torch.channels_last)
    rng = np.random.RandomState(0)
    inputs = AttrDict(I_0=torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32)),
                      I_g=torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32)),
                      end_ind=torch.tensor([9, 4]),
                      z=torch.from_numpy(rng.randn(2, 7, 32).astype(np.float32)))
    with torch.inference_mode():
        want = cpu(inputs, phase="plan")
        launches = fused_gn.LAUNCHES
        got = gpu(AttrDict({k: v.to(card) for k, v in inputs.items()}), phase="plan")
        torch.cuda.synchronize()
    assert fused_gn.LAUNCHES - launches == 3 * 4  # 2 encoder passes + decoder, 4 levels
    for k in ("timeline_images", "timeline_latents", "actions", "regressed_state"):
        assert (got[k].cpu() - want[k]).abs().max().item() < 1e-4, k


BWD_SHAPES = [((5, 16, 16, 64), 8), ((3, 64, 64, 16), 8), ((130, 2, 2, 256), 8),
              ((4, 1, 4, 32), 8), ((14, 32, 32, 16), 8), ((3, 4, 4, 12), 4),
              ((2, 5, 3, 6), 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_twin(card, dtype):
    gen = torch.Generator(card).manual_seed(1)
    for shape, groups in BWD_SHAPES:
        x = (torch.randn(shape, generator=gen, device=card) * 2 + 0.5).to(dtype)
        dy = torch.randn(shape, generator=gen, device=card).to(dtype)
        sc = torch.randn(shape[-1], generator=gen, device=card) * 0.5 + 1
        bi = torch.randn(shape[-1], generator=gen, device=card) * 0.1
        x = fused_gn.clear_of_kink(x, sc, bi, groups)  # no sign test at a tie
        launches = fused_gn.BWD_LAUNCHES
        got = fused_gn.gn_lrelu_bwd(x, dy, sc, bi, groups)
        torch.cuda.synchronize()
        assert fused_gn.BWD_LAUNCHES == launches + 1
        want = fused_gn.gn_lrelu_bwd_reference(x, dy, sc, bi, groups)
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        for g, w, tol in zip(got, want, (2e-5 if dtype == torch.float32 else 3e-2,
                                         2e-5, 2e-5)):
            w = w.float()
            scale = max(1.0, w.abs().max().item())
            assert (g.float() - w).abs().max().item() / scale < tol, shape


def test_bwd_copies_a_dy_that_is_not_nhwc(card):
    x = torch.randn(2, 4, 4, 16, device=card)
    dy = torch.randn(2, 16, 4, 4, device=card).permute(0, 2, 3, 1)  # NCHW memory
    copies = fused_gn.BWD_DY_COPIES
    got = fused_gn.gn_lrelu_bwd(x, dy, torch.ones(16, device=card),
                                torch.zeros(16, device=card), 8)
    assert fused_gn.BWD_DY_COPIES == copies + 1
    want = fused_gn.gn_lrelu_bwd_reference(x, dy, torch.ones(16, device=card),
                                           torch.zeros(16, device=card), 8)
    assert (got[0] - want[0]).abs().max().item() < 2e-5


def test_conv_weights_before_a_norm_get_gradients(card):
    hp = default_hparams()
    hp.overwrite(dict(img_sz=16, ngf=8, nz_enc=32))
    enc = ConvEncoder(dict(hp)).to(card, memory_format=torch.channels_last)
    x = torch.randn(4, 16, 16, 3, device=card)
    launches = (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES)
    e, _ = enc(x)
    e.square().sum().backward()
    torch.cuda.synchronize()
    assert fused_gn.LAUNCHES - launches[0] == 4 == fused_gn.BWD_LAUNCHES - launches[1]
    for conv in enc.conv:
        assert conv.weight.grad is not None and conv.weight.grad.abs().sum() > 0


def _small_train_hp():
    hp = default_hparams()
    hp.overwrite(dict(batch_size=2, max_seq_len=10, img_sz=16, hierarchy_levels=3,
                      matching_type="balanced", regress_length=True,
                      attach_state_regressor=True, state_dim=2, attach_inv_mdl=True,
                      inv_mdl_params=dict(n_actions=2), attach_cost_mdl=True,
                      n_actions=2, seq_enc="conv", tree_lstm="split_linear",
                      lstm_init="mlp", one_step_planner="sh_pred",
                      decoder_distribution="discrete_logistic_mixture"))
    return dict(hp)


def test_small_train_step_on_card_matches_cpu(card, monkeypatch):
    rng = np.random.RandomState(0)
    normals = [rng.randn(2, 2 ** d, 32).astype(np.float32) for d in range(3)]
    uniforms = [rng.rand(2).astype(np.float32) for _ in range(4)]

    def run(model, batch, device):
        draws = {"n": iter(normals), "u": iter(uniforms)}
        monkeypatch.setattr(distributions.Gaussian, "sample", lambda g, gen: g.reparametrize(
            torch.from_numpy(next(draws["n"])).to(g.mu.device)))
        monkeypatch.setattr(distributions, "uniform", lambda shape, gen, device=None:
                            torch.from_numpy(next(draws["u"])).to(device))
        opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam")
        return train_step(model, opt, AttrDict({k: v.to(device) for k, v in batch.items()}),
                          0, None)

    seq = torch.from_numpy((rng.rand(2, 10, 16, 16, 3) * 2 - 1).astype(np.float32))
    batch = AttrDict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, 9], end_ind=torch.tensor([9, 6]),
                     pad_mask=torch.ones(2, 10), actions=torch.randn(2, 9, 2) * 0.1,
                     traj_seq_states=torch.rand(2, 10, 2))
    torch.manual_seed(0)
    cpu = TreeModel(_small_train_hp())
    gpu = TreeModel(_small_train_hp())
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(card, memory_format=torch.channels_last)
    want = run(cpu, batch, "cpu")
    launches = (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES)
    got = run(gpu, batch, card)
    torch.cuda.synchronize()
    # 3 encoder calls + the decoder, 4 norm sites each
    assert fused_gn.LAUNCHES - launches[0] == 16 == fused_gn.BWD_LAUNCHES - launches[1]
    for k, v in want.items():
        if v.dim() == 0 and v.dtype != torch.bool:
            assert abs(got[k].item() - v.item()) <= 1e-5 * max(1.0, abs(v.item())), k
    assert bool(got.grads_finite)
    named = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        if p.requires_grad:
            w = named[name].grad
            scale = max(1e-3, w.abs().max().item())
            assert (p.grad.cpu() - w).abs().max().item() <= 1e-4 * scale, name


def _dtw_inputs(card, b, r, c, seed=0):
    gen = torch.Generator(card).manual_seed(seed)
    cost = torch.rand(b, r, c, generator=gen, device=card) * 2
    ends = torch.tensor([c - 1, int(c * 0.7), int(c * 0.4)], device=card)
    return cost, ends[torch.arange(b, device=card) % 3]


@pytest.mark.parametrize("b,r,c", [(16, 127, 100), (3, 15, 9), (2, 31, 20), (1, 7, 7)])
def test_soft_dtw_kernel_matches_twin(card, b, r, c):
    cost, ends = _dtw_inputs(card, b, r, c)
    comb, begin = sdtw.dp_rows(cost, ends)
    launches = sdtw.LAUNCHES
    got = sdtw.gak(comb, begin)
    torch.cuda.synchronize()
    assert sdtw.LAUNCHES == launches + 1
    want = sdtw.gak_reference(comb, begin)
    finite = want > sdtw.NEG_INF / 2
    assert torch.equal(got > sdtw.NEG_INF / 2, finite)
    err = (got - want).abs()[finite] / want.abs()[finite].clamp(min=1)
    assert err.max().item() < 1e-4
    w = sdtw.posterior(got, comb, ends)
    assert (w - sdtw.posterior(want, comb, ends)).abs().max().item() < 1e-4
    for k in range(b):  # no mass past the end
        assert bool((w[k, :, int(ends[k]) + 1:].abs() < 1e-6).all())


def test_soft_dtw_on_a_cuda_tensor_launches_k3(card):
    cost, ends = _dtw_inputs(card, 4, 15, 10, seed=1)
    launches = sdtw.LAUNCHES
    w = sdtw.soft_dtw(cost.requires_grad_(), ends)
    torch.cuda.synchronize()
    assert sdtw.LAUNCHES == launches + 1 and w.is_cuda and w.grad_fn is None
    with pytest.raises(ValueError):  # the kernel takes int32 begins only
        sdtw.gak(cost.detach(), torch.zeros(4, dtype=torch.int64, device=card))


def test_small_adaptive_train_step_on_card_matches_cpu(card, monkeypatch):
    hp = default_hparams()
    hp.overwrite(dict(batch_size=2, max_seq_len=10, img_sz=16, hierarchy_levels=4,
                      matching_type="dtw_image", attentive_inference=True,
                      learn_matching_temp=False, seq_enc="conv", tree_lstm="sum",
                      regress_length=True, decoder_distribution="gaussian"))
    rng = np.random.RandomState(0)
    normals = [rng.randn(2, 2 ** d, 32).astype(np.float32) for d in range(4)]

    def run(model, batch, device):
        draws = iter(normals)
        monkeypatch.setattr(distributions.Gaussian, "sample", lambda g, gen: g.reparametrize(
            torch.from_numpy(next(draws)).to(g.mu.device)))
        opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam")
        return train_step(model, opt, AttrDict({k: v.to(device) for k, v in batch.items()}),
                          0, None)

    seq = torch.from_numpy((rng.rand(2, 10, 16, 16, 3) * 2 - 1).astype(np.float32))
    batch = AttrDict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, 9], end_ind=torch.tensor([9, 6]),
                     start_ind=torch.zeros(2, dtype=torch.int64),
                     pad_mask=(torch.arange(10)[None] <= torch.tensor([[9], [6]])).float())
    torch.manual_seed(0)
    cpu = TreeModel(dict(hp))
    gpu = TreeModel(dict(hp))
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(card, memory_format=torch.channels_last)
    want = run(cpu, batch, "cpu")
    launches = sdtw.LAUNCHES
    got = run(gpu, batch, card)
    torch.cuda.synchronize()
    assert sdtw.LAUNCHES - launches == 1
    for k, v in want.items():
        if v.dim() == 0 and v.dtype != torch.bool:
            assert abs(got[k].item() - v.item()) <= 1e-5 * max(1.0, abs(v.item())), k
    named = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        if p.requires_grad:
            w = named[name].grad
            scale = max(1e-3, w.abs().max().item())
            assert (p.grad.cpu() - w).abs().max().item() <= 1e-4 * scale, name
