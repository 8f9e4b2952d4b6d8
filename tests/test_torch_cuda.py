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
- K1 and K2 at shapes that reach every branch of `fused_gn.launch_plan`:
  one sample per CTA, samples split over a cluster, packed small samples
  with N not a multiple of samples per CTA, the narrow (V = 1) instance for
  C = 6 and for a view at an odd offset, N = 1 and N < 132; the same
  tolerances. K2's dscale and dbias are bitwise equal across two calls.
- Gradients reach the conv weights before a norm on the card, and one train
  step of a small GCP-tree on the card matches the CPU with the same noise
  (losses 1e-5 relative, gradients 1e-4 of each parameter's largest).
- Kernel K3 (the soft-DTW posterior: both DPs row by row and w, one
  launch) against its row-order twin on the card at the 9-room training
  shape [16, 127, 100], at the largest shape named [2, 511, 500] and at
  shapes that reach every branch of `soft_dtw.launch_plan` (resident or
  streamed C, bulk or plain copies, one to seven warps a chain, 4, 8 and 12
  columns a lane, a cost at an unaligned address): F and Bk within 1e-4 of
  max(1, |D|) where finite and NEG_INF where the twin has it, w within 1e-4
  absolute, no mass past an end; one `soft_dtw` call is one K3 launch and
  its w has no grad_fn; two calls give equal outputs; int32 end_inds work
  through `soft_dtw` (one cast) and the kernel wrapper itself raises for
  them; a small adaptive train step launches K3 once and matches the CPU.
- The evaluation DTW on the card equals the CPU's (the same D, the same
  node indices) on random and on integer-valued costs.
- The CEM simulator's rollouts of a small GCP-tree and one closed-loop
  action of the 9-room ep74 ImageCEMPolicy, card against CPU (images 2e-4,
  latents 5e-4, actions and states 1e-4), with K1 at every norm.
- A small GCP-tree computing in bf16 over float32 parameters on the card:
  K1 on a bf16 x at every norm, float32 outputs within a mean of 1e-2 of
  the same model in bf16 on the CPU, and a train step that leaves float32
  parameters and gradients.
"""
import numpy as np
import pytest
import torch

from video_gcp_torch.core import distributions
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.load import set_float32_precision
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.models.tree import TreeModel
from video_gcp_torch.models import nets
from video_gcp_torch.models.nets import ConvEncoder
from video_gcp_torch.ops import dtw, fused_gn
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


def test_kernels_launch_on_every_card(card):
    """K1, K2 and K3 at shapes whose shared memory passes the 48 KiB default,
    on each visible card in turn: CUDA sets that limit per device, so a
    process that launches on a second card sets it there too (the
    candidate-split planner and one process over several cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        gen = torch.Generator(dev).manual_seed(i)
        x = torch.randn(6, 32, 32, 16, generator=gen, device=dev) * 3 + 1
        sc, bi = torch.ones(16, device=dev), torch.zeros(16, device=dev)
        assert fused_gn.launch_plan(tuple(x.shape), 4, 8, False, True).smem > 48 * 1024
        y = fused_gn.gn_lrelu_fwd(x, sc, bi, 8)
        assert (y - fused_gn.gn_lrelu_reference(x, sc, bi, 8)).abs().max().item() < 2e-5
        dy = torch.randn(x.shape, generator=gen, device=dev)
        dx = fused_gn.gn_lrelu_bwd(x, dy, sc, bi, 8)[0]
        want = fused_gn.gn_lrelu_bwd_reference(x, dy, sc, bi, 8)[0]
        assert (dx - want).abs().max().item() < 2e-5 * max(1.0, want.abs().max().item())
        cost, ends = _dtw_inputs(dev, 2, 511, 500)
        _dtw_check(sdtw.k3(cost, ends, return_dp=True),
                   sdtw.soft_dtw_rows_reference(cost, ends, return_dp=True), ends)


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


PLAN_CASES = [((300, 32, 32, 16), 8),  # K1 f32: a sample per CTA; K2: clusters of 2
              ((140, 64, 64, 16), 8),  # clusters of 2 to 8
              ((1601, 16, 16, 16), 8),  # packed; 1601 is not a multiple of 4
              ((1603, 1, 1, 256), 8),  # packed one-warp teams
              ((7, 5, 3, 6), 2),  # C = 6: the narrow instance
              ((1, 64, 64, 16), 8),  # N = 1: one sample over 2 to 8 CTAs
              ((40, 8, 8, 32), 8)]  # N < 132


def _at_offset(t, offset):
    """t copied into a buffer `offset` elements in: a contiguous view whose
    address is not 16-byte aligned for offset 1."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", PLAN_CASES)
def test_kernels_at_every_plan_branch(card, shape, groups, dtype, offset):
    gen = torch.Generator(card).manual_seed(2)
    c = shape[-1]
    sc = torch.randn(c, generator=gen, device=card) * 0.5 + 1
    bi = torch.randn(c, generator=gen, device=card) * 0.1
    x = (torch.randn(shape, generator=gen, device=card) * 2 + 0.5).to(dtype)
    x = _at_offset(fused_gn.clear_of_kink(x, sc, bi, groups), offset)
    dy = _at_offset(torch.randn(shape, generator=gen, device=card).to(dtype), offset)
    plan = fused_gn._plan(x, groups, True, dy)
    assert (plan.vec == 1) == (offset == 1 or c == 6)
    launches = (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES)
    y = fused_gn.gn_lrelu_fwd(x, sc, bi, groups)
    got = fused_gn.gn_lrelu_bwd(x, dy, sc, bi, groups)
    torch.cuda.synchronize()
    assert (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    want = fused_gn.gn_lrelu_reference(x, sc, bi, groups).float()
    err = (y.float() - want).abs()
    if dtype == torch.float32:
        assert err.max().item() < 2e-5
    else:
        assert (err <= 3e-2 * want.abs().clamp(min=1)).all()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for g, w, t in zip(got, fused_gn.gn_lrelu_bwd_reference(x, dy, sc, bi, groups),
                       (tol, 2e-5, 2e-5)):
        w = w.float()
        assert (g.float() - w).abs().max().item() / max(1.0, w.abs().max().item()) < t


@pytest.mark.parametrize("shape", [(2032, 32, 32, 16), (64, 64, 64, 16), (1600, 2, 2, 128)])
def test_bwd_param_grads_are_bitwise_repeatable(card, shape):
    gen = torch.Generator(card).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen, device=card).to(dtype)
        dy = torch.randn(shape, generator=gen, device=card).to(dtype)
        sc = torch.randn(shape[-1], generator=gen, device=card) * 0.5 + 1
        bi = torch.randn(shape[-1], generator=gen, device=card) * 0.1
        first = fused_gn.gn_lrelu_bwd(x, dy, sc, bi, 8)
        second = fused_gn.gn_lrelu_bwd(x, dy, sc, bi, 8)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)
    for tickets in fused_gn._tickets.values():  # left zero for the next launch
        assert not tickets.any()


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


def _dtw_check(got, want, ends):
    w, f, bk = got
    w_ref, f_ref, bk_ref = want
    for d, ref in ((f, f_ref), (bk, bk_ref)):
        finite = ref > sdtw.NEG_INF / 2
        assert torch.equal(d > sdtw.NEG_INF / 2, finite) and torch.isfinite(d).all()
        err = (d - ref).abs()[finite] / ref.abs()[finite].clamp(min=1)
        assert err.max().item() < 1e-4
    assert (w - w_ref).abs().max().item() < 1e-4
    for k in range(w.shape[0]):  # no mass past the end
        assert bool((w[k, :, int(ends[k]) + 1:].abs() < 1e-6).all())


@pytest.mark.parametrize("b,r,c", [
    (16, 127, 100), (3, 15, 9), (2, 31, 20), (1, 7, 7), (2, 511, 500),
    (1, 129, 129),  # resident, two warps a chain, plain copies (odd r * c)
    (2, 511, 129),  # streamed with plain copies
    (1, 1100, 1030),  # 8 columns a lane, five warps a chain
    (1, 2457, 2457)])  # 12 columns a lane, seven warps a chain
def test_soft_dtw_kernel_matches_row_twin(card, b, r, c):
    cost, ends = _dtw_inputs(card, b, r, c)
    launches = sdtw.LAUNCHES
    got = sdtw.k3(cost, ends, return_dp=True)
    torch.cuda.synchronize()
    assert sdtw.LAUNCHES == launches + 1
    _dtw_check(got, sdtw.soft_dtw_rows_reference(cost, ends, return_dp=True), ends)


def test_soft_dtw_kernel_at_an_unaligned_address(card):
    cost, ends = _dtw_inputs(card, 3, 127, 100, seed=2)
    view = _at_offset(cost, 1)  # not 16-byte aligned: plain copies, 4-byte epilogue
    assert not sdtw.launch_plan(127, 100, view.data_ptr() % 16 == 0).vec
    _dtw_check(sdtw.k3(view, ends, return_dp=True),
               sdtw.soft_dtw_rows_reference(cost, ends, return_dp=True), ends)


def test_soft_dtw_on_a_cuda_tensor_is_one_k3_launch(card):
    cost, ends = _dtw_inputs(card, 4, 15, 10, seed=1)
    launches = sdtw.LAUNCHES
    w = sdtw.soft_dtw(cost.requires_grad_(), ends)
    torch.cuda.synchronize()
    assert sdtw.LAUNCHES == launches + 1 and w.is_cuda and w.grad_fn is None
    assert torch.equal(w, sdtw.soft_dtw(cost, ends))  # the same on every run
    for shape in ((16, 127, 100), (2, 511, 500)):
        cost, ends = _dtw_inputs(card, *shape, seed=3)
        first, second = (sdtw.k3(cost, ends, return_dp=True) for _ in range(2))
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_soft_dtw_log1p_is_the_librarys_on_the_unit_interval(card):
    """K3's branch-free log1p equals log1pf on every float in [0, 1], the
    range of its argument expf(-|a - b|)."""
    assert sdtw.log1p_mismatches(card) == 0


def test_soft_dtw_takes_int32_ends_through_a_cast(card):
    """int32 end_inds work through `soft_dtw`, which casts them to int64 (one
    cast launch before K3); the kernel wrapper itself raises for them."""
    cost, ends = _dtw_inputs(card, 3, 15, 9, seed=4)
    assert torch.equal(sdtw.soft_dtw(cost, ends.to(torch.int32)), sdtw.soft_dtw(cost, ends))
    with pytest.raises(ValueError, match="end_inds must be int64"):
        sdtw.k3(cost, ends.to(torch.int32))


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


@pytest.mark.parametrize("ties", [False, True])
def test_eval_dtw_on_card_matches_cpu(card, ties):
    gen = torch.Generator().manual_seed(5)
    cost = torch.rand(16, 127, 100, generator=gen)
    if ties:
        cost = torch.randint(0, 3, (16, 127, 100), generator=gen).float()
    ends = torch.randint(0, 100, (16,), generator=gen)
    ends[0], ends[-1] = 99, 0
    assert torch.equal(dtw.min_cumsum(cost.to(card)).cpu(), dtw.min_cumsum(cost))
    inds, dist = dtw.batched_dtw_alignment(cost.to(card), ends.to(card))
    want_inds, want_dist = dtw.batched_dtw_alignment(cost, ends)
    assert torch.equal(inds.cpu(), want_inds) and torch.equal(dist.cpu(), want_dist)


def test_small_tree_in_bf16_on_card(card):
    hp = default_hparams()
    hp.overwrite(dict(batch_size=2, max_seq_len=10, img_sz=16, hierarchy_levels=3,
                      matching_type="balanced", seq_enc="conv", tree_lstm="split_linear",
                      lstm_init="mlp", regress_length=True,
                      decoder_distribution="discrete_logistic_mixture"))
    torch.manual_seed(0)
    cpu = TreeModel(dict(hp), dtype=torch.bfloat16)
    gpu = TreeModel(dict(hp), dtype=torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(card, memory_format=torch.channels_last)
    rng = np.random.RandomState(1)
    seq = torch.from_numpy((rng.rand(2, 10, 16, 16, 3) * 2 - 1).astype(np.float32))
    inputs = AttrDict(I_0=seq[:, 0], I_g=seq[:, 9], end_ind=torch.tensor([9, 6]),
                      z=torch.from_numpy(rng.randn(2, 7, 32).astype(np.float32)))
    norm_inputs = []
    for m in gpu.modules():
        if isinstance(m, nets.GroupNorm):
            m.register_forward_pre_hook(lambda mod, args: norm_inputs.append(args[0].dtype))
    launches = fused_gn.LAUNCHES
    with torch.inference_mode():
        got = gpu(AttrDict({k: v.to(card) for k, v in inputs.items()}), phase="test")
        want = cpu(inputs, phase="test")
    torch.cuda.synchronize()
    # 16x16 images: 4 conv levels, so 4 norms in each of the two encoder
    # calls (start, goal) and in the decoder
    assert fused_gn.LAUNCHES - launches == len(norm_inputs) == 12
    assert set(norm_inputs) == {torch.bfloat16}
    for k in ("images", "e_g_prime"):
        assert got.tree[k].dtype == torch.float32
        assert (got.tree[k].cpu() - want.tree[k]).abs().mean().item() < 1e-2, k

    batch = AttrDict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, 9], end_ind=torch.tensor([9, 6]),
                     pad_mask=(torch.arange(10)[None] <= torch.tensor([[9], [6]])).float())
    params = [p for p in gpu.parameters() if p.requires_grad]
    before = [p.detach().clone() for p in params]
    metrics = train_step(gpu.train(), make_optimizer(params, "radam"),
                         AttrDict({k: v.to(card) for k, v in batch.items()}), 0,
                         torch.Generator(card).manual_seed(0))
    assert bool(metrics.grads_finite)
    assert {p.dtype for p in params} == {p.grad.dtype for p in params} == {torch.float32}
    assert sum(not torch.equal(p, b) for p, b in zip(params, before)) > len(params) // 2


def _small_planner_hp():
    hp = default_hparams()
    hp.overwrite(dict(batch_size=1, max_seq_len=15, img_sz=16, hierarchy_levels=4,
                      matching_type="balanced", tree_lstm="sum", regress_length=True,
                      length_pred_weight=0.0, attach_inv_mdl=True,
                      inv_mdl_params=dict(n_actions=2), attach_state_regressor=True,
                      state_dim=2, n_actions=2, nz_vae=8))
    return hp


def test_simulator_on_card_matches_cpu(card):
    """The CEM simulator's rollouts of a small GCP-tree, card against CPU,
    with the same injected z and end_ind (length_pred_weight=0 keeps the
    given end_ind): images 2e-4, latents 5e-4, actions and states 1e-4; K1
    at each of the 12 norms (16x16: 4 per encoder call and decoder)."""
    from video_gcp_torch.planning.cem.simulator import GCPImageSimulator

    torch.manual_seed(0)
    cpu = TreeModel(dict(_small_planner_hp())).eval()
    gpu = TreeModel(dict(_small_planner_hp())).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(card)
    rng = np.random.RandomState(0)
    state = rng.randint(0, 256, (1, 16, 16, 3)).astype(np.uint8)
    goal = rng.rand(1, 16, 16, 3).astype(np.float32)
    z = rng.randn(10, 15, 8).astype(np.float32)
    launches = fused_gn.LAUNCHES
    got = GCPImageSimulator(gpu, append_latent=True).rollout(state, goal, z, 15)
    assert fused_gn.LAUNCHES - launches == 12
    want = GCPImageSimulator(cpu, append_latent=True).rollout(state, goal, z, 15)
    for i in range(len(z)):
        g, w = got.predictions[i], want.predictions[i]
        assert g.shape == w.shape == (15, 16 * 16 * 3 + 32)
        assert np.abs(g[:, :-32] - w[:, :-32]).max() < 2e-4
        assert np.abs(g[:, -32:] - w[:, -32:]).max() < 5e-4
        assert np.abs(got.actions[i] - want.actions[i]).max() < 1e-4
        assert np.abs(got.states[i] - want.states[i]).max() < 1e-4


def test_infer_action_on_card_matches_cpu(card):
    """One closed-loop action of the 9-room ep74 ImageCEMPolicy, card
    against CPU, within 1e-4; 5 K1 launches (the encoder's norms)."""
    from pathlib import Path

    from video_gcp_torch.planning.run import load_control_config

    repo = Path(__file__).resolve().parent.parent
    weights = str(repo / "experiments/prediction/9room/gcp_tree/pretrained_ep74.npz")
    policy = load_control_config(repo / "experiments/control/9room/gcp_tree/mod_hyper.py")[
        "policy"]
    cem = dict(policy["cem_params"], cost_config=dict(policy["cem_params"]["cost_config"],
                                                      load_epoch=weights))
    conf = dict(policy, load_epoch=weights, cem_params=cem)
    on_card = policy["type"](dict(T=200, device="cuda"), conf)
    on_cpu = policy["type"](dict(T=200, device="cpu"), conf)
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    target = rng.randn(128).astype(np.float32)
    launches = fused_gn.LAUNCHES
    got = on_card._infer_action(img, target)
    assert fused_gn.LAUNCHES - launches == 5
    assert np.abs(got - on_cpu._infer_action(img, target)).max() < 1e-4


@pytest.mark.parametrize("model", ["gcp_tree", "gcp_sequential"])
def test_trainer_on_an_h5_dataset_on_card(card, model, tmp_path, monkeypatch):
    """Two train steps of each model of the 9-room experiments, at a cut
    width and horizon, from h5 files of the data generation's layout read
    through the maze re-renderer: the profiler sees K1 and K2 at every norm
    of each step, as many as the wrappers count, and the losses are
    finite."""
    import shutil
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from video_gcp_torch.data import h5
    from video_gcp_torch.training.trainer import ModelTrainer, parse_args

    repo = Path(__file__).resolve().parent.parent
    rng = np.random.RandomState(0)
    data = tmp_path / "data/nav_9rooms"
    data.mkdir(parents=True)
    for i in range(5):
        path = np.clip(np.cumsum(rng.uniform(-0.02, 0.02, (12, 2)), 0)
                       + rng.uniform(-0.4, 0.4, 2), -0.45, 0.45)
        with h5.File(data / f"traj_{i}.h5", "w") as f:
            f.create_dataset("traj_per_file", data=1)
            f.create_dataset("traj0/images", data=np.zeros((12, 1, 32, 32, 3), np.uint8))
            f.create_dataset("traj0/states", data=np.concatenate(
                [path, np.zeros((12, 1)), np.tile(path[-1], (12, 1))], 1))
            f.create_dataset("traj0/actions", data=rng.randn(11, 2) * 0.1)
            f.create_dataset("traj0/pad_mask", data=np.ones(12))
    conf = tmp_path / f"experiments/prediction/nav/{model}/conf.py"
    shutil.copytree(repo / "experiments/prediction/base_configs",
                    tmp_path / "experiments/prediction/base_configs")
    conf.parent.mkdir(parents=True)
    conf.write_text(
        "from video_gcp_tpu.core.attrdict import AttrDict\n"
        "from video_gcp_tpu.data.configs.nav_9rooms import config as nav\n"
        f"from experiments.prediction.base_configs import {model} as b\n"
        "configuration = AttrDict(b.configuration)\n"
        "configuration.update(dict(dataset_name='nav_9rooms', batch_size=2, lr=1e-3))\n"
        "data_config = AttrDict(nav)\n"
        "data_config.dataset_spec = AttrDict(nav.dataset_spec, max_seq_len=8)\n"
        "model_config = AttrDict(b.model_config)\n"
        "model_config.update(dict(img_sz=16, nz_mid_lstm=16, nz_vae=4,\n"
        "    regress_length=True, decoder_distribution='discrete_logistic_mixture'))\n"
        "model_config.pop('add_weighted_pixel_copy')\n")
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    trainer = ModelTrainer(parse_args(["--path", str(conf.parent), "--num_epochs", "1",
                                       "--skip_first_val", "1"]))
    launches = (fused_gn.LAUNCHES, fused_gn.BWD_LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run()
        torch.cuda.synchronize()
    counted = (fused_gn.LAUNCHES - launches[0], fused_gn.BWD_LAUNCHES - launches[1])
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = tuple(sum(e.count for e in kernels if name in e.key)
                 for name in ("gn_lrelu_fwd", "gn_lrelu_bwd"))
    # 4 norms a conv pyramid at 16x16: 3 encoder calls and the decoder
    assert trainer.step == 2, trainer.step
    assert counted == (32, 32) and seen == counted, (counted, seen,
                                                     [e.key for e in kernels][:40])
