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
- Kernel K4 (the evaluation DTW's DP, traceback and per-frame match in one
  launch) against the CPU twin at [16, 511, 500], [16, 127, 100],
  [4, 255, 200], [3, 499, 499], [2, 1, 7], [2, 9, 1] and, with the choices
  in a device scratch and two bands of rows, [1, 2000, 1000]: D and the
  node indices bit for bit, the distances equal, on random and on integer
  costs full of ties, with ends 0 and c - 1 among them; one K4 launch a
  call; a raise for CPU ends beside a CUDA C, a float64 C and a shape past
  the kernel's limit; a C that is not contiguous is copied.
- The CEM simulator's rollouts of a small GCP-tree and one closed-loop
  action of the 9-room ep74 ImageCEMPolicy, card against CPU (images 2e-4,
  latents 5e-4, actions and states 1e-4), with K1 at every norm.
- A small GCP-tree computing in bf16 over float32 parameters on the card:
  K1 on a bf16 x at every norm, float32 outputs within a mean of 1e-2 of
  the same model in bf16 on the CPU, and a train step that leaves float32
  parameters and gradients.
- The train step's finite mask and norm over its gradient buffer
  (`train.grad_mask`, after two warm-up steps, counted with torch.profiler
  as the benchmark counts launches): the same number of launch calls, at
  most 10, for the tied 9-room tree's 146 tensors and the untied 25-room
  tree's 419, at small widths.
- After a warm-up, one 'pruned_dtw' Evaluator sample of a small GCP-tree
  (the prior forward, the dense sample and the metrics) and one balanced
  train forward (binding and losses included) run under
  `torch.cuda.set_sync_debug_mode("error")`: the tree's constant tables are
  on the card, so nothing blocks the host; no table is uploaded, and the
  outputs equal those of the same calls with the tables uploaded afresh.
"""
import json
from pathlib import Path

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
from video_gcp_torch.evaluation.evaluator import Evaluator
from video_gcp_torch.ops import cuda_build, dtw, fused_gn, tree_index
from video_gcp_torch.ops import soft_dtw as sdtw
from video_gcp_torch.parallel.train_step import make_optimizer, train_step
from video_gcp_torch.tracing import COUNTS

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
        launches = COUNTS["k1.launches"]
        got = fused_gn.fused_group_norm_lrelu(x, sc, bi, groups)
        torch.cuda.synchronize()
        assert COUNTS["k1.launches"] == launches + 1
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
        launches = COUNTS["k1.launches"]
        got = gpu(AttrDict({k: v.to(card) for k, v in inputs.items()}), phase="plan")
        torch.cuda.synchronize()
    assert COUNTS["k1.launches"] - launches == 3 * 4  # 2 encoder passes + decoder, 4 levels
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
        launches = COUNTS["k2.launches"]
        got = fused_gn.gn_lrelu_bwd(x, dy, sc, bi, groups)
        torch.cuda.synchronize()
        assert COUNTS["k2.launches"] == launches + 1
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
    launches = (COUNTS["k1.launches"], COUNTS["k2.launches"])
    y = fused_gn.gn_lrelu_fwd(x, sc, bi, groups)
    got = fused_gn.gn_lrelu_bwd(x, dy, sc, bi, groups)
    torch.cuda.synchronize()
    assert (COUNTS["k1.launches"], COUNTS["k2.launches"]) == (launches[0] + 1, launches[1] + 1)
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
    copies = COUNTS["k2.dy_copies"]
    got = fused_gn.gn_lrelu_bwd(x, dy, torch.ones(16, device=card),
                                torch.zeros(16, device=card), 8)
    assert COUNTS["k2.dy_copies"] == copies + 1
    want = fused_gn.gn_lrelu_bwd_reference(x, dy, torch.ones(16, device=card),
                                           torch.zeros(16, device=card), 8)
    assert (got[0] - want[0]).abs().max().item() < 2e-5


def test_conv_weights_before_a_norm_get_gradients(card):
    hp = default_hparams()
    hp.overwrite(dict(img_sz=16, ngf=8, nz_enc=32))
    enc = ConvEncoder(dict(hp)).to(card, memory_format=torch.channels_last)
    x = torch.randn(4, 16, 16, 3, device=card)
    launches = (COUNTS["k1.launches"], COUNTS["k2.launches"])
    e, _ = enc(x)
    e.square().sum().backward()
    torch.cuda.synchronize()
    assert COUNTS["k1.launches"] - launches[0] == 4 == COUNTS["k2.launches"] - launches[1]
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
    launches = (COUNTS["k1.launches"], COUNTS["k2.launches"])
    got = run(gpu, batch, card)
    torch.cuda.synchronize()
    # 3 encoder calls + the decoder, 4 norm sites each
    assert COUNTS["k1.launches"] - launches[0] == 16 == COUNTS["k2.launches"] - launches[1]
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
    launches = COUNTS["k3.launches"]
    got = sdtw.k3(cost, ends, return_dp=True)
    torch.cuda.synchronize()
    assert COUNTS["k3.launches"] == launches + 1
    _dtw_check(got, sdtw.soft_dtw_rows_reference(cost, ends, return_dp=True), ends)


def test_soft_dtw_kernel_at_an_unaligned_address(card):
    cost, ends = _dtw_inputs(card, 3, 127, 100, seed=2)
    view = _at_offset(cost, 1)  # not 16-byte aligned: plain copies, 4-byte epilogue
    assert not sdtw.launch_plan(127, 100, view.data_ptr() % 16 == 0).vec
    _dtw_check(sdtw.k3(view, ends, return_dp=True),
               sdtw.soft_dtw_rows_reference(cost, ends, return_dp=True), ends)


def test_soft_dtw_on_a_cuda_tensor_is_one_k3_launch(card):
    cost, ends = _dtw_inputs(card, 4, 15, 10, seed=1)
    launches = COUNTS["k3.launches"]
    w = sdtw.soft_dtw(cost.requires_grad_(), ends)
    torch.cuda.synchronize()
    assert COUNTS["k3.launches"] == launches + 1 and w.is_cuda and w.grad_fn is None
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
    launches = COUNTS["k3.launches"]
    got = run(gpu, batch, card)
    torch.cuda.synchronize()
    assert COUNTS["k3.launches"] - launches == 1
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


def _k4_inputs(b, r, c, ties, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if ties:  # many equal cells and equal paths
        cost = torch.randint(0, 3, (b, r, c), generator=gen).float()
    else:
        cost = torch.rand(b, r, c, generator=gen)
    ends = torch.randint(0, c, (b,), generator=gen)
    ends[0], ends[-1] = c - 1, 0
    return cost, ends


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("b,r,c", [(16, 511, 500), (16, 127, 100), (4, 255, 200),
                                   (3, 499, 499), (2, 1, 7), (2, 9, 1), (1, 2000, 1000)])
def test_k4_matches_the_cpu_twin(card, b, r, c, ties):
    cost, ends = _k4_inputs(b, r, c, ties)
    assert dtw.launch_plan(r, c).shared == (r < 2000)
    launches = COUNTS["k4.launches"]
    inds, dist, D = dtw.k4(cost.to(card), ends.to(card), return_dp=True)
    torch.cuda.synchronize()
    assert COUNTS["k4.launches"] == launches + 1
    want_inds, want_dist = dtw.alignment_reference(cost, ends)
    assert torch.equal(D.cpu(), dtw.min_cumsum(cost))
    assert torch.equal(inds.cpu(), want_inds)
    assert torch.equal(dist.cpu(), want_dist)


@pytest.mark.parametrize("r,c,shared", [(876, 929, 1), (892, 913, 0)])
def test_k4_at_the_shared_memory_limit(card, r, c, shared):
    """The plan that fills the opt-in limit exactly launches (the kernel has
    no static shared memory beside it), and the next one takes the scratch."""
    plan = dtw.launch_plan(r, c)
    assert (plan.shared, plan.smem == cuda_build.SMEM_LIMIT) == (shared, bool(shared))
    cost, ends = _k4_inputs(1, r, c, False, seed=6)
    inds, dist, D = dtw.k4(cost.to(card), ends.to(card), return_dp=True)
    want_inds, want_dist = dtw.alignment_reference(cost, ends)
    assert torch.equal(D.cpu(), dtw.min_cumsum(cost))
    assert torch.equal(inds.cpu(), want_inds) and torch.equal(dist.cpu(), want_dist)


def test_k4_is_one_launch_a_call_and_raises_for_what_it_does_not_take(card):
    cost, ends = _k4_inputs(3, 31, 20, False, seed=1)
    want = dtw.batched_dtw_alignment(cost, ends)
    launches = COUNTS["k4.launches"]
    got = dtw.batched_dtw_alignment(cost.to(card), ends.to(card))
    torch.cuda.synchronize()
    assert COUNTS["k4.launches"] == launches + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    view = cost.to(card).transpose(1, 2).contiguous().transpose(1, 2)  # copied
    assert not view.is_contiguous()
    got = dtw.batched_dtw_alignment(view, ends.to(card))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    with pytest.raises(ValueError, match="end_inds"):
        dtw.batched_dtw_alignment(cost.to(card), ends)
    with pytest.raises(ValueError, match="float32"):
        dtw.batched_dtw_alignment(cost.to(card, torch.float64), ends.to(card))
    big = torch.zeros(1, 4, dtw.MAX_FRAMES + 1, device=card)
    with pytest.raises(ValueError, match="the kernel takes"):
        dtw.batched_dtw_alignment(big, torch.zeros(1, dtype=torch.int64, device=card))
    assert COUNTS["k4.launches"] == launches + 2


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
    launches = COUNTS["k1.launches"]
    with torch.inference_mode():
        got = gpu(AttrDict({k: v.to(card) for k, v in inputs.items()}), phase="test")
        want = cpu(inputs, phase="test")
    torch.cuda.synchronize()
    # 16x16 images: 4 conv levels, so 4 norms in each of the two encoder
    # calls (start, goal) and in the decoder
    assert COUNTS["k1.launches"] - launches == len(norm_inputs) == 12
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
    launches = COUNTS["k1.launches"]
    got = GCPImageSimulator(gpu, append_latent=True).rollout(state, goal, z, 15)
    assert COUNTS["k1.launches"] - launches == 12
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
    launches = COUNTS["k1.launches"]
    got = on_card._infer_action(img, target)
    assert COUNTS["k1.launches"] - launches == 5
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
    launches = (COUNTS["k1.launches"], COUNTS["k2.launches"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run()
        torch.cuda.synchronize()
    counted = (COUNTS["k1.launches"] - launches[0], COUNTS["k2.launches"] - launches[1])
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = tuple(sum(e.count for e in kernels if name in e.key)
                 for name in ("gn_lrelu_fwd", "gn_lrelu_bwd"))
    # 4 norms a conv pyramid at 16x16: 3 encoder calls and the decoder
    assert trainer.step == 2, trainer.step
    assert counted == (32, 32) and seen == counted, (counted, seen,
                                                     [e.key for e in kernels][:40])


# ---------------------------------------------------------------------------
# The VRNN's rollout as CUDA graphs (models/loop_graph.py)
# ---------------------------------------------------------------------------

VRNN_SMALL = dict(batch_size=2, max_seq_len=12, img_sz=16, ngf=4, nz_mid_lstm=32,
                  n_lstm_layers=2, nz_mid=32, nz_enc=32, nz_vae=8,
                  one_step_planner="continuous", dense_rec_type="svg", hierarchy_levels=0,
                  decoder_distribution="gaussian")
VRNN_VARIANTS = {"lstm": {},
                 "act_cond_conv_lstm": dict(action_conditioned_pred=True, use_conv_lstm=True,
                                            n_actions=2)}
GRAPH_COUNTERS = ("rollout.graph_captures", "rollout.graph_replays")
OUT_TOL, GRAD_TOL = 1e-6, 1e-5  # of each tensor's largest


def _vrnn(card, variant):
    from video_gcp_torch.models.sequential import SequentialModel
    hp = default_hparams()
    hp.overwrite(VRNN_SMALL)
    hp.overwrite(VRNN_VARIANTS[variant])
    torch.manual_seed(0)
    return SequentialModel(dict(hp)).to(card)


def _vrnn_inputs(model, card, b=2):
    """(state, x, context, x_primes, more, z) of a rollout, as CPU tensors."""
    from video_gcp_torch.models.nets import lstm_state_size
    hp, g = model.hp, torch.Generator().manual_seed(1)
    nz, t = hp["nz_enc"], hp["max_seq_len"]
    e_0, e_g = (torch.randn(b, nz, generator=g) for _ in range(2))
    more = torch.randn(b, t - 1, nz, generator=g) if hp["action_conditioned_pred"] else None
    return [torch.randn(b, lstm_state_size(hp), generator=g), e_0, torch.cat([e_0, e_g], -1),
            torch.randn(b, t, nz, generator=g), more, None]


def _graph_counts():
    return tuple(COUNTS[k] for k in GRAPH_COUNTERS)


class _Rollout:
    """One rollout of `model` from `inputs` (fresh leaves on the card) and
    the noise of a generator seeded 0, through the model's graphs or, with
    `eager`, through the loop itself; `backward()` then takes a fixed
    weighted sum of its outputs back to the inputs and the cell."""

    def __init__(self, model, inputs, card, eager=False, mode="posterior"):
        self.model = model
        self.leaves = [None if t is None else t.to(card, copy=True).requires_grad_()
                       for t in inputs]
        self.gen = torch.Generator(card).manual_seed(0)
        if eager:
            self.outputs = model.rollout(*self.leaves, eps=None, mode=mode, generator=self.gen)
        else:
            from video_gcp_torch.models.sequential import rollout_noise
            self.outputs = model.rollout_graph(model.rollout, self.leaves, model.cell, mode,
                                               self.gen, rollout_noise)
        self.gen_state = self.gen.get_state()

    def backward(self):
        g = torch.Generator().manual_seed(2)
        self.model.zero_grad(set_to_none=True)
        sum((o * torch.randn(o.shape, generator=g).to(o.device)).sum()
            for o in self.outputs).backward()
        return dict(outputs=[o.detach().clone() for o in self.outputs],
                    inputs=[t.grad.clone() for t in self.leaves if t is not None],
                    params={n: p.grad.clone() for n, p in self.model.cell.named_parameters()
                            if p.grad is not None})


def _assert_same(got, want):
    for kind, tol in (("outputs", OUT_TOL), ("inputs", GRAD_TOL)):
        assert len(got[kind]) == len(want[kind])
        for k, (a, b) in enumerate(zip(got[kind], want[kind])):
            scale = max(b.abs().max().item(), 1e-30)
            assert (a - b).abs().max().item() <= tol * scale, (kind, k)
    assert got["params"].keys() == want["params"].keys()
    for name, b in want["params"].items():
        scale = max(b.abs().max().item(), 1e-30)
        assert (got["params"][name] - b).abs().max().item() <= GRAD_TOL * scale, name


@pytest.mark.parametrize("variant", list(VRNN_VARIANTS))
def test_rollout_graph_warms_up_captures_and_replays_the_eager_rollout(card, variant):
    model = _vrnn(card, variant)
    inputs = _vrnn_inputs(model, card)
    want = _Rollout(model, inputs, card, eager=True)
    eager_state, eager = want.gen_state, want.backward()
    before = _graph_counts()
    for k in range(3):  # warm-up (eager), capture and replay, replay
        got = _Rollout(model, inputs, card)
        assert torch.equal(got.gen_state, eager_state), k
        _assert_same(got.backward(), eager)
        assert tuple(a - b for a, b in zip(_graph_counts(), before)) == (
            (0, 0), (1, 1), (1, 2))[k]


@pytest.mark.parametrize("variant", list(VRNN_VARIANTS))
def test_rollout_graph_runs_eager_where_a_replay_would_be_wrong(card, variant):
    model = _vrnn(card, variant)
    inputs = _vrnn_inputs(model, card)

    def eager():
        return _Rollout(model, inputs, card, eager=True).backward()

    def counted(expected_delta, run):
        before = _graph_counts()
        out = run()
        assert tuple(a - b for a, b in zip(_graph_counts(), before)) == expected_delta
        return out

    _Rollout(model, inputs, card).backward()  # warm-up
    # a second forward before the first one's backward runs eager
    first = counted((1, 1), lambda: _Rollout(model, inputs, card))
    second = counted((0, 0), lambda: _Rollout(model, inputs, card))
    _assert_same(second.backward(), eager())
    _assert_same(first.backward(), eager())
    counted((0, 1), lambda: _assert_same(_Rollout(model, inputs, card).backward(), eager()))
    # another batch size: one eager call, then a new capture
    wider = _vrnn_inputs(model, card, b=3)
    want = _Rollout(model, wider, card, eager=True).backward()
    for delta in ((0, 0), (1, 1), (0, 1)):
        counted(delta, lambda: _assert_same(_Rollout(model, wider, card).backward(), want))
    # an optimizer step in place between calls: the replay reads the new weights
    opt = torch.optim.SGD(model.cell.parameters(), lr=0.1)
    _Rollout(model, wider, card).backward()
    opt.step()
    counted((0, 1), lambda: _assert_same(_Rollout(model, wider, card).backward(),
                                         _Rollout(model, wider, card, eager=True).backward()))
    # a parameter in new storage: a new key, so eager, then a capture
    weight = next(p for p in model.cell.parameters() if p.requires_grad)
    weight.data = weight.data.clone()
    for delta in ((0, 0), (1, 1)):
        counted(delta, lambda: _assert_same(_Rollout(model, wider, card).backward(),
                                            _Rollout(model, wider, card, eager=True)
                                            .backward()))


def test_train_steps_through_the_rollout_graph_match_eager_steps(card):
    """Three train steps of a small VRNN, the second capturing and the
    third replaying, against three steps of the same model that each start
    from empty graphs (every rollout eager): losses within 1e-5, parameters
    within 1e-5 of each one's largest."""
    from video_gcp_torch.models.loop_graph import LoopGraph
    graphed, eager = _vrnn(card, "lstm"), _vrnn(card, "lstm")
    rng = np.random.RandomState(0)
    t = VRNN_SMALL["max_seq_len"]
    seq = torch.from_numpy((rng.rand(2, t, 16, 16, 3) * 2 - 1).astype(np.float32))
    batch = AttrDict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, -1],
                     end_ind=torch.tensor([t - 1, 7]), pad_mask=torch.ones(2, t))
    batch = AttrDict({k: v.to(card) for k, v in batch.items()})
    runs = {}
    before = _graph_counts()
    for name, model in (("graphed", graphed), ("eager", eager)):
        opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam")
        gen = torch.Generator(card).manual_seed(0)
        totals = []
        for step in range(3):
            if name == "eager":
                model.rollout_graph = LoopGraph(captures="rollout.graph_captures",
                                                replays="rollout.graph_replays")
            totals.append(train_step(model, opt, batch, step, gen).total.item())
        runs[name] = totals
        if name == "graphed":
            assert tuple(a - b for a, b in zip(_graph_counts(), before)) == (1, 2)
    for a, b in zip(runs["graphed"], runs["eager"]):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
    want = dict(eager.named_parameters())
    for name, p in graphed.named_parameters():
        scale = max(want[name].abs().max().item(), 1e-30)
        assert (p - want[name]).abs().max().item() <= 1e-5 * scale, name


# ---------------------------------------------------------------------------
# The GCP tree's level loop as CUDA graphs (models/loop_graph.py)
# ---------------------------------------------------------------------------

TREE_GRAPH_COUNTERS = ("tree_graph.captures", "tree_graph.replays")
_ATTENTIVE_HP = dict(batch_size=2, max_seq_len=10, img_sz=16, hierarchy_levels=4,
                     matching_type="dtw_image", attentive_inference=True,
                     learn_matching_temp=False, seq_enc="conv", tree_lstm="sum",
                     regress_length=True, decoder_distribution="gaussian")
TREE_GRAPH_VARIANTS = ("tied", "untied", "attentive", "bf16")


def _graph_tree(card, variant):
    """A small tree on the card: the tied 9-room-like one of
    `_small_train_hp`, its untied twin, the small adaptive tree with
    attentive inference, or the tied one computing in bf16."""
    if variant == "attentive":
        hp = default_hparams()
        hp.overwrite(_ATTENTIVE_HP)
        hp = dict(hp)
    else:
        hp = dict(_small_train_hp(), untied_layers=variant == "untied")
    torch.manual_seed(0)
    model = TreeModel(hp, dtype=torch.bfloat16 if variant == "bf16" else None)
    return model.to(card, memory_format=torch.channels_last).train()


def _tree_batch(card):
    rng = np.random.RandomState(0)
    seq = torch.from_numpy((rng.rand(2, 10, 16, 16, 3) * 2 - 1).astype(np.float32)).to(card)
    end = torch.tensor([9, 6], device=card)
    return AttrDict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[torch.arange(2), end], end_ind=end,
                    start_ind=torch.zeros(2, dtype=torch.int64, device=card),
                    pad_mask=(torch.arange(10, device=card)[None] <= end[:, None]).float(),
                    actions=torch.from_numpy(rng.randn(2, 9, 2).astype(np.float32) * 0.1)
                    .to(card),
                    traj_seq_states=torch.from_numpy(rng.rand(2, 10, 2).astype(np.float32))
                    .to(card))


def _tree_graph_counts():
    return tuple(COUNTS[k] for k in TREE_GRAPH_COUNTERS)


def _fresh_level_graph(model):
    """Graphs made afresh: the model's next training call runs eager."""
    from video_gcp_torch.models.loop_graph import LoopGraph
    graph = model.level_graph
    model.level_graph = LoopGraph(graph.captures, graph.replays, graph.spans)


def _close(got: dict, want: dict, what=""):
    """Each value within 1e-5 of max(1, |value|), each tensor within 1e-4 of
    max(1e-3, its largest), as the card-vs-CPU step holds its gradients:
    the graph sums a loop input's gradient inside the loop before autograd
    adds the rest, so the encoder's gradients differ from the eager ones by
    rounding (1.8e-5 of `encoder.conv.3.weight`'s largest in the untied
    tree on an H100)."""
    assert got.keys() == want.keys()
    gaps = {}
    for k, b in want.items():
        if torch.is_tensor(b):
            gaps[k] = (got[k] - b).abs().max().item() / max(b.abs().max().item(), 1e-3) / 1e-4
        else:
            gaps[k] = abs(got[k] - b) / max(1.0, abs(b)) / 1e-5
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    assert gaps[worst[0]] <= 1, (what, [(k, gaps[k]) for k in worst])


@pytest.mark.parametrize("variant", TREE_GRAPH_VARIANTS)
def test_train_steps_through_the_tree_graph_match_eager_steps(card, variant):
    """Four train steps of a small tree (the warm-up, the capture and two
    replays) against four steps of the same model whose graphs are made
    afresh before each step (every level loop eager): each step's losses,
    the gradients after each step and the parameters after the last as
    `_close` holds them; the generators end in the same state; the counters read
    0/1/1/1 captures and 0/1/2/3 replays."""
    runs = {}
    for name in ("graphed", "eager"):
        model = _graph_tree(card, variant)
        batch = _tree_batch(card)
        opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam")
        gen = torch.Generator(card).manual_seed(0)
        before = _tree_graph_counts()
        steps = []
        for step in range(4):
            if name == "eager":
                _fresh_level_graph(model)
            m = train_step(model, opt, batch, step, gen)
            steps.append(dict(
                losses={k: v.item() for k, v in m.items() if v.dim() == 0
                        and v.is_floating_point()},
                grads={n: p.grad.detach().clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                counts=tuple(a - b for a, b in zip(_tree_graph_counts(), before))))
            assert bool(m.grads_finite)
        runs[name] = dict(steps=steps, gen=gen.get_state(),
                          params={n: p.detach().clone() for n, p in model.named_parameters()})
    graphed, eager = runs["graphed"], runs["eager"]
    assert [s["counts"] for s in graphed["steps"]] == [(0, 0), (1, 1), (1, 2), (1, 3)]
    assert [s["counts"] for s in eager["steps"]] == [(0, 0)] * 4
    for step, (got, want) in enumerate(zip(graphed["steps"], eager["steps"])):
        _close(got["losses"], want["losses"], f"losses, step {step}")
        _close(got["grads"], want["grads"], f"gradients, step {step}")
    assert torch.equal(graphed["gen"], eager["gen"])
    _close(graphed["params"], eager["params"], "parameters")


def test_tree_graph_runs_eager_where_a_replay_would_be_wrong(card):
    """On the untied tree: a training forward made while the last replay
    awaits its backward runs eager, and both backwards then give the eager
    model's gradients (`.grad` None before each: the copies autograd makes
    of the graph's own gradients); prior-mode, injected-z and no_grad
    calls on the card leave the graphs as they are; a replay is one
    `model.tree_level` span and one `tree_level.bwd` span."""
    from video_gcp_torch import tracing
    model, want_model = _graph_tree(card, "untied"), _graph_tree(card, "untied")
    batch = _tree_batch(card)

    def forward(m, seed, **kwargs):
        kwargs = dict(dict(phase="train", mode="posterior"), **kwargs)
        return m(batch, generator=torch.Generator(card).manual_seed(seed), **kwargs)

    def backward(m, out):
        m.zero_grad(set_to_none=True)
        out.losses.total.value.backward()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()
                 if p.grad is not None}
        return dict(grads, total=out.losses.total.value.item())

    def eager(seed):
        _fresh_level_graph(want_model)
        return backward(want_model, forward(want_model, seed))

    def counted(expected_delta, run):
        before = _tree_graph_counts()
        out = run()
        assert tuple(a - b for a, b in zip(_tree_graph_counts(), before)) == expected_delta
        return out

    counted((0, 0), lambda: backward(model, forward(model, 0)))  # the warm-up
    first = counted((1, 1), lambda: forward(model, 1))
    second = counted((0, 0), lambda: forward(model, 2))  # the replay awaits its backward
    _close(backward(model, second), eager(2))
    _close(backward(model, first), eager(1))
    counted((0, 1), lambda: _close(backward(model, forward(model, 3)), eager(3)))
    key = model.level_graph.key
    z = torch.randn(2, 2 ** 3 - 1, 32, generator=torch.Generator(card).manual_seed(4),
                    device=card)
    for run in (lambda: forward(model, 5, phase="test", mode="prior"),
                lambda: model(AttrDict(batch, z=z), phase="test", mode="posterior"),
                lambda: torch.no_grad()(forward)(model, 6)):
        counted((0, 0), run)
    assert model.level_graph.key == key
    want = eager(7)
    with tracing.session() as s:
        counted((0, 1), lambda: _close(backward(model, forward(model, 7)), want))
    names = [r.name for r in s.records if r.name in ("model.tree_level", "tree_level.bwd")]
    assert names == ["model.tree_level", "tree_level.bwd"], names


@pytest.fixture
def one_rank_group(card, tmp_path):
    """A one-rank NCCL process group on the card."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method="file://" + str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_tree_that_fsdp_split_trains_with_its_levels_eager(card, one_rank_group):
    """dp x fsdp as `shard_model` makes it, over a one-rank ('data',
    'model') mesh with every parameter but the scalars split: FSDP2 gathers
    the parameters anew for each forward, so three train steps of the
    untied tree leave its level graphs empty and the counters as they
    are."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor
    from video_gcp_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, ("data", "model"), (1, 1), "cuda")
    model = _graph_tree(card, "untied")
    scalars = {p for p in model.parameters() if p.dim() == 0}  # FSDP2 splits none
    with torch.no_grad():  # nor a channels_last conv weight (as shard_model does)
        for p in model.parameters():
            p.data = p.data.contiguous()
    fully_shard(model, mesh=mesh, ignored_params=scalars)
    assert all(isinstance(p, DTensor) for p in model.parameters() if p not in scalars)
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam")
    batch, gen = _tree_batch(card), torch.Generator(card).manual_seed(0)
    before = _tree_graph_counts()
    for step in range(3):
        m = train_step(model, opt, batch, step, gen, mesh)
        assert bool(m.grads_finite) and bool(torch.isfinite(m.total))
    assert _tree_graph_counts() == before
    assert model.level_graph.key is None and model.level_graph.graphs is None


def _no_sync_calls(model, evaluator, inputs, batch, card, seeds):
    """One Evaluator sample and one train forward from generators seeded
    `seeds`: the sample's (metrics, dense sample, df nodes) and the forward's
    binding outputs and loss values."""
    gens = [torch.Generator(card).manual_seed(s) for s in seeds]
    m, gen, full = evaluator._eval_sample(inputs, gens[0])
    model.train()
    out = model(batch, phase="train", mode="posterior", generator=gens[1])
    model.eval()
    train = dict(existence_logits=out.existence_logits, gt_match_dists=out.gt_match_dists,
                 **{k: v.value for k, v in out.losses.items()})
    return dict(m, gen=gen, full=full), {k: v.detach() for k, v in train.items()}


def test_an_eval_sample_and_a_train_forward_do_not_synchronise(card, tmp_path, monkeypatch):
    torch.manual_seed(0)
    hp = _small_train_hp()
    model = TreeModel(hp).to(card, memory_format=torch.channels_last).eval()
    rng = np.random.RandomState(0)
    seq = torch.from_numpy((rng.rand(2, 10, 16, 16, 3) * 2 - 1).astype(np.float32)).to(card)
    end = torch.tensor([9, 6], device=card)
    pad = (torch.arange(10, device=card)[None] <= end[:, None]).float()
    inputs = AttrDict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[torch.arange(2), end],
                      end_ind=end, pad_mask=pad)
    batch = AttrDict(inputs, actions=torch.randn(2, 9, 2, device=card) * 0.1,
                     traj_seq_states=torch.rand(2, 10, 2, device=card))
    evaluator = Evaluator(model, str(tmp_path), hp, 10, pruning_scheme="pruned_dtw",
                          top_of_100=False)
    # builds, makes the tables; the train forwards warm up and capture the level graphs
    for seeds in ((1, 2), (5, 6)):
        _no_sync_calls(model, evaluator, inputs, batch, card, seeds)
    torch.cuda.synchronize()
    uploads = COUNTS["tree_index.table_uploads"]
    hits = COUNTS["tree_index.table_hits"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _no_sync_calls(model, evaluator, inputs, batch, card, (3, 4))  # a replay
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the train forward with its levels eager (a fresh LoopGraph's warm-up) too
    graphs = model.level_graph
    _fresh_level_graph(model)
    replays = COUNTS["tree_graph.replays"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        _no_sync_calls(model, evaluator, inputs, batch, card, (7, 8))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert COUNTS["tree_graph.replays"] == replays
    model.level_graph = graphs
    assert COUNTS["tree_index.table_uploads"] == uploads
    assert COUNTS["tree_index.table_hits"] > hits
    monkeypatch.setattr(tree_index, "_TABLES", {})
    want = _no_sync_calls(model, evaluator, inputs, batch, card, (3, 4))
    assert COUNTS["tree_index.table_uploads"] > uploads
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k


def _grad_mask_launches(config_name, device, tmp_path):
    """(update tensors, launch calls inside `train.grad_mask`) of the third
    train step of a configuration at small widths on `device`."""
    from gcpbench import generate, program, program_trace, weights
    from video_gcp_torch import tracing

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / f"gcpbench/configs/{config_name}.json").read_text())
    small = dict(ngf=8, nz_enc=16, nz_mid=16, nz_mid_lstm=16, nz_vae=8, max_seq_len=16)
    model, hp = program.build_model(root, config, device, small)
    weights.assign(model.train(), 0)
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam", lr=2e-4)
    mix = dict(seq_len=16, batch=2, pool_batches=1, lengths=dict(full=1.0, min=16))
    batch = AttrDict(generate.sequences(mix, hp["img_sz"], 2, 0, device))
    gen = torch.Generator(device).manual_seed(0)
    for step in range(2):
        train_step(model, opt, batch, step, gen)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize()
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing.session() as s, torch.profiler.profile(activities=activities) as prof:
        train_step(model, opt, batch, 2, gen)
        if device.type == "cuda":
            torch.cuda.synchronize()
    assert s.counts.get("train.grad_buffer.hits") == 1
    assert "train.grad_buffer.misses" not in s.counts
    path = tmp_path / f"{config_name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return s.counts["train.update_tensors"], program_trace.launches_inside(events, "train.grad_mask")


def test_the_grad_mask_launches_as_many_kernels_for_146_tensors_as_for_419(card, tmp_path):
    got = {name: _grad_mask_launches(name, card, tmp_path)
           for name in ("gcp_tree.9room", "gcp_tree.25room")}
    assert [tensors for tensors, _ in got.values()] == [146, 419], got
    launches = {n for _, n in got.values()}
    assert len(launches) == 1 and 0 < launches.pop() <= 10, got
