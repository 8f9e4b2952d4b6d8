"""The train step's gradients as views into one flat buffer
(`parallel/train_step.py:GradBuffer`), against a copy of the per-tensor
guard it replaced: zero_grad(set_to_none), the zero-fill of the gradients
autograd left out, and a finite flag, a masked_fill_ and a norm a tensor.

On the CPU at small widths (torch on one thread): a tied tree
(gcp_tree.9room) and an untied one (gcp_tree.25room), built as the
benchmark builds them, channels_last conv weights included. Parameters and
RAdam's state must equal the guard's bit for bit; `grad_norm` is one
reduction over a buffer in place of a norm of norms, so it may round
differently (1e-6 relative).
"""
import copy
import json
from pathlib import Path

import pytest
import torch

from gcpbench import generate, program, weights
from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.parallel.train_step import make_optimizer, train_step

ROOT = Path(__file__).resolve().parents[1]
L, T, B = 4, 12, 2
SMALL = dict(hierarchy_levels=L, ngf=8, img_sz=8, nz_enc=16, nz_mid=16, nz_mid_lstm=16,
             nz_vae=8, max_seq_len=T)
CONFIGS = {"tied": "gcp_tree.9room", "untied": "gcp_tree.25room"}
STEPS = 3
HOOKED = "decoder.conv_transpose.0.weight"
NORM_TOL = 1e-6  # relative


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_BUILT = {}


def _model(kind):
    """A fresh copy of the small model of `kind`, its seeded weights and
    `STEPS` batches."""
    if kind not in _BUILT:
        config = json.loads((ROOT / f"gcpbench/configs/{CONFIGS[kind]}.json").read_text())
        model, hp = program.build_model(ROOT, config, "cpu", SMALL)
        weights.assign(model.train(), 11)
        mix = dict(seq_len=T, batch=B, pool_batches=1, lengths=dict(full=0.5, min=3))
        batches = [AttrDict(generate.sequences(mix, hp["img_sz"], B, seed, "cpu"))
                   for seed in range(STEPS)]
        _BUILT[kind] = model, batches
    model, batches = _BUILT[kind]
    return copy.deepcopy(model), batches


def _optimizer(model):
    return make_optimizer([p for p in model.parameters() if p.requires_grad], "radam", lr=2e-4)


def _per_tensor_step(model, optimizer, batch, step, generator):
    """The step's update as it was before the buffer: (grads_finite,
    grad_norm, total loss)."""
    model.zero_grad(set_to_none=True)
    out = model(batch, phase="train", mode="posterior", generator=generator, step=step)
    out.losses.total.value.backward()
    for p in (p for group in optimizer.param_groups for p in group["params"]):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    grads_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    for g in grads:
        g.masked_fill_(~grads_finite, 0.0)
    grad_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    optimizer.step()
    return grads_finite, grad_norm, out.losses.total.value.detach()


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same_state(model, optimizer, want_model, want_optimizer):
    for (name, p), q in zip(model.named_parameters(), want_model.parameters()):
        assert torch.equal(_bits(p.detach()), _bits(q.detach())), name
        state, want = optimizer.state.get(p, {}), want_optimizer.state.get(q, {})
        assert state.keys() == want.keys(), name
        for key in want:
            assert torch.equal(_bits(state[key]), _bits(want[key])), (name, key)


def _plant(model, value, at_step):
    """A hook that puts `value` into one gradient at step `at_step`."""
    calls = {"n": 0}
    param = dict(model.named_parameters())[HOOKED]

    def hook(grad):
        calls["n"] += 1
        if calls["n"] - 1 != at_step:
            return grad
        grad = grad.clone()
        grad[(0,) * grad.dim()] = value
        return grad

    param.register_hook(hook)


def _run(kind, plant=None):
    """`STEPS` steps of the buffered step and of the per-tensor guard on two
    copies of one model; returns both sides' models, optimizers and each
    step's (grads_finite, grad_norm, loss)."""
    model, batches = _model(kind)
    want_model, _ = _model(kind)
    if plant is not None:
        _plant(model, plant, at_step=1)
        _plant(want_model, plant, at_step=1)
    opt, want_opt = _optimizer(model), _optimizer(want_model)
    gen, want_gen = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got, want = [], []
    for k in range(STEPS):
        m = train_step(model, opt, batches[k], k, gen)
        got.append((m.grads_finite, m.grad_norm, m.total))
        want.append(_per_tensor_step(want_model, want_opt, batches[k], k, want_gen))
        if plant is not None and k == 1:
            assert all(not p.grad.any() for p in model.parameters() if p.requires_grad)
    return (model, opt, got), (want_model, want_opt, want)


@pytest.mark.parametrize("plant", [None, float("nan"), float("inf")],
                         ids=["finite", "nan", "inf"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_steps_equal_the_per_tensor_guard(kind, plant):
    (model, opt, got), (want_model, want_opt, want) = _run(kind, plant)
    for k, ((finite, norm, loss), (want_finite, want_norm, want_loss)) in enumerate(
            zip(got, want)):
        assert bool(finite) == bool(want_finite) == (plant is None or k != 1), k
        assert torch.equal(_bits(loss), _bits(want_loss)), k
        assert abs(float(norm) - float(want_norm)) <= NORM_TOL * float(want_norm), k
        if not bool(want_finite):
            assert float(norm) == 0.0 == float(want_norm)
    _assert_same_state(model, opt, want_model, want_opt)
    assert {int(s["step"]) for s in opt.state.values()} == {STEPS}


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_every_gradient_is_a_view_with_its_parameters_strides(kind):
    (model, _, _), _ = _run(kind)
    params = [p for p in model.parameters() if p.requires_grad]
    flats = {f.untyped_storage().data_ptr() for f in model.grad_buffer.flats}
    assert len(flats) == 1  # one device, one dtype
    for p in params:
        assert p.grad.stride() == p.stride() and p.grad.untyped_storage().data_ptr() in flats
    assert any(p.dim() == 4 and not p.is_contiguous()
               and p.is_contiguous(memory_format=torch.channels_last) for p in params)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_a_parameter_without_a_gradient_keeps_zeros(kind):
    plain, batches = _model(kind)
    out = plain(batches[0], phase="train", mode="posterior",
                generator=torch.Generator().manual_seed(5), step=0)
    out.losses.total.value.backward()
    no_grad = [n for n, p in plain.named_parameters() if p.requires_grad and p.grad is None]
    assert no_grad  # the Gaussian log_sigma under the logistic-mixture decoder
    (model, _, _), _ = _run(kind)
    named = dict(model.named_parameters())
    views = {id(p): v for p, v in zip(model.grad_buffer.params, model.grad_buffer.views)}
    for n in no_grad:
        assert named[n].grad is views[id(named[n])] and not named[n].grad.any(), n


def _drop_grads(model):
    model.zero_grad(set_to_none=True)


def _double_by_hook(model):
    """From now on one gradient is replaced after each accumulation."""
    def hook(p):
        p.grad = p.grad * 2
    dict(model.named_parameters())[HOOKED].register_post_accumulate_grad_hook(hook)


def _contiguous_format(model):
    """The conv weights leave channels_last: new strides and storage."""
    model.to(memory_format=torch.contiguous_format)


@pytest.mark.parametrize("between, misses", [(None, 0), (_drop_grads, 1),
                                             (_double_by_hook, 2), (_contiguous_format, 0)],
                         ids=["bound", "set_to_none", "replaced_by_hook", "new_layout"])
def test_the_counters_and_a_gradient_found_outside_its_view(between, misses):
    model, batches = _model("untied")
    want_model, _ = _model("untied")
    opt, want_opt = _optimizer(model), _optimizer(want_model)
    gen, want_gen = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    counts = []
    for k in range(STEPS):
        if k == 1 and between is not None:
            between(model)
            between(want_model)
        with tracing.session() as s:
            train_step(model, opt, batches[k], k, gen)
        counts.append((s.counts.get("train.grad_buffer.hits", 0),
                       s.counts.get("train.grad_buffer.misses", 0)))
        _per_tensor_step(want_model, want_opt, batches[k], k, want_gen)
    assert counts[0] == (1, 0) and all(h + m == 1 for h, m in counts)
    assert sum(m for _, m in counts) == misses
    _assert_same_state(model, opt, want_model, want_opt)
    flat = model.grad_buffer.flats[0].untyped_storage().data_ptr()
    for p in model.parameters():
        if p.requires_grad:
            assert p.grad.untyped_storage().data_ptr() == flat
            assert p.grad.stride() == p.stride()
