"""The sequential VRNN of gcp_sequential.25room_long against the benchmark's
plain reference (gcpbench/reference/sequential.py), its spans, and its cell
train.25room_long_sequential, on the CPU at tiny widths with T=8.

The program and the reference get the same seeded weights
(`gcpbench.weights.assign`), batches (`gcpbench.generate`) and noise (one
generator each, the same seed). Both run float32 on the CPU with the same
torch operations, except GroupNorm + LeakyReLU, which the program computes in
K1's plain twin and the reference in plain `F.group_norm`: their sums run in
another order, so results agree to float32 rounding and not bit for bit.
"""
import ast
import contextlib
import copy
import json
from pathlib import Path

import pytest
import torch

from gcpbench import generate, program, run, spec, weights
from gcpbench.reference import sequential_model as ref
from gcpbench.reference.attrdict import AttrDict as RefAttrDict
from gcpbench.tests.test_gcpbench_run import _broken_train_step
from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.sequential import SequentialModel
from video_gcp_torch.parallel.train_step import make_optimizer, train_step

ROOT = Path(__file__).resolve().parents[1]
CELL = "train.25room_long_sequential"
CONFIG = json.loads((ROOT / "gcpbench/configs/gcp_sequential.25room_long.json").read_text())
T = 8
# the published widths cut in proportion; ngf 8 keeps 4 values a norm group
# at the encoder's last site (ngf 4 leaves 2, whose float32 gradient is
# ill-conditioned in any implementation)
TINY = dict(ngf=8, nz_enc=16, nz_mid=16, nz_mid_lstm=16, nz_vae=8, max_seq_len=T)
TINY_MIX = dict(batch=2, seq_len=T, pool_batches=8, lengths=dict(full=0.5, min=3))
# Relative tolerances, from float32 (eps 1.2e-7) and the reduction order of
# GroupNorm, amplified through T-1 dependent LSTM steps and the backward:
LOSS_RTOL = 1e-6  # a sum over B x T x 32 x 32 x 3 terms
# per element; the atol for leaves whose gradient is near nought (a conv's
# bias before a GroupNorm), where the rounding of the rest dominates
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-7  # three RAdam steps move by lr = 2e-4 a step
IMAGE_ATOL = 1e-5  # decoded tanh images in [-1, 1]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(seed=11):
    prog, hp = program.build_model(ROOT, CONFIG, "cpu", TINY)
    reference = ref.build(hp, "cpu")
    for m in (prog, reference):
        weights.assign(m, seed)
    return prog, reference, hp


def _batch(hp, seed=3, rows=2):
    mix = dict(TINY_MIX, batch=rows)
    return generate.sequences(mix, hp["img_sz"], rows, seed, "cpu")


def _tiny_cell():
    cell = spec.load_cell(CELL, ROOT)
    cell.mix = dict(cell.mix, **TINY_MIX)
    return cell


# (a) the configuration file

def test_the_configuration_file_holds_what_the_experiment_builds():
    hp, cls = program.hparams(ROOT, CONFIG)  # raises where any hparam differs
    assert cls is SequentialModel
    assert program.encode(hp) == CONFIG["hparams"]
    for key, value in CONFIG["published"].items():
        assert hp[key] == value, key
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG["name"])
    assert entry["file"] == "gcpbench/configs/gcp_sequential.25room_long.json"
    assert entry["reduced"] == CONFIG["reduced"] == []
    cell = spec.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["name"] == CONFIG["name"]
    assert cell.mix["kind"] == "train_seq" and set(cell.limits) == {
        "loss", "first_grad", "change_median"}


def test_the_traffic_is_the_tree_cells_but_for_its_loop():
    read = lambda name: json.loads((ROOT / f"gcpbench/traffic/{name}.json").read_text())
    assert read("train_varlen500_seq") == dict(read("train_varlen500"), kind="train_seq")


def test_the_reference_imports_nothing_of_the_program():
    for name in ("sequential.py", "sequential_model.py"):
        tree = ast.parse((ROOT / "gcpbench/reference" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 1 or node.module in ("__future__", "typing", "torch"), \
                    (name, node.module)
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("video_gcp_torch", "video_gcp_tpu", "jax",
                                                 "flax", "optax", "gcpbench"), (name, mod)


def test_flops_per_example_are_affine_in_the_horizon():
    """The stored count at T=500 (FlopCounterMode over the reference at B=1
    on the card) is the line through the counts at T=8 and T=16 at the
    published widths: every part of a step (encoder, rollout, decoder,
    losses, the length predictor's T classes) is linear in T."""
    from torch.utils.flop_counter import FlopCounterMode

    def count(t):
        hp = dict(CONFIG["hparams"], max_seq_len=t)
        torch.manual_seed(0)
        model = ref.build(hp, "cpu").train()
        data = generate.sequences(dict(seq_len=t, batch=1), hp["img_sz"], 1, 0, "cpu")
        with FlopCounterMode(display=False) as fc:
            out = model(RefAttrDict(data), phase="train", mode="posterior",
                        generator=torch.Generator().manual_seed(0), step=0)
            out.losses.total.value.backward()
        return fc.get_total_flops()

    c8, c16 = count(8), count(16)
    per_frame = (c16 - c8) // 8
    assert c16 - c8 == 8 * per_frame
    assert CONFIG["flops"]["train_step_per_example"] == c8 + (500 - 8) * per_frame


# (b) the program against the reference

def test_the_models_hold_the_same_parameters():
    prog, reference, _ = _models()
    a, b = dict(prog.named_parameters()), dict(reference.named_parameters())
    assert sorted(a) == sorted(b)
    for n in a:
        assert a[n].shape == b[n].shape and torch.equal(a[n], b[n]), n
        assert a[n].requires_grad == b[n].requires_grad, n


def test_the_first_step_gives_the_same_loss_and_gradients():
    prog, reference, hp = _models()
    prog.train(), reference.train()
    batch = _batch(hp)
    opt_p = make_optimizer([p for p in prog.parameters() if p.requires_grad], "radam", 2e-4,
                           beta=0.9)
    opt_r = ref.RAdam([p for p in reference.parameters() if p.requires_grad], 2e-4)
    m = train_step(prog, opt_p, AttrDict(batch), 0, torch.Generator().manual_seed(5))
    loss, grads = ref.train_step(reference, opt_r, batch, 0, torch.Generator().manual_seed(5))
    assert float(m.total) == pytest.approx(float(loss), rel=LOSS_RTOL)
    assert bool(m.grads_finite)
    moved = 0
    for n, p in prog.named_parameters():
        if not p.requires_grad:
            continue
        assert torch.allclose(p.grad, grads[n], rtol=GRAD_RTOL, atol=GRAD_ATOL), n
        moved += bool(grads[n].abs().sum() > 0)
    assert moved >= len(grads) - 2  # every leaf but the unused ones gets a gradient


def test_three_radam_steps_give_the_same_parameters():
    prog, reference, hp = _models()
    prog.train(), reference.train()
    opt_p = make_optimizer([p for p in prog.parameters() if p.requires_grad], "radam", 2e-4,
                           beta=0.9)
    opt_r = ref.RAdam([p for p in reference.parameters() if p.requires_grad], 2e-4)
    gp, gr = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    start = {n: p.detach().clone() for n, p in prog.named_parameters()}
    for step in range(3):
        batch = _batch(hp, seed=20 + step)
        m = train_step(prog, opt_p, AttrDict(batch), step, gp)
        loss, _ = ref.train_step(reference, opt_r, batch, step, gr)
        assert float(m.total) == pytest.approx(float(loss), rel=LOSS_RTOL), step
    b = dict(reference.named_parameters())
    for n, p in prog.named_parameters():
        assert torch.allclose(p, b[n], rtol=PARAM_RTOL, atol=PARAM_ATOL), n
    trained = [n for n, p in prog.named_parameters() if p.requires_grad]
    moved = [n for n in trained if not torch.equal(b[n], start[n])]
    assert len(moved) >= 0.9 * len(trained)  # the steps moved what they compared


def test_the_prior_rollout_with_injected_latents_matches():
    prog, reference, hp = _models()
    batch = _batch(hp)
    z = torch.randn(2, T - 1, hp["nz_vae"], generator=torch.Generator().manual_seed(4))
    prior = {k: batch[k] for k in ("I_0", "I_g", "end_ind")}
    with torch.no_grad():
        a = prog(AttrDict(prior, z=z), phase="test", mode="prior")
        b = reference(RefAttrDict(prior, z=z), phase="test", mode="prior")
    assert a.dense_rec.images.shape == (2, T, hp["img_sz"], hp["img_sz"], 3)
    assert torch.allclose(a.dense_rec.images, b.dense_rec.images, atol=IMAGE_ATOL)
    assert torch.allclose(a.dense_rec.encodings, b.dense_rec.encodings, atol=IMAGE_ATOL)
    # other latents give another rollout: the injected z is what was compared
    with torch.no_grad():
        c = prog(AttrDict(prior, z=-z), phase="test", mode="prior")
    assert not torch.allclose(a.dense_rec.encodings, c.dense_rec.encodings, atol=1e-3)


# (c) the spans and the counter

def test_the_rollout_spans_and_counter():
    prog, _, hp = _models()
    prog.train()
    batch = _batch(hp)

    def step(traced):
        m = copy.deepcopy(prog)
        opt = make_optimizer([p for p in m.parameters() if p.requires_grad], "radam", 2e-4)
        before = tracing.COUNTS["rollout.steps"]
        with tracing.session() if traced else contextlib.nullcontext() as s:
            out = train_step(m, opt, AttrDict(batch), 0, torch.Generator().manual_seed(5))
        grads = {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}
        return out, grads, s, tracing.COUNTS["rollout.steps"] - before

    off, on = step(False), step(True)
    assert off[3] == on[3] == T - 1  # counted with tracing on and off
    assert torch.equal(off[0].total, on[0].total)
    assert off[1].keys() == on[1].keys()
    assert all(torch.equal(off[1][n], on[1][n]) for n in off[1])
    records = on[2].records
    names = [r.name for r in records]
    assert names.count("model.rollout") == names.count("rollout.bwd") == 1
    assert on[2].counts["rollout.steps"] == T - 1
    rollout = records[names.index("model.rollout")]
    bwd = records[names.index("rollout.bwd")]
    backward = records[names.index("train.backward")]
    forward_end = min(r.start_ns for r in records if r.name == "model.decoder")
    assert rollout.end_ns is not None and rollout.end_ns <= forward_end
    assert rollout.parent is not None and rollout.parent.name == "train_step"
    assert backward.start_ns <= bwd.start_ns <= bwd.end_ns <= backward.end_ns
    decoder_bwd = records[names.index("decoder.bwd")]
    encoder_bwd = records[names.index("encoder.bwd")]
    assert decoder_bwd.end_ns <= bwd.start_ns and bwd.end_ns <= encoder_bwd.end_ns


def test_the_prior_rollout_counts_and_opens_no_backward_span():
    prog, _, hp = _models()
    batch = _batch(hp)
    prior = AttrDict({k: batch[k] for k in ("I_0", "I_g", "end_ind")})
    with tracing.session() as s, torch.no_grad():
        prog(prior, phase="test", mode="prior", generator=torch.Generator().manual_seed(2))
    names = [r.name for r in s.records]
    assert names.count("model.rollout") == 1 and "rollout.bwd" not in names
    assert s.counts["rollout.steps"] == T - 1


# (d) the cell, cut to a tiny size on the CPU

def test_a_tiny_run_of_the_cell_is_correct():
    r = run.run_cell(_tiny_cell(), 2**31 + 77, 0.2, False, device="cpu", hp_override=TINY)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_frames_per_s", "setup_s"}


def test_the_traced_run_reads_the_four_metrics():
    r = run.run_cell(_tiny_cell(), 2**31 + 78, 0.2, True, device="cpu", hp_override=TINY)
    assert r["correct"], r["checks"]
    names = ("rollout_share.train_seq", "launches_per_step.train_seq",
             "device_idle.train_seq", "train_seq_mfu")
    assert set(r["metrics"]) == set(names)
    assert all(r["metrics"][n]["value"] is not None for n in names)
    assert 0 < r["metrics"]["rollout_share.train_seq"]["value"] < 100
    assert r["trace"].units == 2 and r["trace"].window_s > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "wrong_beta2"])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    _broken_train_step(monkeypatch, fault)
    r = run.run_cell(_tiny_cell(), 2**31 + 79, 0.2, False, device="cpu", hp_override=TINY)
    assert not r["correct"], r["checks"]
