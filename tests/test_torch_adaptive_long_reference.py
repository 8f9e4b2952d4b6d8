"""The 500-frame adaptive tree, gcp_adaptive.25room_long (soft-DTW binding,
attentive inference), against the benchmark's plain reference
(gcpbench/reference/ with the plain soft-DTW of reference/soft_dtw.py bound
in), its spans and counter, and its cell train.25room_long_adaptive, on the
CPU at small widths: tied L=4 (15 nodes), T=12, B=2, ngf 8 at img_sz 8,
variable lengths.

The program and the reference get the same seeded weights
(`gcpbench.weights.assign`), batches (`gcpbench.generate`) and noise (one
generator each, the same seed). Tolerances are tests/test_torch_train.py's,
for its reasons (float32, reduction orders differ: the program's GroupNorm
is K1's plain twin, the reference's plain `F.group_norm`): loss 1e-5
relative to max(1, |value|); each leaf's gradient max |program - reference|
<= 1e-4 * max(1e-3, max |reference|); parameters after each step 1e-6
absolute (the update is lr-scaled).
"""
import contextlib
import copy
import json
from pathlib import Path

import pytest
import torch

from gcpbench import generate, program, run, spec, trace, weights
from gcpbench.loops import train_adaptive
from gcpbench.reference import binding as ref_binding
from gcpbench.reference import model as ref
from gcpbench.reference import plain
from gcpbench.reference import soft_dtw as plain_sdtw
from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.tree import TreeModel
from video_gcp_torch.ops.soft_dtw import soft_dtw_rows_reference
from video_gcp_torch.parallel.train_step import make_optimizer, train_step

ROOT = Path(__file__).resolve().parents[1]
CELL = "train.25room_long_adaptive"
CONFIG = json.loads((ROOT / "gcpbench/configs/gcp_adaptive.25room_long.json").read_text())
BALANCED = json.loads((ROOT / "gcpbench/configs/gcp_tree.25room_long.json").read_text())
L, T, B = 4, 12, 2
SMALL = dict(hierarchy_levels=L, ngf=8, img_sz=8, nz_enc=16, nz_mid=16, nz_mid_lstm=16,
             nz_vae=8, max_seq_len=T)
LOSS_TOL = 1e-5  # relative to max(1, |value|)
GRAD_TOL = 1e-4  # relative to max(1e-3, max |grad|) of the leaf
PARAM_TOL = 1e-6  # absolute, after each optimizer step
W_TOL = 1e-5  # the plain soft-DTW against the port's row twin, absolute


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(seed=11):
    prog, hp = program.build_model(ROOT, CONFIG, "cpu", SMALL)
    reference = ref.build(hp, "cpu")
    for m in (prog, reference):
        weights.assign(m, seed)
    return prog, reference, hp


def _batch(hp, seed):
    mix = dict(seq_len=T, batch=B, pool_batches=1, lengths=dict(full=0.5, min=3))
    return generate.sequences(mix, hp["img_sz"], B, seed, "cpu")


def _trainable(model):
    return [p for p in model.parameters() if p.requires_grad]


# (a) the configuration file and the cell

def test_the_configuration_file_holds_what_the_experiment_builds():
    hp, cls = program.hparams(ROOT, CONFIG)  # raises where any hparam differs
    assert cls is TreeModel
    for key, value in CONFIG["published"].items():
        assert hp[key] == value, key
    differ = {k for k in CONFIG["hparams"] if CONFIG["hparams"][k] != BALANCED["hparams"][k]}
    assert differ == {"matching_type", "attentive_inference", "learn_matching_temp"}
    assert hp["matching_type"] == "dtw_image" and hp["attentive_inference"]
    assert not hp["learn_matching_temp"] and hp["matching_temp_tenthlife"] == -1
    assert 2 ** hp["hierarchy_levels"] - 1 >= hp["max_seq_len"] == 500
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG["name"])
    assert entry["file"] == "gcpbench/configs/gcp_adaptive.25room_long.json"
    assert entry["reduced"] == CONFIG["reduced"] == []
    assert CONFIG["flops"]["train_step_per_example"] > \
        BALANCED["flops"]["train_step_per_example"]


def test_the_cell_resolves_to_its_files():
    cell = spec.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["name"] == CONFIG["name"]
    assert set(cell.limits) == {"loss", "first_grad", "change_median", "posterior"}
    read = lambda name: json.loads((ROOT / f"gcpbench/traffic/{name}.json").read_text())
    assert cell.mix == dict(read("train_varlen500"), kind="train_adaptive")
    loop = spec.loop_module(cell.mix["kind"])
    assert loop is train_adaptive
    from gcpbench.loops import train
    for name in ("window", "end_to_end", "unit_numbers", "release", "span_targets", "explain"):
        assert getattr(loop, name) is getattr(train, name), name  # shared, not copied
    names = {m["name"] for m in cell.per_layer}
    assert names == {"device_idle.train", "train_mfu", "k1_roofline.train",
                     "k2_roofline.train", "launches_per_step.train",
                     "update_us_per_tensor.train", "binding_share.train_adaptive",
                     "k3_roofline.train_adaptive"}
    assert {m["name"] for m in cell.end_to_end} == {"train_frames_per_s", "setup_s"}


# (b) the plain soft-DTW and its binding into the reference

@pytest.mark.parametrize("b,r,c", [(3, 15, 12), (2, 31, 30), (4, 63, 50)])
def test_the_plain_soft_dtw_matches_the_ports_row_twin(b, r, c):
    gen = torch.Generator().manual_seed(r)
    C = 2.0 * torch.rand(b, r, c, generator=gen)
    ends = torch.randint(0, c - 1, (b,), generator=gen)
    w = plain_sdtw.soft_dtw(C, ends)
    assert float((w - soft_dtw_rows_reference(C, ends)).abs().max()) <= W_TOL
    gap = float(plain_sdtw.soft_dtw_stability_gap(w))
    assert gap < 1e-4
    assert float((w.sum(2) - 1.0).abs().max()) <= gap
    frames = torch.arange(c)
    assert not (w * (frames[None, None, :] > ends[:, None, None])).any()  # none past the end


def test_the_replay_binds_the_plain_soft_dtw_and_puts_the_stand_in_back():
    assert ref_binding.soft_dtw is plain.soft_dtw
    with train_adaptive.plain_soft_dtw():
        assert ref_binding.soft_dtw is plain_sdtw.soft_dtw
        assert ref_binding.soft_dtw_stability_gap is plain_sdtw.soft_dtw_stability_gap
    assert ref_binding.soft_dtw is plain.soft_dtw
    assert ref_binding.soft_dtw_stability_gap is plain.soft_dtw_stability_gap
    with pytest.raises(RuntimeError), train_adaptive.plain_soft_dtw():
        raise RuntimeError("a replay that fails")
    assert ref_binding.soft_dtw is plain.soft_dtw
    with pytest.raises(NotImplementedError):
        ref_binding.soft_dtw(torch.zeros(1, 2, 2))


# (c) the program against the reference

def test_two_radam_steps_give_the_same_losses_gradients_and_parameters():
    prog, reference, hp = _models()
    prog.train(), reference.train()
    opt_p = make_optimizer(_trainable(prog), "radam", 2e-4, beta=0.9)
    opt_r = ref.RAdam(_trainable(reference), 2e-4)
    gp, gr = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    names = [n for n, p in prog.named_parameters() if p.requires_grad]
    b = dict(reference.named_parameters())
    for step in range(2):
        batch = _batch(hp, seed=20 + step)
        assert len(set(batch["end_ind"].tolist())) == B  # lengths differ
        m = train_step(prog, opt_p, AttrDict(batch), step, gp)
        with train_adaptive.plain_soft_dtw():
            loss, grads = ref.train_step(reference, opt_r, batch, step, gr)
        assert bool(m.grads_finite)
        assert abs(float(m.total) - float(loss)) <= LOSS_TOL * max(1.0, abs(float(loss))), step
        a = dict(prog.named_parameters())
        for n in names:
            scale = max(1e-3, float(grads[n].abs().max()))
            assert float((a[n].grad - grads[n]).abs().max()) <= GRAD_TOL * scale, (step, n)
            assert float((a[n] - b[n]).detach().abs().max()) <= PARAM_TOL, (step, n)
        attention = [n for n in names if ".inference.attention_layers." in n]
        assert attention and any(a[n].grad.abs().sum() > 0 for n in attention), step
    assert ref_binding.soft_dtw is plain.soft_dtw


def test_the_checks_read_the_posterior_that_a_doubled_temperature_moves():
    """At a small size on the CPU: the program's checked steps agree with the
    reference's on every number, the posterior's included, and the doubled
    matching temperature moves the posterior far more than rounding does."""
    cell = spec.load_cell(CELL, ROOT)
    cell.mix = dict(cell.mix, batch=B, seq_len=T)
    loop = spec.loop_module(cell.mix["kind"])
    s = loop.calibration_setup(run.Context(cell, 2**31 + 31, torch.device("cpu"), SMALL))
    assert len(s.posteriors) == loop.CHECKED_STEPS
    assert s.posteriors[0].shape == (B, 2 ** L - 1, T)
    prog = loop.program_readings(s)
    loop.release(s)
    ref_ = loop.reference_readings(s, tf32=False)
    assert ref_binding.soft_dtw is plain.soft_dtw
    g = loop.gaps(prog, ref_)
    assert all(g[k] <= lim for k, lim in cell.limits.items()), g
    faults = loop.fault_readings(s, ref_)
    assert set(faults) == {"half_batch", "wrong_beta2", "double_matching_temp"}
    hot = loop.gaps(faults["double_matching_temp"], ref_)
    assert hot["posterior"] > 100 * max(g["posterior"], 1e-7)


# (d) spans and counter

def _traced_step(prog, batch, traced):
    m = copy.deepcopy(prog)
    opt = make_optimizer(_trainable(m), "radam", 2e-4)
    before = dict(tracing.COUNTS)
    with tracing.session() if traced else contextlib.nullcontext() as s:
        train_step(m, opt, batch, 0, torch.Generator().manual_seed(5))
    moved = {k for k, v in tracing.COUNTS.items() if v != before.get(k, 0)}
    return s, moved


def test_the_spans_and_the_cell_counter_appear_only_while_tracing_is_on():
    prog, _, hp = _models()
    prog.train()
    batch = AttrDict(_batch(hp, seed=3))
    on, _ = _traced_step(prog, batch, True)
    names = {r.name for r in on.records}
    assert {"binding.nll", "binding.bwd", "inference.attention"} <= names
    assert sum(r.name == "inference.attention" for r in on.records) == L
    assert on.counts["binding.cells"] == B * (2 ** L - 1) * T
    assert all(r.end_ns is not None for r in on.records)
    nll = next(r for r in on.records if r.name == "binding.nll")
    assert nll.parent is not None and nll.parent.name == "model.losses"
    _, moved = _traced_step(prog, batch, False)
    assert "binding.cells" not in moved
    balanced, _ = program.build_model(ROOT, BALANCED, "cpu", dict(SMALL, max_seq_len=T))
    weights.assign(balanced.train(), 11)
    s, _ = _traced_step(balanced, batch, True)
    assert not {"binding.nll", "binding.bwd", "inference.attention"} & {r.name for r in s.records}
    assert "binding.cells" not in s.counts


# (e) the readers of the new metrics

def _events():
    """A trace of one step: a train_step span on the main thread holding a
    binding span, a binding.bwd span on another thread, and launches with
    their device operations matched by correlation id."""
    ann = lambda name, ts, dur, tid: dict(ph="X", cat="user_annotation", name=name, ts=ts,
                                          dur=dur, tid=tid)
    launch = lambda ts, corr: dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                                   ts=ts, dur=1, args=dict(correlation=corr))
    kernel = lambda name, dur, corr: dict(ph="X", cat="kernel", name=name, ts=10_000 + corr,
                                          dur=dur, args=dict(correlation=corr))
    return [ann("train_step", 0, 1000, 1), ann("model.binding", 100, 100, 1),
            ann("binding.bwd", 600, 100, 2), ann("binding.nll", 300, 10, 1),
            launch(50, 1), launch(150, 2), launch(305, 3), launch(650, 4), launch(900, 5),
            launch(2000, 6),
            kernel("conv", 40, 1), kernel("soft_dtw_kernel<4, 0>", 200, 2),
            kernel("bmm", 30, 3), kernel("bmm", 20, 4), kernel("wgrad", 100, 5),
            kernel("outside", 500, 6)]


def test_the_binding_share_and_k3_roofline_readers():
    events = _events()
    binding = train_adaptive.device_seconds_inside(events, train_adaptive.BINDING_SPANS)
    whole = train_adaptive.device_seconds_inside(events, ("train_step",))
    assert binding == pytest.approx(250e-6) and whole == pytest.approx(390e-6)
    profiled = dict(spans={"binding.nll": 1, "train_step": 1}, counts={"binding.cells": 4000})
    run_ = dict(program=dict(profiled=profiled), device_s=dict(binding=binding, train_step=whole),
                trace=trace.reduce(events + [dict(ph="X", cat="user_annotation",
                                                  name=trace.WINDOW, ts=0, dur=20_000)], set()))
    share = spec.metric_reader("binding_share.train_adaptive")(run_)
    assert share == pytest.approx(100 * 250 / 390)
    k3 = spec.metric_reader("k3_roofline.train_adaptive")(run_)
    assert k3 == pytest.approx(100 * 8 * 4000 / 3.35e12 / 200e-6)
    # a program without the spans or the counter reads nothing, and does not raise
    bare = dict(run_, program=dict(profiled=dict(spans={"train_step": 1}, counts={})))
    assert spec.metric_reader("binding_share.train_adaptive")(bare) is None
    assert spec.metric_reader("k3_roofline.train_adaptive")(bare) is None
    assert spec.metric_reader("binding_share.train_adaptive")(dict(run_, program={})) is None


def test_the_traced_pass_hands_the_spans_and_counters_to_the_readers():
    cell = spec.load_cell(CELL, ROOT)
    cell.mix = dict(cell.mix, batch=B, seq_len=T)
    loop = spec.loop_module(cell.mix["kind"])
    s = loop.setup(run.Context(cell, 2**31 + 25, torch.device("cpu"), SMALL))
    out = loop.traced(s)
    profiled = out["program"]["profiled"]
    assert profiled["spans"]["binding.nll"] == loop.PROFILED_STEPS
    assert profiled["spans"]["inference.attention"] == loop.PROFILED_STEPS * L
    assert profiled["counts"]["binding.cells"] == loop.PROFILED_STEPS * B * (2 ** L - 1) * T
    assert set(out["device_s"]) == {"binding", "train_step"}  # no device here: 0 s each
    run_ = dict(window=dict(units=1, seconds=1.0), unit=loop.unit_numbers(s), **out)
    assert spec.metric_reader("update_us_per_tensor.train")(run_) > 0
    assert spec.metric_reader("binding_share.train_adaptive")(run_) is None
    assert spec.metric_reader("k3_roofline.train_adaptive")(run_) is None
