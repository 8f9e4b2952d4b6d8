"""The paper's 25-room flagship, gcp_tree.25room (untied levels: one
TreeLevel module a level), against the benchmark's plain reference
(gcpbench/reference/), its update counters, and its cell train.25room, on
the CPU at small widths: untied L=4, T=12, B=2, ngf 8 at img_sz 8, with the
logistic-mixture decoder and the inverse, cost and state models.

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

from gcpbench import generate, program, run, spec, weights
from gcpbench.reference import model as ref
from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.tree import TreeModel
from video_gcp_torch.parallel.train_step import make_optimizer, train_step

ROOT = Path(__file__).resolve().parents[1]
CELL = "train.25room"
CONFIG = json.loads((ROOT / "gcpbench/configs/gcp_tree.25room.json").read_text())
L, T, B = 4, 12, 2
# ngf 8 keeps 4 values a norm group at the encoder's last site (ngf 4 leaves
# 2, whose float32 gradient is ill-conditioned in any implementation)
SMALL = dict(hierarchy_levels=L, ngf=8, img_sz=8, nz_enc=16, nz_mid=16, nz_mid_lstm=16,
             nz_vae=8, max_seq_len=T)
LOSS_TOL = 1e-5  # relative to max(1, |value|)
GRAD_TOL = 1e-4  # relative to max(1e-3, max |grad|) of the leaf
PARAM_TOL = 1e-6  # absolute, after each optimizer step


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
    assert program.encode(hp) == CONFIG["hparams"]
    for key, value in CONFIG["published"].items():
        assert hp[key] == value, key
    assert hp["untied_layers"] is True and hp["hierarchy_levels"] == 8
    assert hp["attach_inv_mdl"] and hp["attach_cost_mdl"] and hp["attach_state_regressor"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG["name"])
    assert entry["file"] == "gcpbench/configs/gcp_tree.25room.json"
    assert entry["reduced"] == CONFIG["reduced"] == []
    assert CONFIG["flops"]["train_step_per_example"] > 0


def test_the_cell_resolves_to_its_files():
    cell = spec.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["name"] == CONFIG["name"]
    assert set(cell.limits) == {"loss", "first_grad", "change_median"}
    read = lambda name: json.loads((ROOT / f"gcpbench/traffic/{name}.json").read_text())
    assert cell.mix == dict(read("train_full100"), kind="train_spans", seq_len=200)
    loop = spec.loop_module(cell.mix["kind"])
    from gcpbench.loops import train
    for name in ("setup", "window", "end_to_end", "unit_numbers", "release", "check",
                 "calibration_setup", "program_readings", "reference_readings",
                 "fault_readings", "gaps", "span_targets", "explain"):
        assert getattr(loop, name) is getattr(train, name), name  # shared, not copied
    assert loop.traced is not train.traced
    names = {m["name"] for m in cell.per_layer}
    assert names == {"device_idle.train", "train_mfu", "k1_roofline.train",
                     "k2_roofline.train", "launches_per_step.train",
                     "update_us_per_tensor.train"}
    assert {m["name"] for m in cell.end_to_end} == {"train_frames_per_s", "setup_s"}


# (b) the program against the reference

def test_the_levels_are_distinct_modules_that_share_no_storage():
    prog, reference, _ = _models()
    for model in (prog, reference):
        levels = list(model.tree_levels)
        assert len(levels) == L and len({id(m) for m in levels}) == L
        storages = [{p.untyped_storage().data_ptr() for p in m.parameters()} for m in levels]
        for i in range(L):
            for j in range(i + 1, L):
                assert not storages[i] & storages[j], (i, j)
    a, b = dict(prog.named_parameters()), dict(reference.named_parameters())
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]) and a[n].requires_grad == b[n].requires_grad, n
    # the seeded levels differ: each module holds weights of its own
    first = dict(prog.tree_levels[0].named_parameters())
    assert any(not torch.equal(first[n], p) for n, p in prog.tree_levels[1].named_parameters())


def test_three_radam_steps_give_the_same_losses_gradients_and_parameters():
    prog, reference, hp = _models()
    prog.train(), reference.train()
    opt_p = make_optimizer(_trainable(prog), "radam", 2e-4, beta=0.9)
    opt_r = ref.RAdam(_trainable(reference), 2e-4)
    gp, gr = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    names = [n for n, p in prog.named_parameters() if p.requires_grad]
    b = dict(reference.named_parameters())
    for step in range(3):
        batch = _batch(hp, seed=20 + step)
        m = train_step(prog, opt_p, AttrDict(batch), step, gp)
        loss, grads = ref.train_step(reference, opt_r, batch, step, gr)
        assert bool(m.grads_finite)
        assert abs(float(m.total) - float(loss)) <= LOSS_TOL * max(1.0, abs(float(loss))), step
        a = dict(prog.named_parameters())
        for n in names:
            scale = max(1e-3, float(grads[n].abs().max()))
            assert float((a[n].grad - grads[n]).abs().max()) <= GRAD_TOL * scale, (step, n)
            assert float((a[n] - b[n]).detach().abs().max()) <= PARAM_TOL, (step, n)
        for d in range(L):  # every level's own module gets a gradient, on both sides
            level = [n for n in names if n.startswith(f"tree_levels.{d}.")]
            assert level, d
            assert any(a[n].grad.abs().sum() > 0 for n in level), (step, d)
            assert any(grads[n].abs().sum() > 0 for n in level), (step, d)


# (c) the update counters

def test_the_update_counters_count_every_trainable_tensor_while_tracing_is_on():
    prog, _, hp = _models()
    prog.train()
    batch = AttrDict(_batch(hp, seed=3))
    params = _trainable(prog)

    def step(traced):
        m = copy.deepcopy(prog)
        opt = make_optimizer(_trainable(m), "radam", 2e-4)
        before = dict(tracing.COUNTS)
        with tracing.session() if traced else contextlib.nullcontext() as s:
            train_step(m, opt, batch, 0, torch.Generator().manual_seed(5))
        moved = {k for k, v in tracing.COUNTS.items() if v != before.get(k, 0)}
        return s, moved

    off, on = step(False), step(True)
    assert not {"train.update_tensors", "train.update_bytes"} & off[1]
    assert on[0].counts["train.update_tensors"] == len(params) > 4 * L
    assert on[0].counts["train.update_bytes"] == sum(p.numel() * 4 for p in params)


# (d) the cell's traced pass, cut to a small size on the CPU

def test_the_traced_pass_hands_the_spans_and_counters_to_the_readers():
    cell = spec.load_cell(CELL, ROOT)
    cell.mix = dict(cell.mix, batch=B, seq_len=T)
    loop = spec.loop_module(cell.mix["kind"])
    s = loop.setup(run.Context(cell, 2**31 + 23, torch.device("cpu"), SMALL))
    out = loop.traced(s)
    tensors = sum(p.requires_grad for p in s.model.parameters())
    counts = out["program"]["span_pass"]["counts"]
    assert counts["train.update_tensors"] == loop.PROFILED_STEPS * tensors
    assert out["program"]["profiled"]["spans"]["train_step"] == loop.PROFILED_STEPS
    run_ = dict(window=dict(units=1, seconds=1.0), unit=loop.unit_numbers(s), **out)
    for name in ("launches_per_step.train", "update_us_per_tensor.train", "device_idle.train"):
        assert spec.metric_reader(name)(run_) is not None, name
    assert spec.metric_reader("update_us_per_tensor.train")(run_) > 0
    assert out["trace"].units == loop.PROFILED_STEPS and out["trace"].window_s > 0
    # a run without the program's spans reads nothing, and does not raise
    assert spec.metric_reader("update_us_per_tensor.train")(dict(run_, program={})) is None
    assert spec.metric_reader("launches_per_step.train")(dict(run_, program={})) is None
