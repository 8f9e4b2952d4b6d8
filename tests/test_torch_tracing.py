"""The port's spans and counters (video_gcp_torch/tracing.py), on the CPU.

Tracing off records nothing; on, spans nest per thread, share their unit's
id, close on exceptions and appear under the profiler as user annotations;
counters give their change over a session. Every name the package uses is
declared in tracing.py. Tracing changes no number: a small train step
(backward hooks included) and the eval DTW give the same results with it on
and off.
"""
import contextlib
import copy
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import video_gcp_torch
from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.models.tree import TreeModel
from video_gcp_torch.ops.dtw import batched_dtw_alignment
from video_gcp_torch.parallel.train_step import make_optimizer, train_step

PACKAGE = Path(video_gcp_torch.__file__).parent


@tracing.spanned("eval.call")
def _unit(fail=False):
    with tracing.span("eval.sample"):
        with tracing.span("dtw"):
            if fail:
                raise ValueError("inside dtw")
    with tracing.span("eval.metrics"):
        pass


def test_off_records_nothing_and_span_is_the_shared_noop():
    assert not tracing._on
    assert tracing.span("dtw") is tracing.span("eval.call") is tracing._NOOP
    _unit()
    assert tracing._records == []
    with tracing.session() as s:
        pass
    assert s.records == [] and s.counts == {}


def test_nesting_parents_units_and_exceptions():
    with tracing.session() as s:
        _unit()
        with pytest.raises(ValueError):
            _unit(fail=True)
        with tracing.span("dtw"):  # outside any unit
            pass
    names = [r.name for r in s.records]
    assert names == ["eval.call", "eval.sample", "dtw", "eval.metrics",
                     "eval.call", "eval.sample", "dtw", "dtw"]
    first, second = s.records[:4], s.records[4:7]
    assert [r.parent for r in first] == [None, first[0], first[1], first[0]]
    assert [r.parent for r in second] == [None, second[0], second[1]]
    assert {r.unit for r in first} == {first[0].unit}
    assert {r.unit for r in second} == {second[0].unit} != {first[0].unit}
    assert s.records[7].unit is None and s.records[7].parent is None
    assert all(r.end_ns >= r.start_ns for r in s.records)  # closed, the raising ones too
    assert s.seconds("eval.call") == [r.seconds for r in (first[0], second[0])]
    assert not tracing._on and tracing._local.stack == [] and tracing._unit is None


def test_spans_on_another_thread_share_the_unit():
    with tracing.session() as s:
        with tracing.span("train_step"):
            t = threading.Thread(target=lambda: tracing.span("encoder.bwd").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    unit, bwd = s.records
    assert bwd.parent is None and bwd.thread != unit.thread and bwd.unit == unit.unit


def test_counters_and_their_session_deltas():
    tracing.count("k1.launches", 3)  # launch counters count with tracing off
    before = tracing.COUNTS["k1.launches"]
    x = torch.ones(2, 3)
    assert torch.equal(tracing.to_host(x, "eval.metrics"), x)  # off: not counted
    with tracing.session() as outer:
        tracing.count("k1.launches")
        with tracing.session() as inner:
            tracing.count("k3.launches", 2)
            out = torch.empty(2, 3)
            assert tracing.to_host(x, "sim.outputs", out=out) is out
        tracing.to_host(x, "eval.metrics")
    assert tracing.COUNTS["k1.launches"] == before + 1
    assert inner.counts == {"k3.launches": 2, "to_host.copies": 1, "to_host.bytes": 24,
                            "to_host.bytes.sim.outputs": 24}
    assert outer.counts == {"k1.launches": 1, "k3.launches": 2, "to_host.copies": 2,
                            "to_host.bytes": 48, "to_host.bytes.sim.outputs": 24,
                            "to_host.bytes.eval.metrics": 24}


def test_spans_are_user_annotations_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    with tracing.session(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _unit()
    names = [e.name for e in prof.events()]
    for name in ("eval.call", "eval.sample", "dtw", "eval.metrics"):
        assert names.count(name) == 1


_USES = re.compile(r"""\b(span|spanned|grad_span|count)\(\s*["']([^"']+)["']""")
_LAUNCH_COUNTERS = re.compile(r"""\bcounter=["']([^"']+)["']""")  # cuda_build.launch's
_GRAPH_COUNTERS = re.compile(r"""\b(?:captures|replays)=["']([^"']+)["']""")  # LoopGraph's
_SITES = re.compile(r"""(?:to_host|\b_host)\([^()]*(?:\([^()]*\)[^()]*)*,\s*["']([^"']+)["']""")


def test_every_name_used_in_the_package_is_declared():
    used = {"span": set(), "count": set(), "site": set()}
    for path in PACKAGE.rglob("*.py"):
        if path.name == "tracing.py":
            continue
        text = path.read_text()
        for kind, name in _USES.findall(text):
            used["count" if kind == "count" else "span"].add(name)
        used["count"].update(_LAUNCH_COUNTERS.findall(text))
        used["count"].update(_GRAPH_COUNTERS.findall(text))
        used["site"].update(_SITES.findall(text))
    assert used["span"] <= set(tracing.SPANS), used["span"] - set(tracing.SPANS)
    assert used["count"] <= set(tracing.COUNTERS), used["count"] - set(tracing.COUNTERS)
    assert used["site"] <= set(tracing.HOST_SITES), used["site"] - set(tracing.HOST_SITES)
    assert set(tracing.SPANS) <= used["span"], set(tracing.SPANS) - used["span"]
    assert set(tracing.HOST_SITES) <= used["site"]
    assert {"rollout.steps", "rollout.graph_captures", "rollout.graph_replays",
            "tree_graph.captures", "tree_graph.replays",
            "k1.launches", "k2.launches", "k3.launches", "k4.launches",
            "tree_index.table_uploads", "tree_index.table_hits",
            "train.update_tensors", "train.update_bytes",
            "train.grad_buffer.hits", "train.grad_buffer.misses"} <= used["count"]
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)
    assert set(tracing.UNITS) <= set(tracing.SPANS)


B, T, IMG = 2, 8, 8


def _small_model_and_batch():
    hp = default_hparams()
    hp.overwrite(dict(batch_size=B, max_seq_len=T, img_sz=IMG, hierarchy_levels=3,
                      matching_type="balanced", regress_length=True, attach_inv_mdl=True,
                      inv_mdl_params=dict(n_actions=2), n_actions=2,
                      tree_lstm="split_linear", lstm_init="mlp", n_lstm_layers=1,
                      nz_enc=8, nz_mid=8, nz_vae=4, nz_mid_lstm=8, ngf=4))
    torch.manual_seed(0)
    model = TreeModel(dict(hp))
    rng = np.random.RandomState(0)
    seq = torch.tensor((rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32))
    end = torch.tensor([T - 1, 5])
    batch = dict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[torch.arange(B), end], end_ind=end,
                 pad_mask=(torch.arange(T)[None] <= end[:, None]).float(),
                 actions=torch.tensor(rng.randn(B, T - 1, 2).astype(np.float32)))
    return model, batch


def test_train_step_is_bit_identical_with_tracing_on():
    model, batch = _small_model_and_batch()

    def run(traced):
        m = copy.deepcopy(model)
        opt = make_optimizer(list(m.parameters()), "radam", 1e-3)
        gen = torch.Generator().manual_seed(1)
        with tracing.session() if traced else contextlib.nullcontext() as s:
            out = train_step(m, opt, AttrDict(batch), 0, gen)
        grads = [p.grad.clone() for p in m.parameters()]
        return out, grads, list(m.parameters()), s

    off, on = run(False), run(True)
    assert torch.equal(off[0].total, on[0].total)
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
    assert all(torch.equal(a, b) for a, b in zip(off[2], on[2]))
    records = on[3].records
    names = [r.name for r in records]
    assert names[0] == "train_step" and {r.unit for r in records} == {records[0].unit}
    assert names.count("model.tree_level") == names.count("tree_level.bwd") == 3
    bwd = [r for r in records if r.name.endswith(".bwd")]
    assert [r.name for r in bwd] == ["decoder.bwd"] + ["tree_level.bwd"] * 3 + ["encoder.bwd"]
    backward = records[names.index("train.backward")]
    for a, b in zip(bwd, bwd[1:]):  # one after another, inside the backward pass
        assert backward.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns
    assert bwd[-1].end_ns <= backward.end_ns
    for name in ("model.encoder", "model.decoder", "model.binding", "model.losses",
                 "train.grad_mask", "train.optimizer"):
        assert name in names


def test_dtw_is_the_same_with_tracing_on():
    rng = np.random.RandomState(0)
    C = torch.tensor(rng.rand(3, 15, 12).astype(np.float32))
    end = torch.tensor([11, 7, 3])
    inds, dist = batched_dtw_alignment(C, end)
    with tracing.session() as s:
        inds_on, dist_on = batched_dtw_alignment(C, end)
    assert torch.equal(inds, inds_on) and torch.equal(dist, dist_on)
    assert [r.name for r in s.records] == ["dtw"]
