"""The readers of the program's spans and counters (gcpbench/program_trace.py):
launch calls and idle gaps on hand-made chrome traces, nothing read from a
checkout without `video_gcp_torch.tracing`, and the passes over tiny cells on
the CPU."""
import sys

import pytest

from gcpbench import program_trace, run, spec, trace
from gcpbench.tests.conftest import TINY, tiny_cell
from video_gcp_torch import tracing


def _x(name, cat, ts, dur, tid=1):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)


def test_launch_calls_inside_a_span_on_any_thread():
    events = [
        _x("dtw", "user_annotation", 100, 100, tid=1),
        _x("dtw", "user_annotation", 110, 40, tid=1),  # nested: counted once
        _x("cudaLaunchKernel", "cuda_runtime", 150, 5, tid=2),  # another thread
        _x("cuLaunchKernelEx", "cuda_driver", 120, 5, tid=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 199, 5, tid=1),
        _x("cudaStreamSynchronize", "cuda_runtime", 160, 5, tid=1),  # no launch
        _x("cudaLaunchKernel", "cuda_runtime", 250, 5, tid=2),  # outside
        _x("cudaGraphLaunch", "cuda_runtime", 90, 5, tid=2),  # before
        _x("dtw", "cpu_op", 300, 50, tid=1),  # not an annotation
        _x("cudaLaunchKernel", "cuda_runtime", 320, 5, tid=1),
    ]
    assert program_trace.launches_inside(events, "dtw") == 3
    assert program_trace.launches_inside(events, "plan.request") == 0


def test_idle_time_goes_to_the_innermost_program_span_then_the_wrappers():
    events = [
        _x(trace.WINDOW, "user_annotation", 0, 1000),
        _x("train_step", "user_annotation", 0, 1000, tid=1),  # the program's
        _x("backward", "user_annotation", 250, 650, tid=1),  # the harness's wrapper
        _x("train.backward", "user_annotation", 240, 670, tid=1),  # the program's, outside it
        _x("encoder.bwd", "user_annotation", 300, 350, tid=2),  # the autograd thread
        _x("cost", "user_annotation", 920, 30, tid=1),  # a wrapper alone
        _x("kernel_a", "kernel", 0, 100, tid=7),
        _x("kernel_b", "kernel", 200, 100, tid=7),
        _x("kernel_c", "kernel", 700, 100, tid=7),
    ]
    idle = program_trace.idle_by_span(events, (set(tracing.SPANS), {"backward", "cost"}))
    # [100, 200) train_step; [300, 650) encoder.bwd, [650, 700) train.backward;
    # [800, 910) train.backward, [910, 1000) train_step; the wrappers are never innermost
    assert idle == pytest.approx({"train_step": 1.9e-4, "encoder.bwd": 3.5e-4,
                                  "train.backward": 1.6e-4})
    # the wrappers alone, as the harness's names without the program's spans
    idle = program_trace.idle_by_span(events, ({"backward", "cost"},))
    assert idle == pytest.approx({"outside spans": 1.7e-4, "backward": 5e-4, "cost": 0.3e-4})


def test_every_reader_reads_none_without_the_tracing_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "video_gcp_torch.tracing", None)
    called = []
    assert program_trace.program_passes(lambda: called.append(1), lambda: called.append(2),
                                        [], 1) == {}
    assert called == []
    for read in program_trace.READERS.values():
        assert read({"program": {}}) is None and read({}) is None


@pytest.mark.parametrize("cell", ["train.9room", "eval.25room_long"])
def test_the_passes_over_a_tiny_cell(cell):
    c = tiny_cell(cell)
    loop = spec.loop_module(c.mix["kind"])
    s = loop.setup(run.Context(c, 7, __import__("torch").device("cpu"), TINY))
    span_work, profiled_work, units = program_trace.work(loop, c.mix["kind"], s)
    program = program_trace.program_passes(span_work, profiled_work, loop.span_targets(s),
                                           units)
    values = {n: r({"program": program}) for n, r in program_trace.READERS.items()}
    spans = program["span_pass"]["spans"]
    idle = program["profiled"]["trace"].idle_by_span
    if cell.startswith("train"):
        assert spans["train_step"] == units == program["profiled"]["spans"]["train_step"]
        assert spans["encoder.bwd"] == spans["decoder.bwd"] == units
        assert values["launches_per_step.train"] == 0  # the CPU launches nothing
        assert set(idle) <= set(tracing.SPANS) | {"outside spans", "encoder", "decoder",
                                                   "tree_level", "backward", "optimizer"}
    else:
        assert spans["eval.call"] == 1 and spans["dtw"] == spans["eval.sample"]
        mb = values["eval_host_mb_per_call"]
        assert mb == program["span_pass"]["counts"]["to_host.bytes"] / 1e6 > 0
        assert values["dtw_launches_per_call"] == 0
    assert values["plan_cost_ms"] is None
