"""Training cells of the adaptive GCP tree (soft-DTW binding, attentive
inference): `loops/train_spans.py` in everything (the checked steps in
set-up, the window back to back over a pool of batches on the device, the
span pass and the profiled pass over the program's spans), but for the
reference's soft-DTW, one more fault, and what the traced pass keeps.

- The reference's replay runs with the plain soft-DTW of
  `gcpbench/reference/soft_dtw.py` bound into `gcpbench.reference.binding`
  for its length alone; `reference/plain.py`'s raising stand-in is put back
  after it, so every other cell's reference holds no soft-DTW.
- One more number compared, `posterior`: the soft-DTW posterior w [B, N, T]
  of each checked step, the program's (recorded from its binding in
  set-up) against the reference's, as the worst step's relative L2 gap.
  At seeded weights the decoded nodes look alike, so the expected NLL and
  the gradients barely move with w, and only w itself shows a fault in it.
- A fault that only the posterior reads: the reference with its matching
  temperature doubled.
- The traced pass also keeps the device seconds of the operations launched
  inside the program's binding spans and inside its `train_step` spans,
  matched by the profiler's correlation id on any thread
  (`binding_share.train_adaptive` reads them).
"""
from __future__ import annotations

import bisect
import contextlib
import copy
import math

import torch

from gcpbench import program_trace, trace
from gcpbench.loops import train_spans
from gcpbench.loops.train_spans import (  # noqa: F401  the loop's interface, shared
    BETA2, CHECKED_STEPS, FAULT_BETA2, PROFILED_STEPS, State, _step, end_to_end, explain,
    release, span_targets, unit_numbers, window)

BINDING_SPANS = ("model.binding", "binding.nll", "binding.bwd")
FAULT_TEMP = 2.0  # the doubled matching temperature, as a factor


@contextlib.contextmanager
def recording_posteriors(binding_cls, into: list):
    """Append the posterior w that each `binding_cls.get_w` call returns to
    `into`, for the block."""
    get_w = binding_cls.get_w

    def recorded(self, *args, **kwargs):
        w = get_w(self, *args, **kwargs)
        into.append(w.detach())
        return w

    binding_cls.get_w = recorded
    try:
        yield into
    finally:
        binding_cls.get_w = get_w


def setup(ctx) -> State:
    """The tree loop's set-up; the checked steps' posteriors are kept."""
    from video_gcp_torch.models.binding import AdaptiveBinding
    with recording_posteriors(AdaptiveBinding, []) as posteriors:
        s = train_spans.setup(ctx)
    s.posteriors = posteriors
    return s


calibration_setup = setup  # the checked steps need no window


def program_readings(s: State) -> dict:
    return dict(train_spans.program_readings(s), posteriors=s.posteriors)


def gaps(prog: dict, ref: dict) -> dict:
    """The tree loop's numbers, and `posterior`: the worst checked step's
    ||w_program - w_reference|| / ||w_reference|| over the rows both hold
    (inf where a posterior is not finite)."""
    out = train_spans.gaps(prog, ref)
    steps = []
    for a, b in zip(prog["posteriors"], ref["posteriors"], strict=True):
        n = min(len(a), len(b))
        gap = float(torch.linalg.vector_norm((a[:n] - b[:n]).double())
                    / torch.linalg.vector_norm(b[:n].double()))
        steps.append(math.inf if math.isnan(gap) else gap)
    out["posterior"] = max(steps)
    return out


@contextlib.contextmanager
def plain_soft_dtw():
    """The reference's binding with the plain soft-DTW for the block."""
    from gcpbench.reference import binding, soft_dtw
    saved = binding.soft_dtw, binding.soft_dtw_stability_gap
    binding.soft_dtw, binding.soft_dtw_stability_gap = (soft_dtw.soft_dtw,
                                                        soft_dtw.soft_dtw_stability_gap)
    try:
        yield
    finally:
        binding.soft_dtw, binding.soft_dtw_stability_gap = saved


def reference_readings(s: State, tf32: bool, batches=None, beta2: float = BETA2) -> dict:
    """The tree loop's replay of the checked steps, with the plain soft-DTW;
    each step's posterior is kept."""
    from gcpbench.reference.binding import AdaptiveBinding
    with plain_soft_dtw(), recording_posteriors(AdaptiveBinding, []) as posteriors:
        out = train_spans.reference_readings(s, tf32, batches, beta2)
    return dict(out, posteriors=posteriors)


def fault_readings(s: State, ref: dict) -> dict:
    """Planted in the reference: half of each batch left out; RAdam with a
    wrong beta2; and the matching temperature doubled, which only the
    soft-DTW posterior reads."""
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in s.batches[:CHECKED_STEPS]]
    hot = copy.copy(s)
    hot.hp = dict(s.hp, matching_temp=FAULT_TEMP * s.hp["matching_temp"])
    return {"half_batch": reference_readings(s, tf32=False, batches=half),
            "wrong_beta2": reference_readings(s, tf32=False, beta2=FAULT_BETA2),
            "double_matching_temp": reference_readings(hot, tf32=False)}


def check(s: State) -> dict:
    g = gaps(program_readings(s), reference_readings(s, tf32=False))
    return {k: math.inf if math.isnan(v) else v for k, v in g.items()}


def device_seconds_inside(events, spans) -> float:
    """Device seconds of the operations (kernels, copies, memsets) whose
    launch call started inside a user annotation named in `spans`, on any
    thread, matched to the launch by the profiler's correlation id."""
    inside = program_trace._union(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in spans)
    starts = [a for a, _ in inside]
    launched = set()
    for e in events:
        if program_trace.is_launch(e):
            k = bisect.bisect_right(starts, e["ts"]) - 1
            if k >= 0 and e["ts"] <= inside[k][1]:
                launched.add((e.get("args") or {}).get("correlation"))
    launched.discard(None)
    return 1e-6 * sum(e["dur"] for e in events
                      if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATEGORIES
                      and (e.get("args") or {}).get("correlation") in launched)


def traced(s: State) -> dict:
    """`loops/train_spans.py`'s passes; the profiled pass's events also
    give the device seconds launched inside the binding's spans and inside
    `train_step` (`device_s`)."""
    kept = []
    export = program_trace._events

    def keep(prof):
        kept.append(export(prof))
        return kept[-1]

    program_trace._events = keep
    try:
        out = train_spans.traced(s)
    finally:
        program_trace._events = export
    if kept:
        out["device_s"] = {"binding": device_seconds_inside(kept[-1], BINDING_SPANS),
                           "train_step": device_seconds_inside(kept[-1], ("train_step",))}
    return out
