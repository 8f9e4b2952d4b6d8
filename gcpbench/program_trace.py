"""The program's own spans and counters (`video_gcp_torch.tracing`) over a
cell's traced units, and the readers of the per-layer metrics that need them.

    python -m gcpbench.program_trace --workload <cell> --seed <n> [--seconds 15] [--turns 2]

builds the cell as `gcpbench.run` does and, on the card:

1. the cost of tracing: `turns` pairs of windows of `seconds` each, one with
   a tracing session open and one without, in alternating order; each
   window's end-to-end metric;
2. the span pass: the units of the harness's span pass (train: 4 steps;
   eval: one top-of-100 call; plan: 5 requests) with a session open, on the
   host's clock with nothing synchronised: the program's records and
   counters;
3. the profiled pass: the units of the harness's profiled pass (train: the
   same 4 steps; eval: one top-of-1 call; plan: the same 5 requests) under
   torch.profiler, with the harness's wrappers (`loops/*.py:span_targets`)
   and a session open: the host's launch calls inside the program's unit
   and DTW spans, and the device's idle time put down to the innermost
   program span the host was in, on any thread, or where it was in none to
   the innermost wrapper (`idle_by_span`);

then prints one JSON line. `program_passes` gives what the `read_*`
functions read, under a run's "program" key; without the tracing module (a
checkout from before it) it gives nothing and every reader reads None.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from gcpbench import trace

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")
PER_UNIT = ("train_step", "eval.call", "plan.request", "dtw")  # launches counted inside


def _tracing():
    """The program's tracing module, or None in a checkout without one."""
    try:
        return importlib.import_module("video_gcp_torch.tracing")
    except ImportError:
        return None


def is_launch(event: dict) -> bool:
    """A host call that puts work on the device: a kernel or graph launch,
    a copy or a memset, from the CUDA runtime or the driver."""
    return (event.get("ph") == "X" and event.get("cat") in LAUNCH_CATEGORIES
            and event.get("name", "").startswith(LAUNCH_PREFIXES))


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def launches_inside(events, name: str) -> int:
    """Launch calls, on any thread, that start inside a user annotation
    `name` (nested annotations of the same name counted once)."""
    spans = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") == name)
    starts = [a for a, _ in spans]
    n = 0
    for e in events:
        if is_launch(e):
            k = bisect.bisect_right(starts, e["ts"]) - 1
            n += k >= 0 and e["ts"] <= spans[k][1]
    return n


def idle_by_span(events, tiers) -> dict:
    """Seconds of the profiled window in which no device operation ran,
    each idle moment put down to the innermost span (the latest to start)
    that the host was in at that moment, on any thread: a span of the first
    of `tiers` (sets of user-annotation names) that has one, else
    'outside spans'. A gap that starts in one span and ends in another is
    split between them."""
    window = next(e for e in events
                  if e.get("name") == trace.WINDOW and e.get("cat") == "user_annotation")
    lo, hi = window["ts"], window["ts"] + window["dur"]
    busy = _union((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
                  if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATEGORIES
                  and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    gaps, last = [], lo
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if hi > last:
        gaps.append((last, hi))
    names = set().union(*tiers)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") in names)
    starts = [sp[0] for sp in spans]
    rank = {}
    for k, tier in enumerate(tiers):
        for n in tier:
            rank.setdefault(n, k)
    idle = collections.Counter()
    for a, b in gaps:
        over = [sp for sp in spans[:bisect.bisect_left(starts, b)] if sp[1] > a]
        cuts = sorted({a, b} | {t for sp in over for t in sp[:2] if a < t < b})
        for p, q in zip(cuts, cuts[1:]):
            mid = (p + q) / 2
            inside = [sp for sp in over if sp[0] <= mid < sp[1]]
            label = "outside spans"
            if inside:
                best = min(inside, key=lambda sp: (rank[sp[2]], -sp[0]))
                label = best[2]
            idle[label] += (q - p) * 1e-6
    return dict(idle)


def span_seconds(records) -> tuple:
    """({name: seconds}, {name: self seconds}) of closed records: a record
    inside another of its name is counted once, with the outer; self time
    is a record's time less its children's on its thread."""
    total, own = collections.Counter(), collections.Counter()
    inner = collections.Counter()
    for r in records:
        if r.end_ns is None:
            continue
        if r.parent is not None:
            inner[id(r.parent)] += r.seconds
        p = r.parent
        while p is not None and p.name != r.name:
            p = p.parent
        if p is None:
            total[r.name] += r.seconds
    for r in records:
        if r.end_ns is not None:
            own[r.name] += r.seconds - inner[id(r)]
    return dict(total), dict(own)


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def program_passes(work_span, work_profiled, targets, units: int) -> dict:
    """The span pass over `work_span()` and the profiled pass over
    `work_profiled()` (`units` units, under the harness's wrappers
    `targets`), each with a tracing session open; {} without the tracing
    module."""
    tracing = _tracing()
    if tracing is None:
        return {}
    with tracing.session() as s:
        trace.sync()
        work_span()
        trace.sync()
    seconds, own = span_seconds(s.records)
    span_pass = dict(seconds=seconds, self_seconds=own, counts=s.counts,
                     spans=dict(collections.Counter(r.name for r in s.records)))

    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with trace.spans(targets), tracing.session() as s:
        trace.sync()
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                work_profiled()
                trace.sync()
    events = _events(prof)
    harness = {n for _, _, n in targets}
    reduced = trace.reduce(events, harness)
    reduced.idle_by_span = idle_by_span(events, (set(tracing.SPANS), harness))
    reduced.units = units
    profiled = dict(trace=reduced, counts=s.counts,
                    spans=dict(collections.Counter(r.name for r in s.records)),
                    launches={n: launches_inside(events, n) for n in PER_UNIT})
    return dict(span_pass=span_pass, profiled=profiled)


def _launches_per(run, span: str):
    prof = (run.get("program") or {}).get("profiled")
    if not prof or not prof["spans"].get(span):
        return None
    return prof["launches"][span] / prof["spans"][span]


def read_launches_per_step_train(run):
    """Launch calls inside the program's 'train_step' spans, per profiled step."""
    return _launches_per(run, "train_step")


def read_dtw_launches_per_call(run):
    """Launch calls inside the program's 'dtw' spans, per DTW call."""
    return _launches_per(run, "dtw")


def read_launches_per_request_plan(run):
    """Launch calls inside the program's 'plan.request' spans, per request."""
    return _launches_per(run, "plan.request")


def read_eval_host_mb_per_call(run):
    """Bytes the span pass's top-of-100 call handed to the host
    ('to_host.bytes'), in MB, per call."""
    sp = (run.get("program") or {}).get("span_pass")
    if not sp or not sp["spans"].get("eval.call"):
        return None
    return sp["counts"].get("to_host.bytes", 0) / 1e6 / sp["spans"]["eval.call"]


def read_plan_cost_ms(run):
    """Host ms in the program's 'plan.cost' spans per `_plan`, span pass."""
    sp = (run.get("program") or {}).get("span_pass")
    if not sp or not sp["spans"].get("plan.request"):
        return None
    return 1e3 * sp["seconds"].get("plan.cost", 0.0) / sp["spans"]["plan.request"]


READERS = {"launches_per_step.train": read_launches_per_step_train,
           "dtw_launches_per_call": read_dtw_launches_per_call,
           "eval_host_mb_per_call": read_eval_host_mb_per_call,
           "launches_per_request.plan": read_launches_per_request_plan,
           "plan_cost_ms": read_plan_cost_ms}


def work(loop, kind: str, s) -> tuple:
    """(span pass work, profiled work, profiled units) as the cell's
    `loops/<kind>.py:traced` runs them."""
    if kind == "train":
        def steps():
            for _ in range(loop.PROFILED_STEPS):
                loop._step(s)
        return steps, steps, loop.PROFILED_STEPS
    if kind == "eval":
        return (lambda: loop._call(s, s.evaluator, 0)), (lambda: loop._call(s, s.single, 0)), 1
    if kind == "plan":
        def requests():
            for k in range(loop.PROFILED_REQUESTS):
                loop._request(s, k)
        return requests, requests, loop.PROFILED_REQUESTS
    raise ValueError(f"no traced units for loops/{kind}.py")


def cost_turns(loop, s, seconds: float, turns: int) -> dict:
    """Each window's end-to-end metrics, with ("on") and without ("off") a
    tracing session, `turns` pairs in alternating order."""
    tracing = _tracing()
    out = {"off": [], "on": []}
    for k in range(turns):
        for side in (("off", "on") if k % 2 == 0 else ("on", "off")):
            if side == "on":
                with tracing.session():
                    win = loop.window(s, seconds)
            else:
                win = loop.window(s, seconds)
            out[side].append(loop.end_to_end(s, win))
    return out


def main(argv=None) -> int:
    from gcpbench import run, spec
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    root = Path.cwd()
    run.cache_dirs(root)
    if not torch.cuda.is_available():
        print("gcpbench.program_trace: no CUDA device", file=sys.stderr)
        return 3
    if _tracing() is None:
        print("gcpbench.program_trace: the program has no video_gcp_torch.tracing",
              file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload, root)
    loop = spec.loop_module(cell.mix["kind"])
    t0 = time.perf_counter()
    s = loop.setup(run.Context(cell, args.seed, torch.device("cuda")))
    trace.sync()
    out = dict(cell=cell.name, seed=args.seed, setup_s=time.perf_counter() - t0)
    out["cost"] = cost_turns(loop, s, args.seconds, args.turns)
    span_work, profiled_work, units = work(loop, cell.mix["kind"], s)
    program = program_passes(span_work, profiled_work, loop.span_targets(s), units)
    out["metrics"] = {n: r({"program": program}) for n, r in READERS.items()}
    prof = program["profiled"]
    out["span_pass"] = program["span_pass"]
    out["profiled"] = dict(launches=prof["launches"], spans=prof["spans"], counts=prof["counts"],
                           busy_s=prof["trace"].busy_s, window_s=prof["trace"].window_s,
                           **trace.breakdown(prof["trace"], top=30))
    out["device"] = dict(kind=torch.cuda.get_device_name(0), card=run.power_limit())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
