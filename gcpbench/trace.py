"""Benchmark-side spans and the traced pass.

A span is a wrapper that the benchmark puts around a named function of the
program for the traced pass only (the program carries no spans of its own
yet): a `torch.profiler.record_function` range under the profiler, or a
host-clock interval closed by a synchronise in a span pass. The traced pass
runs a few units under `torch.profiler`, exports the trace to a temporary
file, and reduces it to: the union of device-operation intervals inside the
window (busy seconds), device seconds by kernel name, and the idle gaps
labelled with the innermost span the host was in.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "gcpbench.window"


def sync() -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # name -> device seconds
    idle_by_span: dict = field(default_factory=dict)  # name -> idle seconds
    units: int = 0


@contextlib.contextmanager
def spans(targets, on_enter=None, on_exit=None):
    """Wrap each (object, attribute, span name) of `targets` in a
    record_function range, and in `on_enter(name)` / `on_exit(name)` calls
    when given; restored on exit."""
    saved = []
    try:
        for obj, attr, name in targets:
            fn = getattr(obj, attr)
            saved.append((obj, attr, attr in vars(obj), fn))

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                if on_enter:
                    on_enter(_name)
                try:
                    with torch.profiler.record_function(_name):
                        return _fn(*args, **kwargs)
                finally:
                    if on_exit:
                        on_exit(_name)

            setattr(obj, attr, functools.wraps(fn)(wrapped))
        yield
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:  # an instance's wrapper over its class's method
                delattr(obj, attr)


class SpanClock:
    """Host seconds inside each span, each span's edges synchronised with
    the device so that the seconds are the device's work too."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._open = {}

    def enter(self, name):
        sync()
        self._open[name] = time.perf_counter()
        self.calls[name] += 1

    def exit(self, name):
        sync()
        self.seconds[name] += time.perf_counter() - self._open.pop(name)


def span_pass(work, targets) -> dict:
    """Run `work()` with host-clock spans; returns {"seconds": {span:
    seconds}, "calls": {span: calls}}, the whole pass under "total"."""
    clock = SpanClock()
    with spans(targets, clock.enter, clock.exit):
        sync()
        t0 = time.perf_counter()
        work()
        sync()
        clock.seconds["total"] = time.perf_counter() - t0
    return {"seconds": dict(clock.seconds), "calls": dict(clock.calls)}


def profiled_pass(work, targets, units: int) -> Trace:
    """Run `work()` (`units` units of the cell) under torch.profiler with
    the spans, and reduce its trace."""
    from torch.profiler import ProfilerActivity, profile
    with spans(targets):
        sync()
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                work()
                sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce(events, {name for _, _, name in targets})
    out.units = units
    return out


def reduce(events, span_names) -> Trace:
    """Busy, kernel and idle seconds of a chrome trace's events."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    lo = window[0]["ts"]
    hi = lo + window[0]["dur"]
    dev, host = [], []
    kernels = defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                dev.append((a, b))
                kernels[e["name"]] += (b - a) * 1e-6
        elif cat == "user_annotation" and e.get("name") in span_names:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, last = [], lo
    for a, b in merged:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if hi > last:
        gaps.append((last, hi))
    host.sort()
    idle = defaultdict(float)
    for a, b in gaps:
        inside = [s for s in host if s[0] <= a < s[1]]
        label = max(inside, key=lambda s: s[0])[2] if inside else "outside spans"
        idle[label] += (b - a) * 1e-6
    return Trace(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, kernels=dict(kernels),
                 idle_by_span=dict(idle))


def breakdown(trace: Trace, top: int = 10) -> dict:
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
