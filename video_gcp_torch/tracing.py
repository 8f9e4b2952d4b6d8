"""Spans and counters at the port's layer boundaries.

A span marks one layer's work on the host: `with tracing.span("model.decoder"):`
around a block, or `@tracing.spanned("eval.call")` on a function. Tracing is
off unless a `session()` is open. Off, `span` checks one module flag and
returns a shared object that does nothing: no allocation, no clock read, no
`record_function`. On, a span

- keeps a `Record` in memory: its name, `time.perf_counter_ns()` at start and
  end, the span it opened in on its thread, the thread, and the unit. A unit
  is one request of the program's user: a span named in `UNITS` that opens
  outside any unit starts one, and every span until it closes (on any thread)
  shares its id;
- enters `torch.profiler.record_function(name)` while a profiler runs, so
  that the span lies on the trace's timeline, on the clock of the kernels it
  launched.

The backward of a training step runs on the autograd engine's thread.
`grad_span` puts it under spans too: hooks on a forward region's output and
input tensors open the region's span when the first gradient reaches an
output and close it when the first gradient leaves through an input, or when
the backward pass ends. The hooks are registered only while tracing is on and
return nothing, so gradients are the same with tracing on or off.

Counters are entries of `COUNTS`, added to by `count(name, n)`. The kernel
launch counters, the `rollout.*`, `tree_graph.*` and `tree_index.*` counters
count whether tracing is on or off; the host copies at the instrumented
sites (`to_host`), the `train.update_*` counters and `binding.cells` (the
B * N * T cells of each soft-DTW cost matrix) only while it is on
(`enabled()`), so that a step with tracing off pays no loop over tensors.
Every span and counter name is declared here, once: `SPANS`, `COUNTERS` and
`HOST_SITES`.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch

# Every span of the program, from the entry points down; PERF.md §3 says
# which metric or operator reads each.
SPANS = (
    # entry points: each opens a unit
    "train_step", "eval.call", "plan.request",
    # the trainer's loop
    "trainer.data",
    # model forward
    "model.encoder", "model.tree_level", "model.rollout", "model.decoder",
    "model.binding", "model.losses",
    # inside the adaptive tree's levels and losses (attentive inference,
    # soft-DTW binding); the balanced tree opens neither
    "inference.attention", "binding.nll",
    # the train step
    "train.backward", "train.grad_mask", "train.optimizer",
    # model backward, on the autograd engine's thread (grad_span)
    "encoder.bwd", "tree_level.bwd", "rollout.bwd", "decoder.bwd", "binding.bwd",
    # evaluation
    "eval.sample", "eval.metrics", "eval.to_host", "dtw",
    # planning
    "plan.sampler", "plan.simulator", "sim.forward", "sim.to_host", "sim.cap",
    "plan.cost",
)
UNITS = ("train_step", "eval.call", "plan.request")
# The sites whose host copies `to_host` counts, each also as
# "to_host.bytes.<site>".
HOST_SITES = ("eval.metrics", "eval.rand_seqs", "eval.best_gen", "eval.best_full",
              "eval.gt_seq", "eval.end_ind", "sim.outputs", "cost.result")
COUNTERS = ("k1.launches", "k2.launches", "k2.dy_copies", "k3.launches", "k4.launches",
            "rollout.steps", "rollout.graph_captures", "rollout.graph_replays",
            "tree_graph.captures", "tree_graph.replays",
            "tree_index.table_uploads", "tree_index.table_hits",
            "train.update_tensors", "train.update_bytes", "binding.cells",
            "train.grad_buffer.hits", "train.grad_buffer.misses",
            "to_host.copies", "to_host.bytes",
            *(f"to_host.bytes.{site}" for site in HOST_SITES))

COUNTS: collections.Counter = collections.Counter()

_on = False  # the one flag a span reads with tracing off
_synchronize = False  # a unit's span waits for the device before it closes
_records: list = []  # every record since the outermost open session began
_unit = None  # the open unit's id
_unit_ids = itertools.count()
_local = threading.local()  # .stack: this thread's open records


class Record:
    """One span: `name`, `start_ns` and `end_ns` (`time.perf_counter_ns`;
    `end_ns` None while open), `parent` (the record it opened in on its
    thread, or None), `thread` (`threading.get_ident()`) and `unit` (the id
    of the unit it ran in, or None)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "unit")

    def __init__(self, name, parent, thread, unit):
        self.name, self.parent, self.thread, self.unit = name, parent, thread, unit
        self.start_ns = self.end_ns = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Noop:
    """What `span` returns with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("record", "_stack", "_rf", "_opens_unit")

    def __init__(self, name):
        global _unit
        stack = _stack()
        self._opens_unit = _unit is None and name in UNITS
        if self._opens_unit:
            _unit = next(_unit_ids)
        self.record = Record(name, stack[-1] if stack else None, threading.get_ident(),
                             _unit)
        self._stack = stack

    def __enter__(self):
        rec = self.record
        self._rf = None
        if torch._C._autograd._profiler_enabled():  # record_function costs ~10 us
            self._rf = torch.profiler.record_function(rec.name)
            self._rf.__enter__()
        self._stack.append(rec)
        _records.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _unit
        rec = self.record
        if self._opens_unit and _synchronize and torch.cuda.is_available():
            torch.cuda.synchronize()
        rec.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._stack and self._stack[-1] is rec:
            self._stack.pop()
        else:  # closed on another thread than the one it opened on
            self._stack.remove(rec)
        if self._opens_unit:
            _unit = None
        return False


def span(name: str):
    """A context manager that marks a block as span `name` (one of `SPANS`)
    while tracing is on, and does nothing while it is off."""
    if not _on:
        return _NOOP
    return _Span(name)


def spanned(name: str):
    """Decorator form of `span`: each call of the function is a span."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return wrapper
    return decorate


def enabled() -> bool:
    """Whether tracing is on (a session is open)."""
    return _on


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` (one of `COUNTERS`)."""
    COUNTS[name] += n


def to_host(t: torch.Tensor, site: str, out: torch.Tensor = None) -> torch.Tensor:
    """`t` on the host: `t.cpu()`, or copied into the host tensor `out`.
    While tracing is on, counts the copy and its bytes, in all and under
    `site` (one of `HOST_SITES`)."""
    if _on:
        n = t.numel() * t.element_size()
        COUNTS["to_host.copies"] += 1
        COUNTS["to_host.bytes"] += n
        COUNTS["to_host.bytes." + site] += n
    if out is None:
        return t.cpu()
    return out.copy_(t)


class _GradRegion:
    """The backward of one forward region, as span `name`."""

    __slots__ = ("name", "span", "done")

    def __init__(self, name):
        self.name, self.span, self.done = name, None, False

    def open(self, grad):
        if self.span is None and not self.done:
            self.span = _Span(self.name).__enter__()
            torch.autograd.Variable._execution_engine.queue_callback(self.close)

    def close(self, grad=None):
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span, self.done = None, True


def grad_span(name: str, outputs, inputs=()) -> None:
    """While tracing is on and autograd records, put the backward of the
    region that made `outputs` from `inputs` under span `name`: from the
    first gradient that reaches an output to the first that leaves through
    an input, or to the end of the backward pass. Tensors that need no
    gradient, and leaves, are passed over."""
    if not _on or not torch.is_grad_enabled():
        return
    region = _GradRegion(name)
    for tensors, hook in ((outputs, region.open), (inputs, region.close)):
        for t in tensors:
            if t is not None and t.grad_fn is not None:
                t.register_hook(hook)


class Session:
    """What a `session()` saw, filled when it closes: `records` (every span
    that opened while it was open, in order of opening) and `counts` (each
    counter's change over the session, where it changed)."""

    def __init__(self):
        self.records: list = []
        self.counts: dict = {}

    def seconds(self, name: str) -> list:
        """The seconds of each closed span `name`, in order of opening."""
        return [r.seconds for r in self.records if r.name == name and r.end_ns is not None]


_open_sessions = 0


@contextlib.contextmanager
def session(synchronize: bool = False):
    """Turn tracing on for the block and yield its `Session`. Sessions may
    nest; tracing goes off when the outermost one closes. With
    `synchronize`, the span of each unit waits for the device before it
    closes, so that its seconds hold the device's work too."""
    global _on, _synchronize, _open_sessions
    s, start, before, saved_sync = Session(), len(_records), dict(COUNTS), _synchronize
    _open_sessions += 1
    _on, _synchronize = True, _synchronize or synchronize
    try:
        yield s
    finally:
        _open_sessions -= 1
        s.records = _records[start:]
        s.counts = {k: v - before.get(k, 0) for k, v in COUNTS.items()
                    if v != before.get(k, 0)}
        _synchronize = saved_sync
        if not _open_sessions:
            _on = False
            _records.clear()
