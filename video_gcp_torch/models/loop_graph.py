"""A model's Python loop as a pair of CUDA graphs, its forward and its backward.

Two loops of the port are many small dependent ops whose issue by the host,
not the device, sets the pace of a training step on the card: the VRNN's
rollout (`SequentialModel.rollout`, T-1 steps of a dozen ops) and the GCP
tree's levels (`TreeModel.level_loop`, L levels of MLPs, a sample, the
TreeLSTM and the interleaves, and in the adaptive tree the attention).
`LoopGraph` captures such a loop once, with its gradient with respect to
the loop's inputs and the parameters of the module it steps, and replays
both inside an autograd function, one launch each: autograd then
accumulates the parameters' gradients as it does for the eager loop.

When it engages depends only on what a call shows. The graphs serve a call
that its caller finds eligible, whose tensors are on CUDA, while autograd
records, that has a generator where it draws noise, and whose key (mode,
the TF32 switches, each input's presence, shape, dtype, device and whether
it needs a gradient, and the module parameters' addresses, dtypes and
whether they need one) equals the previous such call's. The first call
with a key runs eager and is the warm-up; the second captures and replays;
later ones replay. A new key drops the graphs. A call made while the
previous replay still awaits its backward runs eager, since a replay would
overwrite the activations that backward reads. Every other call (the CPU; evaluation, planning and the val
passes, under no_grad; a model that FSDP split, which its caller finds
ineligible by `sharded`) runs the eager loop and leaves the graphs as they
are.

The noise: the eager loop draws its standard normals from the generator
through `Gaussian.sample`, one `torch.randn` a draw. Before a replay,
`draw_noise` makes the same draws in the same order into the buffers that
the graph reads (`normal_`, which is how `torch.randn` fills a new tensor),
so the samples and the generator's state are the eager loop's.

Each LoopGraph counts its captures and the calls a replay served under the
counter names it is given (always, traced or not); with `spans`, a replay
runs under the forward span and its backward under the backward span.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
import torch.nn as nn

from video_gcp_torch import tracing


def draw_noise(generator: torch.Generator, noise) -> None:
    """Fill each tensor of `noise` in order with the standard normals that
    `torch.randn` of its shape, dtype and device draws from `generator`
    (as `Gaussian.sample` draws them); each must be contiguous. A None
    `generator` would draw from the default one: `LoopGraph` leaves such a
    call to the eager loop, whose `Gaussian.sample` refuses it."""
    for t in noise:
        t.normal_(generator=generator)


def sharded(model: nn.Module) -> bool:
    """Whether FSDP2 split `model` (`parallel.train_step.shard_model`). Its
    forward then reads parameters that FSDP gathers anew in each step and
    frees after the backward, not the DTensors it holds between steps: the
    graphs would read blocks that the allocator may have handed on."""
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def signature(inputs, module: nn.Module, mode):
    """What a call's graphs depend on: the mode, the TF32 switches, each
    input's presence, shape, dtype, device and whether it needs a gradient,
    and the module parameters' addresses, dtypes and whether they need one."""
    return (mode, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            tuple(None if t is None else (t.shape, t.dtype, t.device, t.requires_grad)
                  for t in inputs),
            tuple((p.data_ptr(), p.dtype, p.requires_grad) for p in module.parameters()))


def _key(inputs, module: nn.Module, mode):
    """The call's signature, or None where the graphs cannot serve it."""
    present = [t for t in inputs if t is not None]
    if not (present[0].is_cuda and torch.is_grad_enabled()
            and any(t.requires_grad for t in present + list(module.parameters()))):
        return None
    return signature(inputs, module, mode)


class _Pending:
    """One replay whose backward has not run yet."""

    __slots__ = ("done", "__weakref__")

    def __init__(self):
        self.done = False


class _Loop(nn.Module):
    """`fn` as a module over the stepped module, for `functional_call`."""

    def __init__(self, fn, module: nn.Module):
        super().__init__()
        self.fn, self.module = fn, module

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


class _Graphs:
    """One key's captured forward and backward, their memory pool, and the
    static tensors they read and write.

    The capture runs the loop over aliases of the module's parameters (new
    leaves on the same storage), so that the replays read the parameters'
    current values while the capture's autograd graph shares no node with
    any other: a parameter's own gradient accumulator, made on another
    stream by an eager call whose graph is still alive, would end the
    capture."""

    def __init__(self, fn, inputs, module: nn.Module, noise, mode):
        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        self.addresses = [p.data_ptr() for p in self.params]
        aliases = {"module." + n: p.detach().requires_grad_() for n, p in named}
        self.inputs = [None if t is None else t.detach().clone().requires_grad_(t.requires_grad)
                       for t in inputs]
        device = next(t for t in inputs if t is not None).device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        pool = torch.cuda.graph_pool_handle()
        self.forward, self.backward = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.forward, pool=pool, stream=stream):
            self.outputs = torch.func.functional_call(
                _Loop(fn, module), aliases, tuple(self.inputs),
                dict(eps=noise, mode=mode, generator=None))
        self.differentiable = [o.requires_grad for o in self.outputs]
        outputs = [o for o in self.outputs if o.requires_grad]
        self.output_grads = [torch.empty_like(o) for o in outputs]
        # the autograd function's tensor arguments are the inputs present,
        # then the parameters that need a gradient (captured as the aliases)
        args = [t for t in self.inputs if t is not None] + list(aliases.values())
        wrt = [t for t in args if t.requires_grad]
        with torch.cuda.graph(self.backward, pool=pool, stream=stream):
            grads = iter(torch.autograd.grad(outputs, wrt, self.output_grads,
                                             allow_unused=True))
        self.grads = [next(grads) if t.requires_grad else None for t in args]


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphs, pending, *args):
        ctx.graphs, ctx.pending = graphs, pending
        for buffer, t in zip([s for s in graphs.inputs if s is not None], args):
            buffer.copy_(t)
        graphs.forward.replay()
        # copies: the next replay overwrites the graph's own outputs
        outputs = tuple(o.clone() for o in graphs.outputs)
        ctx.mark_non_differentiable(*(o for o, d in zip(outputs, graphs.differentiable)
                                      if not d))
        return outputs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        graphs = ctx.graphs
        if [p.data_ptr() for p in graphs.params] != graphs.addresses:
            raise RuntimeError("the parameters of a graphed loop moved between its "
                               "forward and its backward")
        for buffer, g in zip(graphs.output_grads,
                             [g for g, d in zip(grads, graphs.differentiable) if d]):
            buffer.copy_(g)
        graphs.backward.replay()
        ctx.pending.done = True
        # The graph's own gradient tensors, not copies: autograd only reads
        # them. A `.grad` that exists (the step's GradBuffer views) takes
        # them by an in-place add; where `.grad` is None, AccumulateGrad
        # would adopt a tensor that nothing else holds, but `graphs.grads`
        # holds these, so it stores a copy; sums with other branches go to
        # new tensors or into the other branch's. All of it is queued on
        # this stream before the next replay can overwrite them. This holds
        # while no loop input is a view of a parameter: the gradient of such
        # an input would reach the parameter as a view of the graph's
        # tensor, a new tensor that AccumulateGrad would adopt as `.grad`.
        return (None, None, *graphs.grads)


class LoopGraph:
    """The graphs of one model's loop, kept on the model so that they and
    their memory go with it (a deep copy of the model starts without).
    `captures` and `replays` name its counters; `spans`, where given, is
    the (forward, backward) span pair a replay runs under."""

    def __init__(self, captures: str, replays: str, spans=None):
        self.captures, self.replays, self.spans = captures, replays, spans
        self.key = None
        self.graphs = None
        self.noise = None  # the replays' noise buffers, from the warm-up
        self._pending = None  # a weak reference to the last replay's _Pending

    def __deepcopy__(self, memo):
        return LoopGraph(self.captures, self.replays, self.spans)

    def __call__(self, fn, inputs, module: nn.Module, mode: str, generator: torch.Generator,
                 noise_like, eligible: bool = True):
        """`fn(*inputs, eps=, mode=, generator=)` -> a tuple of tensors,
        eagerly or from the graphs. `inputs` are tensors or None; `module`
        is the one whose parameters `fn` reads. `noise_like(outputs)` gives,
        from the warm-up's outputs, one empty contiguous tensor per draw the
        loop makes, in order, shaped and typed as the draw; `fn` reads draw k
        from eps[k]. None where the call draws nothing. `eligible` False
        runs the call eagerly."""
        key = _key(inputs, module, mode) if eligible else None
        last = self._pending and self._pending()
        if (key is None or (last is not None and not last.done)
                or (noise_like is not None and generator is None)):
            return fn(*inputs, eps=None, mode=mode, generator=generator)
        if key != self.key:
            self.key, self.graphs = key, None
            outputs = fn(*inputs, eps=None, mode=mode, generator=generator)
            self.noise = None if noise_like is None else noise_like(outputs)
            return outputs
        with tracing.span(self.spans[0]) if self.spans else contextlib.nullcontext():
            if self.noise is not None:
                draw_noise(generator, self.noise)
            if self.graphs is None:
                self.graphs = _Graphs(fn, inputs, module, self.noise, mode)
                tracing.count(self.captures)
            tracing.count(self.replays)
            pending = _Pending()
            self._pending = weakref.ref(pending)
            present = [t for t in inputs if t is not None]
            outputs = _Replay.apply(self.graphs, pending, *present, *self.graphs.params)
        if self.spans:
            tracing.grad_span(self.spans[1], outputs, present)
        return outputs
