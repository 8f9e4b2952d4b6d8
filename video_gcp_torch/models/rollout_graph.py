"""The VRNN's rollout as a pair of CUDA graphs, its forward and its backward.

`SequentialModel.rollout` is max_seq_len - 1 dependent steps of a dozen
small ops each; on the card the host's time to issue them, not the device,
sets the pace of a training step. `RolloutGraph` captures that same Python
loop once, with its gradient with respect to the loop's inputs and the
cell's parameters, and replays both inside an autograd function, one launch
each: autograd then accumulates the parameters' gradients as it does for
the eager loop.

When it engages depends only on what a call shows. The graphs serve a call
whose tensors are on CUDA, while autograd records, and whose key (mode, the
TF32 switches, each input's presence, shape, dtype, device and whether it
needs a gradient, and the parameters' addresses, dtypes and whether they
need one) equals the previous such call's. The first call with a key runs
eager and is the warm-up; the second captures and replays; later ones
replay. A new key drops the graphs. A call made while the previous replay
still awaits its backward runs eager, since a replay would overwrite the
activations that backward reads. Every other call (the CPU; evaluation,
planning and the val passes, under no_grad) runs the eager loop and leaves
the graphs as they are.

The noise: the eager loop draws each step's standard normals from the
generator through `Gaussian.sample`. Before a replay, `draw_noise` makes the
same `torch.randn` calls in the same order into a buffer that the graph
reads, so the samples and the generator's state are the eager loop's;
warm-up and capture draw nothing.

Counters `rollout.graph_captures` and `rollout.graph_replays` (one per
rollout served by a replay) count always.
"""
from __future__ import annotations

import weakref

import torch
import torch.nn as nn

from video_gcp_torch import tracing


def draw_noise(generator: torch.Generator, steps: int, shape, device,
               dtype: torch.dtype) -> torch.Tensor:
    """The standard normals of `steps` rollout steps, [steps, *shape]: one
    `torch.randn` a step, as `Gaussian.sample` draws them."""
    if generator is None:
        raise ValueError("Gaussian.sample needs an explicit torch.Generator")
    return torch.stack([torch.randn(shape, generator=generator, device=device, dtype=dtype)
                        for _ in range(steps)])


def _key(inputs, cell: nn.Module, mode):
    """The call's key, or None where the graphs cannot serve it."""
    params = list(cell.parameters())
    present = [t for t in inputs if t is not None]
    if not (present[0].is_cuda and torch.is_grad_enabled()
            and any(t.requires_grad for t in present + params)):
        return None
    return (mode, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            tuple(None if t is None else (t.shape, t.dtype, t.device, t.requires_grad)
                  for t in inputs),
            tuple((p.data_ptr(), p.dtype, p.requires_grad) for p in params))


class _Pending:
    """One replay whose backward has not run yet."""

    __slots__ = ("done", "__weakref__")

    def __init__(self):
        self.done = False


class _Loop(nn.Module):
    """`fn` as a module over the cell, for `functional_call`."""

    def __init__(self, fn, cell: nn.Module):
        super().__init__()
        self.fn, self.cell = fn, cell

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


class _Graphs:
    """One key's captured forward and backward, their memory pool, and the
    static tensors they read and write.

    The capture runs the loop over aliases of the cell's parameters (new
    leaves on the same storage), so that the replays read the parameters'
    current values while the capture's autograd graph shares no node with
    any other: a parameter's own gradient accumulator, made on another
    stream by an eager call whose graph is still alive, would end the
    capture."""

    def __init__(self, fn, inputs, cell: nn.Module, noise, mode):
        named = [(n, p) for n, p in cell.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        self.addresses = [p.data_ptr() for p in self.params]
        aliases = {"cell." + n: p.detach().requires_grad_() for n, p in named}
        self.inputs = [None if t is None else t.detach().clone().requires_grad_(t.requires_grad)
                       for t in inputs]
        self.noise = None if noise is None else torch.empty_like(noise)
        device = next(t for t in inputs if t is not None).device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        pool = torch.cuda.graph_pool_handle()
        self.forward, self.backward = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.forward, pool=pool, stream=stream):
            self.outputs = torch.func.functional_call(
                _Loop(fn, cell), aliases, tuple(self.inputs),
                dict(eps=self.noise, mode=mode, generator=None))
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
    def forward(ctx, graphs, pending, noise, *args):
        ctx.graphs, ctx.pending = graphs, pending
        for buffer, t in zip([s for s in graphs.inputs if s is not None], args):
            buffer.copy_(t)
        if noise is not None:
            graphs.noise.copy_(noise)
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
            raise RuntimeError("the VRNN cell's parameters moved between the graphed "
                               "rollout's forward and its backward")
        for buffer, g in zip(graphs.output_grads,
                             [g for g, d in zip(grads, graphs.differentiable) if d]):
            buffer.copy_(g)
        graphs.backward.replay()
        ctx.pending.done = True
        return (None, None, None, *(None if g is None else g.clone() for g in graphs.grads))


class RolloutGraph:
    """The rollout's graphs of one model, kept on the model so that they
    and their memory go with it (a deep copy of the model starts without)."""

    def __init__(self):
        self.key = None
        self.graphs = None
        self.noise_like = None  # (steps, shape a step, device, dtype), from the warm-up
        self._pending = None  # a weak reference to the last replay's _Pending

    def __deepcopy__(self, memo):
        return RolloutGraph()

    def __call__(self, fn, inputs, cell: nn.Module, mode: str, generator: torch.Generator):
        """`fn(*inputs, eps=, mode=, generator=)` -> (encodings, q_z.mu,
        q_z.log_sigma, p_z.mu, p_z.log_sigma), each [B, T-1, ...]: eagerly
        or from the graphs. `inputs` are (state, x, context, x_primes,
        more, z), None where absent; `cell` is the module `fn` steps, the
        only one whose parameters it reads."""
        key = _key(inputs, cell, mode)
        last = self._pending and self._pending()
        if key is None or (last is not None and not last.done):
            return fn(*inputs, eps=None, mode=mode, generator=generator)
        if key != self.key:
            self.key, self.graphs = key, None
            outputs = fn(*inputs, eps=None, mode=mode, generator=generator)
            q_mu = outputs[1]  # a step draws noise like its q_z.mu (or p_z.mu, alike)
            self.noise_like = (q_mu.shape[1], q_mu[:, 0].shape, q_mu.device, q_mu.dtype)
            return outputs
        # injected latents z (the last input) draw nothing
        noise = None if inputs[-1] is not None else draw_noise(generator, *self.noise_like)
        if self.graphs is None:
            self.graphs = _Graphs(fn, inputs, cell, noise, mode)
            tracing.count("rollout.graph_captures")
        tracing.count("rollout.graph_replays")
        pending = _Pending()
        self._pending = weakref.ref(pending)
        return _Replay.apply(self.graphs, pending, noise,
                             *(t for t in inputs if t is not None), *self.graphs.params)
