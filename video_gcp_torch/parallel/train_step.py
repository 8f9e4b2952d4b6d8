"""One update step of a GCP model and the validation step
(parallel/train_step.py of the JAX package), on one device or under a
process group.

The JAX step is one jitted program: value_and_grad, a finite-gradient mask,
the optax update and the step's metrics. Here the same runs eagerly:

- every gradient is zeroed when any is non-finite, and the optimizer still
  steps, so the Adam moments decay and the step count advances as under
  optax (the reference's NaN hook, base_trainer.py:24-66, stops instead);
- a parameter that got no gradient (the Gaussian log_sigma under the DLM
  decoder) gets zeros before the step, as optax steps every leaf; without
  them torch's per-parameter step counts would drift from optax's one count;
- `grad_norm` is the global norm of the masked gradients, before clipping.

Under a process group (`mesh=`, see parallel/mesh.py) each rank holds its
`batch_rows` of the global batch, and the gradients are reduced over the
ranks before anything reads them, as XLA's psum does in the JAX step:

- data parallel (a mesh without a 'model' axis, or one of size 1): the
  model is replicated and, after backward and the zero-fill, every gradient
  is averaged over the ranks in one flat all_reduce. Not
  DistributedDataParallel: the step already fills the gradients that
  autograd leaves out (log_sigma under the DLM decoder, VMPC's unused
  sequence encoding), which plain DDP refuses without a graph search each
  step (find_unused_parameters), and the one reduction after backward is
  the JAX step's single psum;
- dp x fsdp (`shard_model` over a ('data', 'model') mesh): FSDP2's
  `fully_shard` keeps each parameter that the JAX rule shards
  (mesh.param_shardings), and its RAdam moments, split over 'model' and
  reduce-scatters their gradients in backward; the small arrays the rule
  replicates stay whole on every rank and are averaged like the data
  parallel ones.

The finite mask and the norm then cover the global gradient (one rank's NaN
zeroes every rank's update), and the returned metrics are the global
batch's: the losses are means over the batch, and every rank holds as many
rows, so their mean over the ranks is the global value.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.ops.tree_index import per_level_means
from video_gcp_torch.parallel.mesh import axis_size, param_shardings


def make_optimizer(params, optim: str = "radam", lr: float = 1e-3,
                   gradient_clip: Optional[float] = None,
                   momentum: float = 0.9, beta: float = 0.9) -> torch.optim.Optimizer:
    """adam / radam / rmsprop / sgd (gcp_builder.py:174-186; RAdam is the
    reference default), matching optax's defaults: Adam and RAdam with
    betas (beta, 0.999) and eps 1e-8, RMSprop with decay 0.9. optax's
    RMSprop adds eps inside the square root and torch's outside it. With
    `gradient_clip`, `train_step` clips the global norm first
    (optax.clip_by_global_norm); the value is kept in the param groups, so
    it travels with the optimizer's state_dict."""
    if optim == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(beta, 0.999), eps=1e-8)
    elif optim == "radam":
        opt = torch.optim.RAdam(params, lr=lr, betas=(beta, 0.999), eps=1e-8)
    elif optim == "rmsprop":
        opt = torch.optim.RMSprop(params, lr=lr, alpha=0.9, eps=1e-8,
                                  momentum=momentum)
    elif optim == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer {optim!r}")
    if _mixed_dtensors(opt.param_groups[0]["params"]):
        # dp x fsdp holds sharded and whole parameters side by side; the
        # multi-tensor kernels take one kind at a time
        for group in opt.param_groups:
            group["foreach"] = False
    for group in opt.param_groups:
        group["gradient_clip"] = gradient_clip
    return opt


def _params(optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _mixed_dtensors(params) -> bool:
    kinds = {_is_dtensor(p) for p in params}
    return len(kinds) > 1


def _local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's own shard (a view), or the tensor itself."""
    return t.to_local() if _is_dtensor(t) else t


def shard_model(model, mesh, min_shard_size: int = 2 ** 15):
    """dp x fsdp: `fully_shard` the whole model over a ('data', 'model')
    mesh (FSDP2; replicated over 'data', split over 'model'), each large
    parameter along the dimension `mesh.param_shardings` picks for it. The
    arrays the rule replicates (GroupNorm scales, biases, scalars) are left
    out of FSDP, whole on every rank. Load weights before this call: after
    it the parameters are sharded tensors. Returns the model."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    named = dict(model.named_parameters())
    dims = param_shardings(named, axis_size(mesh, "model"), min_shard_size)
    with torch.no_grad():  # FSDP splits contiguous tensors only: the split
        for n, p in named.items():  # conv weights leave channels_last
            if dims[n] is not None and not p.is_contiguous():
                p.data = p.data.contiguous()
    dim_of = {id(p): dims[n] for n, p in named.items()}
    whole = {p for n, p in named.items() if dims[n] is None}
    fully_shard(model, mesh=mesh, ignored_params=whole,
                shard_placement_fn=lambda p: Shard(dim_of[id(p)]))
    return model


def broadcast_model(model, src: int = 0):
    """Every parameter and buffer of rank `src`'s (unsharded) model on every
    rank, so that all ranks start from the same weights."""
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, src)


def _average_whole_grads(grads):
    """All-reduce, in one flat buffer per dtype, the mean over the ranks of
    every gradient that FSDP did not reduce (all of them when data
    parallel)."""
    whole = [g for g in grads if not _is_dtensor(g)]
    world = dist.get_world_size()
    for dtype in sorted({g.dtype for g in whole}, key=str):
        same = [g for g in whole if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _global_metrics(metrics: AttrDict) -> AttrDict:
    """The mean over the ranks of every metric, in one all_reduce."""
    keys = list(metrics)
    flat = torch.cat([metrics[k].reshape(-1).float() for k in keys])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, offset = AttrDict(), 0
    for k in keys:
        n = metrics[k].numel()
        out[k] = flat[offset:offset + n].view_as(metrics[k]).to(metrics[k].dtype)
        offset += n
    return out


def train_step(model, optimizer: torch.optim.Optimizer, batch: AttrDict,
               step: int, generator: torch.Generator, mesh=None) -> AttrDict:
    """Forward in phase 'train' / mode 'posterior', backward, finite mask,
    optimizer step. Returns the metrics as tensors on the model's device
    (no host sync): every loss value, `grads_finite`, `grad_norm`, and the
    per-level means of the node-axis breakdowns (`kl_layerwise`, ...).
    In one process the finite mask and `grad_norm` cover every gradient of
    the model, and the clip and the step the optimizer's parameters: an
    optimizer over a subset is optax's `multi_transform` with `set_to_zero`
    for the rest.

    With `mesh` (a DeviceMesh over every rank of the process group) `batch`
    is this rank's rows of the global batch, the gradients are reduced over
    the ranks first and the metrics are the global batch's."""
    model.zero_grad(set_to_none=True)
    out = model(batch, phase="train", mode="posterior", generator=generator,
                step=step)
    losses = out.losses
    losses.total.value.backward()

    params = _params(optimizer)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip = optimizer.param_groups[0].get("gradient_clip")
    if mesh is None:
        # every gradient, also of parameters the optimizer does not step
        # (the inverse-model fine-tune's frozen trunk): the JAX step masks
        # and measures all of them, and clips only what its optimizer sees
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grads_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        for g in grads:
            g.masked_fill_(~grads_finite, 0.0)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(params, clip)
    else:
        grad_norm, grads_finite = _reduced_grads(params, mesh, clip)
    optimizer.step()

    metrics = AttrDict({k: v.value.detach() for k, v in losses.items()})
    metrics.grads_finite = grads_finite
    metrics.grad_norm = grad_norm
    # layerwise tree-loss breakdowns (tree_module.py:159-169)
    for k in ("dense_img_rec", "kl"):
        term = losses.get(k)
        if term is not None and term.breakdown is not None:
            n = term.breakdown.shape[-1]
            if n > 1 and (n & (n + 1)) == 0:  # the node axis of a full tree
                metrics[k + "_layerwise"] = per_level_means(term.breakdown.detach())
    if mesh is not None:
        reduced = _global_metrics(AttrDict(
            {k: v for k, v in metrics.items() if k not in ("grads_finite", "grad_norm")}))
        metrics.update(reduced)
    return metrics


def _reduced_grads(params, mesh, clip):
    """The gradients reduced over the ranks, masked when any element of the
    global gradient is non-finite, and clipped by the global norm
    (optax.clip_by_global_norm, with torch's clip_grad_norm_ formula);
    returns (grad_norm, grads_finite)."""
    grads = [p.grad for p in params]
    _average_whole_grads(grads)
    local = [_local(g) for g in grads]
    finite = torch.stack([torch.isfinite(g).all() for g in local]).all()
    flag = finite.to(torch.float32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    grads_finite = flag[0] > 0
    for g in local:
        g.masked_fill_(~grads_finite, 0.0)
    sq = [torch.linalg.vector_norm(g) ** 2 for g in local]
    whole_sq = sum((s for s, g in zip(sq, grads) if not _is_dtensor(g)),
                   torch.zeros((), device=local[0].device))
    shard_sq = sum((s for s, g in zip(sq, grads) if _is_dtensor(g)),
                   torch.zeros((), device=local[0].device)).reshape(1)
    if axis_size(mesh, "model") > 1:
        dist.all_reduce(shard_sq, group=mesh.get_group("model"))
    grad_norm = torch.sqrt(whole_sq + shard_sq[0])
    if clip is not None:
        coef = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
        for g in local:
            g.mul_(coef)
    return grad_norm, grads_finite


def make_val_step(model, mesh=None):
    """Validation NLL with the train-mode posterior (train.py:211-215):
    `val_step(batch, step, generator)` returns every loss value, no update;
    with `mesh`, the means over the ranks' rows (the global batch's)."""

    @torch.no_grad()
    def val_step(batch: AttrDict, step: int,
                 generator: torch.Generator) -> AttrDict:
        out = model(batch, phase="train", mode="posterior",
                    generator=generator, step=step)
        values = AttrDict({k: v.value for k, v in out.losses.items()})
        return values if mesh is None else _global_metrics(values)

    return val_step
