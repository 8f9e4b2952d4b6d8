"""One update step of a GCP model and the validation step
(parallel/train_step.py of the JAX package, single device).

The JAX step is one jitted program: value_and_grad, a finite-gradient mask,
the optax update and the step's metrics. Here the same runs eagerly:

- every gradient is zeroed when any is non-finite, and the optimizer still
  steps, so the Adam moments decay and the step count advances as under
  optax (the reference's NaN hook, base_trainer.py:24-66, stops instead);
- a parameter that got no gradient (the Gaussian log_sigma under the DLM
  decoder) gets zeros before the step, as optax steps every leaf; without
  them torch's per-parameter step counts would drift from optax's one count;
- `grad_norm` is the global norm of the masked gradients, before clipping.
"""
from __future__ import annotations

from typing import Optional

import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.ops.tree_index import per_level_means


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
    for group in opt.param_groups:
        group["gradient_clip"] = gradient_clip
    return opt


def _params(optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def train_step(model, optimizer: torch.optim.Optimizer, batch: AttrDict,
               step: int, generator: torch.Generator) -> AttrDict:
    """Forward in phase 'train' / mode 'posterior', backward, finite mask,
    optimizer step. Returns the metrics as tensors on the model's device
    (no host sync): every loss value, `grads_finite`, `grad_norm`, and the
    per-level means of the node-axis breakdowns (`kl_layerwise`, ...)."""
    optimizer.zero_grad(set_to_none=True)
    out = model(batch, phase="train", mode="posterior", generator=generator,
                step=step)
    losses = out.losses
    losses.total.value.backward()

    params = _params(optimizer)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    grads_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    for g in grads:
        g.masked_fill_(~grads_finite, 0.0)
    grad_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    clip = optimizer.param_groups[0].get("gradient_clip")
    if clip is not None:
        torch.nn.utils.clip_grad_norm_(params, clip)
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
    return metrics


def make_val_step(model):
    """Validation NLL with the train-mode posterior (train.py:211-215):
    `val_step(batch, step, generator)` returns every loss value, no update."""

    @torch.no_grad()
    def val_step(batch: AttrDict, step: int,
                 generator: torch.Generator) -> AttrDict:
        out = model(batch, phase="train", mode="posterior",
                    generator=generator, step=step)
        return AttrDict({k: v.value for k, v in out.losses.items()})

    return val_step
