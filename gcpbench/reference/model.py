"""The reference's entry points: the GCP-tree model built from a
configuration file's hparams, its training steps with a plain RAdam, and
its prior forward.

The model is a frozen copy of the program's modules in this folder, with
GroupNorm + LeakyReLU as plain torch operations (`plain.py`); nothing here
imports the program. Float32 with TF32 off unless a caller switches TF32 on
for the control.
"""
from __future__ import annotations

import math

import torch

from .attrdict import AttrDict
from .tree import TreeModel


def precision(tf32: bool) -> None:
    """Full float32 (the configurations' precision), or TF32 for the
    control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def build(hparams: dict, device) -> TreeModel:
    model = TreeModel(dict(hparams))
    return model.to(device=device, memory_format=torch.channels_last)


class RAdam:
    """torch.optim.RAdam's update (no weight decay), written out: the first
    steps, while the variance is not yet tractable (rho_t <= 5), move by the
    bias-corrected momentum alone."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = list(params), lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.betas
        self.t += 1
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        rho_inf = 2 / (1 - b2) - 1
        rho_t = rho_inf - 2 * self.t * b2 ** self.t / bc2
        for p, m, v in zip(self.params, self.m, self.v):
            m.mul_(b1).add_(p.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            if rho_t > 5:
                rect = math.sqrt((rho_t - 4) * (rho_t - 2) * rho_inf
                                 / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
                p.sub_(self.lr * rect / bc1 * m * math.sqrt(bc2) / (v.sqrt() + self.eps))
            else:
                p.sub_(self.lr / bc1 * m)


def train_step(model: TreeModel, opt: RAdam, batch: dict, step: int,
               generator: torch.Generator):
    """One update as the configuration trains: the posterior forward, the
    total loss's backward, zeros for parameters without a gradient, every
    gradient zeroed when any is not finite, then RAdam. Returns (total loss,
    {name: gradient} as the optimizer got it)."""
    for p in opt.params:
        p.grad = None
    out = model(AttrDict(batch), phase="train", mode="posterior", generator=generator,
                step=step)
    total = out.losses.total.value
    total.backward()
    for p in opt.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    for g in grads:
        g.masked_fill_(~finite, 0.0)
    opt.step()
    return total.detach(), {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
