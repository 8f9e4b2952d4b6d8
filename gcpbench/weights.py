"""Weights made from the seed on the device, the same for the program and
the reference: one normal draw over every trainable parameter (a
`torch.Generator` on the device, one call), then per leaf a scale. Matrices
and kernels get 1/sqrt(fan in) with the fan in taken as numel / shape[0]; a
norm's scale 1 + 0.1 n; biases and scalars 0.1 n. Parameters that do not
train (the LSTMs' zero input bias) keep their value."""
from __future__ import annotations

import math

import torch


def seeded_values(named_params, seed: int, device) -> dict:
    """{name: tensor} for every trainable parameter of `named_params`
    (name, parameter) pairs, from `seed`."""
    leaves = [(n, p.shape) for n, p in sorted(named_params) if p.requires_grad]
    total = sum(math.prod(s) for _, s in leaves)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape in leaves:
        n = math.prod(shape)
        v = flat[offset:offset + n].view(shape)
        offset += n
        if len(shape) >= 2:
            out[name] = v / math.sqrt(n // shape[0])
        elif name.endswith("weight") and "norm" in name:
            out[name] = 1.0 + 0.1 * v
        else:
            out[name] = 0.1 * v
    return out


@torch.no_grad()
def assign(module: torch.nn.Module, seed: int) -> None:
    """Every trainable parameter of `module` set to its seeded value (its
    memory format kept)."""
    params = dict(module.named_parameters())
    for name, v in seeded_values(params.items(), seed, next(iter(params.values())).device).items():
        params[name].copy_(v)
