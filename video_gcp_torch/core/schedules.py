"""Step-driven schedules (core/schedules.py of the JAX package): a pure
function of the global step, nothing to checkpoint."""
from __future__ import annotations

import torch


def linear_ramp(step, n_steps: int, target: float,
                start: float = 0.0) -> torch.Tensor:
    """Linear burn-in from `start` to `target` over `n_steps` (blox
    LinearUpdater), as a float32 scalar tensor: like the JAX array it
    mirrors, a ramp weight of 0 still enters `total_loss`."""
    step = torch.as_tensor(step, dtype=torch.float32)
    frac = torch.clamp(step / max(n_steps, 1), 0.0, 1.0)
    return start + (target - start) * frac


def exponential_decay(step, initial: float, tenthlife: int,
                      min_limit: float = 0.0) -> torch.Tensor:
    """Exponential decay with a tenth-life in steps: value(tenthlife) =
    initial / 10 (blox ExponentialDecayUpdater; adaptive.py:25-26)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    decay = 0.1 ** (step / max(tenthlife, 1))
    return torch.clamp(initial * decay, min=min_limit)


def kl_weight_at(step, kl_weight: float, burn_in_steps):
    """KL weight: constant, or a linear burn-in when configured
    (base_gcp.py:121-128)."""
    if burn_in_steps is None:
        return kl_weight
    return linear_ramp(step, burn_in_steps, kl_weight)


def matching_temp_at(step, temp: float, tenthlife: int, min_limit: float):
    """Soft-DTW matching temperature: constant when tenthlife == -1, else
    decaying (adaptive.py:23-26)."""
    if tenthlife == -1:
        return temp
    return exponential_decay(step, temp, tenthlife, min_limit)
