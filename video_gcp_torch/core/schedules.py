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


def kl_weight_at(step, kl_weight: float, burn_in_steps):
    """KL weight: constant, or a linear burn-in when configured
    (base_gcp.py:121-128)."""
    if burn_in_steps is None:
        return kl_weight
    return linear_ramp(step, burn_in_steps, kl_weight)
