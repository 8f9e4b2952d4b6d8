"""The reference's entry points for the sequential VRNN: the model built from
a configuration file's hparams; the plain RAdam, the training step and the
precision switch are the tree's (`model.py`), taken by import."""
from __future__ import annotations

import torch

from .model import RAdam, precision, train_step  # noqa: F401  the loops' interface
from .sequential import SequentialModel


def build(hparams: dict, device) -> SequentialModel:
    model = SequentialModel(dict(hparams))
    return model.to(device=device, memory_format=torch.channels_last)
