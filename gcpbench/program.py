"""The system under test, `video_gcp_torch`, built as its own configuration
path builds it: the experiment's conf.py through the port's config loader
and hparams, the model class it names, float32 with TF32 off, channels_last
on the device (video_gcp_torch/load.py:load_model).

The hparams that path yields must equal the configuration file's: the file
holds the configuration as it is run.
"""
from __future__ import annotations

from pathlib import Path

import torch


def encode(value):
    """Hparams as JSON: a class or function by its qualified name."""
    if isinstance(value, dict):
        return {k: encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [encode(v) for v in value]
    if callable(value):
        return f"<{value.__module__}.{value.__qualname__}>"
    return value


def hparams(root: Path, config: dict):
    """(hparams, model class) of the configuration's experiment."""
    from video_gcp_torch.training.config import build_hparams, load_config
    bundle = load_config(root / config["experiment"])
    hp = dict(build_hparams(bundle))
    if encode(hp) != config["hparams"]:
        diff = sorted(k for k in set(hp) | set(config["hparams"])
                      if encode(hp.get(k)) != config["hparams"].get(k))
        raise RuntimeError(f"the program's hparams differ from the configuration "
                           f"file's in {diff}")
    conf = bundle.configuration
    trainer = dict(optimizer=dict(name=conf["optimizer"], lr=conf["lr"], beta=conf["adam_beta"]),
                   evaluation=dict(pruning_scheme=conf["metric_pruning_scheme"],
                                   top_of_100=conf["top_of_100_eval"]))
    for key, value in trainer.items():
        if config[key] != value:
            raise RuntimeError(f"the program's {key} {value} is not the configuration "
                               f"file's {config[key]}")
    return hp, conf["model"]


def build_model(root: Path, config: dict, device, override: dict = None):
    """The configuration's model on `device` (in eval mode), its hparams
    checked against the file; `override` resizes it (CPU tests only)."""
    from video_gcp_torch.load import set_float32_precision
    hp, cls = hparams(root, config)
    hp.update(override or {})
    set_float32_precision()
    model = cls(hp)
    return model.to(device=device, memory_format=torch.channels_last).eval(), hp
