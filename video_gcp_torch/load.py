"""Entry point of the port: build a trained GCP model on the card.

    model = load_model("experiments/prediction/9room/gcp_tree",
                       weights=".../pretrained_ep74.npz")
    with torch.inference_mode():
        out = model(inputs, phase="plan", mode="prior", pred_length=True,
                    generator=torch.Generator("cuda").manual_seed(0))

bf16 compute over float32 parameters, as the JAX package's
`TreeModel(hp, dtype=jnp.bfloat16)`:

    model = load_model(conf_dir, weights, compute_dtype=torch.bfloat16)
"""
from __future__ import annotations

import torch

from video_gcp_torch.training.checkpoint import flax_to_torch, load_pretrained_npz
from video_gcp_torch.training.config import build_hparams, load_config


def set_float32_precision() -> None:
    """Full float32 on the card: cuDNN runs f32 convolutions in TF32 by
    default, which would break parity with the reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def require_device(device, caller: str) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    rather than fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device; pass device='cpu' to run on "
                           "the CPU")
    return device


def load_model(conf_dir, weights=None, device="cuda", dtype=torch.float32,
               compute_dtype=None):
    """The model of `<conf_dir>/conf.py` in eval mode on `device`, with
    `weights` (a pretrained npz of the JAX package) loaded strictly.

    `dtype` is the parameters' dtype (float32, or float64 for reference
    runs); `compute_dtype` the dtype the networks compute in (None: the
    parameters'). Runs on the card unless the caller passes device="cpu";
    without a card it raises rather than fall back. Conv weights are kept
    channels_last, so the conv pyramids' NHWC activations pass through cuDNN
    without copies."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"load_model: parameters in {dtype}; the reference keeps float32 "
            "parameters. For bf16 compute over float32 parameters pass "
            "compute_dtype=torch.bfloat16")
    device = require_device(device, "load_model")
    set_float32_precision()
    bundle = load_config(conf_dir)
    model = bundle.configuration["model"](build_hparams(bundle), dtype=compute_dtype)
    if weights is not None:
        model.load_state_dict(flax_to_torch(load_pretrained_npz(weights)),
                              strict=True)
    model.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    return model.eval()
