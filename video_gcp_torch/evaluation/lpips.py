"""Perceptual distance over the Evaluator's dumps, the LPIPS protocol
(evaluation/lpips.py of the JAX package; gcp/evaluation/lpips/
compute_lpips.py:18-62). The features:

- **AlexNet-LPIPS** when `GCP_LPIPS_WEIGHTS` (or `--weights`) names a file
  or a directory of `.pt`/`.pth` files holding torchvision `alexnet`'s
  features (`features.0.weight`, ...) and, optionally, the lpips 'alex'
  linear head (`lin0.model.1.weight`, ...): with both, LPIPS(alex); with the
  backbone alone, the unweighted AlexNet distance. Nothing is downloaded.
- otherwise a **proxy**: three random stride-2 3x3 convs with ReLU, drawn
  from a seeded torch generator. Its numbers are not LPIPS and not
  comparable with the JAX package's proxy, which draws its weights from
  JAX's PRNG (pass those weights in to reproduce it).

    python -m video_gcp_torch.evaluation.lpips <metrics_dir> [--it N]
        [--weights DIR|FILE] [--device cuda|cpu]

Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

from video_gcp_torch.load import require_device, set_float32_precision
from video_gcp_torch.models.nets import pad_same

LPIPS_WEIGHTS_ENV = "GCP_LPIPS_WEIGHTS"

# torchvision AlexNet's feature convs: (out_ch, kernel, stride, pad), at
# features.{0, 3, 6, 8, 10}; 3x3/s2 max-pools follow relu1 and relu2, and
# LPIPS taps every ReLU
_ALEXNET_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
                  (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEXNET_INDICES = (0, 3, 6, 8, 10)
# the LPIPS scaling layer (lpips.networks)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def random_feature_weights(seed: int = 0) -> list:
    """The proxy's conv kernels for RGB images in the JAX package's HWIO
    layout, drawn from a seeded torch generator on the CPU (not the JAX
    package's draw)."""
    g = torch.Generator().manual_seed(seed)
    out, ch = [], 3
    for out_ch in (32, 64, 128):
        out.append((torch.randn((3, 3, ch, out_ch), generator=g) / np.sqrt(9 * ch)).numpy())
        ch = out_ch
    return out


def random_feature_fn(weights: list | None = None, device="cuda"):
    """The proxy's features: [N, C, H, W] in [-1, 1] -> one map per conv
    (stride 2, XLA "SAME", ReLU). `weights` in random_feature_weights'
    layout (default: its seed-0 draw)."""
    device = require_device(device, "random_feature_fn")
    weights = weights if weights is not None else random_feature_weights()
    kernels = [torch.tensor(w, device=device).permute(3, 2, 0, 1) for w in weights]

    def features(x: torch.Tensor) -> list:
        feats = []
        for w in kernels:
            x = torch.relu(F.conv2d(pad_same(x, (3, 3), (2, 2)), w, stride=2))
            feats.append(x)
        return feats

    features.lins, features.device = None, device
    return features


def load_lpips_params(weights_path: str, device="cpu") -> dict:
    """AlexNet's five feature convs (OIHW, bias) and, if every one is
    there, the lpips head's five channel weights [C], from one checkpoint
    or a directory of `.pt`/`.pth` files (torch.load(weights_only=True))."""
    files = [weights_path]
    if os.path.isdir(weights_path):
        files = sorted(glob.glob(os.path.join(weights_path, "*.pt"))
                       + glob.glob(os.path.join(weights_path, "*.pth")))
        if not files:
            raise FileNotFoundError(f"no .pt/.pth files under {weights_path}")
    raw = {}
    for f in files:
        raw.update(torch.load(f, map_location="cpu", weights_only=True))
    params = {"convs": [], "lins": None}
    for i in _ALEXNET_INDICES:
        if f"features.{i}.weight" not in raw:
            raise KeyError(f"missing AlexNet tensor features.{i}.weight")
        params["convs"].append(tuple(raw[f"features.{i}.{p}"].to(device, torch.float32)
                                     for p in ("weight", "bias")))
    lins = [raw.get(f"lin{i}.model.1.weight") for i in range(5)]
    if all(lin is not None for lin in lins):
        params["lins"] = [lin.reshape(-1).to(device, torch.float32) for lin in lins]
    return params


def alexnet_feature_fn(weights_path: str, device="cuda"):
    """LPIPS(alex)'s features from local weights: [N, C, H, W] in [-1, 1]
    -> the five ReLU maps; the lin head, if present, is `.lins`, the
    weights' device `.device`."""
    device = require_device(device, "alexnet_feature_fn")
    set_float32_precision()
    params = load_lpips_params(weights_path, device)
    shift = torch.tensor(_LPIPS_SHIFT, device=device)[:, None, None]
    scale = torch.tensor(_LPIPS_SCALE, device=device)[:, None, None]

    def features(x: torch.Tensor) -> list:
        h = (x - shift) / scale
        feats = []
        for i, ((w, b), (_, _, stride, pad)) in enumerate(zip(params["convs"], _ALEXNET_CONVS)):
            h = torch.relu(F.conv2d(h, w, b, stride=stride, padding=pad))
            feats.append(h)
            if i < 2:  # VALID 3x3/s2 max-pools after relu1 and relu2
                h = F.max_pool2d(h, 3, 2)
        return feats

    features.lins, features.device = params["lins"], device
    return features


def default_feature_fn(device="cuda"):
    """(features, kind): AlexNet when $GCP_LPIPS_WEIGHTS names a path, else
    the proxy ('random-proxy')."""
    path = os.environ.get(LPIPS_WEIGHTS_ENV)
    if path and os.path.exists(path):
        return alexnet_feature_fn(path, device), "alex"
    return random_feature_fn(device=device), "random-proxy"


@torch.no_grad()
def lpips_distance(a: np.ndarray, b: np.ndarray, feature_fn) -> np.ndarray:
    """Per-image distance [N] of a, b [N, H, W, C] in [-1, 1]: each layer's
    maps unit-normalised over the channels; with the lin head (`.lins`) the
    squared differences weighted per channel (LPIPS), else summed; averaged
    over space and summed over the layers. Runs on the feature function's
    `.device` (the CPU if it names none)."""
    device = getattr(feature_fn, "device", "cpu")
    fa, fb = (feature_fn(torch.as_tensor(np.asarray(v, np.float32), device=device)
                         .permute(0, 3, 1, 2)) for v in (a, b))
    lins = getattr(feature_fn, "lins", None)
    total = 0.0
    for i, (la, lb) in enumerate(zip(fa, fb)):
        na = la / (torch.linalg.vector_norm(la, dim=1, keepdim=True) + 1e-10)
        nb = lb / (torch.linalg.vector_norm(lb, dim=1, keepdim=True) + 1e-10)
        diff2 = (na - nb) ** 2
        if lins is not None:
            diff2 = diff2 * lins[i][:, None, None]
        total = total + diff2.sum(1).mean(dim=(1, 2))
    return total.cpu().numpy()


def compute_lpips(gt_path: str, gen_path: str, feature_fn=None, device="cuda") -> float:
    """The mean distance over the frames that are not all-black padding;
    `feature_fn` defaults to default_feature_fn's on `device`."""
    if feature_fn is None:
        feature_fn = default_feature_fn(device)[0]
    gt = np.transpose(np.load(gt_path), (0, 1, 3, 4, 2))
    gen = np.transpose(np.load(gen_path), (0, 1, 3, 4, 2))
    b, t = gt.shape[:2]
    d = lpips_distance(gt.reshape((-1,) + gt.shape[2:]), gen.reshape((-1,) + gen.shape[2:]),
                       feature_fn).reshape(b, t)
    valid = np.abs(gt.reshape(b, t, -1)).max(-1) > 1e-6
    return float((d * valid).sum() / np.maximum(valid.sum(), 1))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("metrics_dir")
    p.add_argument("--it", default=None)
    p.add_argument("--weights", default=None,
                   help=f"AlexNet/lpips weights (default: ${LPIPS_WEIGHTS_ENV})")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    if args.weights:
        feature_fn, kind = alexnet_feature_fn(args.weights, args.device), "alex"
    else:
        feature_fn, kind = default_feature_fn(args.device)
    label = "LPIPS" if kind == "alex" else "LPIPS-proxy(random-feat)"
    pattern = f"gt_seq_{args.it or '*'}.npy"
    for gt_path in sorted(glob.glob(os.path.join(args.metrics_dir, pattern))):
        gen_path = gt_path.replace("gt_seq_", "gen_images_")
        val = compute_lpips(gt_path, gen_path, feature_fn)
        print(f"{os.path.basename(gt_path)}: {label} = {val:.5f}")


if __name__ == "__main__":
    main()
