"""Frechet Video Distance over the Evaluator's dumps (evaluation/fvd.py of
the JAX package; gcp/evaluation/fvd/compute_fvd.py:27-88).

The protocol: load `gt_seq_*.npy` / `gen_images_*.npy` (channel-first
[B, T, C, H, W] in [-1, 1]), find each sequence's length by its trailing
all-black frames, zero the frames past it in both, embed every video and
take the Frechet distance between the two sets' Gaussian moments. The
embedding:

- **I3D** when `GCP_I3D_WEIGHTS` (or `--weights`) names a pytorch-i3d
  checkpoint (`Conv3d_1a_7x7.conv3d.weight`, `Mixed_3b.b1a.bn.running_mean`,
  ...): the InceptionI3d forward on 224x224 frames, whose 400 Kinetics
  logits FVD is defined on. Nothing is downloaded.
- otherwise a **proxy**: three random stride-2 3-D convs and a random
  projection, drawn from a seeded torch generator. It is not FVD, and its
  numbers are not comparable with the JAX package's proxy, which draws its
  weights from JAX's PRNG (pass those weights in to reproduce it).

The convs and pools use XLA's "SAME" padding (the extra element of an odd
pad at the end, `nets.pad_same`), as the JAX graph does.

    python -m video_gcp_torch.evaluation.fvd <metrics_dir> [--it N]
        [--weights i3d.pt] [--device cuda|cpu]

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

I3D_WEIGHTS_ENV = "GCP_I3D_WEIGHTS"
I3D_SIZE = 224


def detect_lengths(seqs_cf: np.ndarray) -> np.ndarray:
    """Length of each sequence: up to its last frame that is not all black
    (compute_fvd.py's variable-length rule); at least 1."""
    b, t = seqs_cf.shape[:2]
    nonblack = np.abs(seqs_cf.reshape(b, t, -1)).max(-1) > 1e-6
    lengths = np.zeros(b, dtype=int)
    for i in range(b):
        nz = np.nonzero(nonblack[i])[0]
        lengths[i] = (nz[-1] + 1) if len(nz) else 1
    return lengths


def _conv3d(x: torch.Tensor, w: torch.Tensor, stride=(1, 1, 1)) -> torch.Tensor:
    """XLA's "SAME" 3-D conv of NCDHW x with an OIDHW kernel."""
    return F.conv3d(pad_same(x, w.shape[2:], stride), w, stride=stride)


def random_conv_weights(dim: int = 224, seed: int = 0) -> dict:
    """The proxy's weights for RGB videos in the JAX package's layout (conv
    kernels DHWIO, the projection [128, dim]), drawn from a seeded torch
    generator on the CPU: the same on every device, not the JAX package's
    draw."""
    g = torch.Generator().manual_seed(seed)
    convs, ch = [], 3
    for out_ch in (32, 64, 128):
        convs.append((torch.randn((3, 3, 3, ch, out_ch), generator=g)
                      / np.sqrt(27 * ch)).numpy())
        ch = out_ch
    proj = (torch.randn((ch, dim), generator=g) / np.sqrt(ch)).numpy()
    return dict(convs=convs, proj=proj)


def random_conv_embed_fn(weights: dict | None = None, device="cuda"):
    """The proxy embedding [B, T, H, W, C] in [0, 255] -> [B, dim]: three
    stride-2 3x3x3 convs with tanh, the mean over space and time, a linear
    projection. `weights` in random_conv_weights' layout (default: its
    seed-0 draw)."""
    device = require_device(device, "random_conv_embed_fn")
    weights = weights if weights is not None else random_conv_weights()
    convs = [torch.tensor(w, device=device).permute(4, 3, 0, 1, 2) for w in weights["convs"]]
    proj = torch.tensor(weights["proj"], device=device)

    @torch.no_grad()
    def embed(videos: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(videos, dtype=torch.float32, device=device) / 127.5 - 1.0
        x = x.permute(0, 4, 1, 2, 3)
        for w in convs:
            x = torch.tanh(_conv3d(x, w, (2, 2, 2)))
        return (x.mean(dim=(2, 3, 4)) @ proj).cpu().numpy()

    return embed


# ---------------------------------------------------------------------------
# InceptionI3d (Kinetics-400), weights from a local pytorch-i3d checkpoint
# ---------------------------------------------------------------------------

# mixed-block branch widths: (b0 1x1, b1a 1x1, b1b 3x3, b2a 1x1, b2b 3x3, b3b 1x1)
_I3D_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def i3d_param_shapes(num_classes: int = 400) -> dict:
    """The checkpoint's tensor shapes by pytorch-i3d state-dict name (conv
    kernels OIDHW): for checking a checkpoint or synthesizing one."""
    shapes = {}

    def unit(name, in_ch, out_ch, k):
        shapes[f"{name}.conv3d.weight"] = (out_ch, in_ch, k, k, k)
        for p in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.bn.{p}"] = (out_ch,)

    unit("Conv3d_1a_7x7", 3, 64, 7)
    unit("Conv3d_2b_1x1", 64, 64, 1)
    unit("Conv3d_2c_3x3", 64, 192, 3)
    in_ch = 192
    for name, (b0, b1a, b1b, b2a, b2b, b3b) in _I3D_MIXED.items():
        unit(f"{name}.b0", in_ch, b0, 1)
        unit(f"{name}.b1a", in_ch, b1a, 1)
        unit(f"{name}.b1b", b1a, b1b, 3)
        unit(f"{name}.b2a", in_ch, b2a, 1)
        unit(f"{name}.b2b", b2a, b2b, 3)
        unit(f"{name}.b3b", in_ch, b3b, 1)
        in_ch = b0 + b1b + b2b + b3b
    shapes["logits.conv3d.weight"] = (num_classes, in_ch, 1, 1, 1)
    shapes["logits.conv3d.bias"] = (num_classes,)
    return shapes


def load_i3d_params(path: str, device="cpu") -> dict:
    """A pytorch-i3d checkpoint (read with torch.load(weights_only=True))
    -> {name: float32 tensor on `device`}: conv kernels as they are (OIDHW),
    each BatchNorm folded into `<unit>.bn.scale` and `.shift` with torch's
    BatchNorm3d eps of 1e-3 (gamma and beta default to 1 and 0)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = {k: v.to(torch.float32) for k, v in sd.items()}
    for key in [k for k in params if k.endswith(".bn.running_var")]:
        base = key[: -len(".running_var")]
        var = params[key]
        gamma = params.get(base + ".weight", torch.ones_like(var))
        beta = params.get(base + ".bias", torch.zeros_like(var))
        inv = gamma / torch.sqrt(var + 1e-3)
        params[base + ".scale"] = inv
        params[base + ".shift"] = beta - params[base + ".running_mean"] * inv
    return {k: v.to(device) for k, v in params.items()}


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]  # per channel over D, H, W


def _i3d_unit(params, name, x, stride=1):
    """conv3d + folded BN + ReLU (pytorch-i3d Unit3D), XLA "SAME"."""
    s = (stride,) * 3
    x = _conv3d(x, params[f"{name}.conv3d.weight"], s)
    return torch.relu(x * _bcast(params[f"{name}.bn.scale"]) + _bcast(params[f"{name}.bn.shift"]))


def _max_pool3d(x, window, stride):
    return F.max_pool3d(pad_same(x, window, stride, value=-float("inf")), window, stride)


def _i3d_mixed(params, name, x):
    b0 = _i3d_unit(params, f"{name}.b0", x)
    b1 = _i3d_unit(params, f"{name}.b1b", _i3d_unit(params, f"{name}.b1a", x))
    b2 = _i3d_unit(params, f"{name}.b2b", _i3d_unit(params, f"{name}.b2a", x))
    b3 = _i3d_unit(params, f"{name}.b3b", _max_pool3d(x, (3, 3, 3), (1, 1, 1)))
    return torch.cat([b0, b1, b2, b3], dim=1)


@torch.no_grad()
def i3d_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, 3] in [-1, 1] (224x224 for FVD) -> [B, 400] logits."""
    x = x.permute(0, 4, 1, 2, 3)  # NCDHW
    x = _i3d_unit(params, "Conv3d_1a_7x7", x, stride=2)
    x = _max_pool3d(x, (1, 3, 3), (1, 2, 2))
    x = _i3d_unit(params, "Conv3d_2b_1x1", x)
    x = _i3d_unit(params, "Conv3d_2c_3x3", x)
    x = _max_pool3d(x, (1, 3, 3), (1, 2, 2))
    x = _i3d_mixed(params, "Mixed_3b", x)
    x = _i3d_mixed(params, "Mixed_3c", x)
    x = _max_pool3d(x, (3, 3, 3), (2, 2, 2))
    for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
        x = _i3d_mixed(params, name, x)
    x = _max_pool3d(x, (2, 2, 2), (2, 2, 2))
    x = _i3d_mixed(params, "Mixed_5b", x)
    x = _i3d_mixed(params, "Mixed_5c", x)
    # the spatial mean, the 1x1x1 logits conv, the mean over what is left
    x = x.mean(dim=(3, 4), keepdim=True)
    x = F.conv3d(x, params["logits.conv3d.weight"], params["logits.conv3d.bias"])
    return x.mean(dim=(2, 3, 4))


def resize_frames(v: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T, 224, 224, C], bilinear with half-pixel
    centres: jax.image.resize(..., 'bilinear'), which antialiases a
    downscale."""
    b, t, h, w, c = v.shape
    x = v.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(I3D_SIZE, I3D_SIZE), mode="bilinear", align_corners=False,
                      antialias=I3D_SIZE < h or I3D_SIZE < w)
    return x.permute(0, 2, 3, 1).reshape(b, t, I3D_SIZE, I3D_SIZE, c)


def i3d_embed_fn(weights_path: str, batch: int = 16, device="cuda"):
    """The FVD embedding from a local I3D checkpoint: [B, T, H, W, C] in
    [0, 255] -> [B, 400] logits, `batch` videos at a time, frames scaled to
    [-1, 1] and resized to 224x224 (frechet_video_distance.py)."""
    device = require_device(device, "i3d_embed_fn")
    set_float32_precision()
    params = load_i3d_params(weights_path, device)

    def embed(videos: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(videos), batch):
            v = torch.as_tensor(videos[i:i + batch], dtype=torch.float32,
                                device=device) / 127.5 - 1.0
            out.append(i3d_logits(params, resize_frames(v)).cpu().numpy())
        return np.concatenate(out)

    return embed


def default_embed_fn(device="cuda"):
    """(embed, kind): I3D when $GCP_I3D_WEIGHTS names a file, else the
    proxy ('random-proxy': not FVD, for relative comparisons only)."""
    path = os.environ.get(I3D_WEIGHTS_ENV)
    if path and os.path.exists(path):
        return i3d_embed_fn(path, device=device), "i3d"
    return random_conv_embed_fn(device=device), "random-proxy"


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """d^2 = |mu_a - mu_b|^2 + Tr(S_a + S_b - 2 sqrt(S_a S_b))
    (frechet_video_distance.py's calculate_fvd)."""
    import scipy.linalg

    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    s_a = np.cov(feats_a, rowvar=False)
    s_b = np.cov(feats_b, rowvar=False)
    covmean = scipy.linalg.sqrtm(s_a @ s_b)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(np.sum((mu_a - mu_b) ** 2) + np.trace(s_a + s_b - 2.0 * covmean))


def compute_fvd(gt_path: str, gen_path: str, embed_fn=None, max_len: int | None = None,
                device="cuda") -> float:
    """FVD between two dumps; `embed_fn` defaults to default_embed_fn's on
    `device`."""
    gt_cf = np.load(gt_path)
    # channel-first [B, T, C, H, W] in [-1, 1] -> [B, T, H, W, C] in [0, 255]
    to_hwc = lambda x: (np.transpose(x, (0, 1, 3, 4, 2)) + 1.0) * 127.5  # noqa: E731
    gt, gen = to_hwc(gt_cf), to_hwc(np.load(gen_path))
    lengths = detect_lengths(gt_cf)
    if max_len:
        gt, gen = gt[:, :max_len], gen[:, :max_len]
    # the frames past each sequence's length zeroed in both
    mask = (np.arange(gt.shape[1])[None, :] < lengths[:, None]).astype(np.float32)
    gt = gt * mask[:, :, None, None, None]
    gen = gen * mask[:, :, None, None, None]
    embed = embed_fn if embed_fn is not None else default_embed_fn(device)[0]
    return frechet_distance(embed(gt), embed(gen))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("metrics_dir")
    p.add_argument("--it", default=None)
    p.add_argument("--weights", default=None,
                   help=f"I3D checkpoint (default: ${I3D_WEIGHTS_ENV})")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    if args.weights:
        embed, kind = i3d_embed_fn(args.weights, device=args.device), "i3d"
    else:
        embed, kind = default_embed_fn(args.device)
    label = "FVD" if kind == "i3d" else "FVD-proxy(random-feat)"
    pattern = f"gt_seq_{args.it or '*'}.npy"
    for gt_path in sorted(glob.glob(os.path.join(args.metrics_dir, pattern))):
        gen_path = gt_path.replace("gt_seq_", "gen_images_")
        fvd = compute_fvd(gt_path, gen_path, embed_fn=embed)
        print(f"{os.path.basename(gt_path)}: {label} = {fvd:.3f}")


if __name__ == "__main__":
    main()
