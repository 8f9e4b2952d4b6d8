"""The reference's top-of-N evaluation of some examples of a batch: the
protocol of the program's Evaluator written again over the frozen model,
the frozen eval binding and the plain metrics.

Each of the N samples is one prior forward of the whole batch (so that the
generator's draws are those of the program's call); the examples checked
are then matched to their ground truth under the pruning scheme, cropped
to frames 1..end - 1 and the padding masked, and scored by MSE, PSNR and
SSIM per sequence. The DTW's matches (the node each frame takes) are kept
beside the scores.
"""
from __future__ import annotations

import torch

from . import dtw as ref_dtw
from .attrdict import AttrDict
from .eval_binding import tree_dense_sample
from .metrics import mse, psnr, ssim, to_float_images

PRIOR_INPUTS = ("I_0", "I_g", "end_ind", "start_ind", "z", "actions")
METRICS = (("mse", mse), ("psnr", psnr), ("ssim", ssim))


def _score(images, keep, traj, end_ind, pad_mask, scheme: str, max_seq_len: int,
           alter=None):
    """Scores {metric: [rows]} and the DTW's matches [rows, T] (None
    without a DTW); `alter` changes the matches where they are produced."""
    outputs = AttrDict(tree=AttrDict(images=images), prune_keep=keep, end_ind=end_ind)
    inputs = AttrDict(traj_seq=traj, end_ind=end_ind)
    plain, found = ref_dtw.batched_dtw_alignment, []

    def align(C, end_inds):
        inds, dist = plain(C, end_inds)
        inds = alter(inds) if alter is not None else inds
        found.append(inds)
        return inds, dist

    ref_dtw.batched_dtw_alignment = align
    try:
        gen = tree_dense_sample(outputs, inputs, scheme, max_seq_len)
    finally:
        ref_dtw.batched_dtw_alignment = plain
    t_idx = torch.arange(traj.shape[1], device=traj.device)[None, :]
    valid = (t_idx >= 1) & (t_idx <= end_ind[:, None] - 1) & (pad_mask > 0)
    denom = torch.clamp(valid.sum(1), min=1)
    scores = {name: (fn(gen, traj) * valid).sum(1) / denom for name, fn in METRICS}
    return scores, (found[0] if found else None)


@torch.no_grad()
def sample_metrics(model, batch: dict, generator: torch.Generator, samples: int,
                   examples: list, scheme: str, max_seq_len: int,
                   chunk: int = 8, alter=None) -> dict:
    """{metric: [len(examples), samples]} of the checked examples, and
    `match` [len(examples), samples, T], each frame's node (absent without
    a DTW)."""
    prior = AttrDict({k: batch[k] for k in PRIOR_INPUTS if k in batch})
    ex = torch.tensor(examples, device=batch["end_ind"].device)
    traj = to_float_images(batch["traj_seq"][ex])
    end_ind, pad_mask = batch["end_ind"][ex], batch["pad_mask"][ex]
    out = {name: [] for name, _ in METRICS}
    matches = []
    images, keep = [], []
    for k in range(samples):
        o = model(prior, phase="test", mode="prior", generator=generator)
        images.append(o.tree.images[ex])
        keep.append(o.prune_keep[ex])
        if len(images) == chunk or k == samples - 1:
            n = len(images)
            scores, match = _score(torch.cat(images), torch.cat(keep),
                                   traj.repeat(n, 1, 1, 1, 1), end_ind.repeat(n),
                                   pad_mask.repeat(n, 1), scheme, max_seq_len, alter)
            for name, v in scores.items():
                out[name].append(v.reshape(n, len(examples)))
            if match is not None:
                matches.append(match.reshape(n, len(examples), -1).cpu())
            images, keep = [], []
    res = {name: torch.cat(v).T.double().cpu().numpy() for name, v in out.items()}
    if matches:
        res["match"] = torch.cat(matches).transpose(0, 1).numpy()
    return res
