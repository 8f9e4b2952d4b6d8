"""Dense [B, T, ...] predictions on the GT timeline from a model's output
(evaluation/eval_binding.py of the JAX package), batched on the device.
For a tree:

- 'basic': the balanced schedule's matched node per frame; frames no node
  matched repeat the previous one (BalancedEvalBinding,
  evaluation_matching.py:174-206).
- 'dtw': the DTW warp of all df-ordered nodes (DTWEvalBinding:123-149).
- 'pruned_dtw': the nodes the existence predictor keeps, compacted to the
  front (the tail repeats the last kept node), then the DTW warp
  (BalancedPrunedDTWBinding:209-219).

'greedy_exist' and 'greedy_l2' are not ported (ROADMAP item 7.4): the
reference's own dispatch does not reach them (tree_dense_rec.py:30-39).
For the sequential model, 'basic' is the rollout as it is and 'dtw' warps
its frames 1..end onto the GT timeline (sequential_dense_sample).
"""
from __future__ import annotations

import math

import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.binding import balanced_match_dists
from video_gcp_torch.ops.dtw import dtw_warp_sequence
from video_gcp_torch.ops.tree_index import breadthfirst2depthfirst


def basic_timeline_index(depth: int, end_ind: torch.Tensor,
                         max_seq_len: int) -> torch.Tensor:
    """Per-frame bf node index [B, T] under the balanced schedule; frames no
    node matched take the last matched frame's node
    (evaluation_matching.py:174-206 as a dense frame->node map)."""
    w = balanced_match_dists(depth, end_ind, max_seq_len)  # [B, N, T]
    has_match = w.sum(1) > 0
    idx = torch.argmax(w, dim=1)
    t_idx = torch.arange(max_seq_len, device=end_ind.device).expand_as(idx)
    last = torch.where(has_match, t_idx, torch.full_like(t_idx, -1))
    last = torch.cummax(last, dim=1).values
    return torch.gather(idx, 1, torch.clamp(last, 0, max_seq_len - 1))


def _gather_nodes(images: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """images [B, N, ...], idx [B, T] -> [B, T, ...]."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return images[rows, idx]


def _compact_selected_df(values_df: torch.Tensor, keep_df: torch.Tensor) -> torch.Tensor:
    """The kept df nodes moved to the front in order; the tail repeats the
    last kept node (the reference's repeat-last-frame padding,
    BaseEvalBinding:37-45)."""
    n = values_df.shape[1]
    order = torch.argsort((~keep_df).to(torch.uint8), dim=1, stable=True)
    n_keep = keep_df.sum(1)
    pos = torch.arange(n, device=keep_df.device)[None, :]
    last = torch.clamp(n_keep - 1, 0, n - 1)[:, None]
    return _gather_nodes(_gather_nodes(values_df, order),
                         torch.where(pos < n_keep[:, None], pos, last))


def tree_dense_sample(outputs: AttrDict, inputs: AttrDict, scheme: str,
                      max_seq_len: int) -> torch.Tensor:
    """GT-timeline-aligned dense prediction [B, T, ...] from a tree output.
    'dtw' and 'pruned_dtw' warp onto inputs.traj_seq."""
    images_bf = outputs.tree.images
    end_ind = outputs.get("end_ind", inputs.get("end_ind"))
    if scheme == "basic":
        depth = int(math.log2(images_bf.shape[1] + 1))
        return _gather_nodes(images_bf, basic_timeline_index(depth, end_ind, max_seq_len))
    if scheme == "dtw":
        return dtw_warp_sequence(breadthfirst2depthfirst(images_bf), inputs.traj_seq,
                                 end_ind)[0]
    if scheme == "pruned_dtw":
        kept = _compact_selected_df(breadthfirst2depthfirst(images_bf), outputs.prune_keep)
        return dtw_warp_sequence(kept, inputs.traj_seq, end_ind)[0]
    if scheme in ("greedy_exist", "greedy_l2"):
        raise NotImplementedError(
            f"pruning scheme {scheme!r} is not ported (ROADMAP item 7.4); the "
            "reference's dispatch reaches only 'basic', 'dtw' and 'pruned_dtw'")
    raise ValueError(f"unknown pruning scheme {scheme!r}")


def sequential_dense_sample(outputs: AttrDict, inputs: AttrDict, scheme: str,
                            max_seq_len: int) -> torch.Tensor:
    """The VRNN's dense sample (SequentialRecModule.get_sample_with_len,
    sequential.py:70-94): 'basic' returns the rollout; 'dtw' warps frames
    1..end onto the GT timeline (frame 0 is the GT conditioning frame)."""
    images = outputs.dense_rec.images  # [B, T, ...]
    if scheme == "basic":
        return images
    if scheme == "dtw":
        end_ind = outputs.get("end_ind", inputs.get("end_ind"))
        warped = dtw_warp_sequence(images[:, 1:], inputs.traj_seq[:, 1:], end_ind - 1)[0]
        return torch.cat([images[:, :1], warped], dim=1)
    raise ValueError(f"unknown pruning scheme {scheme!r} for the sequential model")


def dense_sample(outputs: AttrDict, inputs: AttrDict, scheme: str,
                 max_seq_len: int) -> torch.Tensor:
    if "tree" in outputs:
        return tree_dense_sample(outputs, inputs, scheme, max_seq_len)
    return sequential_dense_sample(outputs, inputs, scheme, max_seq_len)
