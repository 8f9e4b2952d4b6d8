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
- 'greedy_exist': a priority expansion from the root by existence
  probability, emitted in depth-first order (GreedyExistEvalBinding:48-70);
  needs no ground-truth frames.
- 'greedy_l2': each node, root down, claims the least-L2 frame of its
  segment and its children split the rest; frames no node claimed take the
  previous claimed frame's node, or the next one before the first
  (GreedyL2EvalBinding:73-120, whose `tree.min_l2_match` exists nowhere in
  the reference: this is the JAX package's reading of its intent).

The reference's own dispatch reaches neither greedy scheme
(tree_dense_rec.py:30-39); the JAX package wires both, and so does the
port. For the sequential model, 'basic' is the rollout as it is and 'dtw' warps
its frames 1..end onto the GT timeline (sequential_dense_sample).
"""
from __future__ import annotations

import math

import torch

from .attrdict import AttrDict
from .binding import balanced_match_dists
from .cdist import batch_cdist
from .dtw import dtw_warp_sequence
from .tree_index import (
    breadthfirst2depthfirst,
    depthfirst2breadthfirst,
    interleave,
)


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


def greedy_exist_select(p_bf: torch.Tensor, end_ind: torch.Tensor,
                        max_seq_len: int) -> torch.Tensor:
    """The reference's priority queue (GreedyExistEvalBinding,
    evaluation_matching.py:48-70) batched: a [B, N] frontier over the
    breadth-first tree, one masked argmax a pop (ties and an empty frontier
    take the first index, as jnp.argmax), the popped node's children pushed;
    end_ind + 1 pops per example. Returns the [B, N] bool selection, bf."""
    b, n = p_bf.shape
    dev = p_bf.device
    parent = torch.div(torch.arange(n, device=dev) - 1, 2, rounding_mode="floor")
    not_root = (torch.arange(n, device=dev) >= 1)[None, :]
    length = end_ind + 1
    frontier = torch.zeros((b, n), dtype=torch.bool, device=dev)
    frontier[:, 0] = True
    selected = torch.zeros_like(frontier)
    neg_inf = torch.full_like(p_bf, -math.inf)
    for t in range(min(max_seq_len, n)):
        pick = torch.argmax(torch.where(frontier, p_bf, neg_inf), dim=1)
        onehot = (torch.nn.functional.one_hot(pick, n).bool()
                  & (t < length)[:, None] & frontier.any(1)[:, None])
        selected |= onehot
        frontier = (frontier & ~onehot) | (onehot[:, parent] & not_root)
    return selected


def greedy_l2_match(cost: torch.Tensor, end_ind: torch.Tensor, depth: int):
    """Root down, level by level (JAX eval_binding.py:109-148): each node
    claims the least-cost frame of its segment [lo, hi] (the root's is
    [0, end_ind]); its children get [lo, m - 1] and [m + 1, hi], and an
    empty segment stays empty below. cost [B, N, T] in bf node order;
    returns (match_t [B, N] int64, valid [B, N] bool), bf."""
    b, n, t = cost.shape
    dev = cost.device
    t_idx = torch.arange(t, device=dev)[None, None, :]
    lo = torch.zeros((b, n), dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    hi[:, 0] = end_ind
    match_t = torch.zeros_like(lo)
    valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
    inf = torch.full_like(cost[:, :1], math.inf)
    for level in range(depth):
        sl = slice(2 ** level - 1, 2 ** (level + 1) - 1)
        lo_l, hi_l = lo[:, sl], hi[:, sl]
        ok = lo_l <= hi_l
        seg = (t_idx >= lo_l[:, :, None]) & (t_idx <= hi_l[:, :, None])
        m = torch.argmin(torch.where(seg, cost[:, sl], inf), dim=2)
        match_t[:, sl] = m
        valid[:, sl] = ok
        if level + 1 < depth:
            csl = slice(2 ** (level + 1) - 1, 2 ** (level + 2) - 1)
            one, zero = torch.ones_like(m), torch.zeros_like(m)
            lo[:, csl] = interleave(torch.where(ok, lo_l, one), torch.where(ok, m + 1, one))
            hi[:, csl] = interleave(torch.where(ok, m - 1, zero), torch.where(ok, hi_l, zero))
    return match_t, valid


def _greedy_l2_timeline(images_bf: torch.Tensor, traj_seq: torch.Tensor,
                        end_ind: torch.Tensor) -> torch.Tensor:
    """The bf node of each frame under greedy_l2_match, [B, T]; frames no
    node claimed take the previous claimed frame's node (the next one's
    before the first claim)."""
    depth = int(math.log2(images_bf.shape[1] + 1))
    cost = batch_cdist(images_bf, traj_seq)  # [B, N, T]
    match_t, valid = greedy_l2_match(cost, end_ind, depth)
    b, n, t = cost.shape
    dev = cost.device
    # valid nodes claim disjoint frames (their segments nest); the invalid
    # ones write into a slot past the end, which is dropped
    frame_node = torch.full((b, t + 1), -1, dtype=torch.int64, device=dev)
    frame_node[torch.arange(b, device=dev)[:, None],
               torch.where(valid, match_t, torch.full_like(match_t, t))] = \
        torch.arange(n, device=dev).expand(b, n)
    frame_node = frame_node[:, :t]
    has = frame_node >= 0
    t_idx = torch.arange(t, device=dev).expand(b, t)
    prev_t = torch.cummax(torch.where(has, t_idx, torch.full_like(t_idx, -1)), 1).values
    next_t = torch.flip(torch.cummin(torch.flip(
        torch.where(has, t_idx, torch.full_like(t_idx, t)), [1]), 1).values, [1])
    src = torch.where(prev_t >= 0, prev_t, torch.clamp(next_t, 0, t - 1))
    return torch.clamp(torch.gather(frame_node, 1, torch.clamp(src, 0, t - 1)), 0, n - 1)


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
    if scheme == "greedy_exist":
        if "existence_logits" not in outputs:
            raise ValueError("greedy_exist needs the balanced existence predictor "
                             "(outputs.existence_logits); adaptive models expose "
                             "distance_logits instead")
        p_bf = depthfirst2breadthfirst(torch.sigmoid(outputs.existence_logits))
        selected_df = breadthfirst2depthfirst(greedy_exist_select(p_bf, end_ind, max_seq_len))
        seq = _compact_selected_df(breadthfirst2depthfirst(images_bf), selected_df)
        # on the GT timeline's length, the tail repeating the last kept node
        pos = torch.clamp(torch.arange(max_seq_len, device=seq.device), 0, seq.shape[1] - 1)
        return seq[:, pos]
    if scheme == "greedy_l2":
        return _gather_nodes(images_bf, _greedy_l2_timeline(images_bf, inputs.traj_seq,
                                                            end_ind))
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
