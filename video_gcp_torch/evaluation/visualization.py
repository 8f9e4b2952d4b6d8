"""Tree and sequence plots for logging (evaluation/visualization.py of the
JAX package; the reference's HierarchyLogger family,
gcp/prediction/utils/visualization.py:232-501 and utils/logger.py:103-345):
balanced-tree image pyramids, GT-match overviews, pruned-sequence strips and
plain strips. Numpy only; every function returns a float image in [-1, 1]
(HWC) for training.logger.Logger.log_images."""
from __future__ import annotations

import math

import numpy as np


def _to01(x):
    return np.clip((np.asarray(x) + 1.0) / 2.0, 0.0, 1.0)


def plot_balanced_tree(images_bf: np.ndarray, i_ex: int = 0) -> np.ndarray:
    """Example `i_ex`'s tree [B, N, H, W, C] (breadth-first) as an image
    pyramid: level d in row d, each node centred over its subtree
    (visualization.plot_balanced_tree:232); white where no node is."""
    imgs = _to01(images_bf[i_ex])
    n, h, w, c = imgs.shape
    depth = int(math.log2(n + 1))
    n_leaves = 2 ** (depth - 1)
    canvas = np.ones((depth * h, n_leaves * w, c), dtype=np.float32)
    idx = 0
    for d in range(depth):
        n_nodes = 2 ** d
        stride = n_leaves // n_nodes
        for k in range(n_nodes):
            cx = (k * stride + stride // 2) * w - (w // 2 if stride > 1 else 0)
            cx = max(min(cx, (n_leaves - 1) * w), 0)
            canvas[d * h:(d + 1) * h, cx:cx + w] = imgs[idx]
            idx += 1
    return canvas * 2.0 - 1.0


def plot_gt_matching_overview(images_bf: np.ndarray, match_dists: np.ndarray,
                              traj_seq: np.ndarray, i_ex: int = 0) -> np.ndarray:
    """The GT frames [B, T, H, W, C] in a strip on top and, below each, the
    frame of the node that matches it most (argmax over the nodes of
    `match_dists` [B, N, T]; logger.log_gt_match_overview)."""
    gt = _to01(traj_seq[i_ex])
    imgs = _to01(images_bf[i_ex])
    matched = imgs[np.argmax(np.asarray(match_dists[i_ex]), axis=0)]
    t, h, w, c = gt.shape
    top = gt.transpose(1, 0, 2, 3).reshape(h, t * w, c)
    bottom = matched.transpose(1, 0, 2, 3).reshape(h, t * w, c)
    return np.concatenate([top, bottom], axis=0) * 2.0 - 1.0


def plot_pruned_seq(images_df: np.ndarray, keep_mask: np.ndarray,
                    i_ex: int = 0) -> np.ndarray:
    """The depth-first nodes [B, N, H, W, C] in one strip, the pruned ones
    (keep_mask [B, N] false) greyed out (logger.log_pruned_pred)."""
    shown = _to01(images_df[i_ex]).copy()
    drop = ~np.asarray(keep_mask[i_ex]).astype(bool)
    shown[drop] = shown[drop] * 0.2 + 0.4
    n, h, w, c = shown.shape
    return shown.transpose(1, 0, 2, 3).reshape(h, n * w, c) * 2.0 - 1.0


def seq_strip(images: np.ndarray, i_ex: int = 0, max_frames: int = 20) -> np.ndarray:
    """Example `i_ex` of [B, T, H, W, C] as one horizontal strip of at most
    `max_frames` frames, evenly subsampled."""
    imgs = _to01(images[i_ex])
    step = max(imgs.shape[0] // max_frames, 1)
    imgs = imgs[::step][:max_frames]
    n, h, w, c = imgs.shape
    return imgs.transpose(1, 0, 2, 3).reshape(h, n * w, c) * 2.0 - 1.0
