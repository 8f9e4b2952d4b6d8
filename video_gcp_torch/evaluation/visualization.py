"""Sequence strips for logging (evaluation/visualization.py of the JAX
package; only `seq_strip`, which the Evaluator uses, is ported). Returns
float images in [-1, 1] (HWC) for training.logger.Logger.log_images."""
from __future__ import annotations

import numpy as np


def _to01(x):
    return np.clip((np.asarray(x) + 1.0) / 2.0, 0.0, 1.0)


def seq_strip(images: np.ndarray, i_ex: int = 0, max_frames: int = 20) -> np.ndarray:
    """Example `i_ex` of [B, T, H, W, C] as one horizontal strip of at most
    `max_frames` frames, evenly subsampled."""
    imgs = _to01(images[i_ex])
    step = max(imgs.shape[0] // max_frames, 1)
    imgs = imgs[::step][:max_frames]
    n, h, w, c = imgs.shape
    return imgs.transpose(1, 0, 2, 3).reshape(h, n * w, c) * 2.0 - 1.0
