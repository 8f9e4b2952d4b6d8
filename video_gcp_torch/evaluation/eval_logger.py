"""Evaluation logging backends (evaluation/eval_logger.py of the JAX
package; gcp/evaluation/compute_metrics.py:283-393): files on disk, or the
trainer's Logger. Each backend exposes the calls the Evaluator makes: a
metric line, an image strip, a gif and an array."""
from __future__ import annotations

import os

import numpy as np

from video_gcp_torch.training.logger import _encode_png, _to_uint8


class EvalLogger:
    """Backend interface for the Evaluator's results."""

    def log_metric(self, name, vals, best_vals, it):
        """`best_vals` [B] the best of N per sequence; `vals` [B, N] every
        sample (None when top_of_100 is off)."""
        raise NotImplementedError

    def log_image(self, img, tag, i, it):
        """One [H, W, C] float image in [-1, 1]."""
        raise NotImplementedError

    def log_gif(self, frames, tag, i, it):
        """One [T, H, W, C] float sequence in [-1, 1]."""

    def log_array(self, array, tag, it):
        """Raw array dump (on disk under both backends)."""

    @staticmethod
    def metric_line(name, vals, best_vals):
        line = (f"mean {name} {best_vals.mean()}, standard error of the "
                f"mean (SEM) {best_vals.std()}")
        if vals is not None:
            line += f", mean std of {vals.shape[1]} samples {vals.std(axis=1).mean()}"
        return line


class FileEvalLogger(EvalLogger):
    """Metric lines, PNG strips and npy arrays under `log_dir`
    (compute_metrics.py:327-355)."""

    def __init__(self, log_dir):
        self._log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)

    def _dump_dir(self, tag, it):
        d = os.path.join(self._log_dir, tag, f"it_{it}")
        os.makedirs(d, exist_ok=True)
        return d

    def log_metric(self, name, vals, best_vals, it):
        line = self.metric_line(name, vals, best_vals)
        with open(os.path.join(self._log_dir, f"metrics_{it}.txt"), "a") as f:
            f.write(line + "\n")
        print(line)

    def log_image(self, img, tag, i, it):
        path = os.path.join(self._dump_dir(tag, it), f"{tag}_{i}.png")
        with open(path, "wb") as f:
            f.write(_encode_png(_to_uint8(np.asarray(img))))

    def log_array(self, array, tag, it):
        np.save(os.path.join(self._dump_dir(tag, it), f"{tag}.npy"), array)


class TBEvalLogger(EvalLogger):
    """Forwards the results to a training Logger as `eval/<tag>` records
    (compute_metrics.py:360-393; the port's Logger writes JSON lines, not
    TensorBoard events); arrays still go to disk."""

    def __init__(self, log_dir, tb_logger):
        self._file = FileEvalLogger(log_dir)
        self._tb = tb_logger

    def log_metric(self, name, vals, best_vals, it):
        n = best_vals.shape[0] if vals is None else vals.shape[1]
        self._tb.log_scalar(best_vals.mean(), f"eval/metric/{name}/top{n}_mean", it)
        self._tb.log_scalar(best_vals.std(), f"eval/verbose/{name}/top{n}_std", it)
        if vals is not None:
            self._tb.log_scalar(vals.mean(), f"eval/verbose/{name}/all{n}_mean", it)
            self._tb.log_scalar(vals.std(axis=1).mean(),
                                f"eval/verbose/{name}/all{n}_std", it)
        print(self.metric_line(name, vals, best_vals))

    def log_image(self, img, tag, i, it):
        self._tb.log_images(np.asarray(img)[None], f"eval/{tag}/{i}", it)

    def log_gif(self, frames, tag, i, it):
        self._tb.log_video(np.asarray(frames), f"eval/{tag}/{i}", it)

    def log_array(self, array, tag, it):
        self._file.log_array(array, tag, it)
