"""Scalar, graph, image and video logging as JSON lines (training/logger.py
of the JAX package, without TensorBoard).

Each record is one line of `{log_dir}/events.jsonl`:
`{"step": N, "tag": "<phase>_<name>", "value": x}` for a scalar,
`"values": [...]` for a graph (a 1-D array such as the layerwise losses,
tree_module.py:159-169), and `"file": "images/<name>"` for an image (PNG)
or a video (animated GIF) written beside it.
"""
from __future__ import annotations

import io
import json
import math
import os
import re

import numpy as np


def _to_uint8(images: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> uint8 [0, 255]."""
    return (np.clip((np.asarray(images) + 1.0) / 2.0, 0, 1) * 255).astype(np.uint8)


def _encode_png(img_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, format="PNG")
    return buf.getvalue()


def _encode_gif(frames_u8: np.ndarray, fps: int) -> bytes:
    from PIL import Image

    ims = [Image.fromarray(f) for f in frames_u8]
    buf = io.BytesIO()
    ims[0].save(buf, format="GIF", save_all=True, append_images=ims[1:],
                duration=max(int(1000 / max(fps, 1)), 20), loop=0)
    return buf.getvalue()


class Logger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "events.jsonl")
        self._file = open(self.path, "a")

    def _write(self, record: dict) -> None:
        self._file.write(json.dumps(record) + "\n")

    @staticmethod
    def _tag(name, phase):
        return f"{phase}_{name}"

    def log_scalar(self, value, name, step, phase=""):
        value = float(value)
        self._write(dict(step=int(step), tag=self._tag(name, phase),
                         value=value if math.isfinite(value) else repr(value)))

    def log_scalar_dict(self, d, step, phase=""):
        for k, v in d.items():
            self.log_scalar(v, k, step, phase)

    def log_graph(self, values, name, step, phase=""):
        values = [float(v) for v in np.asarray(values).ravel()]
        self._write(dict(step=int(step), tag=self._tag(name, phase),
                         values=[v if math.isfinite(v) else repr(v) for v in values]))

    def _write_file(self, data: bytes, name, step, phase, ext) -> None:
        tag = self._tag(name, phase)
        rel = os.path.join("images", f"{re.sub(r'[^A-Za-z0-9_.-]', '_', tag)}_{int(step)}.{ext}")
        os.makedirs(os.path.join(self.log_dir, "images"), exist_ok=True)
        with open(os.path.join(self.log_dir, rel), "wb") as f:
            f.write(data)
        self._write(dict(step=int(step), tag=tag, file=rel))

    def log_images(self, images, name, step, phase=""):
        """[N, H, W, C] float in [-1, 1] -> one PNG, the images side by side."""
        images = _to_uint8(images)
        n, h, w, c = images.shape
        grid = images.transpose(1, 0, 2, 3).reshape(h, n * w, c)
        self._write_file(_encode_png(grid), name, step, phase, "png")

    def log_video(self, frames, name, step, phase="", fps=4):
        """[T, H, W, C] float in [-1, 1] -> an animated GIF."""
        self._write_file(_encode_gif(_to_uint8(frames), fps), name, step, phase, "gif")

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.close()

