"""Scalar and graph logging as JSON lines (training/logger.py of the JAX
package, without TensorBoard).

Each record is one line of `{log_dir}/events.jsonl`:
`{"step": N, "tag": "<phase>_<name>", "value": x}` for a scalar, and
`"values": [...]` for a graph (a 1-D array such as the layerwise losses,
tree_module.py:159-169). Images and videos come with the evaluation slice.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np


class Logger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
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

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.close()

