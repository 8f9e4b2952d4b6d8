"""The JAX package's pretrained npz as a state_dict of the model, and the
checkpoint lookups the learned cost uses: a copy of the program's mapping
(training/checkpoint.py), so that the reference derives the weights itself.
Only npz files are read here."""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

_INDEXED = re.compile(r"^(.*)_(\d+)$")
_CAMEL = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")
_LSTM_CELL = "OptimizedLSTMCell"
_GATES = "ifgo"


def load_pretrained_npz(path) -> dict:
    """Rebuild the parameter tree from a flat `np.savez` checkpoint
    (numpy copy of video_gcp_tpu/training/checkpoint.py:load_pretrained_npz).

    Keys are '/'-joined paths 'params/params/<module>/.../kernel' plus a
    scalar 'step'; float16 leaves come back as float32. Returns the top-level
    'params' entry, i.e. `{'params': {<module>: ...}}`."""
    z = np.load(path)
    tree: dict = {}
    for key in z.files:
        if key == "step":
            continue
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        leaf = z[key]
        node[parts[-1]] = leaf.astype(np.float32) if leaf.dtype == np.float16 else leaf
    if "params" not in tree:
        raise ValueError(f"{path}: no 'params/...' keys; not a pretrained npz")
    return tree["params"]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.array(v, dtype=np.float32)


def _torch_path(parts) -> str:
    out = []
    for p in parts:
        m = _INDEXED.match(p)
        out += [_CAMEL.sub("_", m.group(1)).lower(), m.group(2)] if m else [p]
    return ".".join(out)


def _kind(part: str) -> str:
    m = _INDEXED.match(part)
    return m.group(1) if m else part


def _leaf(kind: str, name: str, a: np.ndarray):
    if name == "scale":  # GroupNorm
        return "weight", a
    if name != "kernel":
        return name, a
    if kind == "ConvTranspose":
        return "weight", a[::-1, ::-1].transpose(2, 3, 0, 1)
    if a.ndim > 2:
        # a conv by its rank, whatever its name (Conv_k, and the explicitly
        # named ConvLSTMCell ih/hh and tree fusion proj_i):
        # [*spatial, in, out] -> [out, in, *spatial]
        return "weight", a.transpose((a.ndim - 1, a.ndim - 2) + tuple(range(a.ndim - 2)))
    return "weight", a.T  # Dense / proj


def flax_to_torch(params_tree) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (with or without the outer 'params' collection)
    -> a state_dict for the port's model, to load with strict=True."""
    if set(params_tree) == {"params"}:
        params_tree = params_tree["params"]
    out: Dict[str, np.ndarray] = {}
    cells: Dict[tuple, dict] = {}
    for path, a in _flatten(params_tree):
        kinds = [_kind(p) for p in path]
        if _LSTM_CELL in kinds:
            i = kinds.index(_LSTM_CELL)
            cells.setdefault(path[:i + 1], {})[path[i + 1:]] = a
            continue
        name, value = _leaf(kinds[-2] if len(path) > 1 else "", path[-1], a)
        out[_torch_path(path[:-1] + (name,))] = value
    for cell_path, p in cells.items():
        base = _torch_path(cell_path)
        out[f"{base}.weight_ih"] = np.concatenate(
            [p[("i" + g, "kernel")].T for g in _GATES])
        out[f"{base}.weight_hh"] = np.concatenate(
            [p[("h" + g, "kernel")].T for g in _GATES])
        out[f"{base}.bias_hh"] = np.concatenate([p[("h" + g, "bias")] for g in _GATES])
        out[f"{base}.bias_ih"] = np.zeros_like(out[f"{base}.bias_hh"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def resolve_resume(resume, exp_path) -> Optional[str]:
    """An npz path, as the planner's configuration names it."""
    if isinstance(resume, str) and resume.endswith(".npz") and os.path.isfile(resume):
        return resume
    raise ValueError(f"the reference reads pretrained npz files only, not {resume!r}")


def load_model_state(path) -> Dict[str, torch.Tensor]:
    return flax_to_torch(load_pretrained_npz(path))
