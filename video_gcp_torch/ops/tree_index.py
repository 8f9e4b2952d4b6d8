"""Static index math for the binary subgoal tree (ops/tree_index.py of the
JAX package).

The tree is a dense breadth-first tensor ``[B, 2^L - 1, ...]``.
- breadth-first (bf): level order; node k of level d sits at 2^d - 1 + k.
- depth-first (df): in-order traversal, i.e. the temporal order of frames.

The permutations and the balanced schedule's fractions are constant tables,
as are the adaptive binding's top-bias mask and SSIM's window.
`device_table` makes each once per device and keeps it there, so that no
call copies one from the host: such a copy comes from pageable memory and
blocks the host until the device's queue has drained.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from video_gcp_torch import tracing


@functools.lru_cache(maxsize=None)
def df2bf_perm(depth: int) -> np.ndarray:
    """perm such that ``df_array = bf_array[..., perm, :]``: perm[i] is the
    bf index of the node at df position i (tree_utils.py:235-244)."""
    n = 2 ** depth - 1
    df_indices = np.arange(1, n + 1)
    bf_indices = np.zeros(n, dtype=np.int64)
    for i in range(depth):
        # layer i from the bottom: df position divisible by 2^i, not 2^(i+1)
        mask = (df_indices % (2 ** i) == 0) & (df_indices % (2 ** (i + 1)) > 0)
        bf_indices[mask] = df_indices[mask] // (2 ** (i + 1)) + (
            2 ** (depth - i - 1) - 1)
    return bf_indices


@functools.lru_cache(maxsize=None)
def bf2df_perm(depth: int) -> np.ndarray:
    """Inverse of df2bf_perm: ``bf_array = df_array[..., perm, :]``."""
    fwd = df2bf_perm(depth)
    inv = np.zeros_like(fwd)
    inv[fwd] = np.arange(len(fwd))
    return inv


_TABLES: dict = {}  # (build, *args, device) -> the table on that device


def device_table(build, device: torch.device, *args) -> torch.Tensor:
    """`build(*args)`, a numpy array or a host tensor, as a tensor of its
    dtype on `device`: made and copied there on the first call with these
    arguments and device (counted as `tree_index.table_uploads`), the same
    tensor on every later one (`tree_index.table_hits`). It is made outside
    inference mode, so that a training forward may save it for backward
    after an evaluation made it. Callers only read a table; none writes
    into it."""
    key = (build, *args, device)
    table = _TABLES.get(key)
    if table is not None:
        tracing.count("tree_index.table_hits")
        return table
    with torch.inference_mode(False):
        table = torch.as_tensor(build(*args), device=device)
    _TABLES[key] = table
    tracing.count("tree_index.table_uploads")
    return table


def _depth(x: torch.Tensor, dim: int) -> int:
    return int(np.log2(x.shape[dim] + 1))


def _take(x: torch.Tensor, perm, dim: int) -> torch.Tensor:
    return torch.index_select(x, dim, device_table(perm, x.device, _depth(x, dim)))


def depthfirst2breadthfirst(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return _take(x, bf2df_perm, dim)


def breadthfirst2depthfirst(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return _take(x, df2bf_perm, dim)


def depthfirst2layers(x: torch.Tensor, dim: int = 1):
    """Split a df node axis into per-level tensors, top level first; level d
    has 2^d nodes in left-to-right order (tree_utils.py:222-232)."""
    return split_by_layer_bf(depthfirst2breadthfirst(x, dim), dim)


def interleave(t1: torch.Tensor, t2: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """[a0, a1, ...], [b0, b1, ...] -> [a0, b0, a1, b1, ...]
    (tree_utils.py:202-208)."""
    shape = list(t1.shape)
    shape[dim] *= 2
    return torch.stack([t1, t2], dim=dim + 1).reshape(shape)


def _balanced_fractions(depth: int) -> np.ndarray:
    """float32 (2k + 1) / 2^(d+1) of node k of level d, bf order."""
    return np.concatenate([
        (2 * np.arange(2 ** d, dtype=np.float32) + 1) / 2 ** (d + 1)
        for d in range(depth)])


def balanced_timesteps(depth: int, end_ind: torch.Tensor) -> torch.Tensor:
    """Float matching timesteps of every bf node under balanced binding:
    node k of level d has t = -1 + (end_ind + 2) * (2k + 1) / 2^(d+1)
    (frame_binding.py:52-65). end_ind [B] -> [B, 2^depth - 1]."""
    alpha = device_table(_balanced_fractions, end_ind.device, depth)
    e = end_ind.to(torch.float32)[:, None]
    return -1.0 + (e + 2.0) * alpha[None, :]


def split_by_layer_bf(x: torch.Tensor, dim: int = 1, depth: int = None):
    """Split a bf node axis into per-level tensors (tree_utils.py:155-163)."""
    if depth is None:
        depth = _depth(x, dim)
    return list(torch.split(x, [2 ** d for d in range(depth)], dim=dim))


def per_level_means(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Mean of a bf node-axis tensor per tree level -> [depth] (layerwise
    loss logging, tree_module.py:159-169)."""
    dim = dim % x.dim()
    return torch.stack([p.mean() for p in split_by_layer_bf(x, dim)])
