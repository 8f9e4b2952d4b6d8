"""Checkpoints and weights (training/checkpoint.py of the JAX package):
epoch-named training checkpoints with 'latest' resolution, the flat
pretrained npz reader, and the flax -> torch bridge.

Training checkpoints live in `{exp_path}/weights/weights_ep{N}/` as one torch
state file (model, optimizer, step) in place of orbax's directory
(checkpoint_handler.py:14-184 of the reference). The file holds the whole,
unwrapped model's state dict and the optimizer's in torch's own layout,
whatever run wrote it: a dp x fsdp run gathers its shards
(torch.distributed.checkpoint.state_dict) and rank 0 writes them, so a
checkpoint of a sharded run loads strictly into a single process, and one
of a single process into a sharded run.

The bridge maps a flax parameter tree onto the port's `state_dict` by one
naming rule (see models/nets.py): the flax auto-name `Name_k` becomes the
torch path `name.k` (snake case), other names pass through. Leaves change
layout by the kind of their flax module:

- Dense `kernel [in, out]` -> Linear `weight [out, in]`.
- Conv `kernel [kh, kw, in, out]` -> Conv2d `weight [out, in, kh, kw]`;
  1-D `[k, in, out]` -> Conv1d `[out, in, k]`. 'SAME' with k=4, s=2 on even
  sizes, and with k=3, s=1, is `padding=1`. A kernel of rank 3 or more is
  a conv's whatever the module's name: flax's ConvLSTMCell names its convs
  `ih`/`hh`, the conv tree fusion `proj_i`.
- ConvTranspose `kernel [kh, kw, in, out]` (transpose_kernel=False, k=4, s=2,
  'SAME') -> ConvTranspose2d `weight [in, out, kh, kw]` with the kernel
  flipped in H and W, `padding=1`. Flax applies the kernel unflipped to the
  stride-dilated input; torch's transposed conv is the adjoint of a conv and
  flips it.
- GroupNorm `scale` -> `weight`.
- Scalar parameters (the attention's `log_attn_temp`, the adaptive
  binding's `log_temp`) pass through as 0-d tensors.
- OptimizedLSTMCell: input kernels `ii/if/ig/io` (no bias) and hidden kernels
  `hi/hf/hg/ho` (with bias) -> LSTMCell `weight_ih`, `weight_hh`, `bias_hh`
  packed in torch's i, f, g, o order, and `bias_ih` = 0.
"""
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


STATE_FILE = "state.pt"


def weights_dir(exp_path) -> str:
    return os.path.join(exp_path, "weights")


def ckpt_name(epoch: int) -> str:
    return f"weights_ep{epoch}"


def get_epochs(exp_path):
    wd = weights_dir(exp_path)
    if not os.path.isdir(wd):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"weights_ep(\d+)", d) for d in os.listdir(wd)) if m)


def resolve_resume(resume, exp_path) -> Optional[str]:
    """'latest' | epoch number | checkpoint directory | pretrained .npz ->
    a path, or None when there is nothing to resume from."""
    if resume is None or resume == "none":
        return None
    if isinstance(resume, str) and os.path.isdir(resume):
        return resume
    if isinstance(resume, str) and resume.endswith(".npz") and os.path.isfile(resume):
        return resume
    eps = get_epochs(exp_path)
    if not eps:
        return None
    if resume == "latest":
        epoch = eps[-1]
    else:
        epoch = int(resume)
        if epoch not in eps:
            raise ValueError(f"No checkpoint for epoch {epoch} in {exp_path}")
    return os.path.join(weights_dir(exp_path), ckpt_name(epoch))


def is_sharded(model) -> bool:
    """Whether `model` was split by FSDP (parallel.train_step.shard_model)."""
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def _full_options():
    """Whole tensors on every rank (with cpu_offload only rank 0 gets any)."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions
    return StateDictOptions(full_state_dict=True)


def _to_cpu(x):
    if torch.is_tensor(x):  # a copy: on the CPU, whole parameters would alias
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_cpu(v) for v in x]
    return x


def _param_names(model, optimizer):
    """The optimizer's parameters by name, in its own order."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]


def model_state(model) -> Dict[str, torch.Tensor]:
    """The whole model's state dict; a collective call on a sharded model."""
    if not is_sharded(model):
        return model.state_dict()
    from torch.distributed.checkpoint.state_dict import get_model_state_dict
    return _to_cpu(get_model_state_dict(model, options=_full_options()))


def optimizer_state(model, optimizer) -> dict:
    """`optimizer.state_dict()` of an unsharded run: states keyed by the
    index of their parameter. On a sharded model (a collective call) the
    gathered states, mapped back to those indices."""
    if not is_sharded(model):
        return optimizer.state_dict()
    from torch.distributed.checkpoint.state_dict import get_optimizer_state_dict
    full = _to_cpu(get_optimizer_state_dict(model, optimizer, options=_full_options()))
    names = _param_names(model, optimizer)
    index = {n: i for i, n in enumerate(names)}
    return dict(state={index[n]: v for n, v in full["state"].items()},
                param_groups=[dict(g, params=[index[n] for n in g["params"]])
                              for g in full["param_groups"]])


def load_optimizer_state(model, optimizer, state: dict) -> None:
    """`optimizer_state`'s layout into `optimizer`, sharded or not."""
    if not is_sharded(model):
        optimizer.load_state_dict(state)
        return
    from torch.distributed.checkpoint.state_dict import set_optimizer_state_dict
    names = _param_names(model, optimizer)
    full = dict(state={names[i]: v for i, v in state["state"].items()},
                param_groups=[dict(g, params=[names[i] for i in g["params"]])
                              for g in state["param_groups"]])
    set_optimizer_state_dict(model, optimizer, full, options=_full_options())


def load_model_weights(model, state: Dict[str, torch.Tensor]) -> None:
    """A whole state dict into `model`, strictly, sharded or not."""
    if not is_sharded(model):
        model.load_state_dict(state, strict=True)
        return
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
    )
    set_model_state_dict(model, state, options=StateDictOptions(
        full_state_dict=True, strict=True))


def save_checkpoint(exp_path, epoch: int, model, optimizer, step: int,
                    write: bool = True) -> str:
    """{model, optimizer, step} under weights/weights_ep{epoch}/; written to a
    temporary name first, so a reader never sees half a file. Every rank of
    a sharded run calls it (the gather is collective); only the one with
    `write` writes."""
    path = os.path.join(weights_dir(exp_path), ckpt_name(epoch))
    if not (write or is_sharded(model)):
        return path
    state = dict(model=model_state(model), optimizer=optimizer_state(model, optimizer),
                 step=int(step))
    if write:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def load_checkpoint(path, model, optimizer=None) -> int:
    """Restore a checkpoint directory into `model` (strictly) and, if given,
    `optimizer`, sharded or not; returns the step."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    load_model_weights(model, state["model"])
    if optimizer is not None:
        load_optimizer_state(model, optimizer, state["optimizer"])
    return state["step"]


def load_model_state(path) -> Dict[str, torch.Tensor]:
    """The model's state_dict from a checkpoint directory (`state.pt`) or a
    pretrained npz of the JAX package (through `flax_to_torch`)."""
    if str(path).endswith(".npz"):
        return flax_to_torch(load_pretrained_npz(path))
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    return state["model"]
