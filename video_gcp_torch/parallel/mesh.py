"""Process group, device mesh and sharding rules (parallel/mesh.py of the
JAX package, on torch.distributed).

The JAX package runs one SPMD program over a `jax.sharding.Mesh` and lets
XLA insert the collectives. Here every device is a process, launched by
torchrun:

    torchrun --standalone --nproc_per_node=4 -m video_gcp_torch.training.train ...
    torchrun --nnodes=2 --node_rank=<i> --rdzv_endpoint=<host>:<port> \
        --nproc_per_node=8 -m video_gcp_torch.training.train ...

`init_distributed` joins the process group that torchrun's environment
describes (the multi-node flags replace the JAX package's GCP_MULTIHOST=1
and `jax.distributed.initialize()`), `make_mesh` lays the ranks out as a
`DeviceMesh` with the JAX defaults, `batch_rows` is the row block that
`P('data')` gives a shard, and `param_shardings` is the JAX package's FSDP
rule, which dimension of which parameter the 'model' axis splits.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class DistInfo(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    device: torch.device


def init_distributed(device: str = "cuda", backend: Optional[str] = None) -> DistInfo:
    """Join the process group of a torchrun launch.

    Reads RANK, WORLD_SIZE and LOCAL_RANK (and, through the `env://` init
    method, MASTER_ADDR and MASTER_PORT). On the card each
    process takes `cuda:LOCAL_RANK` (modulo the visible cards) and the group
    runs NCCL; with device='cpu' it runs gloo. `backend` overrides that
    choice: gloo also reduces CUDA tensors, and unlike NCCL it lets two
    ranks share one card. Without torchrun's environment there is no group:
    rank 0 of 1, on `device`. A group that is already up is joined as it
    is."""
    dev = torch.device(device)
    if "RANK" not in os.environ and not dist.is_initialized():
        return DistInfo(0, 1, 0, dev)
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' for gloo on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return DistInfo(dist.get_rank(), dist.get_world_size(), local_rank, dev)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """A DeviceMesh over the first `n_devices` ranks of the process group
    (all of them by default). `shape` gives each axis's size; without it
    every rank goes on the first axis. E.g. dp x fsdp over 8 ranks:
    `make_mesh(8, ("data", "model"), (2, 4))`."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size() if n_devices is None else n_devices
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or _prod(shape) != n:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} "
                         f"does not hold {n} devices")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(names.index(axis)) if axis in names else 0


def batch_rows(rank_in_data: int, n_data: int, b: int) -> slice:
    """The contiguous rows of a global batch of `b` that `P('data')` gives
    shard `rank_in_data` of `n_data`; `b` must divide evenly."""
    if b % n_data:
        raise ValueError(f"a batch of {b} does not split over {n_data} data shards")
    per = b // n_data
    return slice(rank_in_data * per, (rank_in_data + 1) * per)


def param_shardings(named_params: Mapping[str, object], model_axis_size: int,
                    min_shard_size: int = 2 ** 15) -> Dict[str, Optional[int]]:
    """The JAX package's FSDP rule (parallel/mesh.py:param_shardings): an
    array of at least `min_shard_size` elements is split over the 'model'
    axis along its largest dimension that the axis size divides (the first
    of equal ones); a small, scalar or indivisible array is replicated.
    Maps each name to the split dimension, or None for replicated.
    `named_params` maps names to tensors, arrays or shapes."""
    out: Dict[str, Optional[int]] = {}
    for name, x in named_params.items():
        shape = tuple(x) if isinstance(x, (tuple, list, torch.Size)) else tuple(x.shape)
        out[name] = None
        if model_axis_size > 1 and len(shape) >= 1 and _prod(shape) >= min_shard_size:
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                if shape[d] % model_axis_size == 0:
                    out[name] = d
                    break
    return out


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
