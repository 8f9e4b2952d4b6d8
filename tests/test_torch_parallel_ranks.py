"""The rank side of tests/test_torch_parallel.py: code that each spawned
rank runs under a gloo process group on the CPU. It holds no test itself.

It imports torch, numpy and the port only, so that a spawned rank does not
load JAX. The test process writes `spec.pt` (the model's hparams and
weights, the global batch, the recorded noise draws and the cases) into a
work directory; `session` runs every case in one process group and writes
rank r's results to `rank{r}.pt`.
"""
from __future__ import annotations

import contextlib
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from video_gcp_torch.core import distributions
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.data.loader import DataLoader
from video_gcp_torch.models.tree import TreeModel
from video_gcp_torch.parallel.mesh import axis_rank, batch_rows, make_mesh
from video_gcp_torch.parallel.train_step import (
    make_optimizer,
    shard_model,
    train_step,
)
from video_gcp_torch.training import checkpoint as ckpt


@contextlib.contextmanager
def replayed_noise(draws, rows):
    """The train path's normal and uniform draws replaced, in call order,
    by `rows` of the recorded global draws (every draw is batch-leading)."""
    pos = {"normal": 0, "uniform": 0}

    def take(kind, shape):
        a = draws[kind][pos[kind]][rows]
        pos[kind] += 1
        assert a.shape == tuple(shape), (kind, a.shape, tuple(shape))
        return torch.from_numpy(np.ascontiguousarray(a))

    saved = distributions.Gaussian.sample, distributions.uniform
    distributions.Gaussian.sample = lambda g, gen: g.reparametrize(take("normal", g.mu.shape))
    distributions.uniform = lambda shape, gen, device=None: take("uniform", shape)
    try:
        yield
    finally:
        distributions.Gaussian.sample, distributions.uniform = saved
    assert all(pos[k] == len(draws[k]) for k in pos), (pos, {k: len(v) for k, v in draws.items()})


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _shard_dims(model):
    from torch.distributed.tensor import DTensor
    return {n: (p.placements[-1].dim if isinstance(p, DTensor) else None)
            for n, p in model.named_parameters()}


def _mesh(shape):
    n_data, n_model = shape
    if n_model > 1:
        return make_mesh(n_data * n_model, ("data", "model"), shape, "cpu")
    return make_mesh(n_data, device_type="cpu")


def _model_and_optimizer(spec, mesh, min_shard_size):
    model = TreeModel(spec["hp"])
    model.load_state_dict(spec["weights"], strict=True)
    model.to(memory_format=torch.channels_last)  # as the trainer holds it
    n_model = mesh.size(1) if mesh.ndim > 1 else 1
    if n_model > 1:
        shard_model(model, mesh, min_shard_size)
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad],
                         "radam", spec["lr"], None, 0, 0.9)
    return model, opt


def _step(spec, case, model, opt, mesh):
    """One train step on this rank's rows of the global batch."""
    n_data = mesh.size(0)
    b = len(spec["batch"]["traj_seq"])
    rows = batch_rows(axis_rank(mesh, "data"), n_data, b)
    batch = {k: np.array(v[rows]) for k, v in spec["batch"].items()}
    if case.get("nan_row") is not None and rows.start <= case["nan_row"] < rows.stop:
        batch["traj_seq"][case["nan_row"] - rows.start, 3, 2, 2, 0] = np.nan
    batch = AttrDict({k: torch.from_numpy(v) for k, v in batch.items()})
    with replayed_noise(spec["noise"], rows):
        metrics = train_step(model, opt, batch, 0, torch.Generator(), mesh)
    grads = {n: _full(p.grad).detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    return dict(metrics={k: v.detach().clone() for k, v in metrics.items()}, grads=grads,
                local_rows=(rows.start, rows.stop))


def step_case(rank, world, spec, case):
    mesh = _mesh(case["mesh"])
    model, opt = _model_and_optimizer(spec, mesh, case.get("min_shard_size", 2 ** 15))
    out = _step(spec, case, model, opt, mesh)
    out.update(params=ckpt.model_state(model), shard_dims=_shard_dims(model),
               foreach=opt.param_groups[0]["foreach"])
    return out


def checkpoint_case(rank, world, spec, case):
    """A single-process checkpoint loaded strictly into a sharded model and
    its optimizer; one step; the sharded run's checkpoint written by rank 0."""
    mesh = _mesh(case["mesh"])
    model, opt = _model_and_optimizer(spec, mesh, case.get("min_shard_size", 2 ** 15))
    step = ckpt.load_checkpoint(case["load"], model, opt)
    loaded = dict(model=ckpt.model_state(model), optimizer=ckpt.optimizer_state(model, opt),
                  step=step)
    _step(spec, case, model, opt, mesh)
    ckpt.save_checkpoint(case["exp_path"], 1, model, opt, step + 1, write=rank == 0)
    return dict(loaded=loaded, params=ckpt.model_state(model),
                optimizer=ckpt.optimizer_state(model, opt), shard_dims=_shard_dims(model))


class _Examples:
    """Example i is {'x': [i, i], 'y': i}: which rows a rank assembled shows."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full(2, i, np.int64), "y": np.int64(i)}


def loader_case(rank, world, spec, case):
    """This rank's rows of every batch of two epochs."""
    loader = DataLoader(_Examples(case["n"]), case["batch_size"], shuffle=True,
                        drop_last=case["drop_last"], num_workers=1, seed=case["seed"],
                        rows=(rank, world))
    return [[b["y"].numpy() for b in loader] for _ in range(2)]


def trainer_case(rank, world, spec, case):
    """ModelTrainer under this process group, as under torchrun: its layout,
    its generator's first draws and what it printed; with case["run"], a
    run of case["n_seqs"] random sequences (and 4 for val). Each rank's
    clock reads `rank * case["clock_skew"]` seconds late while the trainer
    is built, as when the ranks start at different moments."""
    import io
    import time
    from contextlib import redirect_stdout
    from video_gcp_torch.training.trainer import ModelTrainer, parse_args
    saved = {k: os.environ.get(k) for k in ("GCP_FSDP", "GCP_EXP_DIR")}
    os.environ.update(GCP_FSDP=str(case["fsdp"]), GCP_EXP_DIR=case["exp_dir"])
    clock = time.time
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            time.time = lambda: clock() + rank * case["clock_skew"]
            try:
                trainer = ModelTrainer(parse_args(case["argv"]))
            finally:
                time.time = clock
            res = dict(mesh=tuple(trainer.mesh.shape),
                       noise=torch.rand(4, generator=_copy(trainer.generator)))
            if case["run"]:
                trainer.train_loader.dataset.n_seqs = case["n_seqs"]
                trainer.val_loader.dataset.n_seqs = 4
                trainer.run()
                res["step"] = trainer.step
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    res["stdout"] = out.getvalue()
    return res


def _copy(generator):
    """A generator in `generator`'s state, which it leaves as it was."""
    g = torch.Generator(generator.device)
    g.set_state(generator.get_state())
    return g


CASES = dict(step=step_case, checkpoint=checkpoint_case, loader=loader_case,
             trainer=trainer_case)


def session(rank, world, workdir):
    """Every case of `spec.pt` under one gloo process group."""
    torch.set_num_threads(1)
    # the model's outputs are views; the step does nothing in place on them
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module")
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"),
                            rank=rank, world_size=world)
    try:
        spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
        results = {name: CASES[case["kind"]](rank, world, spec, case)
                   for name, case in spec["cases"].items()}
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
