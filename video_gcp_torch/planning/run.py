"""Planning / control / data-generation CLI with worker parallelism
(planning/run.py of the JAX package).

Reference: gcp/planning/run.py:36-153. Loads a `mod_hyper.py` control config
(python-as-config exposing `config` with agent/policy sub-dicts) through the
port's config importer, so `video_gcp_tpu.X` in the config resolves to
`video_gcp_torch.X`; splits the trajectory index range over worker
processes, and runs `run_trajectories` per worker.

Usage:
    python -m video_gcp_torch.planning.run <mod_hyper.py> [--device cuda|cpu]
        [--nworkers N] [--gpu_id G] [--ngpu K] [--start_idx A] [--end_idx B]
        [--resume_from IDX] [--iex I] [--seed S]

Planners run on the card unless `--device cpu` is given; without a card a
'cuda' run raises. Workers are spawned (CUDA cannot be re-initialised in a
forked child); worker i plans on cuda:{(G + i % K) % device count}.
Each worker reseeds numpy's global generator, from fresh entropy as the
reference does, or with S + i under `--seed S` (data generation and
planning that repeat run for run).
"""
from __future__ import annotations

import argparse
import copy
import multiprocessing
import os
from pathlib import Path

import numpy as np

from video_gcp_torch.planning.infra.sim.benchmarks import run_trajectories
from video_gcp_torch.training.config import _ConfigImporter, _experiments_root


def bench_worker(conf, iex=-1, ngpu=1):
    """One worker's trajectory loop (run.py:16-22)."""
    np.random.seed(conf.get("seed"))  # reseed per worker; None: fresh entropy
    run_trajectories(conf, iex, gpu_id=conf.get("gpu_id", 0), ngpu=ngpu)


def load_control_config(path) -> dict:
    path = Path(path).resolve()
    mod = _ConfigImporter(_experiments_root(path.parent)).exec_file(path, "mod_hyper")
    return dict(mod.config)


def worker_device(device: str, gpu_id: int, ngpu: int, i: int) -> str:
    """The device of worker i: 'cpu', or a card chosen round-robin."""
    if device == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("planning.run: no CUDA device; pass --device cpu "
                           "to run on the CPU")
    return f"cuda:{(gpu_id + i % max(ngpu, 1)) % torch.cuda.device_count()}"


class ControlManager:
    def __init__(self, args=None):
        parser = argparse.ArgumentParser()
        parser.add_argument("experiment", help="path to mod_hyper.py config")
        parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                            help="where the planner runs (the card by default)")
        parser.add_argument("--nworkers", type=int, default=1)
        parser.add_argument("--gpu_id", type=int, default=0)
        parser.add_argument("--ngpu", type=int, default=1)
        parser.add_argument("--start_idx", type=int, default=None)
        parser.add_argument("--end_idx", type=int, default=None)
        parser.add_argument("--nsplit", type=int, default=-1,
                            help="number of splits of the full index range")
        parser.add_argument("--isplit", type=int, default=-1,
                            help="index of the split to run")
        parser.add_argument("--resume_from", type=int, default=None)
        parser.add_argument("--iex", type=int, default=-1,
                            help="run only this example index")
        parser.add_argument("--seed", type=int, default=None,
                            help="seed of worker 0's np.random (worker i: seed + i); "
                                 "fresh entropy by default")
        self.args = parser.parse_args(args)

    def run(self):
        args = self.args
        conf = load_control_config(args.experiment)

        exp_dir = os.path.dirname(os.path.abspath(args.experiment))
        conf.setdefault("current_dir", exp_dir)
        conf.setdefault("log_dir", os.path.join(exp_dir, "log"))
        conf.setdefault("data_save_dir", os.path.join(exp_dir, "data"))
        os.makedirs(conf["log_dir"], exist_ok=True)
        os.makedirs(conf["data_save_dir"], exist_ok=True)

        start = args.start_idx if args.start_idx is not None \
            else conf.get("start_index", 0)
        end = args.end_idx if args.end_idx is not None \
            else conf.get("end_index", conf.get("ntraj", 1) - 1)

        # split the global range when running as one shard of many
        if args.nsplit != -1:
            assert args.isplit >= 0
            n = end - start + 1
            per = -(-n // args.nsplit)
            start = start + args.isplit * per
            end = min(start + per - 1, end)
        if args.resume_from is not None:
            start = args.resume_from

        if args.nworkers == 1:
            conf.update(start_index=start, end_index=end, gpu_id=args.gpu_id, seed=args.seed,
                        device=worker_device(args.device, args.gpu_id, args.ngpu, 0))
            bench_worker(conf, args.iex, args.ngpu)
        else:
            confs = []
            n = end - start + 1
            per = -(-n // args.nworkers)
            for i in range(args.nworkers):
                modconf = copy.deepcopy(conf)
                modconf["start_index"] = start + i * per
                modconf["end_index"] = min(start + (i + 1) * per - 1, end)
                modconf["gpu_id"] = i + args.gpu_id
                modconf["seed"] = None if args.seed is None else args.seed + i
                modconf["device"] = worker_device(args.device, args.gpu_id,
                                                  args.ngpu, i)
                confs.append(modconf)
            with multiprocessing.get_context("spawn").Pool(args.nworkers) as p:
                p.map(bench_worker, confs)


def main(argv=None):
    ControlManager(argv).run()


if __name__ == "__main__":
    main()
