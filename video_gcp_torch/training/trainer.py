"""The trainer of the port: epoch loop, validation NLL, checkpoints,
resume (training/trainer.py of the JAX package).

    python -m video_gcp_torch.training.train --path <conf_dir>
        [--resume latest|<epoch>|<dir>|<weights.npz>] [--num_epochs N]
        [--feed_random_data 1] [--deterministic 1] [--device cuda|cpu]

Runs on the card unless `--device cpu` is given; without a GPU it raises.
Per step: `parallel.train_step.train_step` (forward in phase 'train' /
mode 'posterior', with K3 in the adaptive binding's matching, backward
through K1+K2 on the card, finite mask, RAdam). Without trained weights
(9room/gcp_adaptive), `--resume latest` finds no checkpoint and training
starts from the port's initialisation.
Validation computes the loss values with the train-mode posterior
(train.py:211-215). The image metrics and visualizations of the JAX trainer
wait for the evaluation slice (ROADMAP queue 1, item 7); the h5 datasets
wait until the published data is in the repository.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import sys
import time

import numpy as np
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.data.datasets import RandomVideoDataset
from video_gcp_torch.data.loader import DataLoader
from video_gcp_torch.load import set_float32_precision
from video_gcp_torch.parallel.train_step import make_optimizer, make_val_step, train_step
from video_gcp_torch.training import checkpoint as ckpt
from video_gcp_torch.training.config import (
    build_hparams,
    datetime_str,
    get_exp_dir,
    load_config,
)
from video_gcp_torch.training.logger import Logger


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, v):
        self.sum += v
        self.count += 1

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path", required=True)
    p.add_argument("--prefix", default="")
    p.add_argument("--new_dir", default=0, type=int)
    p.add_argument("--resume", default="latest")
    p.add_argument("--train", default=1, type=int)
    p.add_argument("--metric", default=0, type=int)
    p.add_argument("--val_sweep", default=0, type=int)
    p.add_argument("--dataset_val_sweep", default=0, type=int)
    p.add_argument("--deterministic", default=0, type=int)
    p.add_argument("--log_outputs_interval", default=10, type=int)
    p.add_argument("--skip_first_val", default=0, type=int)
    p.add_argument("--feed_random_data", default=0, type=int)
    p.add_argument("--verbose_timing", default=0, type=int,
                   help="synchronize the device after every step and record "
                        "its wall time (ModelTrainer.step_seconds)")
    p.add_argument("--val_metric_batches", default=0, type=int,
                   help="image metrics on val batches: not ported yet, keep 0")
    p.add_argument("--num_epochs", default=0, type=int,
                   help="override configuration['num_epochs'] when > 0")
    p.add_argument("--train_deadline", default=0, type=float,
                   help="absolute wall deadline (epoch seconds): stop cleanly "
                        "at the first epoch boundary past it")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


class ModelTrainer:
    def __init__(self, args):
        self.args = args
        for flag, item in (("metric", 7), ("val_sweep", 7), ("dataset_val_sweep", 7)):
            if getattr(args, flag):
                raise NotImplementedError(
                    f"--{flag} is not ported yet; ROADMAP queue 1, item {item}")
        if args.val_metric_batches:
            raise NotImplementedError(
                "--val_metric_batches: the image metrics are not ported yet; "
                "ROADMAP queue 1, item 7 (pass 0)")
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ModelTrainer: no CUDA device; pass --device cpu "
                               "to train on the CPU")
        set_float32_precision()
        bundle = load_config(args.path)
        self.conf = bundle.configuration
        self.data_conf = bundle.data_conf
        if args.deterministic:
            np.random.seed(0)
            torch.manual_seed(0)

        base = os.path.join(get_exp_dir(), bundle.exp_name)
        if args.prefix:
            base = os.path.join(base, args.prefix)
        if args.new_dir:
            base += datetime_str()
        self.exp_path = base
        os.makedirs(self.exp_path, exist_ok=True)
        with open(os.path.join(self.exp_path, "cmd.txt"), "a") as f:
            f.write(" ".join(sys.argv) + "\n")
        self.logger = Logger(os.path.join(self.exp_path, "events"))

        self.hp = build_hparams(bundle)
        self.model = self.conf["model"](self.hp).to(
            self.device, memory_format=torch.channels_last)
        print(f"model parameters: {sum(p.numel() for p in self.model.parameters())}")
        self.train_loader, self.val_loader = self._build_loaders()
        self.optimizer = make_optimizer(
            [p for p in self.model.parameters() if p.requires_grad],
            self.conf["optimizer"], self.conf["lr"] or 1e-3,
            self.conf["gradient_clip"], self.conf["momentum"], self.conf["adam_beta"])
        self.val_step = make_val_step(self.model)
        self.generator = torch.Generator(self.device).manual_seed(
            0 if args.deterministic else int(time.time()))
        self.step = 0
        self.step_seconds = []  # per step, with --verbose_timing

        self.start_epoch = 0
        path = ckpt.resolve_resume(args.resume, self.exp_path)
        if path is not None:
            print(f"resuming from {path}")
            if path.endswith(".npz"):  # pretrained parameters, fresh optimizer
                self.model.load_state_dict(
                    ckpt.flax_to_torch(ckpt.load_pretrained_npz(path)), strict=True)
            else:
                self.step = ckpt.load_checkpoint(path, self.model, self.optimizer)
                m = re.search(r"weights_ep(\d+)", path)
                if m:
                    self.start_epoch = int(m.group(1)) + 1

    def _build_loaders(self):
        if not (self.args.feed_random_data or self.conf.get("dataset_name") is None):
            raise NotImplementedError(
                "the h5 datasets are not ported yet (the published data is not in "
                "the repository); pass --feed_random_data 1")
        mpar = dict(self.hp)
        train_set = RandomVideoDataset(None, mpar, self.data_conf, "train",
                                       dataset_size=256)
        val_set = RandomVideoDataset(None, mpar, self.data_conf, "val",
                                     dataset_size=32)
        bs = self.conf["batch_size"]
        # one assembling thread by default: the step's Python thread issues
        # thousands of small launches, and more loader threads take the
        # interpreter from it (9room/gcp_tree on an H100 host with 8 cores:
        # 211 ms per step with 1 thread, 558 ms with 8; PERF.md)
        n_workers = int(os.environ.get("GCP_N_DATA_WORKERS", "1"))
        train_loader = DataLoader(train_set, bs, shuffle=True,
                                  n_repeat=self.conf["epoch_cycles_train"],
                                  num_workers=n_workers, device=self.device)
        # drop_last=False: a val split may be smaller than one batch
        val_loader = DataLoader(val_set, bs, shuffle=False, drop_last=False,
                                num_workers=n_workers, device=self.device)
        return train_loader, val_loader

    def run(self):
        args = self.args
        if args.num_epochs > 0:
            self.conf["num_epochs"] = args.num_epochs
        try:
            if not args.train:
                self.val(self.start_epoch)
                return
            for epoch in range(self.start_epoch, self.conf["num_epochs"]):
                if args.train_deadline and time.time() > args.train_deadline:
                    print(f"train_deadline reached before epoch {epoch}: stopping "
                          f"(latest checkpoint: ep{epoch - 1})", flush=True)
                    break
                self.train_epoch(epoch)
                ckpt.save_checkpoint(self.exp_path, epoch, self.model,
                                     self.optimizer, self.step)
                if not (epoch == 0 and args.skip_first_val):
                    self.val(epoch)
        finally:
            self.logger.close()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self, epoch: int):
        meters = AttrDict(data=AverageMeter(), step=AverageMeter())
        n_batches = len(self.train_loader)
        self.model.train()
        t0 = time.time()
        for i, batch in enumerate(self.train_loader):
            t1 = time.time()
            meters.data.update(t1 - t0)
            metrics = train_step(self.model, self.optimizer, batch, self.step,
                                 self.generator)
            self.step += 1
            if self.args.verbose_timing:
                self._sync()
                self.step_seconds.append(time.time() - t1)
            if i % self.args.log_outputs_interval == 0:
                metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
                self.logger.log_scalar_dict(
                    {k + "_loss": v for k, v in metrics.items() if np.ndim(v) == 0
                     and k != "grads_finite"}, self.step, "train")
                self.logger.log_scalar(metrics["grads_finite"], "grads_finite",
                                       self.step, "train")
                for k, v in metrics.items():
                    if np.ndim(v) > 0:
                        self.logger.log_graph(v, k, self.step, "train")
                if not bool(metrics["grads_finite"]):
                    self._dump_debug_data(batch, metrics)
                meters.step.update(time.time() - t1)
                togo = (n_batches - i) * (meters.data.avg + meters.step.avg) / 60
                print(f"epoch {epoch} it {i}/{n_batches} "
                      f"total: {float(metrics['total']):.4f} "
                      f"t_data {meters.data.avg:.3f}s t_step {meters.step.avg:.3f}s "
                      f"ETA {togo:.1f}min", flush=True)
            else:
                meters.step.update(time.time() - t1)
            t0 = time.time()
        if self.step_seconds:
            print(f"epoch {epoch}: median step {statistics.median(self.step_seconds):.4f}s")

    def val(self, epoch: int):
        losses_acc = {}
        t0 = time.time()
        for batch in self.val_loader:
            for k, v in self.val_step(batch, self.step, self.generator).items():
                losses_acc.setdefault(k, []).append(float(v))
        for k, vals in losses_acc.items():
            self.logger.log_scalar(np.mean(vals), k + "_loss", self.step, "val")
        print(f"[val] epoch {epoch} "
              + " ".join(f"{k}: {np.mean(v):.4f}" for k, v in losses_acc.items())
              + f" ({time.time() - t0:.1f}s)", flush=True)
        self.logger.flush()
        return {k: float(np.mean(v)) for k, v in losses_acc.items()}

    def _dump_debug_data(self, batch, metrics):
        """Non-finite gradients: save the batch and metrics for offline
        debugging (the reference's NaN hook, base_trainer.py:40-66)."""
        path = os.path.join(self.exp_path, f"debug_nan_step{self.step}.pt")
        torch.save(dict(batch={k: v.cpu() for k, v in batch.items()},
                        metrics=metrics), path)
        print(f"WARNING: non-finite gradients at step {self.step}; dumped {path}")


def main(argv=None):
    ModelTrainer(parse_args(argv)).run()
