"""The trainer of the port: epoch loop, validation, checkpoints, resume,
and the top-of-100 metric evaluation (training/trainer.py of the JAX
package).

    python -m video_gcp_torch.training.train --path <conf_dir>
        [--resume latest|<epoch>|<dir>|<weights.npz>] [--num_epochs N]
        [--feed_random_data 1] [--deterministic 1] [--device cuda|cpu]
        [--metric 1] [--val_sweep 1] [--dataset_val_sweep 1]
        [--val_metric_batches N] [--val_data_size N]

    [GCP_FSDP=k] torchrun --standalone --nproc_per_node=N \
        -m video_gcp_torch.training.train --path <conf_dir> ...

Runs on the card unless `--device cpu` is given; without a GPU it raises.
Under torchrun (several GPUs, or several nodes with torchrun's --nnodes,
--node_rank and --rdzv_endpoint) each process trains on its own card over
NCCL (gloo with `--device cpu`): data parallel over every rank, the global
batch split by rows; with GCP_FSDP=k a dp x fsdp layout of N/k data shards
by a k-wide 'model' axis that holds the large parameters and their RAdam
moments split (the JAX trainer's mesh, trainer.py:151-164; N/k must divide
the batch). Only rank 0 writes the event log, prints and checkpoints; every
rank reads a resume. `--metric` and `--dataset_val_sweep` run in one
process.
Per step: `parallel.train_step.train_step` (forward in phase 'train' /
mode 'posterior', with K3 in the adaptive binding's matching, backward
through K1+K2 on the card, finite mask, RAdam). Without trained weights
(9room/gcp_adaptive), `--resume latest` finds no checkpoint and training
starts from the port's initialisation.

A config that names a dataset trains on the h5 files under
$GCP_DATA_DIR/<dataset_name> through the dataset's configured class (the
9-room maze's re-renderer for nav_9rooms); `--feed_random_data 1` and a
config without a dataset take the synthetic RandomVideoDataset.

Validation computes the loss values with the train-mode posterior
(train.py:211-215) and, on the first `--val_metric_batches` batches, PSNR,
SSIM and MSE of one prior sample (a tree's warped onto the GT timeline by
DTW). Rank 0 logs images of each val pass into `events/images/`: of the
first metric batch's prior sample the GT and predicted strips
(`val_gt_vs_pred`), a GIF (`val_pred_gif`), the tree (`output_tree`) and
the pruned nodes (`pruned_pred`), or for a state-space model its top-down
overlay (`prediction_topdown`); of a train-mode posterior pass on the first
val batch the GT-match overview (`gt_match_overview`), the head-averaged
attention (`attention_masks`) and the regressed states drawn by the
dataset's `render_trajectory` (`regressed_state_topdown`).
`--metric 1` runs the Evaluator (top-of-100 with the configuration's
`metric_pruning_scheme`) over the val set instead of training;
`--val_sweep 1` validates every saved epoch; `--dataset_val_sweep 1`
validates the current weights on each dataset of the configuration's
`dataset_sweep_specs`, at its own horizon.
"""
from __future__ import annotations

import argparse
import math
import os
import re
import statistics
import sys
import time

import numpy as np
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.metrics import mse, psnr, ssim, to_float_images
from video_gcp_torch.data.datasets import GlobalSplitVarLenVideoDataset, RandomVideoDataset
from video_gcp_torch.data.loader import DataLoader
from video_gcp_torch.evaluation import visualization as vis
from video_gcp_torch.evaluation.eval_binding import dense_sample
from video_gcp_torch.evaluation.eval_logger import TBEvalLogger
from video_gcp_torch.evaluation.evaluator import PRIOR_INPUTS, Evaluator
from video_gcp_torch.load import set_float32_precision
from video_gcp_torch.models.bc import BCModel
from video_gcp_torch.ops.tree_index import breadthfirst2depthfirst
from video_gcp_torch.parallel.mesh import axis_rank, axis_size, init_distributed, make_mesh
from video_gcp_torch.parallel.train_step import (
    broadcast_model,
    make_optimizer,
    make_val_step,
    shard_model,
    train_step,
)
from video_gcp_torch.training import checkpoint as ckpt
from video_gcp_torch.training.config import (
    build_data_conf,
    build_hparams,
    datetime_str,
    get_dataset_path,
    get_exp_dir,
    load_config,
    require_dataset,
)
from video_gcp_torch.training.logger import Logger


class _NullLogger:
    """The event log of a rank other than 0: writes nothing."""

    def __getattr__(self, name):
        return lambda *a, **kw: None


def _host(t) -> np.ndarray:
    """A tensor as a float32 (or its own integer or bool) numpy array."""
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


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
    p.add_argument("--val_data_size", default=-1, type=int)
    p.add_argument("--log_outputs_interval", default=10, type=int)
    p.add_argument("--skip_first_val", default=0, type=int)
    p.add_argument("--feed_random_data", default=0, type=int)
    p.add_argument("--verbose_timing", default=0, type=int,
                   help="synchronize the device after every step and record "
                        "its wall time and the wait for its batch "
                        "(ModelTrainer.step_seconds, data_seconds)")
    p.add_argument("--val_metric_batches", default=4, type=int,
                   help="val batches for the quick per-epoch PSNR/SSIM/MSE of "
                        "one prior sample (the whole val split when it has "
                        "fewer); the reported protocol is the top-of-100 "
                        "evaluation, --metric 1")
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
        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ModelTrainer: no CUDA device; pass --device cpu "
                               "to train on the CPU")
        self.dist = init_distributed(args.device)
        self.device = self.dist.device
        self.is_main = self.dist.rank == 0
        set_float32_precision()
        bundle = load_config(args.path)
        self.conf = bundle.configuration
        self.data_conf = bundle.data_conf
        self.mesh = self._make_mesh()
        if args.deterministic:
            np.random.seed(0)
            torch.manual_seed(0)

        base = os.path.join(get_exp_dir(), bundle.exp_name)
        if args.prefix:
            base = os.path.join(base, args.prefix)
        if args.new_dir:
            base += datetime_str()
        self.exp_path = base
        if self.is_main:
            os.makedirs(self.exp_path, exist_ok=True)
            with open(os.path.join(self.exp_path, "cmd.txt"), "a") as f:
                f.write(" ".join(sys.argv) + "\n")
        self.logger = (Logger(os.path.join(self.exp_path, "events")) if self.is_main
                       else _NullLogger())

        self.hp = build_hparams(bundle)
        self.model = self.conf["model"](self.hp).to(
            self.device, memory_format=torch.channels_last)
        self.print(f"model parameters: {sum(p.numel() for p in self.model.parameters())}")
        self.train_loader, self.val_loader = self._build_loaders()
        # every rank reads the resume; pretrained weights go in before the
        # model is sharded, a checkpoint (model and optimizer) after
        self.start_epoch = 0
        path = ckpt.resolve_resume(args.resume, self.exp_path)
        if path is not None:
            self.print(f"resuming from {path}")
            if path.endswith(".npz"):  # pretrained parameters, fresh optimizer
                self.model.load_state_dict(
                    ckpt.flax_to_torch(ckpt.load_pretrained_npz(path)), strict=True)
        if self.mesh is not None:
            broadcast_model(self.model)  # one initialisation for every rank
            if axis_size(self.mesh, "model") > 1:
                shard_model(self.model, self.mesh)
        self.optimizer = make_optimizer(
            [p for p in self.model.parameters() if p.requires_grad],
            self.conf["optimizer"], self.conf["lr"] or 1e-3,
            self.conf["gradient_clip"], self.conf["momentum"], self.conf["adam_beta"])
        self.val_step = make_val_step(self.model, self.mesh)
        seed = 0 if args.deterministic else int(time.time())
        if self.mesh is not None:
            # rank 0's seed, then one stream per data shard: the ranks of a
            # 'model' group hold the same rows and draw the same noise for
            # them, as the JAX step's replicated values
            t = torch.tensor([seed], dtype=torch.int64, device=self.device)
            torch.distributed.broadcast(t, 0)
            seed = int(t[0]) + axis_rank(self.mesh, "data")
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.step = 0
        self.step_seconds = []  # per step, with --verbose_timing
        self.data_seconds = []  # the wait for each step's batch, likewise
        if path is not None and not path.endswith(".npz"):
            self.step = ckpt.load_checkpoint(path, self.model, self.optimizer)
            m = re.search(r"weights_ep(\d+)", path)
            if m:
                self.start_epoch = int(m.group(1)) + 1

    def print(self, *a, **kw):
        if self.is_main:
            print(*a, **kw)

    def _make_mesh(self):
        """None in a single process; else the JAX trainer's layout
        (trainer.py:151-164): a 'data' axis over the ranks or, with
        GCP_FSDP=k, ('data', 'model') of shape (N/k, k). The JAX trainer
        leaves devices idle until the data axis divides the batch; torchrun
        starts every rank, so a layout that does not divide raises."""
        world = self.dist.world_size
        if world == 1 and "RANK" not in os.environ:
            return None
        fsdp = int(os.environ.get("GCP_FSDP", "1"))
        bs = self.conf["batch_size"]
        if world % fsdp or bs % (world // fsdp):
            raise ValueError(f"{world} ranks with GCP_FSDP={fsdp} leave {world / fsdp:g} "
                             f"data shards, which do not divide the batch of {bs}")
        dev = self.device.type
        if fsdp > 1:
            return make_mesh(world, ("data", "model"), (world // fsdp, fsdp), dev)
        return make_mesh(world, device_type=dev)

    def _build_loaders(self):
        dataset_name = self.conf.get("dataset_name")
        mpar = dict(self.hp)
        if self.args.feed_random_data or dataset_name is None:
            train_set = RandomVideoDataset(None, mpar, self.data_conf, "train",
                                           dataset_size=256)
            val_set = RandomVideoDataset(None, mpar, self.data_conf, "val",
                                         dataset_size=32)
        else:
            require_dataset(dataset_name)
            data_dir = get_dataset_path(dataset_name)
            dset_cls = self._dataset_class()
            train_set = dset_cls(data_dir, mpar, self.data_conf, "train")
            val_set = dset_cls(data_dir, mpar, self.data_conf, "val", shuffle=False,
                               dataset_size=self.args.val_data_size)
        train_loader = self._loader(train_set, shuffle=True,
                                    n_repeat=self.conf["epoch_cycles_train"])
        # drop_last=False: the published splits leave val sets smaller than
        # one batch (0.006 of the files)
        val_loader = self._loader(val_set, shuffle=False, drop_last=False)
        return train_loader, val_loader

    def _loader(self, dataset, **kw):
        if self.mesh is not None:
            kw["rows"] = (axis_rank(self.mesh, "data"), axis_size(self.mesh, "data"))
        # one assembling thread by default: the step's Python thread issues
        # thousands of small launches, and more loader threads take the
        # interpreter from it (9room/gcp_tree on an H100 host with 8 cores:
        # 211 ms per step with 1 thread, 558 ms with 8; PERF.md)
        n_workers = int(os.environ.get("GCP_N_DATA_WORKERS", "1"))
        return DataLoader(dataset, self.conf["batch_size"], num_workers=n_workers,
                          device=self.device, **kw)

    def _dataset_class(self):
        spec_cls = self.data_conf.dataset_spec.get("dataset_class")
        if spec_cls is not None and not isinstance(spec_cls, str):
            return spec_cls
        return GlobalSplitVarLenVideoDataset

    def run(self):
        args = self.args
        if args.num_epochs > 0:
            self.conf["num_epochs"] = args.num_epochs
        if self.mesh is not None and (args.metric or args.dataset_val_sweep):
            raise ValueError("--metric and --dataset_val_sweep run in one process, "
                             "not under torchrun")
        try:
            if args.val_sweep:
                for epoch in ckpt.get_epochs(self.exp_path):
                    path = os.path.join(ckpt.weights_dir(self.exp_path),
                                        ckpt.ckpt_name(epoch))
                    self.step = ckpt.load_checkpoint(path, self.model, self.optimizer)
                    self.val(epoch)
                return
            if args.dataset_val_sweep:
                self.run_dataset_val_sweep()
                return
            if args.metric:
                self.run_metric_eval()
                return
            if not args.train:
                self.val(self.start_epoch)
                return
            for epoch in range(self.start_epoch, self.conf["num_epochs"]):
                if args.train_deadline and time.time() > args.train_deadline:
                    self.print(f"train_deadline reached before epoch {epoch}: stopping "
                          f"(latest checkpoint: ep{epoch - 1})", flush=True)
                    break
                self.train_epoch(epoch)
                ckpt.save_checkpoint(self.exp_path, epoch, self.model,
                                     self.optimizer, self.step, write=self.is_main)
                if not (epoch == 0 and args.skip_first_val):
                    self.val(epoch)
        finally:
            self.logger.close()

    def run_dataset_val_sweep(self):
        """Validate the current weights on each dataset of
        `dataset_sweep_specs` at its horizon, with hierarchy_levels =
        ceil(log2(max_seq_len)) for a tree (train.py:71-99; JAX
        trainer.py:285-370). The levels must be tied, so that the parameters
        do not depend on the depth. The model is rebuilt per horizon and
        takes every current parameter of the same shape; horizon-dependent
        ones (the length predictor's max_seq_len-wide head) keep their
        initialisation and are reported. Each dataset is read through its
        own config (data/configs/<name>.py and its dataset_spec.py)."""
        sweeps = self.conf.get("dataset_sweep_specs", [])
        if not sweeps:
            raise ValueError("set configuration['dataset_sweep_specs'] for the sweep")
        if self.hp.get("untied_layers", False):
            raise ValueError("the dataset sweep changes the tree's depth: it needs "
                             "tied layers")
        model, val_loader, val_step = self.model, self.val_loader, self.val_step
        current = {k: v.detach() for k, v in model.state_dict().items()}
        try:
            for spec in sweeps:
                hp = dict(self.hp, max_seq_len=spec["max_seq_len"])
                if self.hp.get("hierarchy_levels", 0) > 0:
                    hp["hierarchy_levels"] = int(math.ceil(math.log2(spec["max_seq_len"])))
                data_conf = build_data_conf(spec["dataset_name"])
                data_conf.dataset_spec.max_seq_len = spec["max_seq_len"]
                dset_cls = data_conf.dataset_spec.get("dataset_class")
                if dset_cls is None or isinstance(dset_cls, str):
                    dset_cls = self._dataset_class()
                val_set = dset_cls(get_dataset_path(spec["dataset_name"]), hp, data_conf,
                                   "val", shuffle=False, dataset_size=self.args.val_data_size)
                # drop_last=False: a val split of fewer examples than a
                # batch is still validated
                loader = self._loader(val_set, shuffle=False, drop_last=False)
                if len(loader) == 0:
                    raise RuntimeError(f"dataset sweep {spec['dataset_name']}: empty val loader")
                swept = type(model)(hp).to(self.device, memory_format=torch.channels_last)
                fresh = swept.state_dict()
                skipped = sorted(k for k, v in fresh.items()
                                 if k not in current or current[k].shape != v.shape)
                swept.load_state_dict({k: fresh[k] if k in skipped else current[k]
                                       for k in fresh}, strict=True)
                if skipped:
                    print(f"[dataset sweep] horizon-dependent params kept fresh: {skipped}")
                self.model, self.val_loader = swept, loader
                self.val_step = make_val_step(swept)
                print(f"[dataset sweep] {spec['dataset_name']} "
                      f"(T={spec['max_seq_len']}, L={hp.get('hierarchy_levels')})", flush=True)
                self.val(0)
        finally:
            self.model, self.val_loader, self.val_step = model, val_loader, val_step

    def run_metric_eval(self):
        """The top-of-100 evaluation on the val set (--metric 1; JAX
        trainer.py:372-398): the Evaluator's dumps under `metrics/`, its
        `eval/...` records and `val_eval_<metric>` in the event log."""
        evaluator = Evaluator(
            self.model, self.exp_path, self.conf, max_seq_len=self.hp["max_seq_len"],
            pruning_scheme=self.conf["metric_pruning_scheme"],
            top_of_100=bool(self.conf["top_of_100_eval"]),
            use_images=self.hp["use_convs"],
            eval_logger=TBEvalLogger(os.path.join(self.exp_path, "metrics"), self.logger))
        generator = torch.Generator(self.device).manual_seed(123)
        for batch in self.val_loader:
            evaluator.eval(batch, generator)
        summary = evaluator.dump_results(self.step)
        for k, v in summary.items():
            self.logger.log_scalar(v, "eval_" + k, self.step, "val")
        self.logger.flush()
        return summary

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
                                 self.generator, self.mesh)
            self.step += 1
            if self.args.verbose_timing:
                self._sync()
                self.step_seconds.append(time.time() - t1)
                self.data_seconds.append(t1 - t0)
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
                if not bool(metrics["grads_finite"]) and self.is_main:
                    self._dump_debug_data(batch, metrics)
                meters.step.update(time.time() - t1)
                togo = (n_batches - i) * (meters.data.avg + meters.step.avg) / 60
                self.print(f"epoch {epoch} it {i}/{n_batches} "
                      f"total: {float(metrics['total']):.4f} "
                      f"t_data {meters.data.avg:.3f}s t_step {meters.step.avg:.3f}s "
                      f"ETA {togo:.1f}min", flush=True)
            else:
                meters.step.update(time.time() - t1)
            t0 = time.time()
        if self.step_seconds:
            self.print(f"epoch {epoch}: median step {statistics.median(self.step_seconds):.4f}s")

    def val(self, epoch: int):
        losses_acc = {}
        img_metrics = {"psnr": [], "ssim": [], "mse": []}
        t0 = time.time()
        for n, batch in enumerate(self.val_loader, 1):
            for k, v in self.val_step(batch, self.step, self.generator).items():
                losses_acc.setdefault(k, []).append(float(v))
            if n <= self.args.val_metric_batches:
                self._quick_image_metrics(batch, img_metrics, log_images=n == 1)
            if n == 1:
                self._log_posterior_viz(batch)
        if self.mesh is not None:  # the ranks' rows: the mean of their means
            img_metrics = {k: [self._rank_mean(np.mean(v))] for k, v in img_metrics.items()
                           if v}
        for k, vals in losses_acc.items():
            self.logger.log_scalar(np.mean(vals), k + "_loss", self.step, "val")
        for k, vals in img_metrics.items():
            if vals:
                self.logger.log_scalar(np.mean(vals), k, self.step, "val")
        self.print(f"[val] epoch {epoch} "
              + " ".join(f"{k}: {np.mean(v):.4f}" for k, v in losses_acc.items())
              + (f" | psnr {np.mean(img_metrics['psnr']):.2f}" if img_metrics["psnr"] else "")
              + f" ({time.time() - t0:.1f}s)", flush=True)
        self.logger.flush()
        return {k: float(np.mean(v)) for k, v in losses_acc.items()}

    def _rank_mean(self, value: float) -> float:
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        torch.distributed.all_reduce(t)
        return float(t[0]) / self.dist.world_size

    @torch.no_grad()
    def _quick_image_metrics(self, batch, acc, log_images=False):
        """PSNR, SSIM and MSE of one prior sample on one val batch, averaged
        over the padded frames without the first/last crop (JAX
        trainer.py:488-516): a tree's nodes warped onto the GT timeline by
        DTW, the sequential model's rollout as it is. With `log_images`,
        rank 0 also logs the sample's images (_log_val_images), the
        state-space models' top-down overlay among them, before their
        metrics are skipped."""
        if isinstance(self.model, BCModel):
            return  # no frames to score (the JAX trainer's _dense_prediction is None)
        batch = AttrDict(batch)
        batch.traj_seq = to_float_images(batch.traj_seq)
        out = self.model(AttrDict({k: batch[k] for k in PRIOR_INPUTS if k in batch}),
                         phase="test", mode="prior", generator=self.generator)
        pred = dense_sample(out, batch, "dtw" if "tree" in out else "basic",
                            self.model.hp["max_seq_len"])
        if log_images and self.is_main:
            self._log_val_images(out, batch, pred)
        if not self.hp.get("use_convs", True):
            return  # image metrics over state vectors mean nothing (JAX :507-508)
        mask = batch.pad_mask
        denom = mask.sum()
        for name, fn in (("psnr", psnr), ("ssim", ssim), ("mse", mse)):
            acc[name].append(float((fn(pred, batch.traj_seq) * mask).sum() / denom))

    def _log_val_images(self, out, batch, pred):
        """The prior sample's images (JAX trainer.py:518-552; the
        reference's HierarchyLogger family); for a state-space model its
        top-down overlay (base_gcp.py:329-330 prediction_topdown)."""
        if not self.hp.get("use_convs", True):
            self._log_topdown_overlay(batch, pred, "prediction_topdown")
            return
        gen = _host(pred)
        self.logger.log_images(np.stack([vis.seq_strip(_host(batch.traj_seq)), vis.seq_strip(gen)]),
                               "val_gt_vs_pred", self.step, "val")
        self.logger.log_video(gen[0], "val_pred_gif", self.step, "val")
        if "tree" in out:
            self.logger.log_images(vis.plot_balanced_tree(_host(out.tree.images))[None],
                                   "output_tree", self.step, "val")
            if "prune_keep" in out:
                self.logger.log_images(
                    vis.plot_pruned_seq(_host(breadthfirst2depthfirst(out.tree.images)),
                                        _host(out.prune_keep))[None],
                    "pruned_pred", self.step, "val")

    @torch.no_grad()
    def _log_posterior_viz(self, batch):
        """Of a train-mode posterior pass on one val batch: the GT-match
        overview, the attention averaged over heads (logger.py:195-199,
        tree.py:104) and the regressed states' top-down overlay
        (base_gcp.py:313-316); JAX trainer.py:554-595. Every rank runs the
        pass (a sharded model's forward is collective); rank 0 logs. The GT
        row shows the float frames (the JAX trainer hands the plot the
        uint8 batch, which saturates to white)."""
        want_overlay = hasattr(self._dataset_class(), "render_trajectory")
        use_convs = self.hp.get("use_convs", True)
        if isinstance(self.model, BCModel) or not (use_convs or want_overlay):
            return
        out = self.model(batch, phase="train", mode="posterior", generator=self.generator,
                         step=self.step)
        if not self.is_main:
            return
        if use_convs and "tree" in out:
            imgs = _host(out.tree.images)
            gt = _host(to_float_images(batch.traj_seq))
            if "gt_match_dists" in out:
                self.logger.log_images(
                    vis.plot_gt_matching_overview(imgs, _host(out.gt_match_dists), gt)[None],
                    "gt_match_overview", self.step, "val")
            gamma = out.tree.get("gamma")
            if gamma is not None:
                gamma = _host(gamma)
                if gamma.ndim == 4:  # [B, N, heads, T]
                    gamma = gamma.mean(2)
                self.logger.log_images(vis.plot_gt_matching_overview(imgs, gamma, gt)[None],
                                       "attention_masks", self.step, "val")
        if want_overlay and "regressed_state" in out:
            self._log_topdown_overlay(batch, out.regressed_state, "regressed_state_topdown")

    def _log_topdown_overlay(self, batch, predictions, name):
        """The dataset's top-down drawing of the GT and predicted states
        (logger.py:271-289 log_dataset_specific_trajectory), if its class
        has `render_trajectory`."""
        dset_cls = self._dataset_class()
        if not hasattr(dset_cls, "render_trajectory"):
            return
        host = AttrDict({k: _host(v) for k, v in batch.items()})
        im = dset_cls.render_trajectory(None, host, _host(predictions), host.end_ind)
        if "image" in im:  # [N, H, W, 3] in [0, 1]; the Logger takes [-1, 1]
            self.logger.log_images(np.asarray(im["image"]) * 2.0 - 1.0, name, self.step, "val")
        if "video" in im:
            self.logger.log_video(np.asarray(im["video"]) * 2.0 - 1.0, name, self.step, "val")

    def _dump_debug_data(self, batch, metrics):
        """Non-finite gradients: save the batch and metrics for offline
        debugging (the reference's NaN hook, base_trainer.py:40-66)."""
        path = os.path.join(self.exp_path, f"debug_nan_step{self.step}.pt")
        torch.save(dict(batch={k: v.cpu() for k, v in batch.items()},
                        metrics=metrics), path)
        print(f"WARNING: non-finite gradients at step {self.step}; dumped {path}")


def main(argv=None):
    try:
        ModelTrainer(parse_args(argv)).run()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
