"""Top-of-100 evaluation protocol (evaluation/evaluator.py of the JAX
package; gcp/evaluation/compute_metrics.py:49-393).

Per val batch the model draws `top_of` prior samples. Each is one batched
'test'/'prior' forward under torch.inference_mode() with its own draws from
the caller's torch.Generator; the prediction is aligned to the GT timeline
by the pruning scheme (eval_binding.dense_sample), the first and last
(conditioning) frames are cropped and padded frames masked, PSNR, SSIM and
MSE are averaged per sequence, and the best sample per sequence (by
`top_comp_metric`, MSE by default) is kept on the device with torch.where.
Only the [B, top_of] metric arrays and the best frames come back to the
host, once per batch.

Dumps: `metrics/results_{it}.txt` and the printed CSV line (best mean, best
std, per-sample std per metric; compute_metrics.py:184-195), the .npy
sequences in the reference's channel-first layout [B, T, C, H, W] so the
offline FVD and LPIPS tools read them unchanged, and image strips and gifs
through the eval logger.

The prior forward reads only the start and goal frames, the end index,
injected latents `z` if given and the actions, which only an
action-conditioned model (VMPC) reads: the JAX program also encodes the
sequence, a value no output uses, which XLA drops.

`use_images=False` scores a `use_convs=False` model's state vectors
[B, T, D]: only the per-frame vector MSE, with the same crop and mask, and
no sequence dumps (JAX evaluator.py:84-96, 221).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.metrics import mse, psnr, ssim, to_float_images
from video_gcp_torch.evaluation.eval_binding import dense_sample
from video_gcp_torch.evaluation.eval_logger import FileEvalLogger
from video_gcp_torch.evaluation.visualization import seq_strip
from video_gcp_torch.load import set_float32_precision
from video_gcp_torch.ops.tree_index import breadthfirst2depthfirst

LOWER_IS_BETTER = ["mse"]  # psnr and ssim: higher is better
PRIOR_INPUTS = ("I_0", "I_g", "end_ind", "start_ind", "z", "actions")


class Evaluator:
    N_PLOTTED_ELEMENTS = 5

    def __init__(self, model, logdir: str, hp, max_seq_len: int,
                 pruning_scheme: str = "dtw", top_of_100: bool = True,
                 top_comp_metric: str = "mse", use_images: bool = True,
                 eval_logger=None):
        set_float32_precision()  # SSIM's window sums need full float32
        self.model = model
        self._logdir = os.path.join(logdir, "metrics")
        os.makedirs(self._logdir, exist_ok=True)
        self._eval_logger = eval_logger or FileEvalLogger(self._logdir)
        self._pruning_scheme = pruning_scheme
        self._top_of = 100 if top_of_100 else 1
        self._metric = top_comp_metric
        self._max_seq_len = max_seq_len
        self._use_images = use_images
        self.full_evaluation = None

    def _eval_sample(self, inputs: AttrDict, generator: torch.Generator):
        """One prior sample of the batch: (per-sequence metrics [B] each,
        the dense prediction [B, T, ...], a tree's nodes in df order or the
        sequential model's rollout)."""
        with torch.inference_mode():
            out = self.model(AttrDict({k: inputs[k] for k in PRIOR_INPUTS if k in inputs}),
                             phase="test", mode="prior", generator=generator)
            gen = dense_sample(out, inputs, self._pruning_scheme, self._max_seq_len)
            t_idx = torch.arange(inputs.traj_seq.shape[1], device=gen.device)[None, :]
            valid = ((t_idx >= 1) & (t_idx <= inputs.end_ind[:, None] - 1)
                     & (inputs.pad_mask > 0))
            denom = torch.clamp(valid.sum(1), min=1)
            if self._use_images:
                m = AttrDict({name: (fn(gen, inputs.traj_seq) * valid).sum(1) / denom
                              for name, fn in (("mse", mse), ("psnr", psnr), ("ssim", ssim))})
            else:  # the image metrics would reduce the batch axis of [B, T, D]
                err = torch.mean((gen - inputs.traj_seq) ** 2, dim=-1)
                m = AttrDict(mse=(err * valid).sum(1) / denom)
            full = breadthfirst2depthfirst(out.tree.images) if "tree" in out else gen
            return m, gen, full

    def eval(self, inputs, generator: torch.Generator) -> AttrDict:
        """The protocol on one batch; returns (and accumulates for the dumps)
        every sample's metrics [B, top_of], the best sample per sequence and
        `N_PLOTTED_ELEMENTS` further single samples."""
        inputs = AttrDict(inputs)
        inputs.traj_seq = to_float_images(inputs.traj_seq)
        lower = self._metric in LOWER_IS_BETTER
        per_sample = []
        best_val = best_gen = best_full = None
        for _ in range(self._top_of):
            m, gen, full = self._eval_sample(inputs, generator)
            per_sample.append(m)
            crit = m[self._metric]
            if best_val is None:
                best_val, best_gen, best_full = crit, gen, full
                continue
            better = crit < best_val if lower else crit > best_val
            best_gen = torch.where(better.reshape((-1,) + (1,) * (gen.dim() - 1)),
                                   gen, best_gen)
            best_full = torch.where(better.reshape((-1,) + (1,) * (full.dim() - 1)),
                                    full, best_full)
            best_val = torch.where(better, crit, best_val)
        metrics = AttrDict({k: torch.stack([m[k] for m in per_sample], 1).cpu().numpy()
                            for k in per_sample[0]})
        rand_seqs = [self._eval_sample(inputs, generator)[1].cpu().numpy()
                     for _ in range(min(self.N_PLOTTED_ELEMENTS, self._top_of))]
        result = AttrDict(metrics=metrics, best_gen=best_gen.cpu().numpy(),
                          best_full=best_full.cpu().numpy(),
                          gt_seq=inputs.traj_seq.cpu().numpy(),
                          end_ind=inputs.end_ind.cpu().numpy(), rand_seqs=rand_seqs)
        self._accumulate(result)
        return result

    def _accumulate(self, result):
        if self.full_evaluation is None:
            self.full_evaluation = AttrDict(
                metrics=AttrDict({k: [] for k in result.metrics}),
                best_gen=[], best_full=[], gt_seq=[], rand_seqs=[])
        for k, v in result.metrics.items():
            self.full_evaluation.metrics[k].append(v)
        for k in ("best_gen", "best_full", "gt_seq", "rand_seqs"):
            self.full_evaluation[k].append(result[k])

    def reset(self):
        self.full_evaluation = None

    def dump_results(self, it: int) -> dict:
        summary = self.dump_metrics(it)
        if self._use_images:
            self.dump_seqs(it)
        self.reset()
        return summary

    def dump_metrics(self, it: int) -> dict:
        """Best-sample mean and std and per-sample std of each metric: the
        CSV line and `results_{it}.txt` (compute_metrics.py:184-195)."""
        metrics = {k: np.concatenate(v, 0) for k, v in self.full_evaluation.metrics.items()}
        pick = np.argmin if self._metric in LOWER_IS_BETTER else np.argmax
        best_idx = pick(metrics[self._metric], axis=1)
        print_st, summary, lines = [], {}, []
        for name in sorted(metrics):
            vals = metrics[name]
            best = vals[np.arange(vals.shape[0]), best_idx]
            print_st.extend([best.mean(), best.std(), vals.std(axis=1).mean()])
            summary[name] = float(best.mean())
            lines.append(f"{name}: best_mean {best.mean():.6f} best_std {best.std():.6f} "
                         f"sample_std {vals.std(axis=1).mean():.6f}")
            self._eval_logger.log_metric(name, vals if self._top_of > 1 else None, best, it)
        print(*print_st, sep=",")
        with open(os.path.join(self._logdir, f"results_{it}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return summary

    def dump_seqs(self, it: int):
        """.npy dumps in the reference layout [B, T, C, H, W]
        (compute_metrics.py:199-226), then GT-vs-best strips and gifs."""
        gt = np.concatenate(self.full_evaluation.gt_seq, 0)[:, 1:]
        gen = np.concatenate(self.full_evaluation.best_gen, 0)[:, 1:]
        full = np.concatenate(self.full_evaluation.best_full, 0)

        def to_cf(x):
            return np.transpose(x, (0, 1, 4, 2, 3))

        np.save(os.path.join(self._logdir, f"gt_seq_{it}.npy"), to_cf(gt))
        np.save(os.path.join(self._logdir, f"gen_images_{it}.npy"), to_cf(gen))
        np.save(os.path.join(self._logdir, f"full_gen_seq_{it}.npy"), to_cf(full))
        first_batch_samples = self.full_evaluation.rand_seqs[0]
        if first_batch_samples:
            samples = np.stack(first_batch_samples, 1)  # [B, S, T, H, W, C]
            np.save(os.path.join(self._logdir, f"seq_samples_{it}.npy"),
                    np.transpose(samples[: self.N_PLOTTED_ELEMENTS], (0, 1, 2, 5, 3, 4)))
        for i in range(min(self.N_PLOTTED_ELEMENTS, gt.shape[0])):
            strip = np.concatenate([seq_strip(gt[i][None]), seq_strip(gen[i][None])], axis=0)
            self._eval_logger.log_image(strip, "gt_vs_best", i, it)
            self._eval_logger.log_gif(gen[i], "best_gen", i, it)
