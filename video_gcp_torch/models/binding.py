"""Node-to-frame binding (models/binding.py of the JAX package): how the
predicted tree nodes attach to the ground-truth frames.

- BalancedBinding (frame_binding.py:37-99): closed-form one-hot match
  distributions of the midpoint schedule, the reconstruction loss of the
  matched nodes, and an existence predictor that prunes nodes.
- AdaptiveBinding (adaptive_binding/adaptive.py:17-135): a detached cost
  matrix (node images or latents against the frames) through the soft-DTW
  posterior (ops/soft_dtw.py, kernel K3 on the card); the expected Gaussian
  NLL of every node against every frame weighted by that posterior; and a
  distance predictor that prunes near-duplicate consecutive nodes.

Both share one interface for the tree model: `logits_key` names the
pruning logits in the outputs. Masks are fixed-shape [B, N] over df-ordered
nodes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.distributions import normalize
from video_gcp_torch.core.losses import (
    bce_logits_loss,
    gaussian_nll_loss,
    penalty_loss,
)
from video_gcp_torch.core.schedules import matching_temp_at
from video_gcp_torch.models import dlm
from video_gcp_torch.models.nets import MLP
from video_gcp_torch.ops.cdist import batch_cdist
from video_gcp_torch.ops.soft_dtw import soft_dtw, soft_dtw_stability_gap
from video_gcp_torch.ops.tree_index import (
    balanced_timesteps,
    breadthfirst2depthfirst,
    depthfirst2breadthfirst,
)


def balanced_match_dists(depth: int, end_ind: torch.Tensor,
                         max_seq_len: int) -> torch.Tensor:
    """One-hot match distributions of the balanced schedule, bf order
    [B, 2^depth - 1, max_seq_len]: one-hot at trunc(timestep), zeroed where
    the node's timestep equals a parent's truncated timestep
    (frame_binding.py:42-50)."""
    ts = balanced_timesteps(depth, end_ind)
    t_idx = torch.arange(max_seq_len, device=end_ind.device)
    one_hot = (torch.trunc(ts).long()[..., None] == t_idx).float()

    b = end_ind.shape[0]
    t_l = [torch.full((b, 1), -1.0, device=end_ind.device)]
    t_r = [end_ind.float()[:, None] + 1.0]
    for d in range(1, depth):
        mid = ts[:, 2 ** (d - 1) - 1:2 ** d - 1]
        t_l.append(torch.stack([t_l[-1], mid], 2).reshape(b, -1))
        t_r.append(torch.stack([mid, t_r[-1]], 2).reshape(b, -1))
    t_l, t_r = torch.cat(t_l, 1), torch.cat(t_r, 1)
    collide = (torch.trunc(t_l) == ts) | (torch.trunc(t_r) == ts)
    return torch.where(collide[:, :, None], torch.zeros_like(one_hot), one_hot)


class BalancedBinding(nn.Module):
    logits_key = "existence_logits"

    def __init__(self, hp):
        super().__init__()
        self.hp = hp
        self.existence_predictor = MLP(hp["nz_enc"], 1, hp["nz_mid"],
                                       hp["n_processing_layers"])

    def prune_logits(self, e_g_prime_bf: torch.Tensor) -> torch.Tensor:
        """Existence logits per df node (frame_binding.py:67-78)."""
        return self.existence_predictor(
            breadthfirst2depthfirst(e_g_prime_bf))[..., 0]

    @staticmethod
    def prune_mask(logits: torch.Tensor) -> torch.Tensor:
        """[B, N] keep-mask over df nodes; the first node is always kept."""
        keep = torch.sigmoid(logits) > 0.5
        keep[:, 0] = True
        return keep

    def root_bounds(self, inputs: AttrDict, end_ind: torch.Tensor):
        """Match-timestep bounds of the virtual root: (-1, end + 1)
        (frame_binding.py:62-65)."""
        return (torch.full_like(end_ind, -1, dtype=torch.float32),
                end_ind.to(torch.float32) + 1.0)

    def get_w(self, inputs: AttrDict, outputs: AttrDict, step=0) -> torch.Tensor:
        return balanced_match_dists(self.hp["hierarchy_levels"], inputs.end_ind,
                                    self.hp["max_seq_len"])

    def reconstruction_loss(self, inputs: AttrDict, outputs: AttrDict,
                            log_sigma: torch.Tensor) -> AttrDict:
        """NLL of the per-frame matched node (the argmax of w over nodes,
        frame_binding.py:28-34 and 88-99) against the GT frame: the DLM NLL
        under the discrete-logistic-mixture decoder, else the Gaussian NLL
        with the global log_sigma."""
        idx = torch.argmax(outputs.gt_match_dists, dim=1)  # [B, T]
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        estimates = outputs.tree.images[rows, idx]
        outputs.soft_matched_estimates = estimates.detach()
        weight = self.hp["dense_img_rec_weight"]
        if outputs.tree.get("dlm_params") is not None:
            nll_mat = dlm.nll(outputs.tree.dlm_params[rows, idx], inputs.traj_seq)
            return AttrDict(dense_img_rec=penalty_loss(
                nll_mat * inputs.pad_mask[:, :, None, None], weight=weight,
                breakdown=1, reduction=[-1, -2]))
        pad = inputs.pad_mask.reshape(
            inputs.pad_mask.shape + (1,) * (inputs.traj_seq.dim() - 2))
        return AttrDict(dense_img_rec=gaussian_nll_loss(
            estimates, inputs.traj_seq, log_sigma, weights=pad, weight=weight,
            breakdown=1))

    def loss(self, outputs: AttrDict) -> AttrDict:
        """Existence BCE: a df node exists where it matches a frame."""
        target = breadthfirst2depthfirst(outputs.gt_match_dists).sum(2)
        return AttrDict(existence_predictor=bce_logits_loss(
            outputs.existence_logits, target))


class AdaptiveBinding(nn.Module):
    logits_key = "distance_logits"

    def __init__(self, hp):
        super().__init__()
        self.hp = hp
        # soft-DTW with no horizontal transitions needs >= 1 node per frame:
        # raised at build, not deep in the loss
        n_nodes = 2 ** hp["hierarchy_levels"] - 1
        if n_nodes < hp["max_seq_len"]:
            raise ValueError(
                f"adaptive (soft-DTW) matching requires 2^hierarchy_levels-1 "
                f">= max_seq_len nodes, got {n_nodes} nodes for "
                f"max_seq_len={hp['max_seq_len']}; raise hierarchy_levels to >= "
                f"{int(np.ceil(np.log2(hp['max_seq_len'] + 1)))}")
        if hp["matching_type"] not in ("dtw_image", "dtw_latent"):
            raise ValueError(f"unknown matching_type {hp['matching_type']!r}")
        self.distance_predictor = MLP(2 * hp["nz_enc"], 1, hp["nz_mid"],
                                      hp["n_processing_layers"])
        if hp.get("learn_matching_temp", True):
            self.log_temp = nn.Parameter(torch.tensor(math.log(hp["matching_temp"])))

    @staticmethod
    def root_bounds(inputs: AttrDict, end_ind: torch.Tensor):
        """Match-timestep bounds of the virtual root: (start, end)
        (frame_binding.py:19-20)."""
        start = inputs.get("start_ind")
        start = torch.zeros_like(end_ind) if start is None else start
        return start.to(torch.float32), end_ind.to(torch.float32)

    def matching_temp(self, step):
        hp = self.hp
        if hp.get("learn_matching_temp", True):
            return torch.exp(self.log_temp)
        return matching_temp_at(step, hp["matching_temp"],
                                hp.get("matching_temp_tenthlife", -1),
                                hp.get("matching_temp_min", 1e-3))

    def get_w(self, inputs: AttrDict, outputs: AttrDict, step=0) -> torch.Tensor:
        """Soft-DTW posterior over node-frame matches (adaptive.py:32-60):
        bf-ordered [B, N, T], normalized over nodes. Nothing here takes a
        gradient: the cost is detached, as in the JAX package. Sets
        outputs.soft_dtw_stability_gap, the raw marginals' drift from 1."""
        with torch.no_grad():
            if self.hp["matching_type"] == "dtw_image":
                nodes_df = breadthfirst2depthfirst(outputs.tree.images)
                cost = batch_cdist(nodes_df, inputs.traj_seq, reduction="mean")
            else:
                nodes_df = breadthfirst2depthfirst(outputs.tree.e_g_prime)
                cost = batch_cdist(nodes_df, inputs.enc_traj_seq, reduction="mean")
            cost = self._hack_weights_df(cost)
            w = soft_dtw(cost / self.matching_temp(step), inputs.end_ind)
            outputs.soft_dtw_stability_gap = soft_dtw_stability_gap(w)
            return depthfirst2breadthfirst(normalize(w, 1))

    def _hack_weights_df(self, cost: torch.Tensor) -> torch.Tensor:
        """Top bias on the first levels' nodes in df order
        (binding_loss.WeightsHacker.hack_weights_df:81-91)."""
        hp = self.hp
        if hp.get("top_bias", 1.0) == 1.0:
            return cost
        n_top_layers = int(np.log2(hp["n_top_bias_nodes"] + 1))
        depth = int(np.log2(cost.shape[1] + 1))
        m = np.ones(cost.shape[1], dtype=np.float32)
        for l in range(n_top_layers):
            m[2 ** (depth - l - 1) - 1::2 ** (depth - l)] = hp["top_bias"]
        return cost * torch.as_tensor(m, device=cost.device)[None, :, None]

    def _hack_weights_bf(self, weights: torch.Tensor) -> torch.Tensor:
        """Leaves and top bias on bf-ordered per-node weights
        (binding_loss.WeightsHacker.hack_weights:67-78)."""
        hp = self.hp
        max_seq_len = hp["max_seq_len"]
        if abs(hp.get("leaves_bias", 0.0)) > 0.0:
            weights = torch.cat([weights[:, :-max_seq_len],
                                 weights[:, -max_seq_len:] * (1 - hp["leaves_bias"])], 1)
        if hp.get("top_bias", 1.0) != 1.0:
            n = hp["n_top_bias_nodes"]
            weights = torch.cat([weights[:, :n] * hp["top_bias"], weights[:, n:]], 1)
        return weights

    def reconstruction_loss(self, inputs: AttrDict, outputs: AttrDict,
                            log_sigma: torch.Tensor) -> AttrDict:
        """Expected Gaussian NLL of every node against every frame, weighted
        by the match distribution (binding_loss.LossAveragingCriterion.loss:
        19-42). It rests on the Gaussian decoder's cdist factorization, so
        the discrete-logistic-mixture decoder raises, as the JAX package's
        assertion does."""
        if outputs.tree.get("dlm_params") is not None:
            raise ValueError("adaptive binding requires "
                             "decoder_distribution='gaussian'")
        predictions = outputs.tree.images  # [B, N, ...] bf
        w = outputs.gt_match_dists  # [B, N, T] bf
        loss_val = batch_cdist(predictions, inputs.traj_seq, reduction="sum")
        log_sigmas = log_sigma - torch.log(self._hack_weights_bf(torch.ones_like(loss_val)))
        n = int(np.prod(predictions.shape[2:]))
        loss_val = (0.5 * loss_val * torch.exp(-2.0 * log_sigmas)
                    + n * (log_sigmas + 0.5 * math.log(2 * math.pi)))
        loss_val = loss_val * (w * inputs.pad_mask[:, None])
        with torch.no_grad():
            outputs.soft_matched_estimates = torch.einsum(
                "bnt,bn...->bt...", w.to(predictions.dtype), predictions)
        return AttrDict(dense_img_rec=penalty_loss(
            loss_val, weight=self.hp["dense_img_rec_weight"], breakdown=2,
            reduction=[-1, -2]))

    def prune_logits(self, e_g_prime_bf: torch.Tensor) -> torch.Tensor:
        """Distance-predictor logits between consecutive df nodes, [B, N-1]
        (adaptive.py:62-77): high where the later node repeats a frame."""
        latents_df = breadthfirst2depthfirst(e_g_prime_bf)
        return self.distance_predictor(latents_df[:, :-1], latents_df[:, 1:])[..., 0]

    def prune_mask(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, N] keep-mask over df nodes; the first node is always kept."""
        close = torch.sigmoid(logits) > self.hp.get("learned_pruning_threshold", 0.5)
        return torch.cat([torch.ones_like(close[:, :1]), ~close], 1)

    def loss(self, outputs: AttrDict) -> AttrDict:
        """Distance BCE: target 1 where two consecutive df nodes match the
        same frame best."""
        best = torch.argmax(breadthfirst2depthfirst(outputs.gt_match_dists), dim=-1)
        target = (best[:, 1:] == best[:, :-1]).to(torch.float32)
        return AttrDict(distance_predictor=bce_logits_loss(
            outputs.distance_logits, target))
