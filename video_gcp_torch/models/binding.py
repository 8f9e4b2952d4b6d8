"""Balanced node-to-frame binding (models/binding.py of the JAX package):
closed-form one-hot match distributions, the reconstruction loss of the
matched nodes, and the existence predictor that prunes nodes. Masks are
fixed-shape [B, N] over df-ordered nodes."""
from __future__ import annotations

import torch
import torch.nn as nn

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.losses import (
    bce_logits_loss,
    gaussian_nll_loss,
    penalty_loss,
)
from video_gcp_torch.models import dlm
from video_gcp_torch.models.nets import MLP
from video_gcp_torch.ops.tree_index import (
    balanced_timesteps,
    breadthfirst2depthfirst,
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

    def get_w(self, inputs: AttrDict) -> torch.Tensor:
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
