"""Auxiliary models attached to the predictor (models/aux_models.py of the
JAX package): length predictor, inverse model, cost model, state regressor,
with their losses and the cost model's training targets."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core import distributions
from video_gcp_torch.core.losses import ce_logits_loss, l2_loss
from video_gcp_torch.models.nets import MLP


def gather_t(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, ...], idx [B] -> x[b, idx[b]] of shape [B, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


class LengthPredictor(nn.Module):
    """p(seq_len | e_0, e_g) as logits over max_seq_len."""

    def __init__(self, hp):
        super().__init__()
        self.mlp = nn.ModuleList([MLP(2 * hp["nz_enc"], hp["max_seq_len"],
                                      hp["nz_mid"], hp["n_processing_layers"])])

    def forward(self, e_0: torch.Tensor, e_g: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None) -> AttrDict:
        """The length is sampled from the logits by the inverse CDF at
        uniforms `u` [B], which the caller owns (the CEM simulator's) or
        which are drawn from `generator`; without either it is their argmax
        (the JAX model's rng=None branch)."""
        logits = self.mlp[0](e_0, e_g)
        if u is None and generator is None:
            sampled = torch.argmax(logits, dim=-1)
        else:
            if u is None:
                u = torch.rand(logits.shape[0], generator=generator, device=logits.device)
            cdf = torch.cumsum(torch.softmax(logits.float(), dim=-1), dim=-1)
            sampled = torch.searchsorted(cdf, u.to(cdf)[:, None], right=True)[:, 0]
            sampled = torch.clamp(sampled, max=logits.shape[-1] - 1)
        # predicted length >= 3 for planning (base_gcp.py:223)
        return AttrDict(seq_len_logits=logits,
                        end_ind_pred=torch.clamp(sampled, min=2))

    @staticmethod
    def loss(outputs: AttrDict, end_ind: torch.Tensor, weight: float) -> AttrDict:
        return AttrDict(seq_len=ce_logits_loss(outputs.seq_len_logits, end_ind,
                                               weight=weight))


class InverseModel(nn.Module):
    """action_t = MLP(e_t, e_{t+1})."""

    def __init__(self, p, in_size: int):
        super().__init__()
        self.mlp = nn.ModuleList([MLP(2 * in_size, p["n_actions"],
                                      p.get("nz_mid", 32),
                                      p.get("n_processing_layers", 3))])

    def forward(self, enc_seq_0: torch.Tensor, enc_seq_1: torch.Tensor) -> torch.Tensor:
        return self.mlp[0](enc_seq_0, enc_seq_1)

    @staticmethod
    def loss(actions_pred, actions_gt, pad_mask, weight: float = 1.0) -> AttrDict:
        n = actions_pred.shape[1]
        return AttrDict(action_reconst=l2_loss(
            actions_pred, actions_gt[:, :n], weights=pad_mask[:, :n, None],
            weight=weight))


class CostModel(nn.Module):
    """cost(e_start, e_end) -> scalar."""

    def __init__(self, p, in_size: int):
        super().__init__()
        self.mlp = nn.ModuleList([MLP(2 * in_size, 1, p.get("nz_mid", 128),
                                      p.get("n_processing_layers", 3))])

    def forward(self, enc_start: torch.Tensor, enc_end: torch.Tensor) -> torch.Tensor:
        return self.mlp[0](enc_start, enc_end)

    @staticmethod
    def sample_targets(generator: torch.Generator, model_enc_seq: torch.Tensor,
                       traj_seq: torch.Tensor, end_ind: torch.Tensor):
        """A random index pair per example and the GT path length between
        them: the cumulative frame-to-frame distance of traj_seq
        (cost_mdl.py:82-100). Latents and target carry no gradient."""
        b = end_ind.shape[0]
        dev = end_ind.device
        u1 = distributions.uniform((b,), generator, dev)
        u2 = distributions.uniform((b,), generator, dev)
        end = end_ind.to(torch.float32)
        start_idx = (u1 * (end - 1.0)).to(torch.int64)
        end_idx = (u2 * (end - (start_idx + 1)) + (start_idx + 1)).to(torch.int64)
        start = gather_t(model_enc_seq, start_idx).detach()
        stop = gather_t(model_enc_seq, end_idx).detach()
        flat = traj_seq.reshape(traj_seq.shape[:2] + (-1,))
        step_len = torch.linalg.vector_norm(flat[:, 1:] - flat[:, :-1], dim=-1)
        cum = torch.cat([step_len.new_zeros(b, 1), torch.cumsum(step_len, 1)], 1)
        gt_cost = gather_t(cum, end_idx) - gather_t(cum, start_idx)
        return start, stop, gt_cost[:, None].detach()

    @staticmethod
    def loss(cost_pred, cost_target) -> AttrDict:
        return AttrDict(cost_estimation=l2_loss(cost_pred, cost_target))


class StateRegressor(nn.Module):
    """MLP from node latents to states."""

    def __init__(self, hp):
        super().__init__()
        self.mlp = nn.ModuleList([MLP(hp["nz_enc"], hp["state_dim"],
                                      hp["nz_mid"], hp["n_processing_layers"])])

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        return self.mlp[0](latents)
