"""Approximate posteriors q(z | e_l, e_r, evidence) (models/inference.py of
the JAX package):

- MatchedInference: the (temporally encoded) sequence at the node's
  matching timestep (gcp/prediction/models/tree/inference.py:9-43);
- AttentiveInference: multi-head attention of the (e_l, e_r) query over the
  encoded sequence, masked to the active segment
  (adaptive_binding/attentive_inference.py:11-86), used when
  hp.attentive_inference (the gcp_adaptive configs).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.nets import (
    MLP,
    FixedPriorHead,
    GaussianHead,
    MaskedMultiheadAttention,
)


def gather_timestep(seq: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """seq [B, T, D], float timesteps [B, N] -> [B, N, D] at the truncated,
    clipped indices (inference.py:30-33)."""
    idx = torch.clamp(torch.trunc(timesteps).long(), 0, seq.shape[1] - 1)
    return torch.gather(seq, 1, idx[..., None].expand(-1, -1, seq.shape[-1]))


def _q_head(hp) -> nn.Module:
    if hp.get("var_inf", "standard") == "deterministic":
        return FixedPriorHead(hp["nz_vae"])
    return GaussianHead(3 * hp["nz_enc"], hp["nz_vae"], hp["nz_mid"],
                        hp["n_processing_layers"])


class MatchedInference(nn.Module):
    def __init__(self, hp):
        super().__init__()
        self.deterministic = hp.get("var_inf", "standard") == "deterministic"
        self.q = _q_head(hp)

    def forward(self, inf_enc_seq: torch.Tensor, e_l: torch.Tensor,
                e_r: torch.Tensor, timesteps: torch.Tensor) -> AttrDict:
        if self.deterministic:
            return AttrDict(q_z=self.q(e_l), gamma=None)
        e_tilde = gather_timestep(inf_enc_seq, timesteps)
        return AttrDict(q_z=self.q(e_l, e_r, e_tilde), gamma=None)


class AttentiveInference(nn.Module):
    """Query MLP on (e_l, e_r), then n_attention_layers rounds of masked
    attention, each followed by a parameter-free layer norm and a predictor
    MLP with a skip connection that refines the query; the last round's
    attended value goes through `out` into the Gaussian head
    (attentive_inference.py:47-86). Under var_inf='deterministic' only the
    fixed prior is built, as flax creates no other parameter then."""

    def __init__(self, hp):
        super().__init__()
        self.deterministic = hp.get("var_inf", "standard") == "deterministic"
        self.q = _q_head(hp)
        if self.deterministic:
            return
        nz_enc, d_key = hp["nz_enc"], hp["nz_attn_key"]
        n_layers = hp.get("n_attention_layers", 1)
        self.query_net = MLP(2 * nz_enc, d_key, hp["nz_mid"],
                             hp["n_processing_layers"])
        self.attention_layers = nn.ModuleList(
            MaskedMultiheadAttention(hp, d_key) for _ in range(n_layers))
        self.predictor_layers = nn.ModuleList(
            MLP(nz_enc, d_key, hp["nz_mid"], 2) for _ in range(n_layers))
        self.out = nn.Linear(nz_enc, nz_enc)

    def forward(self, inf_enc_seq: torch.Tensor, inf_enc_key_seq: torch.Tensor,
                e_l: torch.Tensor, e_r: torch.Tensor, start_ind: torch.Tensor,
                end_ind: torch.Tensor) -> AttrDict:
        """Node-axis arguments [B, N, ...]; sequences [B, T, nz_enc];
        start_ind and end_ind [B, N], the masking bounds."""
        if self.deterministic:
            return AttrDict(q_z=self.q(e_l), gamma=None)
        query = self.query_net(e_l, e_r)
        for attn, pred in zip(self.attention_layers, self.predictor_layers):
            raw, gamma = attn(query, inf_enc_key_seq, inf_enc_seq, start_ind, end_ind)
            query = _layer_norm(pred(_layer_norm(raw)) + query)
        return AttrDict(q_z=self.q(e_l, e_r, self.out(raw)), gamma=gamma)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Layer norm without parameters: eps 1e-5, biased variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)
