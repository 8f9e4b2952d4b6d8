"""Sequential goal-conditioned predictor, an SVG-style VRNN
(models/sequential.py of the JAX package; gcp/prediction/models/sequential.py:13-131
and the blox VRNNCell it wraps).

The JAX package rolls the cell with one `nn.scan` over max_seq_len - 1
steps; here the cell is an nn.Module stepped by a Python loop. Per step:

    p_z_t = prior(h_t)                     (learned prior from the LSTM state)
    q_z_t = q(h_t, x'_t)                   (the posterior sees the GT next frame)
    z_t   ~ q (posterior mode) | p (prior mode) | injected (planning)
    h_{t+1}, o_t = LSTM(h_t, [x_t, z_t, context])
    x_{t+1} = tanh(W o_t)                  (the next frame's latent)

Frames decode through the shared ConvDecoder, and the GT first frame I_0 is
prepended (sequential.py:57).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.distributions import Gaussian
from video_gcp_torch.core.losses import (
    gaussian_nll_loss,
    kl_divergence_loss,
    l2_loss,
    penalty_loss,
)
from video_gcp_torch.models import dlm
from video_gcp_torch.models.base import BaseGCPModel
from video_gcp_torch.models.nets import (
    MLP,
    Casting,
    GaussianHead,
    LSTMStack,
    linear,
    lstm_state_size,
    set_compute_dtype,
)


class VRNNCell(Casting, nn.Module):
    """One VRNN step over the packed LSTM state (blox VRNNCell). The output
    projection computes in the compute dtype; its tanh runs in the
    parameters' dtype, as the JAX cell's in float32."""

    def __init__(self, hp):
        super().__init__()
        nz_enc, nz_vae, mid, n = (hp["nz_enc"], hp["nz_vae"], hp["nz_mid"],
                                  hp["n_processing_layers"])
        size = hp["nz_mid_lstm"]
        self.lstm = LSTMStack(nz_enc + nz_vae + 2 * nz_enc, size, hp["n_lstm_layers"])
        self.prior_head = GaussianHead(size, nz_vae, mid, n)
        self.inf_head = GaussianHead(size + nz_enc, nz_vae, mid, n)
        self.out_proj = nn.Linear(size, nz_enc)

    def forward(self, state, x, context, x_prime: Optional[torch.Tensor],
                z_ext: Optional[torch.Tensor], mode: str,
                generator: Optional[torch.Generator]):
        h_top = state[..., -self.lstm.size:]  # the top layer's h
        p_z = self.prior_head(h_top)
        q_z = self.inf_head(h_top, x_prime) if x_prime is not None else p_z
        if z_ext is not None:
            z = p_z.reparametrize(z_ext)
        elif mode == "posterior" and x_prime is not None:
            z = q_z.sample(generator)
        else:
            z = p_z.sample(generator)
        new_state, out = self.lstm(state, torch.cat([x, z, context], dim=-1))
        dt, pdt = self.dtypes(self.out_proj.weight)
        x_next = torch.tanh(linear(self.out_proj, out, dt).to(pdt))
        return new_state, x_next, q_z, p_z


class SequentialModel(BaseGCPModel):
    """SVG-style dense predictor (SequentialModel / SequentialRecModule).

    `dtype` is the compute dtype over the parameters, as in TreeModel."""

    def __init__(self, hp, dtype: Optional[torch.dtype] = None):
        super().__init__(hp)
        hp = self.hp
        if hp.get("use_conv_lstm", False):
            raise NotImplementedError(
                "use_conv_lstm (ConvLSTMStack) is not ported yet (ROADMAP item 10)")
        if self.use_dlm:
            # the log sigma serves only the Gaussian decoder's NLL; flax
            # creates the parameter where it is first used, so the JAX
            # model has none under the DLM decoder
            del self.log_sigma_mod
        self.cell = VRNNCell(hp)
        self.init_mlp = MLP(3 * hp["nz_enc"], lstm_state_size(hp), hp["nz_mid"],
                            hp["n_processing_layers"])
        if self.regress_decoder_actions:
            # decoder-side action regression (base_gcp.py:80)
            self.action_head = MLP(hp["nz_enc"], hp["n_actions"], hp["nz_mid"],
                                   hp["n_processing_layers"])
        set_compute_dtype(self, dtype)

    def predict_sequence(self, inputs: AttrDict, outputs: AttrDict, mode: str,
                         generator: Optional[torch.Generator]) -> AttrDict:
        t_steps = self.hp["max_seq_len"] - 1
        context = torch.cat([inputs.e_0, inputs.e_g], dim=-1)
        state, x = self.init_mlp(inputs.e_0, context), inputs.e_0
        x_primes = inputs.get("enc_traj_seq")
        z = inputs.get("z")
        if z is not None:
            # planner latents may come with T entries; the rollout uses T-1
            z = z[:, :t_steps].to(self.param_dtype)
        xs, q_zs, p_zs = [], [], []
        for t in range(t_steps):
            state, x, q_z, p_z = self.cell(
                state, x, context, None if x_primes is None else x_primes[:, t + 1],
                None if z is None else z[:, t], mode, generator)
            xs.append(x)
            q_zs.append(q_z)
            p_zs.append(p_z)
        encodings = torch.stack(xs, 1)  # [B, T-1, nz_enc]
        outputs.dense_rec = AttrDict(
            encodings=encodings,
            q_z=Gaussian(torch.stack([g.mu for g in q_zs], 1),
                         torch.stack([g.log_sigma for g in q_zs], 1)),
            p_z=Gaussian(torch.stack([g.mu for g in p_zs], 1),
                         torch.stack([g.log_sigma for g in p_zs], 1)))
        images, dlm_params = self.decode_seq(encodings, inputs.skips)
        outputs.dense_rec.images = torch.cat([inputs.I_0[:, None].to(images.dtype), images],
                                             dim=1)
        outputs.dense_rec.dlm_params = dlm_params
        return outputs

    def forward(self, inputs: AttrDict, phase: str = "test", mode: str = "prior",
                pred_length: bool = False, generator: Optional[torch.Generator] = None,
                step=0) -> AttrDict:
        """The inputs and outputs of TreeModel.forward, with the dense
        rollout in `outputs.dense_rec` (encodings, q_z, p_z, images and the
        DLM parameters) in place of the tree; injected latents `z` are
        [B, T-1 (or T), nz_vae], one per step."""
        if phase not in ("train", "test", "plan") or mode not in ("prior", "posterior"):
            raise ValueError(f"unknown phase/mode {phase!r}/{mode!r}")
        if mode == "posterior" and "traj_seq" not in inputs:
            raise ValueError("mode='posterior' infers latents from inputs.traj_seq")
        inputs = self.run_encoder(self.preprocess_inputs(inputs))
        outputs = AttrDict()
        self.get_end_ind(inputs, outputs, pred_length,
                         None if mode == "posterior" else generator)
        self.predict_sequence(inputs, outputs, mode, generator)
        losses = AttrDict()
        if "traj_seq" in inputs and phase == "train":
            losses = self.compute_losses(inputs, outputs, step)
            inputs.model_enc_seq = torch.cat([inputs.e_0[:, None],
                                              outputs.dense_rec.encodings], dim=1)
            outputs.update(self.run_aux_models(inputs, phase, generator))
            losses.update(self.aux_losses(inputs, outputs))
            losses = self.assemble_total(inputs, losses)
        if phase == "plan":
            outputs.update(self.plan_outputs(inputs, outputs))
        outputs.losses = losses
        return outputs

    def plan_outputs(self, inputs: AttrDict, outputs: AttrDict) -> AttrDict:
        """Planner-facing dense outputs (the cem_simulator contract)."""
        lat = torch.cat([inputs.e_0[:, None], outputs.dense_rec.encodings], dim=1)
        plan = AttrDict(timeline_images=outputs.dense_rec.images, timeline_latents=lat)
        if self.hp["attach_inv_mdl"]:
            plan.actions = self.inv_mdl(lat[:, :-1], lat[:, 1:])
        if self.hp["attach_state_regressor"]:
            plan.regressed_state = self.state_regressor(lat)
        return plan

    def compute_losses(self, inputs: AttrDict, outputs: AttrDict, step) -> AttrDict:
        """The dense reconstruction NLL and the per-step KL
        (sequential.py:60-68), and the decoder's action regression."""
        hp = self.hp
        losses = AttrDict()
        target = inputs.traj_seq[:, 1:]
        pad = inputs.pad_mask[:, 1:]
        if outputs.dense_rec.dlm_params is not None:
            nll_mat = dlm.nll(outputs.dense_rec.dlm_params, target)
            losses.dense_img_rec = penalty_loss(nll_mat * pad[:, :, None, None],
                                                weight=hp["dense_img_rec_weight"],
                                                breakdown=1, reduction=[-1, -2])
        else:
            pred = outputs.dense_rec.images[:, 1:]  # the first frame is the GT I_0
            w = pad.reshape(pad.shape + (1,) * (target.dim() - 2))
            losses.dense_img_rec = gaussian_nll_loss(
                pred, target, self.log_sigma(), weights=w,
                weight=hp["dense_img_rec_weight"], breakdown=1)
        if self.regress_decoder_actions and "actions" in inputs:
            pred_a = self.apply_action_activation(
                self.action_head(outputs.dense_rec.encodings))
            n = min(pred_a.shape[1], inputs.actions.shape[1])
            losses.dense_action_rec = l2_loss(
                pred_a[:, :n], inputs.actions[:, :n],
                weights=inputs.pad_mask[:, 1:n + 1, None],
                weight=hp["dense_action_rec_weight"])
        losses.kl = kl_divergence_loss(outputs.dense_rec.q_z, outputs.dense_rec.p_z,
                                       weights=pad[:, :, None], weight=self.kl_weight(step),
                                       free_nats_per_dim=hp["free_nats"], breakdown=1)
        return losses
