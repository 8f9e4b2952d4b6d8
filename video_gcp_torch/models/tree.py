"""GCP-tree: hierarchical goal-conditioned predictor, level by level
(models/tree.py of the JAX package).

The tree is a dense breadth-first tensor [B, 2^L - 1, ...]. Each of the L
levels is one batched call over all 2^d nodes of that level: prior ->
(injected z | prior sample) -> TreeLSTM subgoal prediction. The children's
parent tensors are built by `interleave`. All 2^L - 1 nodes are then decoded
in one folded pass through the conv pyramid.

Ported: the prior rollout (`mode='prior'`, `phase` 'test' or 'plan') and
training (`phase='train'`, `mode='posterior'`): posterior latents from the
matched or the attentive inference, balanced or adaptive (soft-DTW)
matching, the reconstruction/KL/entropy losses, the existence or distance
predictor's loss, the auxiliary models and the loss total.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.distributions import Gaussian, safe_entropy
from video_gcp_torch.core.losses import LossTerm, kl_divergence_loss, penalty_loss
from video_gcp_torch.evaluation.eval_binding import basic_timeline_index
from video_gcp_torch.models.base import BaseGCPModel
from video_gcp_torch.models.binding import AdaptiveBinding, BalancedBinding
from video_gcp_torch.models.inference import AttentiveInference, MatchedInference
from video_gcp_torch.models.nets import MLP, FixedPriorHead, GaussianHead
from video_gcp_torch.models.tree_lstm import LSTMInitializer, TreeLSTMPredictor
from video_gcp_torch.ops.tree_index import depthfirst2layers, interleave


class TreeLevel(nn.Module):
    """One recursion step applied to all nodes of a level
    (tree_module.py:19-114). Node-axis arguments are [B, n, ...].

    Only the root level initializes the LSTM states of the virtual parents,
    so only a module that serves the root holds `lstm_initializer` (flax
    creates its weights on that level alone)."""

    def __init__(self, hp, serves_root: bool = True):
        super().__init__()
        self.hp = hp
        nz_enc, nz_vae = hp["nz_enc"], hp["nz_vae"]
        self.learned_prior = hp.get("prior_type", "learned") == "learned"
        if self.learned_prior:
            self.prior = GaussianHead(2 * nz_enc, nz_vae, hp["nz_mid"],
                                      hp["n_processing_layers"])
        else:
            self.prior = FixedPriorHead(nz_vae)
        self.attentive = hp["attentive_inference"]
        self.inference = (AttentiveInference(hp) if self.attentive
                          else MatchedInference(hp))
        pred_in = 2 * nz_enc + nz_vae + (2 * nz_enc if hp["context_every_step"] else 0)
        if hp["tree_lstm"]:
            self.subgoal_pred = TreeLSTMPredictor(hp, hp["tree_lstm"], pred_in)
            if serves_root:
                self.lstm_initializer = LSTMInitializer(hp)
        else:
            self.subgoal_pred = MLP(pred_in, nz_enc, hp["nz_mid"],
                                    hp["n_processing_layers"],
                                    final_activation="tanh")

    def forward(self, inputs: AttrDict, e_l, e_r, hidden_l, hidden_r, t_l, t_r,
                z_ext: Optional[torch.Tensor], mode: str,
                generator: Optional[torch.Generator]) -> AttrDict:
        sg = AttrDict()
        sg.p_z = self.prior(e_l, e_r)
        sg.match_timesteps = (t_l + t_r) / 2.0
        if z_ext is None and mode == "posterior":
            if self.attentive:
                # q(z | e_l, e_r, attention over the frames of the whole
                # sequence, or of the node's own segment)
                if self.hp.get("mask_inf_attention", False):
                    s_ind, e_ind = torch.floor(t_l), torch.ceil(t_r)
                else:
                    s_ind = inputs.start_ind[:, None].expand(t_l.shape)
                    e_ind = inputs.end_ind[:, None].expand(t_r.shape)
                sg.update(self.inference(inputs.inf_enc_seq, inputs.inf_enc_key_seq,
                                         e_l, e_r, s_ind, e_ind))
            else:
                # q(z | e_l, e_r, the sequence at the node's timestep)
                sg.update(self.inference(inputs.inf_enc_seq, e_l, e_r,
                                         sg.match_timesteps))
            z = sg.q_z.sample(generator)
        elif z_ext is not None:
            # injected latents (planner): standard normal mapped through the
            # learned prior (tree_module.py:81-82)
            z = sg.p_z.reparametrize(z_ext) if self.learned_prior else z_ext
        else:
            z = sg.p_z.sample(generator)
        if "q_z" not in sg:
            sg.q_z = sg.p_z  # prior mode: q is the prior

        pred_inputs = [e_l, e_r, z]
        if self.hp["context_every_step"]:
            pred_inputs += [inputs.e_0[:, None].expand_as(e_l),
                            inputs.e_g[:, None].expand_as(e_r)]
        if self.hp["tree_lstm"]:
            if hidden_l is None:
                hidden_l, hidden_r = self.lstm_initializer(e_l, e_r, z)
                sg.init_hidden_l, sg.init_hidden_r = hidden_l, hidden_r
            sg.hidden_state, sg.e_g_prime = self.subgoal_pred(
                hidden_l, hidden_r, *pred_inputs)
        else:
            sg.e_g_prime = self.subgoal_pred(*pred_inputs)
            sg.hidden_state = None
        sg.z = z
        return sg


class TreeModel(BaseGCPModel):
    """Start/goal encoding, level-by-level tree production, dense decode,
    pruning logits, and the planner's timeline outputs (tree.py:14-124)."""

    def __init__(self, hp):
        super().__init__(hp)
        hp = self.hp
        if self.regress_decoder_actions:
            raise NotImplementedError(
                "decoder action regression (regress_actions with "
                "one_step_planner != 'sh_pred') is only supported by the "
                "sequential model; tree configs use 'sh_pred'")
        self.depth = hp["hierarchy_levels"]
        # tied levels share one module; flax names it tree_levels_0 as well
        n_modules = self.depth if hp["untied_layers"] else 1
        self.tree_levels = nn.ModuleList(TreeLevel(hp, serves_root=(d == 0))
                                         for d in range(n_modules))
        if hp["matching_type"] == "balanced":
            self.binding = BalancedBinding(hp)
        elif "dtw" in hp["matching_type"]:
            self.binding = AdaptiveBinding(hp)
        else:
            raise NotImplementedError(hp["matching_type"])

    def predict_sequence(self, inputs: AttrDict, outputs: AttrDict,
                         end_ind: torch.Tensor, mode: str,
                         generator: Optional[torch.Generator]) -> AttrDict:
        e_l, e_r = inputs.e_0[:, None], inputs.e_g[:, None]
        t_l, t_r = (t[:, None] for t in self.binding.root_bounds(inputs, end_ind))
        hidden_l = hidden_r = None
        z_layers = None
        if "z" in inputs:
            z_layers = depthfirst2layers(inputs.z.to(self.dtype))

        levels = []
        for d in range(self.depth):
            level = self.tree_levels[d if self.hp["untied_layers"] else 0]
            sg = level(inputs, e_l, e_r, hidden_l, hidden_r, t_l, t_r,
                       None if z_layers is None else z_layers[d], mode,
                       generator)
            levels.append(sg)
            if d + 1 < self.depth:
                t_mid = sg.match_timesteps
                e_l, e_r = (interleave(e_l, sg.e_g_prime),
                            interleave(sg.e_g_prime, e_r))
                t_l, t_r = interleave(t_l, t_mid), interleave(t_mid, t_r)
                if self.hp["tree_lstm"]:
                    if hidden_l is None:
                        hidden_l, hidden_r = sg.init_hidden_l, sg.init_hidden_r
                    hidden_l = interleave(hidden_l, sg.hidden_state)
                    hidden_r = interleave(sg.hidden_state, hidden_r)

        tree = AttrDict(
            e_g_prime=torch.cat([l.e_g_prime for l in levels], 1),
            match_timesteps=torch.cat([l.match_timesteps for l in levels], 1),
            z=torch.cat([l.z for l in levels], 1),
            q_z=Gaussian.cat([l.q_z for l in levels], 1),
            p_z=Gaussian.cat([l.p_z for l in levels], 1),
        )
        if levels[0].get("gamma") is not None:  # attention weights [B, N, T]
            tree.gamma = torch.cat([l.gamma for l in levels], 1)
        tree.images, tree.dlm_params = self.decode_seq(tree.e_g_prime,
                                                       inputs.skips)
        outputs.tree = tree
        return outputs

    def forward(self, inputs: AttrDict, phase: str = "test",
                mode: str = "prior", pred_length: bool = False,
                generator: Optional[torch.Generator] = None,
                step=0) -> AttrDict:
        """`inputs` holds NHWC start/goal images I_0, I_g (uint8 or [-1, 1]
        floats), optionally end_ind [B], injected depth-first latents
        z [B, 2^L - 1, nz_vae], and for training the batch of the data
        loader (traj_seq, pad_mask, actions, traj_seq_states). `generator`
        drives every random draw: the predicted length (prior mode), the
        non-injected latents and the auxiliary models' index pairs; without
        one the length is the argmax and z must be injected. With
        phase='train' and traj_seq given, `outputs.losses` holds every loss
        term and the total; `step` sets the KL weight's burn-in."""
        if phase not in ("train", "test", "plan") or mode not in ("prior", "posterior"):
            raise ValueError(f"unknown phase/mode {phase!r}/{mode!r}")
        if mode == "posterior" and "traj_seq" not in inputs:
            raise ValueError("mode='posterior' infers latents from inputs.traj_seq")
        inputs = self.run_encoder(self.preprocess_inputs(inputs))
        outputs = AttrDict()
        end_ind = self.get_end_ind(inputs, outputs, pred_length,
                                   None if mode == "posterior" else generator)
        self.predict_sequence(inputs, outputs, end_ind, mode, generator)
        # existence (balanced) or distance (adaptive) logits
        logits = self.binding.prune_logits(outputs.tree.e_g_prime)
        outputs[self.binding.logits_key] = logits
        outputs.prune_keep = self.binding.prune_mask(logits)
        losses = AttrDict()
        if "traj_seq" in inputs and phase == "train":
            self.compute_matching(inputs, outputs, step)
            losses = self.compute_losses(inputs, outputs, step)
            losses.update(self.binding.loss(outputs))
            # the matched latent timeline feeds the auxiliary models
            idx = torch.argmax(outputs.gt_match_dists, dim=1)  # [B, T]
            rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
            inputs.model_enc_seq = outputs.tree.e_g_prime[rows, idx]
            outputs.update(self.run_aux_models(inputs, phase, generator))
            losses.update(self.aux_losses(inputs, outputs))
            losses = self.assemble_total(inputs, losses)
        if phase == "plan":
            outputs.update(self.plan_outputs(outputs))
        outputs.losses = losses
        return outputs

    def compute_matching(self, inputs: AttrDict, outputs: AttrDict, step) -> None:
        """Match tree nodes to GT frames (tree_module.py:132-147)."""
        w = self.binding.get_w(inputs, outputs, step)
        outputs.gt_match_dists = w
        outputs.tree.match_dist = w
        outputs.entropy = safe_entropy(w, dim=-1)
        outputs.p_n = torch.clamp(w.sum(2), 0.0, 1.0)

    def compute_losses(self, inputs: AttrDict, outputs: AttrDict, step) -> AttrDict:
        hp = self.hp
        losses = self.binding.reconstruction_loss(inputs, outputs, self.log_sigma())
        losses.kl = kl_divergence_loss(outputs.tree.q_z, outputs.tree.p_z,
                                       weight=self.kl_weight(step),
                                       free_nats_per_dim=hp["free_nats"],
                                       breakdown=1)
        losses.entropy = penalty_loss(outputs.entropy, weight=hp["entropy_weight"])
        if "soft_dtw_stability_gap" in outputs:
            # log-only (weight 0): the f32 drift of the soft-DTW marginals,
            # a hard assertion in float64 in probabilistic_dtw.py:118-120
            losses.soft_dtw_stability_gap = LossTerm(
                outputs.soft_dtw_stability_gap, weight=0.0)
        return losses

    def plan_outputs(self, outputs: AttrDict) -> AttrDict:
        """Planner-facing outputs [B, T, ...], valid up to outputs.end_ind:
        the balanced-schedule timeline of images and latents, plus inferred
        actions and regressed states (cem_simulator.py:14-43)."""
        idx = basic_timeline_index(self.depth, outputs.end_ind,
                                   self.hp["max_seq_len"])
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        plan = AttrDict(timeline_images=outputs.tree.images[rows, idx],
                        timeline_latents=outputs.tree.e_g_prime[rows, idx])
        lat = plan.timeline_latents
        if self.hp["attach_inv_mdl"]:
            plan.actions = self.inv_mdl(lat[:, :-1], lat[:, 1:])
        if self.hp["attach_state_regressor"]:
            plan.regressed_state = self.state_regressor(lat)
        return plan
