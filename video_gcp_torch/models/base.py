"""Shared GCP model core (models/base.py of the JAX package): hparam
validation, module construction, input preprocessing, encoding, length
prediction, the folded decode, the auxiliary models' training pass and the
loss assembly.

With `use_convs=False` a model predicts flat state vectors [..., input_nc]
instead of images: `MLPEncoder` and `MLPDecoder` take the conv pyramids'
places (no GroupNorm, so no K1 or K2 on that path) and the decoder is
Gaussian whatever `decoder_distribution` says, as in the JAX package."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core import distributions
from video_gcp_torch.core.metrics import to_float_images
from video_gcp_torch.core.losses import LossTerm, l2_loss, total_loss
from video_gcp_torch.core.schedules import kl_weight_at
from video_gcp_torch.models import dlm
from video_gcp_torch.models.aux_models import (
    CostModel,
    InverseModel,
    LengthPredictor,
    StateRegressor,
    gather_t,
)
from video_gcp_torch.models.nets import (
    MLP,
    Casting,
    ConvDecoder,
    ConvEncoder,
    GaussianLogSigma,
    build_seq_encoder,
)


class MLPEncoder(Casting, nn.Module):
    """State-space encoder for use_convs=False models: an MLP from the
    state [B, input_nc] to [B, nz_enc], and no skips."""

    def __init__(self, hp):
        super().__init__()
        self.mlp = nn.ModuleList([MLP(hp["input_nc"], hp["nz_enc"], hp["nz_mid"],
                                      hp["n_processing_layers"])])

    def forward(self, x: torch.Tensor):
        return self.mlp[0](x), None


class MLPDecoder(Casting, nn.Module):
    """State-space decoder for use_convs=False models: an MLP from a latent
    [B, nz_enc] to a state [B, input_nc]; skips are ignored."""

    def __init__(self, hp):
        super().__init__()
        self.mlp = nn.ModuleList([MLP(hp["nz_enc"], hp["input_nc"], hp["nz_mid"],
                                      hp["n_processing_layers"])])

    @property
    def dense(self):  # the first layer, whose dtype is the parameters'
        return self.mlp[0].dense

    def forward(self, e: torch.Tensor, skips=None) -> torch.Tensor:
        return self.mlp[0](e)


class BaseGCPModel(nn.Module):
    """Common construction and forward pieces; subclasses add the predictor."""

    # Declared-for-parity switches that no published config sets and that are
    # not implemented in either package: accepted at their defaults only.
    _UNIMPLEMENTED_DEFAULTS = dict(
        pixel_shift_decoder=False,
        add_weighted_pixel_copy=False,
        skip_from_parents=False,
        one_hot_attn_time_cond=False,
        regress_index=False,
        train_on_action_seqs=False,
        supervised_decoder=False,
        states_inference=False,
        standardize=None,
        supervise_match_weight=0.0,
        dump_encodings="",
        dump_encodings_inv_model="",
        log_cartgripper=False,
        log_d2b_3x3maze=0,
    )

    def __init__(self, hp):
        super().__init__()
        self.hp = dict(hp)
        self.validate_hparams(self.hp)
        self.setup_core()

    @classmethod
    def validate_hparams(cls, hp):
        for flag, default in cls._UNIMPLEMENTED_DEFAULTS.items():
            if hp.get(flag, default) != default:
                raise NotImplementedError(
                    f"hparam {flag}={hp[flag]!r} is declared for config parity "
                    "but not implemented (no published config sets it); keep "
                    f"it at its default {default!r} or pop it from the config")
        if hp.get("var_inf", "standard") == "2layer":
            raise NotImplementedError(
                "var_inf='2layer' (and nz_vae2) is not implemented; use "
                "'standard' or 'deterministic'")
        if hp.get("dense_rec_type", "none") not in ("none", "svg", "node_prob", None):
            raise ValueError(f"unknown dense_rec_type {hp['dense_rec_type']!r}")
        if hp.get("one_step_planner", "discrete") not in (
                "discrete", "continuous", "sh_pred"):
            raise ValueError(f"unknown one_step_planner {hp['one_step_planner']!r}")
        if hp.get("action_activation") not in (None, "sigmoid", "tanh"):
            raise ValueError(f"unknown action_activation {hp['action_activation']!r}")

    @property
    def regress_decoder_actions(self) -> bool:
        return bool(self.hp["regress_actions"]
                    and self.hp.get("one_step_planner") != "sh_pred")

    def apply_action_activation(self, actions: torch.Tensor) -> torch.Tensor:
        act = self.hp.get("action_activation")
        if act == "sigmoid":
            return torch.sigmoid(actions)
        if act == "tanh":
            return torch.tanh(actions)
        return actions

    @property
    def param_dtype(self) -> torch.dtype:
        return self.decoder.dense[0].weight.dtype

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (flax's `dtype`); the parameters' by default."""
        return self.decoder.compute_dtype or self.param_dtype

    def setup_core(self):
        hp = self.hp
        use_convs = hp.get("use_convs", True)
        self.use_dlm = (use_convs and hp.get("decoder_distribution")
                        == "discrete_logistic_mixture")
        encoder_cls = ConvEncoder if use_convs else MLPEncoder
        self.encoder = encoder_cls(hp)
        if not use_convs:
            self.decoder = MLPDecoder(hp)
        elif self.use_dlm:
            self.decoder = ConvDecoder(
                hp, out_channels=dlm.n_dlm_channels(hp["input_nc"]),
                tanh_out=False)
        else:
            self.decoder = ConvDecoder(hp)
        if hp.get("separate_cnn_start_goal_encoder", False):
            self.start_goal_encoder = encoder_cls(hp)
        self.log_sigma_mod = GaussianLogSigma(hp)

        self.inf_encoder = build_seq_encoder(hp)  # may be None
        self.inf_key_encoder = build_seq_encoder(hp)
        nz = hp["nz_enc"]
        if hp.get("act_cond_inference", False):
            # action-conditioned inference: the zero-padded actions fused
            # into the temporal inference encoding (ActionConditioningWrapper,
            # auxilliary_models/misc.py:59-70)
            self.act_cond_net = MLP(nz + hp["n_actions"], nz, hp["nz_mid"],
                                    hp["n_processing_layers"])
        if hp["regress_length"]:
            self.length_pred = LengthPredictor(hp)
        if hp["attach_inv_mdl"]:
            inv_p = dict(nz_mid=hp["nz_mid"],
                         n_processing_layers=hp["n_processing_layers"])
            inv_p.update(hp["inv_mdl_params"])
            self.inv_mdl = InverseModel(inv_p, nz)
        if hp["attach_cost_mdl"]:
            cost_p = dict(nz_mid=hp["nz_mid"],
                          n_processing_layers=hp["n_processing_layers"])
            cost_p.update({k: v for k, v in hp["cost_mdl_params"].items()
                           if not callable(v)})
            self.cost_mdl = CostModel(cost_p, nz)
        if hp["attach_state_regressor"]:
            self.state_regressor = StateRegressor(hp)
        if hp["action_conditioned_pred"]:
            self.action_encoder = MLP(hp["n_actions"], nz, hp["nz_mid"],
                                      hp["n_processing_layers"])

    def _start_goal_encoder(self) -> nn.Module:
        # not registered twice: a shared encoder would duplicate state_dict keys
        if self.hp.get("separate_cnn_start_goal_encoder", False):
            return self.start_goal_encoder
        return self.encoder

    # ----- forward pieces -----------------------------------------------------

    def preprocess_inputs(self, inputs: AttrDict) -> AttrDict:
        """uint8 images -> [-1, 1] floats in the parameters' dtype (the
        encoder casts them to the compute dtype), then non_goal_conditioned
        zeroing (base_gcp.py:163-175)."""
        inputs = inputs.copy()
        for key in ("traj_seq", "I_0", "I_g"):
            if key in inputs:
                inputs[key] = to_float_images(inputs[key]).to(self.param_dtype)
        if self.hp["non_goal_conditioned"]:
            if "traj_seq" in inputs:
                seq = inputs.traj_seq.clone()
                seq[torch.arange(seq.shape[0]), inputs.end_ind] = 0.0
                inputs.traj_seq = seq
            inputs.I_g = torch.zeros_like(inputs.I_g)
        if "start_ind" not in inputs and "end_ind" in inputs:
            inputs.start_ind = torch.zeros_like(inputs.end_ind)
        return inputs

    def run_encoder(self, inputs: AttrDict) -> AttrDict:
        """Encode the sequence (when given), the start/goal frames and,
        under action_conditioned_pred, the actions [B, T-1, n_actions]."""
        if "traj_seq" in inputs and "enc_traj_seq" not in inputs:
            seq = inputs.traj_seq
            b, t = seq.shape[:2]
            enc, _ = self.encoder(seq.reshape((b * t,) + seq.shape[2:]))
            inputs.enc_traj_seq = enc.reshape(b, t, -1)
        if "enc_traj_seq" in inputs:
            for name, enc in (("inf_enc_seq", self.inf_encoder),
                              ("inf_enc_key_seq", self.inf_key_encoder)):
                inputs[name] = (inputs.enc_traj_seq if enc is None
                                else enc(inputs.enc_traj_seq))
            if self.hp.get("act_cond_inference", False):
                # the actions zero-padded at the end to the sequence's
                # length (misc.py:66-69) and fused into the inference
                # encoding
                seq, acts = inputs.inf_enc_seq, inputs.actions
                acts = F.pad(acts, (0, 0, 0, max(seq.shape[1] - acts.shape[1], 0)))
                inputs.inf_enc_seq = self.act_cond_net(seq, acts[:, :seq.shape[1]])

        sg_encoder = self._start_goal_encoder()
        inputs.e_0, inputs.skips = sg_encoder(inputs.I_0)
        inputs.e_g = sg_encoder(inputs.I_g)[0]
        if self.hp["action_conditioned_pred"] and "actions" in inputs:
            inputs.enc_action_seq = self.action_encoder(inputs.actions)
        return inputs

    def get_end_ind(self, inputs: AttrDict, outputs: AttrDict,
                    pred_length: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """Optionally predict the sequence length (base_gcp.py:215-229)."""
        hp = self.hp
        end_ind = inputs.get("end_ind", None)
        if hp["regress_length"]:
            outputs.update(self.length_pred(inputs.e_0, inputs.e_g, generator,
                                            inputs.get("seq_len_u")))
            if pred_length and (hp["length_pred_weight"] > 0 or end_ind is None):
                end_ind = outputs.end_ind_pred
                if hp["action_conditioned_pred"] or hp["non_goal_conditioned"]:
                    end_ind = torch.full_like(end_ind, hp["max_seq_len"] - 1)
        outputs.end_ind = end_ind
        return end_ind

    def decode_seq(self, e_seq: torch.Tensor, skips):
        """Decode [B, N, nz_enc] latents with the node axis folded into the
        batch. Returns (images [B, N, H, W, C], dlm_params or None); under the
        DLM decoder `images` is the mixture mean."""
        b, n = e_seq.shape[:2]
        out = self.decoder(e_seq.reshape(b * n, -1), skips)
        out = out.reshape((b, n) + out.shape[1:])
        if self.use_dlm:
            return dlm.mean(out, self.hp["input_nc"]), out
        return out, None

    def log_sigma(self) -> torch.Tensor:
        return self.log_sigma_mod()

    # ----- training ----------------------------------------------------------

    def run_aux_models(self, inputs: AttrDict, phase: str,
                       generator: Optional[torch.Generator]) -> AttrDict:
        """Inverse model, state regressor and cost model on the matched latent
        timeline `inputs.model_enc_seq` [B, T, D] (base_gcp.py:234-262)."""
        hp = self.hp
        aux = AttrDict()
        if "model_enc_seq" not in inputs:
            return aux
        enc_seq = inputs.model_enc_seq
        if hp["attach_inv_mdl"] and phase == "train":
            if hp.get("train_inv_mdl_full_seq", False):
                detached = enc_seq.detach()
                aux.actions = self.inv_mdl(detached[:, :-1], detached[:, 1:])
            else:
                # pair sampling (inverse_mdl.py:85-101): t0 uniform in
                # [0, end - temp_dist], t1 = t0 + delta, delta in [1, temp_dist];
                # the action at t0 regressed from the GT frame encodings
                temp_dist = hp["inv_mdl_params"].get("temp_dist", 1)
                b, dev = enc_seq.shape[0], enc_seq.device
                max_t0 = torch.clamp(inputs.end_ind.to(torch.float32) - temp_dist,
                                     min=0.0)
                u0 = distributions.uniform((b,), generator, dev)
                u1 = distributions.uniform((b,), generator, dev)
                t0 = (u0 * (max_t0 + 1.0)).to(torch.int64)
                delta = 1 + (u1 * temp_dist).to(torch.int64)
                src = inputs.enc_traj_seq.detach()
                aux.pair_action = self.inv_mdl(gather_t(src, t0),
                                               gather_t(src, t0 + delta))[:, None]
                aux.pair_action_target = gather_t(inputs.actions, t0)[:, None]
        if hp["attach_state_regressor"]:
            aux.regressed_state = self.state_regressor(enc_seq.detach())
        if hp["attach_cost_mdl"] and hp["run_cost_mdl"] and phase == "train":
            start, end, gt_cost = CostModel.sample_targets(
                generator, enc_seq, inputs.traj_seq, inputs.end_ind)
            aux.cost = self.cost_mdl(start, end)
            aux.cost_target = gt_cost
        return aux

    def aux_losses(self, inputs: AttrDict, outputs: AttrDict) -> AttrDict:
        hp = self.hp
        losses = AttrDict()
        if hp["regress_length"] and "seq_len_logits" in outputs:
            losses.update(LengthPredictor.loss(outputs, inputs.end_ind,
                                               hp["length_pred_weight"]))
        if "actions" in outputs and "actions" in inputs:
            losses.update(InverseModel.loss(outputs.actions, inputs.actions,
                                            inputs.pad_mask))
        if "pair_action" in outputs:
            losses.action_reconst = l2_loss(outputs.pair_action,
                                            outputs.pair_action_target)
        if "cost" in outputs:
            losses.update(CostModel.loss(outputs.cost, outputs.cost_target))
        if "regressed_state" in outputs and "traj_seq_states" in inputs:
            n = outputs.regressed_state.shape[1]
            losses.state_regression = l2_loss(
                outputs.regressed_state, inputs.traj_seq_states[:, :n],
                weights=inputs.pad_mask[:, :n, None])
        return losses

    def kl_weight(self, step):
        return kl_weight_at(step, self.hp["kl_weight"],
                            self.hp.get("kl_weight_burn_in", None))

    def assemble_total(self, inputs: AttrDict, losses: AttrDict) -> AttrDict:
        """total = sum(w * v) / prod(traj_seq.shape[1:]) (base_gcp.py:294-304);
        nll = dense_img_rec + kl, logged at weight 0 (base_gcp.py:289-290)."""
        if "dense_img_rec" in losses and "kl" in losses:
            losses.nll = LossTerm(losses.dense_img_rec.value + losses.kl.value,
                                  weight=0.0)
        numel = 1
        for s in inputs.traj_seq.shape[1:]:
            numel *= s
        losses.total = LossTerm(total_loss(losses, numel), weight=0.0)
        return losses
