"""Goal-conditioned behavioral cloning (models/bc.py of the JAX package;
gcp/prediction/models/auxilliary_models/bc_mdl.py:15-168).

Encodes every frame and the goal with the conv encoder and predicts the
actions from the fused encodings: a reactive MLP, or a recurrent LSTMStack
run over time. Trained with the L2 action reconstruction through the
trainer's usual contract: forward(inputs, phase, mode, ...) returns outputs
with `.losses`, whose `total` (weight 0) the train step minimises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.losses import LossTerm, l2_loss, total_loss
from video_gcp_torch.core.metrics import to_float_images
from video_gcp_torch.models.nets import (
    MLP,
    Casting,
    ConvEncoder,
    LSTMStack,
    linear,
    set_compute_dtype,
)


class BCModel(Casting, nn.Module):
    """hp.reactive (default True): an MLP on [e_t, e_g]; else an LSTMStack
    over the time steps with a linear action head. `dtype` is the compute
    dtype over the parameters, as in TreeModel."""

    def __init__(self, hp, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hp = dict(hp)
        hp = self.hp
        self.reactive = hp.get("reactive", True)
        self.encoder = ConvEncoder(hp)
        if self.reactive:
            self.policy = MLP(2 * hp["nz_enc"], hp["n_actions"], hp["nz_mid"],
                              hp["n_processing_layers"])
        else:
            self.lstm = LSTMStack(2 * hp["nz_enc"], hp["nz_mid_lstm"], hp["n_lstm_layers"])
            self.head = nn.Linear(hp["nz_mid_lstm"], hp["n_actions"])
        set_compute_dtype(self, dtype)

    def _head(self, out: torch.Tensor) -> torch.Tensor:
        dt, pdt = self.dtypes(self.head.weight)
        return linear(self.head, out, dt).to(pdt)

    def forward(self, inputs: AttrDict, phase: str = "train", mode: str = "posterior",
                pred_length: bool = False, generator: Optional[torch.Generator] = None,
                step=0) -> AttrDict:
        """inputs: traj_seq [B, T, H, W, C] and I_g (uint8 or [-1, 1]), and
        for training actions [B, T-1, n_actions] and pad_mask [B, T].
        Returns the actions of the first T-1 frames (the last has none);
        `mode`, `pred_length`, `generator` and `step` are the trainer's
        contract, unused: the model draws nothing."""
        seq = to_float_images(inputs.traj_seq)
        b, t = seq.shape[:2]
        enc_seq = self.encoder(seq.reshape((b * t,) + seq.shape[2:]))[0].reshape(b, t, -1)
        enc_goal = self.encoder(to_float_images(inputs.I_g))[0]
        fused = torch.cat([enc_seq, enc_goal[:, None].expand_as(enc_seq)], -1)
        if self.reactive:
            actions = self.policy(fused)
        else:
            state = fused.new_zeros((b, self.lstm.state_size))
            outs = []
            for i in range(t):
                state, out = self.lstm(state, fused[:, i])
                outs.append(out)
            actions = self._head(torch.stack(outs, 1))
        actions = actions[:, :-1]

        outputs = AttrDict(actions=actions)
        losses = AttrDict()
        if "actions" in inputs and phase == "train":
            n = actions.shape[1]
            # pad_mask[:, :n]: the action at t is valid where frame t is
            losses.action_reconst = l2_loss(actions, inputs.actions[:, :n],
                                            weights=inputs.pad_mask[:, :n, None])
            numel = 1
            for s in seq.shape[1:]:
                numel *= s
            losses.total = LossTerm(total_loss(losses, numel), weight=0.0)
        outputs.losses = losses
        return outputs

    def act_single(self, I_0: torch.Tensor, I_g: torch.Tensor,
                   hidden: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One test-time action from [-1, 1] images [B, H, W, C], with the
        recurrent policy's hidden state threaded through (None for the
        reactive one) (TestTimeBCModel)."""
        fused = torch.cat([self.encoder(I_0)[0], self.encoder(I_g)[0]], -1)
        if self.reactive:
            return self.policy(fused), None
        if hidden is None:
            hidden = fused.new_zeros((I_0.shape[0], self.lstm.state_size))
        hidden, out = self.lstm(hidden, fused)
        return self._head(out), hidden
