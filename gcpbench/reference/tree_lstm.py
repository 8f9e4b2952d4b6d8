"""TreeLSTM subgoal predictors (models/tree_lstm.py of the JAX package):
fuse the two parents' packed LSTM states, step an LSTM stack, emit the
subgoal latent. Under hp.use_conv_lstm the stack is a ConvLSTMStack, each
packed chunk is a latent grid and the linear fusions are 3x3 convs."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .nets import (
    CONV_LSTM_SPATIAL,
    MLP,
    Casting,
    conv_nhwc,
    linear,
    lstm_state_size,
    make_lstm_stack,
)


class TreeLSTMPredictor(Casting, nn.Module):
    """p(e_sg | h_l, h_r, e_l, e_r, z, [e_0, e_g]).

    fusion 'sum' adds the parents' packed states, 'linear' projects their
    concatenation, 'split_linear' projects each (layer, c|h) chunk pair with
    its own Linear (the published choice), or its own 3x3 conv under
    use_conv_lstm. The projections and the output head compute in the
    compute dtype; the fused state and the subgoal latent return in the
    parameters' dtype."""

    def __init__(self, hp, fusion: str, in_size: int):
        super().__init__()
        if fusion not in ("sum", "linear", "split_linear"):
            raise ValueError(f"unknown tree_lstm fusion {fusion!r}")
        self.fusion = fusion
        self.conv = hp.get("use_conv_lstm", False)
        state = lstm_state_size(hp)
        self.n_chunks = 2 * hp["n_lstm_layers"] if fusion == "split_linear" else 1
        if fusion != "sum":
            width = state // self.n_chunks
            if self.conv:
                ch = width // CONV_LSTM_SPATIAL ** 2
                self.proj = nn.ModuleList(
                    nn.Conv2d(2 * ch, ch, 3, padding=1) for _ in range(self.n_chunks))
            else:
                self.proj = nn.ModuleList(
                    nn.Linear(2 * width, width) for _ in range(self.n_chunks))
        # flax names the stack after its class: LSTMStack_0 / ConvLSTMStack_0
        self.stack_name = "conv_lstm_stack" if self.conv else "lstm_stack"
        setattr(self, self.stack_name, nn.ModuleList([make_lstm_stack(hp, in_size)]))
        self.dense = nn.ModuleList([nn.Linear(hp["nz_mid_lstm"], hp["nz_enc"])])

    def _project(self, proj: nn.Module, cl: torch.Tensor, cr: torch.Tensor,
                 dt: torch.dtype) -> torch.Tensor:
        x = torch.cat([cl, cr], -1)
        if not self.conv:
            return linear(proj, x, dt)
        # the concatenation [cl, cr] is reshaped onto the grid as a whole,
        # as the JAX module does: a cell's channels are not cl's, then cr's
        s = CONV_LSTM_SPATIAL
        lead, width = x.shape[:-1], cl.shape[-1]
        grid = x.reshape(-1, s, s, x.shape[-1] // (s * s))
        return conv_nhwc(proj, grid, dt).reshape(lead + (width,))

    def forward(self, hidden_l: torch.Tensor, hidden_r: torch.Tensor,
                *inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dt, pdt = self.dtypes(self.dense[0].weight)
        if self.fusion == "sum":
            fused = hidden_l + hidden_r
        else:
            pairs = zip(hidden_l.chunk(self.n_chunks, -1),
                        hidden_r.chunk(self.n_chunks, -1))
            fused = torch.cat([self._project(proj, cl, cr, dt)
                               for proj, (cl, cr) in zip(self.proj, pairs)], -1).to(pdt)
        stack = getattr(self, self.stack_name)[0]
        new_state, out = stack(fused, torch.cat(inputs, -1))
        return new_state, torch.tanh(linear(self.dense[0], out, dt)).to(pdt)


class LSTMInitializer(nn.Module):
    """Initial states of the virtual root parents: 'zero', or two MLP heads
    on (e_l, e_r, z) of the first subgoal call ('mlp')."""

    def __init__(self, hp):
        super().__init__()
        self.kind = hp.get("lstm_init", "zero")
        self.state_size = lstm_state_size(hp)
        if self.kind == "mlp":
            in_size = 2 * hp["nz_enc"] + hp["nz_vae"]
            self.mlp = nn.ModuleList(
                MLP(in_size, self.state_size, hp.get("init_mlp_mid_sz", 32),
                    hp.get("init_mlp_layers", 3)) for _ in range(2))
        elif self.kind != "zero":
            raise ValueError(f"unknown lstm_init {self.kind!r}")

    def forward(self, e_l: torch.Tensor, e_r: torch.Tensor, z: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.kind == "zero":
            zeros = e_l.new_zeros(e_l.shape[:-1] + (self.state_size,))
            return zeros, zeros
        return self.mlp[0](e_l, e_r, z), self.mlp[1](e_l, e_r, z)
