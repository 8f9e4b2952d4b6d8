"""Network building blocks (models/nets.py of the JAX package), main-path
subset: GroupNorm+LeakyReLU, MLP, conv encoder/decoder pyramids, Gaussian
heads, the packed-state LSTM stack, the conv sequence encoder and the
time-masked multi-head attention of the attentive inference.

Images are NHWC at every public function, as in the JAX package. A conv layer
sees the same memory as an NCHW tensor in `torch.channels_last` (a permuted
view, no copy), and the fused GroupNorm kernel reads it back as NHWC.

Submodule names follow one rule so that flax checkpoints map onto them
mechanically (training/checkpoint.py:flax_to_torch): the flax auto-name
`Name_k` becomes the torch path `name.k` (snake case, a ModuleList index).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_gcp_torch.core.distributions import Gaussian, unit_gaussian
from video_gcp_torch.ops.fused_gn import fused_group_norm_lrelu


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv layer to NHWC x through channels_last views."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """GroupNorm with a fused LeakyReLU(0.2) epilogue on NHWC input, always
    through `fused_group_norm_lrelu` (kernel K1 on CUDA). Parameters are
    flax's `scale`/`bias`, named `weight`/`bias` here."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-6, negative_slope: float = 0.2):
        super().__init__()
        self.num_groups, self.eps, self.negative_slope = (
            num_groups, eps, negative_slope)
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_group_norm_lrelu(x, self.weight, self.bias,
                                      self.num_groups, self.eps,
                                      self.negative_slope)


def _norm_act(hp, ch: int) -> nn.Module:
    """The conv blocks' norm+LeakyReLU: groups start at 8 and halve until
    they divide the channel count."""
    if hp.get("normalization", "group") != "group":
        raise NotImplementedError(
            f"normalization={hp['normalization']!r}: only 'group' is ported")
    groups = 8
    while ch % groups:
        groups //= 2
    return GroupNorm(groups, ch)


def _n_levels(hp) -> int:
    return hp.get("n_conv_layers") or int(math.log2(hp["img_sz"]))


class MLP(nn.Module):
    """n_layers hidden Linear+LeakyReLU(0.2) layers and a linear head over
    the concatenated inputs."""

    def __init__(self, in_size: int, out_size: int, mid_size: int,
                 n_layers: int = 3, final_activation: Optional[str] = None):
        super().__init__()
        sizes = [in_size] + [mid_size] * n_layers + [out_size]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.final_activation = final_activation

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        x = torch.cat(inputs, dim=-1)
        for layer in self.dense[:-1]:
            x = _leaky(layer(x))
        x = self.dense[-1](x)
        if self.final_activation == "tanh":
            x = torch.tanh(x)
        return x


class ConvEncoder(nn.Module):
    """Stride-2 conv pyramid (k=4, 'SAME' = padding 1 on even sizes) to a
    flat latent, plus the per-resolution activations as skips."""

    def __init__(self, hp):
        super().__init__()
        chans = [hp["input_nc"]] + [min(hp["ngf"] * 2 ** i, 256)
                                    for i in range(_n_levels(hp))]
        self.conv = nn.ModuleList(
            nn.Conv2d(a, b, 4, stride=2, padding=1)
            for a, b in zip(chans[:-1], chans[1:]))
        self.group_norm = nn.ModuleList(_norm_act(hp, ch) for ch in chans[1:])
        s = hp["img_sz"] // 2 ** _n_levels(hp)
        self.dense = nn.ModuleList([nn.Linear(chans[-1] * s * s, hp["nz_enc"])])

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = img
        skips = []
        for conv, norm in zip(self.conv, self.group_norm):
            x = norm(conv_nhwc(conv, x))
            skips.append(x)
        return self.dense[0](x.reshape(x.shape[0], -1)), skips


class ConvDecoder(nn.Module):
    """Transposed-conv pyramid from a flat latent back to an image, with skip
    connections from the start-image encoder entering every
    `skips_stride`-th level. Flax's ConvTranspose (k=4, s=2, 'SAME') is
    `ConvTranspose2d(padding=1)` with the kernel flipped (see the bridge)."""

    def __init__(self, hp, out_channels: Optional[int] = None,
                 tanh_out: bool = True):
        super().__init__()
        n = _n_levels(hp)
        self.hp = hp
        self.ch0 = min(hp["ngf"] * 2 ** (n - 1), 256)
        self.s0 = hp["img_sz"] // 2 ** n
        self.dense = nn.ModuleList(
            [nn.Linear(hp["nz_enc"], self.ch0 * self.s0 * self.s0)])
        enc_ch = [min(hp["ngf"] * 2 ** i, 256) for i in range(n)]
        deconvs, norms = [], []
        cin = self.ch0
        for i in reversed(range(n)):
            if self._uses_skip(i):
                cin += enc_ch[i]
            ch = min(hp["ngf"] * 2 ** max(i - 1, 0), 256) if i > 0 else hp["ngf"]
            deconvs.append(nn.ConvTranspose2d(cin, ch, 4, stride=2, padding=1))
            norms.append(_norm_act(hp, ch))
            cin = ch
        self.conv_transpose = nn.ModuleList(deconvs)
        self.group_norm = nn.ModuleList(norms)
        out_ch = out_channels or hp["input_nc"]
        self.conv = nn.ModuleList([nn.Conv2d(cin, out_ch, 3, padding=1)])
        self.tanh_out = tanh_out

    def _uses_skip(self, i: int) -> bool:
        return (self.hp.get("use_skips", True)
                and i % self.hp.get("skips_stride", 2) == 0)

    def forward(self, e: torch.Tensor,
                skips: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = self.dense[0](e).reshape(e.shape[0], self.s0, self.s0, self.ch0)
        n = len(self.conv_transpose)
        for j, (deconv, norm) in enumerate(zip(self.conv_transpose,
                                               self.group_norm)):
            i = n - 1 - j
            if skips is not None and self._uses_skip(i):
                skip = skips[i]
                if skip.shape[0] != x.shape[0]:
                    # per-example skips over the folded node axis
                    skip = skip.repeat_interleave(x.shape[0] // skip.shape[0], 0)
                x = torch.cat([x, skip], dim=-1)
            x = norm(conv_nhwc(deconv, x))
        x = conv_nhwc(self.conv[0], x)
        return torch.tanh(x) if self.tanh_out else x


class GaussianLogSigma(nn.Module):
    """Learned global decoder log-sigma (learn_beta / initial_sigma)."""

    def __init__(self, hp):
        super().__init__()
        init = torch.tensor(math.log(hp.get("initial_sigma", 1.0)))
        if hp.get("learn_beta", True):
            self.log_sigma = nn.Parameter(init)
        else:
            self.register_buffer("log_sigma", init, persistent=False)

    def forward(self) -> torch.Tensor:
        return self.log_sigma


class GaussianHead(nn.Module):
    """MLP emitting a diagonal Gaussian (q networks / learned priors)."""

    def __init__(self, in_size: int, nz: int, mid_size: int, n_layers: int = 3):
        super().__init__()
        self.nz = nz
        if nz:
            self.mlp = nn.ModuleList([MLP(in_size, 2 * nz, mid_size, n_layers)])

    def forward(self, *inputs: torch.Tensor) -> Gaussian:
        if self.nz == 0:
            return unit_gaussian(inputs[0].shape[:-1] + (0,),
                                 inputs[0].device, inputs[0].dtype)
        return Gaussian.from_concat(self.mlp[0](*inputs))


class FixedPriorHead(nn.Module):
    """Unit Gaussian prior (blox FixedPrior)."""

    def __init__(self, nz: int):
        super().__init__()
        self.nz = nz

    def forward(self, ref: torch.Tensor, *unused) -> Gaussian:
        return unit_gaussian(ref.shape[:-1] + (self.nz,), ref.device, ref.dtype)


class LSTMStack(nn.Module):
    """Multi-layer LSTM advancing one step. The state is packed as one tensor
    [..., n_layers * 2 * size], [c; h] per layer, so tree levels can
    interleave and fuse states as plain tensors. Each layer is an
    `nn.LSTMCell` (gates i, f, g, o); flax's OptimizedLSTMCell has no input
    bias, so `bias_ih` holds zeros and is frozen (trained, it would move
    the gate bias twice per step)."""

    def __init__(self, in_size: int, size: int, n_layers: int):
        super().__init__()
        self.size, self.n_layers = size, n_layers
        self.optimized_lstm_cell = nn.ModuleList(
            nn.LSTMCell(in_size if i == 0 else size, size) for i in range(n_layers))
        for cell in self.optimized_lstm_cell:
            nn.init.zeros_(cell.bias_ih)
            cell.bias_ih.requires_grad_(False)

    def forward(self, packed: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        chunks = packed.reshape(-1, packed.shape[-1]).chunk(self.n_layers, -1)
        new = []
        for cell, chunk in zip(self.optimized_lstm_cell, chunks):
            c, h = chunk.chunk(2, -1)
            h, c = cell(x, (h, c))
            new += [c, h]
            x = h
        return (torch.cat(new, -1).reshape(lead + (packed.shape[-1],)),
                x.reshape(lead + (self.size,)))


def lstm_state_size(hp) -> int:
    return hp["n_lstm_layers"] * 2 * hp["nz_mid_lstm"]


class ConvSeqEncoder(nn.Module):
    """1-D temporal conv (k=3, 'SAME' = padding 1) + LeakyReLU over per-frame
    latents [B, T, D] (blox ConvSeqEncodingModule)."""

    def __init__(self, hp):
        super().__init__()
        k = hp.get("conv_inf_enc_kernel_size", 3)
        if k % 2 == 0:
            raise NotImplementedError("even conv_inf_enc_kernel_size: 'SAME' "
                                      "padding would be asymmetric")
        d = hp["nz_enc"]
        self.conv = nn.ModuleList(
            nn.Conv1d(d, d, k, padding=k // 2)
            for _ in range(hp.get("conv_inf_enc_layers", 1)))

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        x = seq.transpose(1, 2)
        for conv in self.conv:
            x = _leaky(conv(x))
        return x.transpose(1, 2)


def build_seq_encoder(hp) -> Optional[nn.Module]:
    kind = hp.get("seq_enc", "none")
    if kind == "none":
        return None
    if kind == "conv":
        return ConvSeqEncoder(hp)
    if kind in ("lstm", "bi-lstm"):
        raise NotImplementedError(
            f"seq_enc={kind!r} (RecurrentSeqEncoder) is not ported: no config "
            "of the repository uses it (ROADMAP.md, modules still missing)")
    raise ValueError(f"unknown seq_enc {kind!r}")


class MaskedMultiheadAttention(nn.Module):
    """One layer of time-masked multi-head attention (the JAX package's
    MaskedMultiheadAttention, blox MultiheadAttention as used by the
    attentive inference). The query is already projected to nz_attn_key.

    Every node of a batch element attends over the same sequence, so the
    keys and values are projected once per sequence, [B, T, ...], and the
    node axis broadcasts; the JAX module projects a copy per node, which
    gives the same values and, summed over the copies, the same weight
    gradients. flax's auto-names Dense_0..2 (query, key, value) become
    `dense.0..2`; `log_attn_temp` is the learned softmax temperature."""

    def __init__(self, hp, d_query: int):
        super().__init__()
        self.n_heads = hp.get("n_attention_heads", 1)
        self.d_key = hp.get("nz_attn_key", hp["nz_enc"])
        self.nz_enc = hp["nz_enc"]
        if self.d_key % self.n_heads or self.nz_enc % self.n_heads:
            raise ValueError(f"{self.n_heads} attention heads do not divide "
                             f"nz_attn_key={self.d_key} and nz_enc={self.nz_enc}")
        self.dense = nn.ModuleList([nn.Linear(d_query, self.d_key),
                                    nn.Linear(self.nz_enc, self.d_key),
                                    nn.Linear(self.nz_enc, self.nz_enc)])
        self.temperature = hp.get("attention_temperature", 1.0)
        if hp.get("learn_attn_temp", True):
            self.log_attn_temp = nn.Parameter(torch.tensor(math.log(self.temperature)))
        else:
            self.log_attn_temp = None

    def forward(self, query: torch.Tensor, keys: torch.Tensor,
                values: torch.Tensor, start_ind: torch.Tensor,
                end_ind: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """query [B, N, Dq]; keys and values [B, T, nz_enc]; start_ind and
        end_ind [B, N], the inclusive span of frames each node attends to.
        Returns the attended values [B, N, nz_enc] and the attention
        weights averaged over heads, [B, N, T]."""
        b, n = query.shape[:2]
        t, h = keys.shape[1], self.n_heads
        d_head = self.d_key // h
        q = self.dense[0](query).reshape(b, n, h, d_head)
        k = self.dense[1](keys).reshape(b, t, h, d_head)
        v = self.dense[2](values).reshape(b, t, h, self.nz_enc // h)
        logits = torch.einsum("bnhd,bthd->bnht", q, k) / math.sqrt(d_head)
        if self.log_attn_temp is not None:
            logits = logits / torch.exp(self.log_attn_temp)
        else:
            logits = logits / self.temperature
        t_idx = torch.arange(t, device=query.device)
        mask = (t_idx >= start_ind[..., None]) & (t_idx <= end_ind[..., None])
        logits = torch.where(mask[:, :, None, :], logits,
                             torch.full_like(logits, -1e30))
        gamma = torch.softmax(logits, dim=-1)  # [B, N, h, T]
        attended = torch.einsum("bnht,bthd->bnhd", gamma, v)
        return attended.reshape(b, n, self.nz_enc), gamma.mean(dim=2)
