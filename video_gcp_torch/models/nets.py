"""Network building blocks (models/nets.py of the JAX package):
GroupNorm+LeakyReLU (or LeakyReLU alone under normalization='none'), MLP,
conv encoder/decoder pyramids, Gaussian heads, the packed-state LSTM and
ConvLSTM stacks, the conv and recurrent sequence encoders and the
time-masked multi-head attention of the attentive inference.

Images are NHWC at every public function, as in the JAX package. A conv layer
sees the same memory as an NCHW tensor in `torch.channels_last` (a permuted
view, no copy), and the fused GroupNorm kernel reads it back as NHWC.

Compute dtype (flax's `dtype` over `param_dtype`): parameters keep their own
dtype (float32, or float64 in the tests) and a module that holds weights
computes in its `compute_dtype`, which `set_compute_dtype` sets on a whole
model (None: the parameters' dtype). Each module casts its inputs and its
weights where the JAX module casts them, and returns in the parameters'
dtype where the JAX module returns float32. The GroupNorm parameters are
not cast: K1 takes a bf16 x with float32 scale and bias, as flax's norm does.

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


class Casting:
    """Mixin of the modules that compute in `compute_dtype` over
    parameters of their own dtype; None computes in the parameters' dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def dtypes(self, weight: torch.Tensor) -> Tuple[torch.dtype, torch.dtype]:
        """(compute dtype, parameter dtype), read off one of the weights."""
        return self.compute_dtype or weight.dtype, weight.dtype


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Every casting module of `model` computes in `dtype` from now on."""
    for m in model.modules():
        if isinstance(m, Casting):
            m.compute_dtype = dtype


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's Dense(dtype=dtype): input, kernel and bias cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def conv_nhwc(conv: nn.Module, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply an NCHW conv layer to NHWC x through channels_last views, with
    x and the weights cast to dtype (default: the weights' own; then it is
    the layer's call, hooks included)."""
    dtype = dtype or conv.weight.dtype
    x = x.permute(0, 3, 1, 2).to(dtype)
    if dtype == conv.weight.dtype:
        y = conv(x)
    elif isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, conv.weight.to(dtype), conv.bias.to(dtype), conv.stride,
                               conv.padding, conv.output_padding, conv.groups, conv.dilation)
    else:
        y = conv._conv_forward(x, conv.weight.to(dtype), conv.bias.to(dtype))
    return y.permute(0, 2, 3, 1)


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


class LeakyReLU(nn.Module):
    """The conv blocks' activation under normalization='none' (no
    parameters, no kernel launch)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _leaky(x)


def _norm_act(hp, ch: int) -> nn.Module:
    """The conv blocks' norm+LeakyReLU: groups start at 8 and halve until
    they divide the channel count; 'none' is the LeakyReLU alone (JAX
    nets.py:66-77)."""
    if hp.get("normalization", "group") != "group":
        return LeakyReLU()
    groups = 8
    while ch % groups:
        groups //= 2
    return GroupNorm(groups, ch)


def pad_same(x: torch.Tensor, kernels, strides, value: float = 0.0) -> torch.Tensor:
    """x padded for a VALID conv or pool that then gives XLA's "SAME"
    result; `kernels` and `strides` name x's last len(kernels) axes. Each
    axis keeps ceil(size / stride) outputs, and an odd total pad puts the
    extra element at the end (a stride-2 k=7 conv on an even length pads
    (2, 3))."""
    pads = []
    for size, k, s in reversed(list(zip(x.shape[-len(kernels):], kernels, strides))):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def _n_levels(hp) -> int:
    return hp.get("n_conv_layers") or int(math.log2(hp["img_sz"]))


class MLP(Casting, nn.Module):
    """n_layers hidden Linear+LeakyReLU(0.2) layers and a linear head over
    the concatenated inputs; returns the parameters' dtype."""

    def __init__(self, in_size: int, out_size: int, mid_size: int,
                 n_layers: int = 3, final_activation: Optional[str] = None):
        super().__init__()
        sizes = [in_size] + [mid_size] * n_layers + [out_size]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.final_activation = final_activation

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        dt, pdt = self.dtypes(self.dense[0].weight)
        x = torch.cat([i.to(dt) for i in inputs], dim=-1)
        for layer in self.dense[:-1]:
            x = _leaky(linear(layer, x, dt))
        x = linear(self.dense[-1], x, dt)
        if self.final_activation == "tanh":
            x = torch.tanh(x)
        return x.to(pdt)


class ConvEncoder(Casting, nn.Module):
    """Stride-2 conv pyramid (k=4, 'SAME' = padding 1 on even sizes) to a
    flat latent in the parameters' dtype, plus the per-resolution
    activations as skips in the compute dtype."""

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
        dt, pdt = self.dtypes(self.dense[0].weight)
        x = img
        skips = []
        for conv, norm in zip(self.conv, self.group_norm):
            x = norm(conv_nhwc(conv, x, dt))
            skips.append(x)
        return linear(self.dense[0], x.reshape(x.shape[0], -1), dt).to(pdt), skips


class ConvDecoder(Casting, nn.Module):
    """Transposed-conv pyramid from a flat latent back to an image in the
    parameters' dtype, with skip connections from the start-image encoder
    entering every `skips_stride`-th level. Flax's ConvTranspose (k=4, s=2, 'SAME') is
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
        dt, pdt = self.dtypes(self.dense[0].weight)
        x = linear(self.dense[0], e, dt).reshape(e.shape[0], self.s0, self.s0, self.ch0)
        n = len(self.conv_transpose)
        for j, (deconv, norm) in enumerate(zip(self.conv_transpose,
                                               self.group_norm)):
            i = n - 1 - j
            if skips is not None and self._uses_skip(i):
                skip = skips[i].to(dt)
                if skip.shape[0] != x.shape[0]:
                    # per-example skips over the folded node axis
                    skip = skip.repeat_interleave(x.shape[0] // skip.shape[0], 0)
                x = torch.cat([x, skip], dim=-1)
            x = norm(conv_nhwc(deconv, x, dt))
        x = conv_nhwc(self.conv[0], x, dt)
        return (torch.tanh(x) if self.tanh_out else x).to(pdt)


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


class LSTMStack(Casting, nn.Module):
    """Multi-layer LSTM advancing one step. The state is packed as one tensor
    [..., n_layers * 2 * size], [c; h] per layer, so tree levels can
    interleave and fuse states as plain tensors. Each layer holds the
    weights of an `nn.LSTMCell` (gates i, f, g, o); flax's OptimizedLSTMCell
    has no input bias, so `bias_ih` holds zeros and is frozen (trained, it
    would move the gate bias twice per step).

    As flax's cell under dtype=bf16, the state c and h, the gates and their
    nonlinearities are in the compute dtype; the packed state and the output
    return in the parameters' dtype. (The card's fused LSTM-cell kernel
    evaluates the gates in float32 and rounds c and h once.)"""

    def __init__(self, in_size: int, size: int, n_layers: int):
        super().__init__()
        self.size, self.n_layers = size, n_layers
        self.optimized_lstm_cell = nn.ModuleList(
            nn.LSTMCell(in_size if i == 0 else size, size) for i in range(n_layers))
        for cell in self.optimized_lstm_cell:
            nn.init.zeros_(cell.bias_ih)
            cell.bias_ih.requires_grad_(False)

    @property
    def state_size(self) -> int:
        return self.n_layers * 2 * self.size

    def top_h(self, packed: torch.Tensor) -> torch.Tensor:
        """The top layer's h, [..., size]."""
        return packed[..., -self.size:]

    def forward(self, packed: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt, pdt = self.dtypes(self.optimized_lstm_cell[0].weight_hh)
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1]).to(dt)
        chunks = packed.reshape(-1, packed.shape[-1]).to(dt).chunk(self.n_layers, -1)
        new = []
        for cell, chunk in zip(self.optimized_lstm_cell, chunks):
            c, h = chunk.chunk(2, -1)
            h, c = torch.lstm_cell(x, (h, c), *(w.to(dt) for w in (
                cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)))
            new += [c, h]
            x = h
        return (torch.cat(new, -1).reshape(lead + (packed.shape[-1],)).to(pdt),
                x.reshape(lead + (self.size,)).to(pdt))


CONV_LSTM_SPATIAL = 4  # the latent grid's side in the conv-LSTM variant


class ConvLSTMCell(nn.Module):
    """flax's `nn.ConvLSTMCell` with 3x3 'SAME' convs (padding 1) on NHWC
    grids: `ih` on the input and `hh` on h, each with a bias; the gates
    split in the order i, g, f, o, and f = sigmoid(f + 1)."""

    def __init__(self, size: int):
        super().__init__()
        self.ih = nn.Conv2d(size, 4 * size, 3, padding=1)
        self.hh = nn.Conv2d(size, 4 * size, 3, padding=1)

    def forward(self, c: torch.Tensor, h: torch.Tensor, x: torch.Tensor,
                dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        gates = conv_nhwc(self.ih, x, dtype) + conv_nhwc(self.hh, h, dtype)
        i, g, f, o = gates.chunk(4, -1)
        new_c = torch.sigmoid(f + 1) * c + torch.sigmoid(i) * torch.tanh(g)
        return new_c, torch.sigmoid(o) * torch.tanh(new_c)


class ConvLSTMStack(Casting, nn.Module):
    """Multi-layer ConvLSTM advancing one step over a 4x4 latent grid (the
    JAX package's ConvLSTMStack, hp.use_conv_lstm), with
    LSTMStack's packed-state contract: one tensor [..., n_layers * 2 *
    spatial^2 * size] laid out [layer, (c|h), y, x, channel]. A vector step
    input enters through a Dense stem reshaped onto the grid; the step
    output is the top layer's h averaged over the grid, [..., size]."""

    spatial = CONV_LSTM_SPATIAL

    def __init__(self, in_size: int, size: int, n_layers: int):
        super().__init__()
        self.size, self.n_layers = size, n_layers
        self.dense = nn.ModuleList([nn.Linear(in_size, self.spatial ** 2 * size)])
        self.conv_lstm_cell = nn.ModuleList(ConvLSTMCell(size) for _ in range(n_layers))

    @property
    def state_size(self) -> int:
        return self.n_layers * 2 * self.spatial ** 2 * self.size

    def top_h(self, packed: torch.Tensor) -> torch.Tensor:
        """The top layer's h averaged over the grid, [..., size]."""
        s, c = self.spatial, self.size
        h = packed[..., -s * s * c:]
        return h.reshape(h.shape[:-1] + (s, s, c)).mean(dim=(-3, -2))

    def forward(self, packed: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt, pdt = self.dtypes(self.dense[0].weight)
        s, c = self.spatial, self.size
        lead = packed.shape[:-1]
        maps = packed.reshape(-1, self.n_layers, 2, s, s, c).to(dt)
        x = linear(self.dense[0], x.reshape(-1, x.shape[-1]), dt).reshape(-1, s, s, c)
        layers = []
        for i, cell in enumerate(self.conv_lstm_cell):
            new_c, x = cell(maps[:, i, 0], maps[:, i, 1], x, dt)
            layers.append(torch.stack([new_c, x], 1))  # [N, (c|h), y, x, channel]
        new = torch.stack(layers, 1).reshape(lead + (self.state_size,))
        return new.to(pdt), x.mean(dim=(1, 2)).reshape(lead + (c,)).to(pdt)


def make_lstm_stack(hp, in_size: int) -> nn.Module:
    """The recurrent core the hparams ask for: ConvLSTMStack under
    hp.use_conv_lstm, else LSTMStack; both pack their state alike."""
    cls = ConvLSTMStack if hp.get("use_conv_lstm", False) else LSTMStack
    return cls(in_size, hp["nz_mid_lstm"], hp["n_lstm_layers"])


def lstm_state_size(hp) -> int:
    """The packed state's width for the configured stack."""
    size = hp["n_lstm_layers"] * 2 * hp["nz_mid_lstm"]
    if hp.get("use_conv_lstm", False):
        size *= CONV_LSTM_SPATIAL ** 2
    return size


class ConvSeqEncoder(Casting, nn.Module):
    """1-D temporal conv + LeakyReLU over per-frame latents [B, T, D] (blox
    ConvSeqEncodingModule), 'SAME' padded: (k // 2) a side for an odd
    kernel, one more at the end for an even one."""

    def __init__(self, hp):
        super().__init__()
        self.k = hp.get("conv_inf_enc_kernel_size", 3)
        d = hp["nz_enc"]
        self.conv = nn.ModuleList(
            nn.Conv1d(d, d, self.k) for _ in range(hp.get("conv_inf_enc_layers", 1)))

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        dt, pdt = self.dtypes(self.conv[0].weight)
        x = seq.transpose(1, 2).to(dt)
        for conv in self.conv:
            x = _leaky(conv._conv_forward(pad_same(x, (self.k,), (1,)),
                                          conv.weight.to(dt), conv.bias.to(dt)))
        return x.transpose(1, 2).to(pdt)


class RecurrentSeqEncoder(Casting, nn.Module):
    """An LSTM over time (blox RecurrentSeqEncodingModule; flax's
    nn.RNN(OptimizedLSTMCell) from a zero state); bidirectional, a second
    LSTM over the reversed sequence, its outputs put back in time order,
    and a Dense over both (BidirectionalSeqEncodingModule). Each cell holds
    an `nn.LSTMCell`'s weights, gates i, f, g, o; flax's cell has no input
    bias, so `bias_ih` holds zeros and is frozen, as in LSTMStack."""

    def __init__(self, hp, bidirectional: bool = False):
        super().__init__()
        size = hp["nz_enc"]
        self.optimized_lstm_cell = nn.ModuleList(
            nn.LSTMCell(size, size) for _ in range(2 if bidirectional else 1))
        for cell in self.optimized_lstm_cell:
            nn.init.zeros_(cell.bias_ih)
            cell.bias_ih.requires_grad_(False)
        if bidirectional:
            self.dense = nn.ModuleList([nn.Linear(2 * size, size)])

    def _run(self, cell: nn.LSTMCell, x: torch.Tensor, dt: torch.dtype,
             reverse: bool) -> torch.Tensor:
        weights = [w.to(dt) for w in (cell.weight_ih, cell.weight_hh, cell.bias_ih,
                                      cell.bias_hh)]
        h = c = x.new_zeros(x.shape[0], cell.hidden_size)
        steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
        out = [None] * x.shape[1]
        for t in steps:
            h, c = torch.lstm_cell(x[:, t], (h, c), *weights)
            out[t] = h
        return torch.stack(out, 1)

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        dt, pdt = self.dtypes(self.optimized_lstm_cell[0].weight_hh)
        x = seq.to(dt)
        out = self._run(self.optimized_lstm_cell[0], x, dt, reverse=False)
        if len(self.optimized_lstm_cell) == 2:
            out_b = self._run(self.optimized_lstm_cell[1], x, dt, reverse=True)
            out = linear(self.dense[0], torch.cat([out, out_b], -1), dt)
        return out.to(pdt)


def build_seq_encoder(hp) -> Optional[nn.Module]:
    kind = hp.get("seq_enc", "none")
    if kind == "none":
        return None
    if kind == "conv":
        return ConvSeqEncoder(hp)
    if kind in ("lstm", "bi-lstm"):
        return RecurrentSeqEncoder(hp, bidirectional=kind == "bi-lstm")
    raise ValueError(f"unknown seq_enc {kind!r}")


class MaskedMultiheadAttention(Casting, nn.Module):
    """One layer of time-masked multi-head attention (the JAX package's
    MaskedMultiheadAttention, blox MultiheadAttention as used by the
    attentive inference). The query is already projected to nz_attn_key.

    Every node of a batch element attends over the same sequence, so the
    keys and values are projected once per sequence, [B, T, ...], and the
    node axis broadcasts; the JAX module projects a copy per node, which
    gives the same values and, summed over the copies, the same weight
    gradients. flax's auto-names Dense_0..2 (query, key, value) become
    `dense.0..2`; `log_attn_temp` is the learned softmax temperature.

    The projections and the logits are in the compute dtype. Dividing by the
    learned temperature, a parameter, promotes the logits to the parameters'
    dtype (jnp's promotion), so the softmax and the weighted sum run there;
    under a fixed temperature they stay in the compute dtype."""

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
        dt, pdt = self.dtypes(self.dense[0].weight)
        b, n = query.shape[:2]
        t, h = keys.shape[1], self.n_heads
        d_head = self.d_key // h
        q = linear(self.dense[0], query, dt).reshape(b, n, h, d_head)
        k = linear(self.dense[1], keys, dt).reshape(b, t, h, d_head)
        v = linear(self.dense[2], values, dt).reshape(b, t, h, self.nz_enc // h)
        logits = torch.einsum("bnhd,bthd->bnht", q, k) / math.sqrt(d_head)
        if self.log_attn_temp is not None:
            logits = logits.to(pdt) / torch.exp(self.log_attn_temp)
        else:
            logits = logits / self.temperature
        t_idx = torch.arange(t, device=query.device)
        mask = (t_idx >= start_ind[..., None]) & (t_idx <= end_ind[..., None])
        logits = torch.where(mask[:, :, None, :], logits,
                             torch.full_like(logits, -1e30))
        gamma = torch.softmax(logits, dim=-1)  # [B, N, h, T]
        attended = torch.einsum("bnht,bthd->bnhd", gamma, v.to(gamma.dtype))
        return (attended.reshape(b, n, self.nz_enc).to(pdt),
                gamma.mean(dim=2).to(pdt))
