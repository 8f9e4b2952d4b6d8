"""The one generator of inputs: sequences made on the device from the seed,
as a traffic mix (`traffic/<mix>.json`) describes them.

A sequence is a bright disc that walks smoothly over a background of its
own colour, rendered at the configuration's image size: frames near in time
look alike and far ones differ, as in the maze datasets, so matching
frames to nodes (the eval DTW) has something to find. Its states are the
disc's positions and its actions their steps. Frames after the last real
one are zero and masked, as the datasets pad them.

Every seed gets the same set of lengths: `lengths.full` of the rows run the
whole `seq_len`, the rest are spread evenly over [`lengths.min`,
`seq_len` - 1] frames; the seed orders them and draws the walks.
"""
from __future__ import annotations

import torch


def lengths(mix: dict, rows: int) -> list:
    """The set of sequence lengths (frames) of `rows` rows."""
    t = mix["seq_len"]
    spec = mix.get("lengths", {})
    n_full = round(spec.get("full", 1.0) * rows)
    lo = min(spec.get("min", t), t)
    rest = rows - n_full
    return [t] * n_full + [round(lo + (t - 1 - lo) * i / max(rest - 1, 1)) for i in range(rest)]


def sequences(mix: dict, img_sz: int, rows: int, seed: int, device) -> dict:
    """`rows` sequences [rows, T, ...] from `seed`: traj_seq (uint8 NHWC),
    traj_seq_states, actions, pad_mask, end_ind, I_0 and I_g."""
    t = mix["seq_len"]
    gen = torch.Generator(device).manual_seed(seed)
    lens = torch.tensor(lengths(mix, rows), device=device)
    lens = lens[torch.randperm(rows, generator=gen, device=device)]
    end_ind = lens - 1
    # a smooth walk in [0.15, 0.85]^2: velocity a low-passed normal draw
    noise = torch.randn(rows, t, 2, generator=gen, device=device)
    vel = torch.zeros_like(noise)
    step = mix.get("step", 0.03)
    for i in range(1, t):
        vel[:, i] = 0.9 * vel[:, i - 1] + step * noise[:, i]
    pos = torch.remainder(0.5 + torch.cumsum(vel, 1), 2.0)
    pos = 0.15 + 0.7 * torch.where(pos > 1.0, 2.0 - pos, pos)  # reflected at the walls
    grid = (torch.arange(img_sz, device=device, dtype=torch.float32) + 0.5) / img_sz
    dy = grid[None, None, :, None] - pos[:, :, 1, None, None]
    dx = grid[None, None, None, :] - pos[:, :, 0, None, None]
    disc = torch.exp(-(dx * dx + dy * dy) / (2 * mix.get("radius", 0.08) ** 2))
    colour = torch.rand(rows, 1, 1, 1, 3, generator=gen, device=device) * 0.5
    img = colour + (1.0 - colour) * disc[..., None]  # [rows, T, H, W, 3]
    valid = torch.arange(t, device=device)[None, :] <= end_ind[:, None]
    img = img * valid[:, :, None, None, None]
    traj_seq = (img * 255.0).round().to(torch.uint8)
    rows_idx = torch.arange(rows, device=device)
    pad_mask = valid.to(torch.float32)
    return dict(traj_seq=traj_seq, traj_seq_states=pos * pad_mask[..., None],
                actions=(pos[:, 1:] - pos[:, :-1]) * pad_mask[:, 1:, None],
                pad_mask=pad_mask, end_ind=end_ind,
                I_0=traj_seq[:, 0], I_g=traj_seq[rows_idx, end_ind])


def batches(mix: dict, img_sz: int, seed: int, device) -> list:
    """`mix.pool_batches` batches of `mix.batch` rows, all rows different."""
    b, n = mix["batch"], mix["pool_batches"]
    pool = sequences(mix, img_sz, b * n, seed, device)
    return [{k: v[i * b:(i + 1) * b] for k, v in pool.items()} for i in range(n)]


def n_frames(mix: dict) -> int:
    """Frames a batch holds (B * T): the unit of the throughput metrics."""
    return mix["batch"] * mix["seq_len"]

