"""Datasets (data/datasets.py of the JAX package), numpy only: the shared
per-example processing and the synthetic `RandomVideoDataset`.

Batch contract, per example:

    traj_seq   [T, H, W, C] uint8 images (NHWC; [-1, 1] on the device) or
               [T, state_dim] states
    pad_mask   [T] float32, 1 = real frame
    I_0, I_g   first and goal frame
    end_ind    int, index of the last real frame; start_ind = 0
    traj_seq_states [T, state_dim], actions [T-1, n_actions]

The h5 trajectory readers and the maze re-renderer wait until the published
data is in the repository.
"""
from __future__ import annotations

import numpy as np

from video_gcp_torch.core.attrdict import AttrDict


def resize_video(video: np.ndarray, size) -> np.ndarray:
    """[T, H, W, C] at `size`. The port has no image library: a video that
    would need resizing raises."""
    if tuple(video.shape[1:3]) == tuple(size):
        return video
    raise NotImplementedError(
        f"resize_video: frames of {tuple(video.shape[1:3])} need resizing to "
        f"{tuple(size)}, which the port does not do (no cv2)")


class BaseVideoDataset:
    """Image/state selection, I_0/I_g/pad_mask derivation
    (data_loader.py:23-102)."""

    def __init__(self, data_dir, mpar, data_conf, phase, shuffle=True,
                 dataset_size=-1):
        self.phase = phase
        self.data_dir = data_dir
        self.spec = data_conf.get("dataset_spec", AttrDict())
        self.data_conf = data_conf
        self.dataset_size = dataset_size
        self.shuffle = shuffle and phase == "train"
        self.use_states = not mpar.get("use_convs", True)
        self.img_sz = mpar.get("img_sz", 32)
        self.states_mean = self.spec.get("states_mean", None)
        self.states_std = self.spec.get("states_std", None)

    @property
    def max_seq_len(self):
        return self.spec["max_seq_len"]

    def process_data_dict(self, data_dict: AttrDict) -> AttrDict:
        if "images" in data_dict:
            data_dict.traj_seq_images = data_dict.pop("images")
        if "states" in data_dict:
            data_dict.traj_seq_states = data_dict.pop("states")
            if self.states_mean is not None:
                data_dict.traj_seq_states = (
                    data_dict.traj_seq_states - self.states_mean
                ) / (1e-6 + self.states_std)
        if "traj_seq_images" in data_dict and data_dict.traj_seq_images.ndim > 1:
            data_dict.traj_seq_images = self.preprocess_images(
                data_dict.traj_seq_images)
        data_dict.traj_seq = (data_dict.traj_seq_states if self.use_states
                              else data_dict.traj_seq_images)
        if "start_ind" not in data_dict:
            data_dict.start_ind = 0
        if "end_ind" not in data_dict:
            data_dict.end_ind = self.max_seq_len - 1
        if "pad_mask" not in data_dict:
            data_dict.pad_mask = np.ones(self.max_seq_len, dtype=np.float32)
        data_dict.I_0 = data_dict.traj_seq[0]
        data_dict.I_g = data_dict.traj_seq[data_dict.end_ind]
        if "traj_seq_images" in data_dict:
            data_dict.I_0_image = data_dict.traj_seq_images[0]
            data_dict.I_g_image = data_dict.traj_seq_images[data_dict.end_ind]
            if not self.use_states:
                del data_dict["traj_seq_images"]  # identical to traj_seq
        return data_dict

    def preprocess_images(self, images: np.ndarray) -> np.ndarray:
        """uint8 NHWC at img_sz; the [-1, 1] normalization runs on the
        device (models/base.py:to_float_images)."""
        if images.ndim == 5:
            images = images[:, 0]  # camera axis
        if images.dtype != np.uint8:
            raise TypeError(f"images must be uint8, got {images.dtype}")
        return resize_video(images, (self.img_sz, self.img_sz))


class RandomVideoDataset(BaseVideoDataset):
    """Synthetic point-mass video: per index, a dot moves along a random
    piecewise-linear path on a dark background, deterministic from the index
    (the same frames as the JAX package's RandomVideoDataset)."""

    def __init__(self, data_dir, mpar, data_conf, phase, shuffle=True,
                 dataset_size=256):
        super().__init__(data_dir, mpar, data_conf, phase, shuffle, dataset_size)
        if "max_seq_len" not in self.spec:
            self.spec["max_seq_len"] = mpar.get("max_seq_len", 20)
        self.n_seqs = dataset_size if dataset_size != -1 else 256
        self.phase_seed = {"train": 0, "val": 10_000_000, "test": 20_000_000}[phase]

    def __len__(self):
        return self.n_seqs

    def __getitem__(self, index) -> AttrDict:
        rng = np.random.RandomState(self.phase_seed + index)
        t = self.max_seq_len
        length = rng.randint(max(t // 2, 4), t + 1)

        # piecewise-linear waypoint path in [0.15, 0.85]^2
        n_way = rng.randint(2, 5)
        way = rng.rand(n_way, 2) * 0.7 + 0.15
        seg = np.linspace(0, n_way - 1, length)
        lo = np.floor(seg).astype(int)
        frac = (seg - lo)[:, None]
        hi = np.minimum(lo + 1, n_way - 1)
        states = way[lo] * (1 - frac) + way[hi] * frac  # [length, 2]

        imgs = np.zeros((t, self.img_sz, self.img_sz, 3), dtype=np.uint8)
        yy, xx = np.mgrid[0:self.img_sz, 0:self.img_sz]
        for i in range(length):
            cx, cy = states[i] * self.img_sz
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                          / (2 * (self.img_sz / 12) ** 2))
            imgs[i, :, :, 0] = (blob * 255).astype(np.uint8)
            imgs[i, :, :, 1] = ((1 - blob) * 60).astype(np.uint8)

        pad_mask = np.zeros(t, dtype=np.float32)
        pad_mask[:length] = 1.0
        full_states = np.zeros((t, 2), dtype=np.float32)
        full_states[:length] = states
        actions = np.zeros((t - 1, 2), dtype=np.float32)
        actions[:length - 1] = np.diff(full_states[:length], axis=0)

        return self.process_data_dict(AttrDict(
            images=imgs, states=full_states, actions=actions, pad_mask=pad_mask,
            end_ind=length - 1, start_ind=0))
