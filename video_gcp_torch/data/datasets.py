"""Datasets (data/datasets.py of the JAX package), numpy only: the shared
per-example processing, the h5 trajectory readers and the synthetic
`RandomVideoDataset`.

Batch contract, per example:

    traj_seq   [T, H, W, C] uint8 images (NHWC; [-1, 1] on the device) or
               [T, state_dim] states
    pad_mask   [T] float32, 1 = real frame
    I_0, I_g   first and goal frame
    end_ind    int, index of the last real frame; start_ind = 0
    traj_seq_states [T, state_dim], actions [T-1, n_actions]

The h5 files hold `traj{i}/images` (uint8 [T, H, W, C] or [T, n_cam, H, W,
C]), `states`, `actions`, `pad_mask` and a global `traj_per_file`
(data_loader.py:134-155). They are read through the port's own HDF5 module
(`data/h5.py`) and frames are resized with `raster.resize_area`, a copy of
OpenCV's INTER_AREA, so neither h5py nor OpenCV is needed.
"""
from __future__ import annotations

import collections
import glob
import hashlib
import os
import random

import numpy as np

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.data import h5
from video_gcp_torch.planning.infra import raster


def resize_video(video: np.ndarray, size) -> np.ndarray:
    """[T, H, W, C] uint8 -> [T, size[0], size[1], C] (INTER_AREA)."""
    if tuple(video.shape[1:3]) == tuple(size):
        return video
    out = np.empty((video.shape[0], size[0], size[1], video.shape[-1]), dtype=video.dtype)
    for i in range(video.shape[0]):
        out[i] = raster.resize_area(video[i], size[1], size[0])
    return out


class BaseVideoDataset:
    """Phase split, image/state selection, I_0/I_g/pad_mask derivation
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
        self.randomize_length = mpar.get("randomize_length", False)
        self.randomize_start = mpar.get("randomize_start", False)
        self.states_mean = self.spec.get("states_mean", None)
        self.states_std = self.spec.get("states_std", None)
        # the maze re-renderer sets this False: its observations are drawn
        # from the states, so the stored frames are never read
        self.load_h5_images = True
        self._rng = np.random.RandomState()

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
        device (core/metrics.py:to_float_images)."""
        if images.ndim == 5:
            images = images[:, 0]  # camera axis
        if images.dtype != np.uint8:
            raise TypeError(f"images must be uint8, got {images.dtype}")
        return resize_video(images, (self.img_sz, self.img_sz))

    @staticmethod
    def get_dataset_spec(data_dir):
        """`dataset_spec.py` beside the data (gcp_builder.py:149-163)."""
        from video_gcp_torch.training.config import load_dataset_spec

        return load_dataset_spec(data_dir)


class VarLenVideoDataset(BaseVideoDataset):
    """h5 variable-length trajectories with random max_seq_len windows
    (data_loader.py:105-261)."""

    def __init__(self, data_dir, mpar, data_conf, phase, shuffle=True,
                 dataset_size=-1):
        super().__init__(data_dir, mpar, data_conf, phase, shuffle, dataset_size)
        self.filenames = self._get_filenames()
        self.traj_per_file = self._get_traj_per_file(self.filenames[0])
        self.ram_cache = mpar.get("ram_cache", True)
        self._cache = {}

    def _get_filenames(self):
        raise NotImplementedError

    @staticmethod
    def _shuffle_with_seed(arr, seed=2):
        rng = random.Random()
        rng.seed(seed)
        rng.shuffle(arr)
        return arr

    def _get_traj_per_file(self, path):
        with h5.File(path, "r") as f:
            return int(f["traj_per_file"][()])

    def __len__(self):
        full = len(self.filenames) * self.traj_per_file
        if self.dataset_size != -1:
            return min(self.dataset_size, full)
        return full

    def _load_traj(self, index) -> AttrDict:
        """The trajectory's arrays, cached in RAM after the first read: the
        cache holds the images camera-selected and resized to img_sz (uint8),
        so later epochs touch neither the disk nor the resize. Model param
        `ram_cache=False` turns it off for datasets larger than the host's
        memory."""
        cached = self._cache.get(index) if self.ram_cache else None
        if cached is None:
            path = self.filenames[index // self.traj_per_file]
            try:
                with h5.File(path, "r") as f:
                    key = f"traj{index % self.traj_per_file}"
                    cached = AttrDict()
                    if self.load_h5_images and key + "/images" in f:
                        imgs = f[key + "/images"][()]
                        if imgs.ndim == 5:
                            imgs = imgs[:, 0]  # camera axis
                        cached.images = resize_video(imgs, (self.img_sz, self.img_sz))
                    for name in ["states", "actions", "pad_mask"]:
                        if key + "/" + name in f:
                            cached[name] = f[key + "/" + name][()].astype(np.float32)
            except Exception as e:
                raise ValueError(f"Problem loading file {path}: {e}") from e
            if self.ram_cache:
                self._cache[index] = cached
        # a fresh AttrDict: the processing below pops and renames keys
        return AttrDict(cached)

    def __getitem__(self, index) -> AttrDict:
        data_dict = self._load_traj(index)
        end_ind = int(np.argmax(data_dict.pad_mask
                                * np.arange(data_dict.pad_mask.shape[0], dtype=np.float32)))
        start_ind = (self._rng.randint(0, max(end_ind - 1, 1))
                     if self.randomize_start else 0)
        start_ind, end_ind, data_dict = self._sample_max_len_video(data_dict, start_ind,
                                                                   end_ind)
        if self.randomize_length:
            end_ind = self._randomize_length(start_ind, end_ind, data_dict)
        data_dict.end_ind = end_ind
        data_dict.start_ind = start_ind
        return self.process_data_dict(data_dict)

    def _sample_max_len_video(self, data_dict, start_ind, end_ind):
        """A random max_seq_len window in training, the first one otherwise;
        padded or cropped to the fixed length (data_loader.py:175-189)."""
        target = self.max_seq_len
        extra = (end_ind - start_ind + 1) - target
        if self.phase == "train":
            offset = max(0, int(self._rng.rand() * (extra + 1))) + start_ind
        else:
            offset = 0

        def maybe_pad(val):
            val = val[offset:]
            n = val.shape[0]
            if n > target:
                return val[:target]
            if n < target:
                pad = np.zeros((target - n,) + val.shape[1:], dtype=val.dtype)
                return np.concatenate([val, pad], 0)
            return val

        data_dict = AttrDict({k: maybe_pad(v) for k, v in data_dict.items()})
        if "actions" in data_dict:
            data_dict.actions = data_dict.actions[:-1]
        end_ind = min(end_ind - offset, target - 1)
        return 0, end_ind, data_dict

    def _randomize_length(self, start_ind, end_ind, data_dict):
        """A uniform random length in [3, end] from a random chop
        (data_loader.py:191-211)."""
        length = 3 + int(self._rng.rand() * (end_ind - 2))
        chop = int(self._rng.rand() * (end_ind + 1 - length))
        end_ind = length - 1
        t = self.max_seq_len
        pad_mask = np.logical_and(np.arange(t) <= end_ind,
                                  np.arange(t) >= start_ind).astype(np.float32)

        def chop_pad(arr):
            arr = np.concatenate([arr[chop:], np.repeat(arr[-1:], chop, 0)], 0)
            arr[end_ind + 1:] = 0
            return arr

        for key in [k for k in data_dict if k != "pad_mask"]:
            data_dict[key] = chop_pad(data_dict[key])
        data_dict.pad_mask = pad_mask
        return end_ind


class FolderSplitVarLenVideoDataset(VarLenVideoDataset):
    """train/val/test by directory: {data_dir}/hdf5/{phase}/*
    (data_loader.py:264-272)."""

    def _get_filenames(self):
        filenames = sorted(glob.glob(os.path.join(self.data_dir, "hdf5", self.phase, "*")))
        if not filenames:
            raise RuntimeError(f"no files in {self.data_dir}/hdf5/{self.phase}")
        return self._shuffle_with_seed(filenames)


class GlobalSplitVarLenVideoDataset(VarLenVideoDataset):
    """train/val/test by a global fraction of the files
    (data_loader.py:275-289)."""

    def _get_filenames(self):
        filenames = []
        for root, _, files in os.walk(self.data_dir):
            for f in files:
                if f.endswith(".h5") and f != "dataset_info.h5":
                    filenames.append(os.path.join(root, f))
        if not filenames:
            raise RuntimeError(f"no h5 files under {self.data_dir}")
        filenames = self._shuffle_with_seed(filenames)
        frac = self.spec["split"]
        phases = ["train", "val", "test"]
        bounds = np.cumsum([0] + [frac[p] for p in phases])
        i = phases.index(self.phase)
        lo = int(len(filenames) * bounds[i])
        hi = int(len(filenames) * bounds[i + 1])
        return filenames[lo:hi]


class MazeGlobalSplitVarLenVideoDataset(GlobalSplitVarLenVideoDataset):
    """Keeps only the (x, y) position states (data_loader.py:292-296)."""

    def process_data_dict(self, data_dict):
        if "states" in data_dict:
            data_dict["states"] = data_dict["states"][..., :2]
        return super().process_data_dict(data_dict)


class MazeTopRenderedGlobalSplitVarLenVideoDataset(MazeGlobalSplitVarLenVideoDataset):
    """Replaces the stored images with top-down renders around the agent
    (data_loader.py:299-319): each frame's (x, y) state is drawn into the
    static maze overview with the goal marked, by the renderer that the
    TopdownMultiroom2dEnv uses at control time, so training and control see
    the same observations.

    The render is a function of the windowed state path and the crop
    window alone, so it is cached under the path's md5 and end index: later
    epochs skip the renderer. The cache is an LRU capped at
    GCP_RENDER_CACHE_MB (2048 by default), because randomized train windows
    insert new keys nearly every epoch."""

    def __init__(self, data_dir, mpar, data_conf, phase, shuffle=True,
                 dataset_size=-1):
        from video_gcp_torch.planning.infra.envs.multiroom2d import Multiroom2dEnv

        super().__init__(data_dir, mpar, data_conf, phase, shuffle, dataset_size)
        if "n_rooms" not in data_conf:
            raise ValueError("the maze re-renderer needs n_rooms in the dataset config")
        self.load_h5_images = False  # observations are re-rendered below
        self._crop_window_px = data_conf["crop_window"]
        self._render_env = Multiroom2dEnv({"n_rooms": data_conf["n_rooms"]}, no_env=True,
                                          crop_window=self._crop_window_px)
        self._render_cache = collections.OrderedDict()
        self._render_cache_bytes = 0
        self._render_cache_cap = int(
            float(os.environ.get("GCP_RENDER_CACHE_MB", "2048")) * 1e6)

    def process_data_dict(self, data_dict):
        if "states" not in data_dict or "end_ind" not in data_dict:
            raise ValueError("the maze re-renderer needs states and end_ind")
        end = data_dict["end_ind"]
        cache_key = rendered = None
        if self.ram_cache:
            path = np.ascontiguousarray(data_dict["states"][:end + 1, :2], dtype=np.float32)
            cache_key = (int(end), hashlib.md5(path.tobytes()).hexdigest())
            rendered = self._render_cache.get(cache_key)
            if rendered is not None:
                self._render_cache.move_to_end(cache_key)
        if rendered is None:
            w = self._crop_window_px
            raw = np.zeros((data_dict["states"].shape[0], 1, w * 2, w * 2, 3), dtype=np.uint8)
            self._render_env.render_traj_top_down_u8(data_dict["states"][:end + 1],
                                                     data_dict["states"][end, :2],
                                                     raw[:end + 1, 0])
            # resized before caching: a smaller cache, and the base class's
            # resize is then a no-op
            rendered = self.preprocess_images(raw)
            if cache_key is not None:
                self._render_cache[cache_key] = rendered
                self._render_cache_bytes += rendered.nbytes
                while (self._render_cache_bytes > self._render_cache_cap
                       and len(self._render_cache) > 1):
                    _, old = self._render_cache.popitem(last=False)
                    self._render_cache_bytes -= old.nbytes
        data_dict["images"] = rendered
        return super().process_data_dict(data_dict)


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
