"""Trajectory savers: HDF5 (train/val/test split, padded) + raw pngs/pkl.

Reference: gcp/planning/infra/agent/utils/hdf5_saver.py + record_saver.py
HDF5SaverBase + RawSaver (raw_saver.py). The HDF5 layout matches the
framework's dataset reader exactly (datasets.VarLenVideoDataset):
`traj{i}/images,states,actions,pad_mask` + `traj_per_file`.

A copy of planning/infra/agent/savers.py of the JAX package: PNGs are
written with `raster.write_png` and h5 files with the port's own HDF5
module (`data/h5.py`), so data generation needs neither OpenCV nor h5py.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.data import h5
from video_gcp_torch.planning.infra import raster


def pad_traj_timesteps(traj: AttrDict, max_num_actions: int) -> AttrDict:
    """Zero-pad images/actions to fixed length (hdf5_saver.py:9-36)."""
    if "images" in traj:
        im_shape = traj.images.shape
        if im_shape[0] < max_num_actions + 1:
            zeros = np.zeros(
                (max_num_actions + 1 - im_shape[0],) + im_shape[1:],
                dtype=np.uint8,
            )
            traj.images = np.concatenate([traj.images, zeros])
    ac_shape = traj.actions.shape
    if ac_shape[0] < max_num_actions:
        zeros = np.zeros((max_num_actions - ac_shape[0],) + ac_shape[1:])
        traj.actions = np.concatenate([traj.actions, zeros])
    for key in ["states", "regression_state"]:
        if key in traj and traj[key].shape[0] < max_num_actions + 1:
            zeros = np.zeros(
                (max_num_actions + 1 - traj[key].shape[0],) + traj[key].shape[1:],
                dtype=traj[key].dtype,
            )
            traj[key] = np.concatenate([traj[key], zeros])
    return traj


def get_pad_mask(action_len: int, max_num_actions: int) -> np.ndarray:
    """1 where real frames, 0 where padded (hdf5_saver.py:39-55)."""
    if action_len < max_num_actions:
        return np.concatenate(
            [np.ones(action_len + 1), np.zeros(max_num_actions - action_len)]
        )
    if action_len == max_num_actions:
        return np.ones(max_num_actions + 1)
    raise ValueError


class HDF5Saver:
    """Buffers trajectories and writes traj_per_file-sized h5 files into
    train/val/test subdirectories (record_saver.HDF5SaverBase:184-235)."""

    def __init__(self, save_dir, envparams, agentparams, traj_per_file,
                 offset=0, split=(0.90, 0.05, 0.05),
                 split_train_val_test=True):
        self.save_dir = save_dir
        self.traj_per_file = traj_per_file
        self.split = split
        self.split_train_val_test = split_train_val_test
        self.do_not_save_images = agentparams.get("do_not_save_images", False)
        self.max_num_actions = agentparams["T"]
        self._buffer = []
        self._file_cntr = offset
        os.makedirs(save_dir, exist_ok=True)

    def _save_manifests(self, agent_data, obs, policy_out):
        pass

    def make_traj(self, agent_data, obs, policy_out) -> AttrDict:
        traj = AttrDict()
        if not self.do_not_save_images:
            traj.images = obs["images"]
        traj.states = obs["state"]
        traj.actions = np.stack([p["actions"] for p in policy_out], 0)
        traj.pad_mask = get_pad_mask(traj.actions.shape[0],
                                     self.max_num_actions)
        return pad_traj_timesteps(traj, self.max_num_actions)

    def save_traj(self, itr, agent_data, obs, policy_out):
        self._buffer.append(self.make_traj(agent_data, obs, policy_out))
        if len(self._buffer) >= self.traj_per_file:
            self._flush()

    def _phase_dir(self):
        if not self.split_train_val_test:
            return self.save_dir
        draw = np.random.rand()
        if draw < self.split[0]:
            phase = "train"
        elif draw < self.split[0] + self.split[1]:
            phase = "val"
        else:
            phase = "test"
        d = os.path.join(self.save_dir, "hdf5", phase)
        os.makedirs(d, exist_ok=True)
        return d

    def _flush(self):
        path = os.path.join(self._phase_dir(), f"traj_{self._file_cntr}.h5")
        with h5.File(path, "w") as f:
            f.create_dataset("traj_per_file", data=len(self._buffer))
            for i, traj in enumerate(self._buffer):
                for k, v in traj.items():
                    f.create_dataset(f"traj{i}/{k}", data=v)
        self._write_dataset_spec(self._buffer[0])
        self._buffer = []
        self._file_cntr += 1

    def _write_dataset_spec(self, traj):
        """Ship a `dataset_spec.py` with the data, like the published datasets
        (the trainer loads it and merges the dims into the model config,
        gcp_builder.py:149-163). Raw dims recorded here; dataset
        config modules may override (e.g. maze datasets train on (x, y) only).
        """
        spec_path = os.path.join(self.save_dir, "dataset_spec.py")
        if os.path.exists(spec_path):
            return
        spec = {
            "max_seq_len": int(self.max_num_actions),
            "state_dim": int(traj.states.shape[-1]) if "states" in traj else -1,
            "n_actions": int(traj.actions.shape[-1]),
        }
        body = ",\n    ".join(f"{k}={v}" for k, v in spec.items())
        with open(spec_path, "w") as f:  # a plain dict: both packages read it
            f.write("# auto-generated by HDF5Saver at data collection time\n"
                    f"dataset_spec = dict(\n    {body},\n)\n")

    def flush(self):
        if self._buffer:
            self._flush()


class RawSaver:
    """Per-trajectory pngs + obs pkl (raw_saver.py), the format
    BenchmarkAgent._load_raw_data reads back."""

    def __init__(self, save_dir, ngroup=1000):
        self.save_dir = save_dir
        self.ngroup = ngroup

    def save_traj(self, itr, agent_data=None, obs_dict=None, policy_out=None):
        igrp = itr // self.ngroup
        traj_folder = os.path.join(
            self.save_dir, f"raw/traj_group{igrp}", f"traj{itr}"
        )
        os.makedirs(traj_folder, exist_ok=True)
        if obs_dict is not None and "images" in obs_dict:
            images = obs_dict["images"]
            for c in range(images.shape[1]):
                cam_dir = os.path.join(traj_folder, f"images{c}")
                os.makedirs(cam_dir, exist_ok=True)
                for t in range(images.shape[0]):
                    raster.write_png(os.path.join(cam_dir, f"im_{t}.png"),
                                     images[t, c])
        if agent_data is not None:
            with open(os.path.join(traj_folder, "agent_data.pkl"), "wb") as f:
                pickle.dump(agent_data, f)
        if obs_dict is not None:
            with open(os.path.join(traj_folder, "obs_dict.pkl"), "wb") as f:
                pickle.dump(
                    {k: v for k, v in obs_dict.items() if k != "images"}, f
                )
        if policy_out is not None:
            with open(os.path.join(traj_folder, "policy_out.pkl"), "wb") as f:
                pickle.dump(policy_out, f)
