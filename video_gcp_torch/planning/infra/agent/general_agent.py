"""Environment rollout agents with retry-on-failure and observation history.

Behavior parity with gcp/planning/infra/agent/general_agent.py:23-340 +
benchmarking_agent.py:11-94 (one trajectory per `sample`; policy arguments
filled by signature reflection; retries up to N_MAX_TRIALS; optional
rejection sampling until the goal is reached; per-trajectory gifs), built
around an `ObsHistory` buffer object that owns all per-key preallocation and
history views instead of an inline cache-dict loop.

A copy of planning/infra/agent/general_agent.py of the JAX package: images
are resized and PNGs read and written with `raster`, h5 files read with the
port's HDF5 module (`data/h5.py`), and pickles read with the port's
unpickler.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from video_gcp_torch.core.attrdict import load_pickle
from video_gcp_torch.core.params import ParamDict
from video_gcp_torch.data import h5
from video_gcp_torch.planning.infra import raster
from video_gcp_torch.planning.infra.policy.policy import get_policy_args


class Image_Exception(Exception):
    pass


class Environment_Exception(Exception):
    pass


def _fit_image(img, h, w):
    if img.shape[0] == h and img.shape[1] == w:
        return img
    return raster.resize_area(img, w, h)


def resize_store(t, target_array, input_array):
    """Resize per-camera frames into row t of the cache (im_utils)."""
    h, w = target_array.shape[2:4]
    target_array[t] = np.stack([_fit_image(im, h, w) for im in input_array])


def npy_to_gif(images, path, fps=4):
    """Save a frame list as gif (im_utils.npy_to_gif); falls back to a PNG
    film-strip when imageio is unavailable."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        import imageio
    except ImportError:
        strip = np.concatenate(images[:: max(len(images) // 10, 1)], axis=1)
        raster.write_png(path + ".png", strip)
        return
    imageio.mimsave(path + ".gif", images, fps=fps)


class ObsHistory:
    """Typed per-key observation history over one rollout.

    On the first observation every key gets a [horizon, ...] buffer: images a
    uint8 buffer of the agent's camera geometry (frames are resized in),
    other arrays a same-shape/dtype buffer, everything else a plain list.
    `record` appends; `view` returns the history-so-far per key.
    """

    def __init__(self, horizon, ncam, height, width, nchannels):
        self._horizon = horizon
        self._img_shape = (ncam, height, width, nchannels)
        self._buffers = None
        self._t = 0

    def record(self, env_obs):
        if self._buffers is None:
            self._buffers = {k: self._alloc(k, v) for k, v in env_obs.items()}
        t = self._t
        for k, v in env_obs.items():
            buf = self._buffers[k]
            if k == "images":
                resize_store(t, buf, v)
            elif isinstance(buf, list):
                buf.append(v)
            else:
                buf[t] = v
        self._t += 1

    def _alloc(self, key, value):
        if key == "images":
            return np.zeros((self._horizon,) + self._img_shape, dtype=np.uint8)
        if isinstance(value, np.ndarray):
            return np.zeros((self._horizon,) + value.shape, dtype=value.dtype)
        return []

    def view(self):
        return {k: buf if isinstance(buf, list) else buf[: self._t]
                for k, buf in self._buffers.items()}

    def latest_frame(self, cam=0):
        if "images" not in self._buffers:
            return None
        return self._buffers["images"][self._t - 1, cam]


class GeneralAgent:
    N_MAX_TRIALS = 100

    def __init__(self, hyperparams, start_goal_list=None):
        self._hp = self._default_hparams()
        self.override_defaults(hyperparams)
        self.T = self._hp.T
        self._start_goal_list = start_goal_list
        self._goal = None
        self._goal_seq = None
        self._goal_image = None
        self._demo_images = None
        self._reset_state = None
        self.gif_images_traj, self.topdown_images = [], []
        self._setup_world(0)

    def override_defaults(self, config):
        for name, value in config.items():
            self._hp[name] = value

    def _default_hparams(self):
        return ParamDict(
            T=None, adim=None, sdim=None, ncam=1,
            rejection_sample=False, type=None, env=None,
            image_height=48, image_width=64, nchannels=3,
            data_save_dir="", log_dir="",
            make_final_gif=True, make_final_gif_freq=1,
            make_final_gif_pointoverlay=False,
            gen_xml=(True, 1),  # re-setup env every N trajectories
            start_goal_confs=None, show_progress=False,
            do_not_save_images=False,
        )

    def _setup_world(self, itr):
        env_type, env_params = self._hp.env
        env_params = dict(env_params)
        if self._start_goal_list is not None:
            env_params["init_pos"] = self._start_goal_list[itr, 0]
            env_params["goal_pos"] = self._start_goal_list[itr, 1]
        self.env = env_type(env_params, self._reset_state)
        self._hp.adim = self.adim = self.env.adim
        self._hp.sdim = self.sdim = self.env.sdim
        self._hp.ncam = self.ncam = self.env.ncam

    # ------------------------------------------------------------------

    def sample(self, policy, i_traj):
        """One trajectory: re-setup the env when due (the benchmark agent
        reloads start/goal configs here, benchmarking_agent.py:20), then
        retry rollouts until one is valid."""
        self.i_traj = i_traj
        if self._hp.gen_xml[0] and i_traj > 0 \
                and i_traj % self._hp.gen_xml[1] == 0:
            self._setup_world(i_traj)

        result = (None, None, None)
        for i_trial in range(1, self.N_MAX_TRIALS + 1):
            try:
                result = self.rollout(policy, i_trial, i_traj)
            except Image_Exception:
                continue
            if result[0]["traj_ok"]:
                break

        if self._hp.make_final_gif and i_traj % self._hp.make_final_gif_freq == 0:
            self.save_gif(i_traj)
        self._reset_state = None
        return result

    def rollout(self, policy, i_trial, i_traj):
        self.gif_images_traj, self.topdown_images = [], []
        self._history = ObsHistory(
            self._hp.T + 1, self._hp.ncam, self._hp.image_height,
            self._hp.image_width, self._hp.nchannels)
        agent_data, policy_outputs = {}, []

        initial_env_obs, self._reset_state = self.env.reset(self._reset_state)
        obs = self._record_obs(initial_env_obs, agent_data)
        policy.reset()

        t, done = 0, self._hp.T <= 0
        while not done:
            pi_t = policy.act(
                **get_policy_args(policy, obs, t, i_traj, agent_data))
            policy_outputs.append(pi_t)
            if "done" in pi_t:
                done = pi_t["done"]
            try:
                obs = self._record_obs(self.env.step(pi_t["actions"]),
                                       agent_data)
            except Environment_Exception:
                return {"traj_ok": False}, None, None
            if t == self._hp.T - 1 or obs["env_done"][-1]:
                done = True
            t += 1

        traj_ok = self.env.valid_rollout()
        if self._hp.rejection_sample and self._hp.rejection_sample > i_trial:
            traj_ok = self.env.goal_reached()
        self._required_rollout_metadata(agent_data, traj_ok, t, i_trial)
        return agent_data, obs, policy_outputs

    def _record_obs(self, env_obs, agent_data):
        """Append an env observation; return the history view plus the
        standing goal/demo/reset metadata."""
        self._history.record(env_obs)
        frame = self._history.latest_frame()
        if frame is not None:
            self.gif_images_traj.append(frame)

        obs = self._history.view()
        for key, value in (("goal_image", self._goal_image),
                           ("goal", self._goal),
                           ("demo_images", self._demo_images)):
            if value is not None:
                agent_data[key] = value
        if self._reset_state is not None:
            agent_data["reset_state"] = self._reset_state
            obs["reset_state"] = self._reset_state
        return obs

    def _required_rollout_metadata(self, agent_data, traj_ok, t, i_tr):
        agent_data["term_t"] = t - 1
        if hasattr(self.env, "goal_reached"):
            try:
                agent_data["goal_reached"] = self.env.goal_reached()
            except NotImplementedError:
                pass
        agent_data["traj_ok"] = traj_ok

    def save_gif(self, i_traj, overlay=False):
        if self.gif_images_traj:
            npy_to_gif(self.gif_images_traj,
                       os.path.join(self._hp.log_dir,
                                    f"verbose/traj{i_traj}/video"))


class BenchmarkAgent(GeneralAgent):
    """1-trial evaluation agent; loads start/goal confs from disk and adds
    env.eval() stats (benchmarking_agent.py:11-94)."""

    N_MAX_TRIALS = 1

    def __init__(self, hyperparams, start_goal_list=None):
        self._start_goal_confs = hyperparams.get("start_goal_confs", None)
        super().__init__(hyperparams, start_goal_list)

    def _setup_world(self, itr):
        super()._setup_world(itr)
        if self._start_goal_confs is not None:
            self._reset_state = self._load_raw_data(itr)

    def _required_rollout_metadata(self, agent_data, traj_ok, t, i_itr):
        super()._required_rollout_metadata(agent_data, traj_ok, t, i_itr)
        agent_data.update(self.env.eval())

    def get_reset_state(self, obs_dict):
        return self.env.get_reset_from_obs(obs_dict)

    def _load_raw_data(self, itr):
        """Reverse of RawSaver.save_raw_data (benchmarking_agent.py:39-91):
        demo start/goal images + the env reset state from obs_dict.pkl."""
        folder = os.path.join(self._start_goal_confs,
                              f"traj_group{itr // 1000}", f"traj{itr}")
        n_frames = len(glob.glob(os.path.join(folder, "images0", "*.png")))
        assert n_frames > 0, f"no files found in {folder}!"

        h, w = self._hp.image_height, self._hp.image_width
        demo = np.zeros((n_frames, self.ncam, h, w, 3))
        for t in (0, n_frames - 1):
            for c in range(self.ncam):
                rgb = raster.read_png(os.path.join(folder, f"images{c}",
                                                   f"im_{t}.png"))
                demo[t, c] = _fit_image(rgb, h, w)
        self._demo_images = demo.astype(np.float32) / 255.0
        self._goal_image = self._demo_images[-1]

        obs_dict = dict(load_pickle(os.path.join(folder, "obs_dict.pkl")))
        self._goal = self.env.get_goal_from_obs(obs_dict)
        return self.env.get_reset_from_obs(obs_dict)


class BenchmarkAgentLoadHDF5(BenchmarkAgent):
    """Benchmark agent that takes its start and goal from an h5 trajectory
    file (benchmarking_agent_load_hdf5.py:9-42): the start state is the first
    frame's, the goal the last valid frame's, and the goal image that frame
    resized bilinearly."""

    def _load_raw_data(self, itr):
        path = self._start_goal_confs
        if not path.endswith(".h5"):
            files = sorted(glob.glob(os.path.join(path, "**/*.h5"), recursive=True))
            assert files, f"no h5 files under {path}"
            path, itr = files[itr % len(files)], itr // len(files)
        with h5.File(path, "r") as f:
            key = f"traj{itr % int(f['traj_per_file'][()])}"
            states = f[f"{key}/states"][()]
            pad_mask = f[f"{key}/pad_mask"][()]
            end = int(np.argmax(pad_mask * np.arange(len(pad_mask))))
            images = f[f"{key}/images"][()] if f"{key}/images" in f else None

        if images is not None:
            h, w = self._hp.image_height, self._hp.image_width
            goal_img = images[end].astype(np.float32) / 255.0
            if goal_img.ndim == 3:
                goal_img = goal_img[None]
            self._goal_image = np.stack([raster.resize_linear(goal_img[c], w, h)
                                         for c in range(goal_img.shape[0])])[None]
            self._demo_images = None
        self._goal = states[end, -2:] if states.shape[-1] > 3 else states[end, :2]
        return np.concatenate([states[0][:2], [0.0], self._goal])
