"""Multiroom navigation environment (kinematic 2-D core + top-down obs).

Reference: gcp/planning/infra/envs/miniworld_env/multiroom3d/
multiroom3d_env.py + base_miniworld_env.py + base_env.py. The reference wraps
the gym-miniworld OpenGL 3-D env (an EMPTY external submodule in the
checkout); the published data-gen and control configs only consume the
TopdownMultiroom3dEnv variant whose observations are cv2 top-down renders
(SURVEY.md §2.13). This rebuild provides:

- Multiroom2dEnv: kinematic point agent in the deterministic maze layout with
  wall-collision checks (KD-tree over the wall point cloud), PRM shortest-dist
  eval metrics, and the reference's top-down renderers.
- TopdownMultiroom2dEnv: image observations = cropped top-down renders around
  the agent — the drop-in equivalent of TopdownMultiroom3dEnv.
- EgocentricMultiroom2dEnv: first-person observations from the raycaster in
  fpv.py, the reference's Multiroom3dEnv camera mode.

A real gym-miniworld 3-D env can still be wrapped by subclassing and
overriding reset/step (kept as an optional host dependency, as the reference
treats it).

A numpy copy of planning/infra/envs/multiroom2d.py of the JAX package; the
agent and goal dots and the trajectories are drawn with `raster.line` in
place of `cv2.line`.
"""
from __future__ import annotations

import copy
import numbers

import numpy as np
from scipy.spatial import cKDTree

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.params import ParamDict
from video_gcp_torch.planning.infra import raster
from video_gcp_torch.planning.infra.envs.layout import (
    RoomSampler2d,
    define_layout,
    draw_layout_overview,
)


class BaseEnv:
    """Env interface (base_env.py:6-126)."""

    def reset(self, reset_state=None):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def valid_rollout(self):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    @property
    def adim(self):
        raise NotImplementedError

    @property
    def sdim(self):
        raise NotImplementedError


class Multiroom2dEnv(BaseEnv):
    def __init__(self, hp, reset_state=None, no_env=False, crop_window=None):
        self._hp = self._default_hparams()
        for name, value in hp.items():
            self._hp[name] = value

        self._ncam = 1
        self._goal = None
        self._goaldistances = []
        self._initial_shortest_dist = None
        self._final_shortest_dist = None
        self._full_traj = []

        self._rooms_per_side = int(np.sqrt(self._hp.n_rooms))
        self._layout = define_layout(self._rooms_per_side)
        self._topdown_render_scale = 256
        self._static_img_topdown = draw_layout_overview(
            self._rooms_per_side, self._topdown_render_scale
        )
        self._crop_window = crop_window
        if crop_window is not None:
            pad = crop_window
            bg = self._static_img_topdown
            padded = np.zeros((bg.shape[0] + 2 * pad, bg.shape[1] + 2 * pad, 3),
                              dtype=bg.dtype)
            padded[pad:-pad, pad:-pad] = bg
            self._static_img_topdown = padded

        self._adim, self._sdim = 2, 3
        self._wall_tree = cKDTree(
            np.stack([self._layout.ox, self._layout.oy], axis=1)
        )
        self.state_sampler = RoomSampler2d(self._rooms_per_side)
        self.current_pos = None
        self.goal_pos = None
        self.prm_policy = None
        self._heading = 0.0

    def _default_hparams(self):
        return ParamDict(
            obs_height=300, obs_width=400, goal_pos=None, init_pos=None,
            n_rooms=9, heading_smoothing=0.2,
        )

    # --- coordinate transforms: identity in the 2-D core (the reference's
    # mj2mw/mw2mj map between mujoco layout coords and the 27x-scaled
    # miniworld frame; without the 3-D env both sides use layout coords) ---
    @staticmethod
    def mj2mw(x):
        return np.asarray(x)

    @staticmethod
    def mw2mj(x):
        return np.asarray(x)

    # ------------------------------------------------------------------

    def reset(self, reset_state=None):
        self._goaldistances = []
        self._full_traj = []
        if reset_state is None:
            start_pos = self.state_sampler.sample(self._hp.init_pos)
            start_angle = 2 * np.pi * np.random.rand()
            goal_pos = self.state_sampler.sample(self._hp.goal_pos)
        else:
            start_pos = np.asarray(reset_state[:2])
            start_angle = float(reset_state[2])
            goal_pos = np.asarray(reset_state[-2:])

        reset_state_out = AttrDict(start_pos=start_pos,
                                   start_angle=start_angle, goal=goal_pos)
        self.goal_pos = goal_pos
        self._goal = goal_pos
        self._heading = start_angle
        self.current_pos = np.concatenate([start_pos, [start_angle]])
        obs = self._make_obs()
        self._post_step(self.current_pos)
        self._initial_shortest_dist = self.comp_shortest_dist(start_pos, goal_pos)
        return obs, reset_state_out

    def step(self, action):
        action = np.asarray(action, np.float32)
        pos = self.current_pos[:2]
        new_pos = pos + action
        # wall collision: sub-step and stop before penetrating a wall
        n_sub = max(int(np.ceil(np.linalg.norm(action) /
                                (self._layout.robot_size / 2))), 1)
        for k in range(1, n_sub + 1):
            cand = pos + action * k / n_sub
            if self._collides(cand):
                new_pos = pos + action * (k - 1) / n_sub
                break
        else:
            new_pos = pos + action

        # heading smoothing (multiroom3d_env heading_smoothing param)
        if np.linalg.norm(action) > 1e-8:
            target = np.arctan2(action[1], action[0])
            a = self._hp.heading_smoothing
            self._heading = (1 - a) * self._heading + a * target
        self.current_pos = np.concatenate([new_pos, [self._heading]])
        obs = self._make_obs()
        self._post_step(self.current_pos)
        return obs

    def _collides(self, pos):
        half = self._layout.table_size / 2
        if (np.abs(pos) > half - self._layout.robot_size).any():
            return True
        d, _ = self._wall_tree.query(pos)
        return d <= self._layout.robot_size

    def _make_obs(self):
        qpos_full = self.current_pos.copy()
        return AttrDict(
            images=self._render_obs()[None],  # add camera dim
            qpos_full=qpos_full,
            goal=self.goal_pos,
            env_done=False,
            state=np.concatenate([qpos_full, self.goal_pos]),
            topdown_image=self.render_pos_top_down(qpos_full, self.goal_pos),
        )

    def _render_obs(self):
        """Camera observation; the 2-D core renders top-down."""
        img = self.render_pos_top_down(self.current_pos, self.goal_pos)
        return np.asarray(img * 255, dtype=np.uint8)

    def _post_step(self, agent_pos):
        self.current_pos = agent_pos
        self._goaldistances.append(
            self.comp_shortest_dist(agent_pos[:2], self.goal_pos)
        )
        self._full_traj.append(agent_pos)

    def valid_rollout(self):
        return True

    def eval(self):
        self._final_shortest_dist = self.comp_shortest_dist(
            self.current_pos[:2], self.goal_pos
        )
        stats = {}
        stats["improvement"] = self._initial_shortest_dist - self._final_shortest_dist
        stats["initial_dist"] = self._initial_shortest_dist
        stats["final_dist"] = self._final_shortest_dist
        stats["all_goal_distances"] = self._goaldistances
        stats["full_traj"] = self._full_traj
        stats["goal"] = self._goal
        return stats

    def comp_shortest_dist(self, p1, p2):
        """PRM-based shortest distance inside the maze
        (multiroom3d_env.py:132-138)."""
        if self.prm_policy is None:
            from video_gcp_torch.planning.infra.policy.prm_policy.prm_policy import (
                PrmPolicy,
            )

            self.prm_policy = PrmPolicy(
                None, AttrDict(n_samples_per_room=200), None, None,
                **self.env_policy_params(),
            )
        dist, _ = self.prm_policy.compute_shortest_path(p1, p2)
        return dist

    def env_policy_params(self):
        def transform_plan(state_plan, action_plan):
            action_plan = state_plan[:, 1:] - state_plan[:, :-1]
            return state_plan, action_plan

        conversion_fcns = AttrDict(
            transform_plan=transform_plan,
            env2prm=self.mw2mj,
            prm2env=self.mj2mw,
        )
        return {"conversion_fcns": conversion_fcns, "n_rooms": self._hp.n_rooms}

    def get_reset_from_obs(self, obs_dict):
        return obs_dict["state"][0]

    def get_goal_from_obs(self, obs_dict):
        self._goal = obs_dict["goal"][-1]
        return self._goal

    def set_goal(self, goal):
        self._goal = goal

    def has_goal(self):
        return self._goal is not None

    def goal_reached(self, eps: float = 0.05):
        """True when the agent ends in the goal's room-neighborhood (shortest
        maze distance below eps, ~15% of a room)."""
        if self.current_pos is None or self.goal_pos is None:
            return False
        return self.comp_shortest_dist(self.current_pos[:2], self.goal_pos) < eps

    # ------------------------------------------------------------------
    # top-down renderers (multiroom3d_env.py:150-219)
    # ------------------------------------------------------------------

    def render_top_down(self, traj, background=None, goal=None,
                        line_thickness=4, color=(1.0, 0, 0), mark_pts=False):
        if isinstance(color[0], numbers.Number):
            color = [color] * (max(traj.shape[0] - 1, 1))
        img = (self._static_img_topdown.copy() if background is None
               else background.copy())
        traj = np.asarray(traj).copy()
        if traj.ndim == 1:
            traj = traj[None]
        if traj.shape[1] >= 2:
            traj = traj[:, :2]
        traj = traj + 0.5 * self._layout.table_size
        s = self._topdown_render_scale
        for i in range(traj.shape[0] - 1):
            raster.line(
                img,
                (int(traj[i, 0] * s), img.shape[0] - int(traj[i, 1] * s)),
                (int(traj[i + 1, 0] * s), img.shape[0] - int(traj[i + 1, 1] * s)),
                color[i], line_thickness,
            )
        img = self.render_pos_top_down(traj[0] - 0.5 * self._layout.table_size,
                                       traj[-1] - 0.5 * self._layout.table_size,
                                       background=img)
        return img

    def render_pos_top_down(self, current_pose, goal_pos, background=None,
                            large_goal=False):
        full = (self._static_img_topdown if background is None
                else background)

        def convert(pos, img_shape):
            pos = np.asarray(pos[:2]).copy()
            pos = pos + 0.5 * self._layout.table_size
            return (int(pos[0] * self._topdown_render_scale),
                    img_shape[0] - int(pos[1] * self._topdown_render_scale))

        curr = convert(current_pose, full.shape)
        goal = convert(goal_pos, full.shape)
        if self._crop_window is not None:
            w = self._crop_window
            curr = (curr[0] + w, curr[1] - w)
            goal = (goal[0] + w, goal[1] - w)
            # copy ONLY the crop window (the full padded background is ~3 MB;
            # copying it per frame dominated data-loading time)
            curr = (max(w, curr[0]), max(w, curr[1]))
            lower = np.asarray(curr) - w
            upper = np.asarray(curr) + w
            img = np.ascontiguousarray(
                full[lower[1]:upper[1], lower[0]:upper[0]]
            )
            off = np.array([lower[0], lower[1]])
            curr_l = (curr[0] - off[0], curr[1] - off[1])
            goal_l = (goal[0] - off[0], goal[1] - off[1])
            raster.line(img, curr_l, curr_l, (0.0, 0, 1.0), 10)
            raster.line(img, goal_l, goal_l, (0.0, 1.0, 0),
                     10 if not large_goal else 20)
            return img
        img = full.copy()
        raster.line(img, curr, curr, (0.0, 0, 1.0), 10)
        raster.line(img, goal, goal, (0.0, 1.0, 0), 10 if not large_goal else 20)
        return img

    def render_traj_top_down_u8(self, states, goal_pos, out):
        """Render a whole trajectory of agent positions against one goal into
        `out` [T, 2w, 2w, 3] uint8 — the per-frame loop of the dataset
        re-render path with all position conversions vectorized (one numpy
        pass instead of T python `convert` calls)."""
        assert self._crop_window is not None
        if not hasattr(self, "_static_u8_topdown"):
            self._static_u8_topdown = np.ascontiguousarray(
                (self._static_img_topdown * 255).astype(np.uint8)
            )
        full = self._static_u8_topdown
        w = self._crop_window
        s = self._topdown_render_scale
        pos = np.asarray(states)[:, :2] + 0.5 * self._layout.table_size
        px = (pos[:, 0] * s).astype(np.int64) + w
        py = full.shape[0] - (pos[:, 1] * s).astype(np.int64) - w
        np.maximum(px, w, out=px)
        np.maximum(py, w, out=py)
        g = np.asarray(goal_pos)[:2] + 0.5 * self._layout.table_size
        gx = int(g[0] * s) + w
        gy = full.shape[0] - int(g[1] * s) - w
        t = len(px)
        for i in range(t):
            x, y = px[i], py[i]
            img = out[i]
            img[...] = full[y - w:y + w, x - w:x + w]
            raster.line(img, (w, w), (w, w), (0, 0, 255), 10)
            raster.line(img, (gx - x + w, gy - y + w), (gx - x + w, gy - y + w),
                     (0, 255, 0), 10)
        return out

    @property
    def adim(self):
        return self._adim

    @property
    def sdim(self):
        return self._sdim

    @property
    def ncam(self):
        return self._ncam


class EgocentricMultiroom2dEnv(Multiroom2dEnv):
    """First-person RGB observations: the reference's Multiroom3dEnv camera
    mode (multiroom3d_env.py:85-99, gym-miniworld OpenGL) served by the
    raycaster in fpv.py. States, actions and goals are the base env's; only
    `obs.images` changes."""

    def __init__(self, hp, reset_state=None, no_env=False, crop_window=None):
        super().__init__(hp, reset_state, no_env, crop_window)
        from video_gcp_torch.planning.infra.envs.fpv import FirstPersonRenderer

        self._fpv = FirstPersonRenderer(
            self._rooms_per_side, img_size=int(self._hp.fpv_img_size),
            textures=self._hp.fpv_textures)

    def _default_hparams(self):
        hp = super()._default_hparams()
        hp["fpv_img_size"] = 64
        # 'off' matches the published flat-colour datasets; 'auto' gives the
        # miniworld textured look (the PNG pack when on disk, else procedural)
        hp["fpv_textures"] = "off"
        return hp

    def _render_obs(self):
        return self._fpv.render(self.current_pos[:2], self.current_pos[2], self.goal_pos)


class TopdownMultiroom2dEnv(Multiroom2dEnv):
    """Image observations = cropped top-down render around the agent
    (TopdownMultiroom3dEnv, multiroom3d_env.py:230-246)."""

    def __init__(self, hp, reset_state=None, no_env=False, crop_window=None):
        assert "crop_window" in hp
        temp_hp = copy.deepcopy(dict(hp))
        crop_window = temp_hp.pop("crop_window")
        super().__init__(temp_hp, reset_state, no_env, crop_window=crop_window)

    def reset(self, reset_state=None):
        obs, reset_state = super().reset(reset_state)
        obs.images = np.asarray(
            255 * obs.topdown_image.copy(), dtype=np.uint8
        )[None]
        return obs, reset_state

    def step(self, action):
        obs = super().step(action)
        obs.images = np.asarray(
            255 * obs.topdown_image.copy(), dtype=np.uint8
        )[None]
        return obs
