"""PRM expert policy for maze navigation data generation.

Behavior parity with gcp/planning/infra/policy/prm_policy/prm_policy.py:12-298
(room-sequence search -> per-room/door PRM roadmap -> Dijkstra ->
spline-smoothed state plan -> delta-state actions, replanning on deviation,
reverse/nudge fallback plans after planner failure — SURVEY.md §5.3), built as
a pipeline of pure planning functions feeding a small plan-cursor the policy
steps through.

A numpy copy of planning/infra/policy/prm_policy/prm_policy.py of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import interpolate

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.planning.infra.envs.layout import (
    RoomSampler2d,
    define_layout,
    plan_room_seq,
    plan_room_seq_multimodal,
)
from video_gcp_torch.planning.infra.policy.policy import Policy
from video_gcp_torch.planning.infra.policy.prm_policy.prm import PRM_planning

STEPS_PER_UNIT_LENGTH = 20  # plan discretization (prm_policy.py:175)


@dataclass
class _Plan:
    """A smoothed state plan and the cursor stepping through its actions."""

    states: np.ndarray  # [2, T]
    actions: np.ndarray  # [2, T-1] delta-state actions
    step: int = 0

    @classmethod
    def from_states(cls, states):
        return cls(states=states, actions=states[:, 1:] - states[:, :-1])

    def expected_pos(self):
        """Where the agent should be after `step` executed actions."""
        return self.states[:, min(self.step, self.states.shape[1] - 1)]

    def pop_action(self):
        """Next action, or None when the plan is exhausted."""
        if self.step >= self.actions.shape[1]:
            return None
        a = self.actions[:, self.step]
        self.step += 1
        return a

    def remaining_reversed(self):
        """Backtrack plan: the not-yet-executed tail, reversed in sign
        (failure fallback, prm_policy.py:192-196)."""
        tail = -2 * self.actions[:, max(self.step - 1, 0):]
        return _Plan(states=self.states, actions=tail)


def _random_nudge():
    states = 0.02 * np.random.rand(2, 1)
    return _Plan(states=states, actions=states)


# ---------------------------------------------------------------------------
# planning pipeline (pure functions)
# ---------------------------------------------------------------------------


def roadmap_points(layout, sampler, hp, room_path):
    """PRM node samples covering the rooms (and optionally doorways) of the
    route: [2, P] coordinate lists."""
    rooms = range(hp.n_rooms) if room_path is None else room_path
    pts = []
    for room in rooms:
        n = (int(np.random.choice(PrmPolicy.VAR_SAMPLING_RATES))
             if hp.use_var_sampling else hp.n_samples_per_room)
        pts.extend(sampler.sample(room) for _ in range(n))
    if hp.bottleneck_sampling:
        if room_path is None:
            doorways = [tuple(d) for d in layout.doors]
        else:
            doorways = [tuple(sorted(pair))
                        for pair in zip(room_path[:-1], room_path[1:])]
        pts.extend(
            sampler.sample_door(a, b, hp.sample_door_center)
            for a, b in doorways for _ in range(hp.n_samples_per_door))
    arr = np.asarray(pts).T
    return list(arr[0]), list(arr[1])


def door_waypoint_path(layout, sampler, p1, p2, straight_through_door=False):
    """Coarse path through door centers and its length
    (prm_policy.py:198-216). Returns (length, waypoints [K, 2]); out-of-table
    queries return (10.0, [])."""
    pts = np.stack([np.asarray(p1), np.asarray(p2)])
    if (pts < -0.5).any() or (pts > 0.5).any():
        return 10.0, []
    rooms = plan_room_seq(layout.coords2ridx(*p1), layout.coords2ridx(*p2),
                          layout.doors)
    waypoints = [np.asarray(p1)]
    for a, b in zip(rooms[:-1], rooms[1:]):
        if straight_through_door:
            waypoints.extend(sampler.get_door_path(a, b))
        else:
            waypoints.append(sampler.get_door_pos(min(a, b), max(a, b)))
    waypoints.append(np.asarray(p2))
    waypoints = np.array(waypoints)
    length = float(np.linalg.norm(np.diff(waypoints, axis=0), axis=1).sum())
    return length, waypoints


def smooth_plan(path_x, path_y, n_steps):
    """Cubic-spline resample of a PRM path into an [2, n_steps] state plan;
    None when the fit degenerates (duplicate points,
    prm_policy.py:185-189)."""
    try:
        tck, _ = interpolate.splprep([path_x, path_y], s=0.0)
    except (TypeError, ValueError):
        return None
    return np.stack(interpolate.splev(np.linspace(0, 1, n_steps), tck))


# ---------------------------------------------------------------------------


class PrmPolicy(Policy):
    VAR_SAMPLING_RATES = [30, 300]

    def __init__(self, ag_params, policyparams, gpu_id=None, ngpu=None,
                 conversion_fcns=None, n_rooms=None):
        super().__init__()
        self.override_defaults(dict(policyparams, n_rooms=n_rooms))

        self._rooms_per_side = int(np.sqrt(self._hp.n_rooms))
        self.layout = define_layout(self._rooms_per_side)
        self.state_sampler = RoomSampler2d(
            self._rooms_per_side, sample_wide=self.layout.non_symmetric)
        self.convert = conversion_fcns
        self._prm_params = dict(
            n_knn=self._hp.n_knn,
            max_edge_len=self._hp.max_edge_len,
            cost_fcn=lambda d: d ** self._hp.cost_power,
        )
        self.reset()

    def reset(self):
        self._plan_cursor = None
        self._room_plan = None

    def _default_hparams(self):
        p = super()._default_hparams()
        p.update(dict(
            n_samples_per_room=50,
            n_samples_per_door=3,
            n_knn=10,
            max_edge_len=0.1,
            replan_eps=0.05,
            max_planning_retries=2,
            cost_power=2,
            bottleneck_sampling=True,
            use_var_sampling=False,
            subsample_factor=1.0,
            max_traj_length=None,
            smooth_trajectory=False,
            sample_door_center=False,
            use_scripted_path=False,
            straight_through_door=False,
            n_rooms=None,
            use_fallback_plan=True,
            logger=None,
        ))
        return p

    # ------------------------------------------------------------------

    def act(self, t=None, i_tr=None, qpos_full=None, goal=None):
        self.i_tr = i_tr
        pos = qpos_full[t, :2]
        needs_plan = self._plan_cursor is None or (
            np.linalg.norm(pos - self._plan_cursor.expected_pos())
            > self._hp.replan_eps)
        if needs_plan:
            self._replan(qpos_full[t], goal[t], t)

        action = self._plan_cursor.pop_action()
        done = action is None
        return AttrDict(actions=np.zeros(2) if done else action, done=done)

    # --- legacy aliases used by older configs/tests ---
    @property
    def state_plan(self):
        return None if self._plan_cursor is None else self._plan_cursor.states

    @property
    def action_plan(self):
        return None if self._plan_cursor is None else self._plan_cursor.actions

    # ------------------------------------------------------------------

    def _replan(self, agent_pos, goal_pos, t):
        pos = np.asarray(agent_pos[:2])
        goal = np.asarray(goal_pos)
        if self.convert is not None:
            pos, goal = self.convert.env2prm(pos), self.convert.env2prm(goal)

        length, door_path = door_waypoint_path(
            self.layout, self.state_sampler, pos, goal,
            self._hp.straight_through_door)

        if self._hp.use_scripted_path:
            path_xy, found = ([p[0] for p in door_path],
                              [p[1] for p in door_path]), True
        else:
            path_xy, found = self._prm_query(pos, goal)

        if not found:
            if self._hp.use_fallback_plan:
                self._fallback_plan()
            return

        # subsample_factor thins (>1) or densifies (<1) the executed plan
        # (ref prm_policy.py:175 divides the discretization by it)
        n_steps = int(length * STEPS_PER_UNIT_LENGTH
                      / self._hp.subsample_factor)
        if self._hp.max_traj_length is not None:
            n_steps = min(n_steps, self._hp.max_traj_length - t)
        states = smooth_plan(*path_xy, max(n_steps, 2))
        if states is None:
            self._fallback_plan()
            return

        if self.convert is not None:
            states, actions = self.convert.transform_plan(
                states, states[:, 1:] - states[:, :-1])
            self._plan_cursor = _Plan(states=states, actions=actions)
        else:
            self._plan_cursor = _Plan.from_states(states)

    def _prm_query(self, pos, goal):
        """Roadmap + Dijkstra between pos and goal, with retries over fresh
        point samples (prm_policy.py:130-171)."""
        if self._room_plan is None:
            seq_planner = (plan_room_seq_multimodal if self.layout.multimodal
                           else plan_room_seq)
            self._room_plan = seq_planner(
                self.layout.coords2ridx(*pos),
                self.layout.coords2ridx(*goal), self.layout.doors)

        for _ in range(self._hp.max_planning_retries):
            pts = roadmap_points(self.layout, self.state_sampler, self._hp,
                                 self._room_plan)
            px, py, ok = PRM_planning(
                pos[0], pos[1], goal[0], goal[1],
                self.layout.ox, self.layout.oy, self.layout.robot_size,
                self._prm_params,
                self._hp.n_samples_per_room * self._hp.n_rooms, pts)
            if ok:
                return (px, py), True
        return None, False

    def _fallback_plan(self):
        if self._plan_cursor is not None:
            fallback = self._plan_cursor.remaining_reversed()
            self._plan_cursor = (fallback if fallback.actions.shape[1]
                                 else _random_nudge())
        else:
            self._plan_cursor = _random_nudge()

    def compute_shortest_path(self, p1, p2, transform_pose=True,
                              straight_through_door=False):
        if self.convert is not None and transform_pose:
            p1, p2 = self.convert.env2prm(p1), self.convert.env2prm(p2)
        return door_waypoint_path(self.layout, self.state_sampler, p1, p2,
                                  straight_through_door)

    def plan_room_seq(self, start, goal, doors):
        if self.layout.multimodal:
            return plan_room_seq_multimodal(start, goal, doors)
        return plan_room_seq(start, goal, doors)
