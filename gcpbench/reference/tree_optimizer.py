"""Hierarchical tree-latent optimization for CEM planning over GCP trees.

Behavior parity with gcp/planning/tree_optimizer.py:7-260 — per optimization
pass, one tree layer is "elited": every segment at the active layer scores its
N candidate subgoal latents by learned to+from cost against the segment
boundaries and freezes the argmin; once the configured CEM layers are
exhausted, each remaining subtree is optimized jointly as a best-of-N dense
segment under the low-level cost. Architecture differs deliberately: instead
of a recursive web of per-node optimizer objects, ALL state lives in one flat
depth-first-ordered latent array (`_frozen_z` + `_frozen` mask) with an
active-level counter, and `optimize` walks segments as (lo, hi) index ranges
of that array. Host-side numpy throughout — the tree is tiny; every candidate
evaluation consumes the batched device rollouts passed in.

Conventions: rollouts are [T_i, D] numpy arrays = flattened observations with
the model latent appended on the last `subgoal_cost_fcn.input_dim` dims;
images are NHWC.

A numpy copy of planning/tree_optimizer.py of the JAX package.
"""
from __future__ import annotations

import numpy as np


class HierarchicalTreeLatentOptimizer:
    def __init__(self, latent_dim, sampling_rates, depth, subgoal_cost_fcn,
                 ll_cost_fcn, final_layer_samples):
        self._latent_dim = latent_dim
        self._depth = depth
        self._n_nodes = 2 ** depth - 1
        self._rates = list(sampling_rates)
        self._n_cem_levels = len(self._rates)
        assert self._n_cem_levels < depth
        self._subgoal_cost_fcn = subgoal_cost_fcn
        self._ll_cost_fcn = ll_cost_fcn
        self._final_layer_samples = final_layer_samples

        # df-ordered (in-order) latent tree + freeze mask; level k of the
        # tree is frozen by the k-th optimize() call
        self._frozen_z = np.zeros((self._n_nodes, self._latent_dim))
        self._frozen = np.zeros(self._n_nodes, dtype=bool)
        self._next_level = 0
        self._done = False
        self._latest = None  # samples behind the rollouts being optimized
        self._opt_z = None  # frozen root latent, [1, latent_dim]

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    def sample(self, below_opt_layer: bool = False) -> np.ndarray:
        """Candidate latent trees [N, n_nodes, latent_dim]: frozen levels are
        tiled, every other node draws i.i.d. from the (never-refit) unit
        Gaussian; N = the active level's sampling rate."""
        del below_opt_layer  # flat equivalent: free nodes are always i.i.d.
        if self._done:
            z = self._frozen_z[None].copy()
        else:
            n = (self._rates[self._next_level]
                 if self._next_level < self._n_cem_levels
                 else self._final_layer_samples)
            z = np.tile(self._frozen_z[None], (n, 1, 1))
            free = ~self._frozen
            z[:, free] = np.random.normal(
                size=(n, int(free.sum()), self._latent_dim))
        self._latest = z.copy()
        return z

    # ------------------------------------------------------------------
    # optimization
    # ------------------------------------------------------------------

    def optimize(self, all_rollouts, goal):
        """Freeze the active level against the candidate rollouts; returns
        (best skeleton/segment rollout, its cost)."""
        rollouts = [np.asarray(r) for r in all_rollouts]
        result = self._optimize_range(rollouts, np.asarray(goal),
                                      0, self._n_nodes, 0)
        if self._next_level < self._n_cem_levels:
            self._next_level += 1
        else:
            self._done = True
        return result

    def _optimize_range(self, rollouts, goal, lo, hi, level):
        node = (lo + hi) // 2
        if level < self._next_level:
            return self._descend(rollouts, goal, lo, hi, level, node)
        if level < self._n_cem_levels:
            return self._freeze_subgoal(rollouts, goal, node)
        return self._freeze_segment(rollouts, goal, lo, hi)

    def _descend(self, rollouts, goal, lo, hi, level, node):
        """Recurse through an already-frozen node: split every rollout at its
        midpoint and optimize both halves. Rollouts too short to split
        compete as whole segments under the low-level cost instead
        (tree_optimizer.py:153-190)."""
        shorts = [r for r in rollouts if r.shape[0] < 3]
        work = [self._dummy_seq(r[0]) if r.shape[0] < 3 else r
                for r in rollouts]
        mids = [r.shape[0] // 2 for r in work]
        subgoal = work[0][mids[0]]

        left, cost_left = self._optimize_range(
            [r[:m] for r, m in zip(work, mids)], subgoal, lo, node, level + 1)
        right, cost_right = self._optimize_range(
            [r[m:] for r, m in zip(work, mids)], goal, node + 1, hi,
            level + 1)
        best = np.concatenate([left, right])
        cost = cost_left + cost_right

        if shorts:
            short_roll, short_cost, _ = self._best_segment(shorts, goal)
            if short_cost < cost or np.isnan(cost):
                best, cost = short_roll, short_cost
        return best, cost

    def _freeze_subgoal(self, rollouts, goal, node):
        """Elite the active CEM node: argmin over candidates of
        to-subgoal + from-subgoal learned cost (tree_optimizer.py:105-151)."""
        states, latents = self._split(rollouts)
        mids = [r.shape[0] // 2 for r in rollouts]
        start_lat = np.stack([l[0] for l in latents])
        mid_lat = np.stack([l[m] for l, m in zip(latents, mids)])

        joined = goal.shape[-1] == rollouts[0].shape[-1]
        if joined:
            goal_lat = np.repeat(self._split([goal[None]])[1][0], len(rollouts),
                                 axis=0)
        else:
            goal_lat = np.stack([l[-1] for l in latents])

        # Dummy (unsplittable) candidates carry inf boundary rows; score them
        # as inf directly instead of feeding inf into the cost net, where
        # inf-inf arithmetic would raise warnings and mask real NaNs.
        bad = ~(np.isfinite(start_lat).all(-1)
                & np.isfinite(mid_lat).all(-1)
                & np.isfinite(goal_lat).all(-1))
        start_lat, mid_lat, goal_lat = (
            np.nan_to_num(x, posinf=0.0, neginf=0.0)
            for x in (start_lat, mid_lat, goal_lat))
        cost = (self._subgoal_cost_fcn(start_lat, mid_lat)
                + self._subgoal_cost_fcn(mid_lat, goal_lat))
        cost = np.where(bad, np.inf, cost)
        best = int(np.argmin(cost))

        self._frozen_z[node] = self._latest[best, node]
        self._frozen[node] = True
        if node == (self._n_nodes // 2):  # root latent, kept for inspection
            self._opt_z = self._frozen_z[node][None].copy()

        skeleton = [states[best][0]]
        mid_state = states[best][mids[best]]
        if (mid_state != skeleton[-1]).any():
            skeleton.append(mid_state)
        if not joined:
            skeleton.append(self._goal_to_state(goal, skeleton[-1]))
        return np.stack(skeleton), cost[best]

    def _freeze_segment(self, rollouts, goal, lo, hi):
        """Best-of-N over a final dense segment; freezes the whole remaining
        subtree [lo, hi) to the winner's latents."""
        roll, cost, best = self._best_segment(rollouts, goal)
        self._frozen_z[lo:hi] = self._latest[best, lo:hi]
        self._frozen[lo:hi] = True
        return roll, cost

    def _best_segment(self, rollouts, goal):
        inputs, seg_goal = self._segment_cost_inputs(rollouts, goal)
        bad = np.array([not np.isfinite(np.asarray(x)).all() for x in inputs])
        inputs = [np.nan_to_num(np.asarray(x), posinf=0.0, neginf=0.0)
                  for x in inputs]
        if isinstance(seg_goal, list):
            seg_goal = [np.nan_to_num(np.asarray(g), posinf=0.0, neginf=0.0)
                        for g in seg_goal]
        else:
            seg_goal = np.nan_to_num(np.asarray(seg_goal), posinf=0.0,
                                     neginf=0.0)
        cost = np.where(bad, np.inf, self._ll_cost_fcn(inputs, seg_goal))
        best = int(np.argmin(cost))
        return self._split(rollouts)[0][best], cost[best], best

    # ------------------------------------------------------------------
    # representation hooks (overridden by the image variant)
    # ------------------------------------------------------------------

    def _split(self, rollouts):
        """[T, D] rows -> (state parts, latent parts) per rollout."""
        d = self._subgoal_cost_fcn.input_dim
        return ([r[..., :-d] for r in rollouts],
                [r[..., -d:] for r in rollouts])

    def _segment_cost_inputs(self, rollouts, goal):
        states, _ = self._split(rollouts)
        if goal.shape[-1] == rollouts[0].shape[-1]:
            seg_goal = self._split([goal[None]])[0][0][0]
        else:
            seg_goal = goal
        return states, seg_goal

    def _goal_to_state(self, goal, reference):
        """Convert a raw goal into the rollout's state format."""
        if goal.shape == reference.shape:
            return goal
        return np.broadcast_to(goal, reference.shape).copy()

    @staticmethod
    def _dummy_seq(reference_row):
        """Unsplittable-segment placeholder with infinite boundary cost."""
        inf = np.full_like(reference_row, np.inf)
        return np.stack([inf, np.zeros_like(reference_row), inf])

    @property
    def fully_optimized(self):
        return self._done


class ImageHierarchicalTreeLatentOptimizer(HierarchicalTreeLatentOptimizer):
    """Image rollouts: the state part of each flattened row reshapes to an
    NHWC image, and segment costs run on the latent parts (reference
    tree_optimizer.py:226-260, channel-first there)."""

    def _split(self, rollouts):
        d = self._subgoal_cost_fcn.input_dim

        def to_image(flat):
            assert flat.ndim == 2
            res = int(np.sqrt(flat.shape[1] / 3))
            return flat.reshape(flat.shape[0], res, res, 3)

        return ([to_image(r[..., :-d]) for r in rollouts],
                [r[..., -d:] for r in rollouts])

    def _segment_cost_inputs(self, rollouts, goal):
        _, latents = self._split(rollouts)
        if np.ndim(goal) > 2:  # raw image goal: use final rollout latent
            seg_goal = [l[-1:] for l in latents]
        else:
            seg_goal = [self._split([goal[None]])[1][0] for _ in latents]
        return latents, seg_goal

    def _goal_to_state(self, goal, reference):
        if goal.ndim == 4:  # [1, H, W, C] env image in [0, 1]
            return goal[0] * 2.0 - 1.0
        return super()._goal_to_state(goal, reference)
