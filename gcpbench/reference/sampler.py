"""CEM proposal distributions.

Behavioral parity with gcp/planning/cem/sampler.py:7-143 (class names and
constructor signatures are config values), but structured around a shared
Gaussian-belief helper instead of the reference's class chain:

- ``FlatCEMSampler``: independent per-step Gaussians, moment-matched refit.
- ``HierarchicalTreeCEMSampler`` (+ image variant): a thin adapter that hands
  sampling AND eliting to the layer-sequential tree-latent optimizer
  (planning/tree_optimizer.py); it is deliberately NOT a Gaussian sampler.

All samplers are host-side numpy: the proposal state is a few KB, while every
candidate evaluation they feed is a batched device rollout.

A numpy copy of planning/cem/sampler.py of the JAX package.
"""
from __future__ import annotations

import numpy as np

from .attrdict import AttrDict
from .tree_optimizer import (
    HierarchicalTreeLatentOptimizer,
    ImageHierarchicalTreeLatentOptimizer,
)


class _GaussianBelief:
    """Diagonal Gaussian over a [n_steps, dim] latent/action block."""

    def __init__(self, n_steps: int, dim: int, initial_std: float):
        self._shape = (n_steps, dim)
        self._std0 = initial_std
        self.reset()

    def reset(self):
        self.mean = np.zeros(self._shape)
        self.std = np.full(self._shape, float(self._std0))

    def draw_noise(self, n: int) -> np.ndarray:
        """n zero-mean samples with the belief's per-step scale."""
        return np.random.normal(scale=self.std, size=(n,) + self._shape)

    def moment_refit(self, elites: np.ndarray):
        self.mean, self.std = elites.mean(axis=0), elites.std(axis=0)

    def weighted_refit(self, samples: np.ndarray, weights: np.ndarray):
        w = weights / weights.sum()
        self.mean = np.einsum("n,nsd->sd", w, samples)


class CEMSampler:
    """Interface for samplers used in the CEM optimization loop."""

    def __init__(self, clip_val, n_steps, action_dim, initial_std):
        self._clip = clip_val
        self._steps = n_steps
        self._dim = action_dim
        self._std0 = initial_std
        self.init()

    def init(self):
        """Reset proposal state; called at the start of every planning call."""
        raise NotImplementedError

    def sample(self, n_samples):
        raise NotImplementedError

    def fit(self, data, scores):
        raise NotImplementedError

    def get_dists(self):
        raise NotImplementedError

    @property
    def append_latent(self):
        """Whether device rollouts must carry latents for this sampler."""
        return False


class FlatCEMSampler(CEMSampler):
    """Independent per-step Gaussians, refit to elite moments."""

    def init(self):
        self._belief = _GaussianBelief(
            self._steps, self._dim, self._std0)

    def sample(self, n_samples):
        raw = self._belief.mean[None] + self._belief.draw_noise(n_samples)
        return np.clip(raw, -self._clip, self._clip)

    def fit(self, data, scores):
        self._belief.moment_refit(np.asarray(data))

    def get_dists(self):
        return AttrDict(mean=self._belief.mean, std=self._belief.std)


class HierarchicalTreeCEMSampler(CEMSampler):
    """Layer-sequential tree-latent CEM (reference sampler.py:83-143).

    Both proposal and eliting live in the tree-latent optimizer (coarse
    layers are optimized and frozen before fine ones); this class only adapts
    that optimizer to the CEMSampler surface the planner drives.
    """

    _optimizer_cls = HierarchicalTreeLatentOptimizer

    def __init__(self, clip_val, n_steps, action_dim, initial_std, *,
                 n_level_hierarchy, sampling_rates_per_layer,
                 subgoal_cost_fcn=None, ll_cost_fcn=None, n_ll_samples=1,
                 **unused_kwargs):
        self._depth = n_level_hierarchy
        self._layer_rates = list(sampling_rates_per_layer)
        self._subgoal_cost = subgoal_cost_fcn
        self._ll_cost = ll_cost_fcn
        self._final_samples = n_ll_samples
        if n_level_hierarchy < len(self._layer_rates):
            raise ValueError(
                "more per-layer sampling rates than tree layers "
                f"({len(self._layer_rates)} > {n_level_hierarchy})")
        super().__init__(clip_val, 2 ** n_level_hierarchy - 1, action_dim,
                         initial_std)

    def init(self):
        self._optimizer = self._optimizer_cls(
            self._dim,
            list(self._layer_rates),
            self._depth,
            self._subgoal_cost,
            self._ll_cost,
            self._final_samples,
        )

    def sample(self, n_samples):
        # candidate count is dictated by the optimizer's layer schedule
        return np.clip(self._optimizer.sample(),
                       -self._clip, self._clip)

    def optimize(self, rollouts, goal):
        """Elite selection: score + freeze the current layer, return the best
        rollout (with the goal frame appended when the tree under-covered the
        right edge)."""
        best_rollout, best_cost = self._optimizer.optimize(rollouts, goal)
        best_rollout = self._ensure_goal_tail(best_rollout, goal)
        return [best_rollout], np.atleast_1d(np.asarray(best_cost))

    @staticmethod
    def _ensure_goal_tail(rollout, goal):
        if (rollout[-1] != goal).any():
            rollout = np.concatenate((rollout, goal[None]))
        return rollout

    def fit(self, data, scores):
        pass  # eliting already happened inside optimize()

    def get_dists(self):
        return AttrDict(mean=0.0, std=1.0)

    @property
    def append_latent(self):
        return True  # subgoal costs are computed on rollout latents

    @property
    def fully_optimized(self):
        return self._optimizer.fully_optimized


class ImageHierarchicalTreeCEMSampler(HierarchicalTreeCEMSampler):
    """Image-prediction variant: optimizer splits flattened pixel+latent
    rollouts, and the goal tail is compared in the planner's [-1, 1] pixel
    range (reference sampler.py:129-143)."""

    _optimizer_cls = ImageHierarchicalTreeLatentOptimizer

    @staticmethod
    def _ensure_goal_tail(rollout, goal):
        goal_img = np.asarray(goal[0]) * 2.0 - 1.0  # [H, W, C] env -> planner
        if rollout[-1].shape != goal_img.shape or \
                (rollout[-1] != goal_img).any():
            rollout = np.concatenate((rollout, goal_img[None]))
        return rollout
