"""CEM planners over batched device rollouts.

Behavioral parity with gcp/planning/cem/cem_planner.py:15-266 (class names and
hparam keys are config values), restructured host-first around three pieces
instead of the reference's monolithic planner loop:

- ``RolloutBatch``: a ragged host-side batch of candidate rollouts with the
  select/concat/clip operations the loop needs. Everything heavy inside it
  came from ONE batched model call (see cem/simulator.py) — the host
  only shuffles references.
- ``run_cem``: the CEM iteration as a pure function over four callables
  (sample / evaluate / select / refit), unit-testable without a model.
- Planner classes: thin shells that build the cost + sampler from hparams and
  provide the callables. Elite selection is a method so the hierarchical
  planner can swap in layer-sequential tree optimization.

Intentional deltas from the reference: candidate chunks ceil-divide (the
reference floor-divides and silently drops the tail batch), image/latent
splitting is an explicit ``ImageCost`` interface instead of a ``hasattr``
probe on a private method, and the ``hack_add_state`` log back-patch is gone
(no caller needs it).

A numpy copy of planning/cem/cem_planner.py of the JAX package.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.params import ParamDict
from video_gcp_torch.planning.cem.cost_fcn import (
    EuclideanPathLength,
    ImageCost,
    LearnedCostEstimate,
)
from video_gcp_torch.planning.cem.sampler import (
    FlatCEMSampler,
    HierarchicalTreeCEMSampler,
)


@dataclass
class RolloutBatch:
    """Ragged batch of candidate rollouts (lists of [T_i, ...] numpy arrays;
    per-candidate lengths differ because the model predicts sequence length)."""

    predictions: list = field(default_factory=list)
    latents: list = field(default_factory=list)
    states: list = field(default_factory=list)
    actions: list = field(default_factory=list)

    FIELDS = ("predictions", "latents", "states", "actions")

    def __len__(self):
        return len(self.predictions)

    def absorb(self, sim_output: AttrDict):
        """Append one simulator chunk."""
        for name in self.FIELDS:
            getattr(self, name).extend(sim_output.get(name, []))

    def take(self, idxs) -> "RolloutBatch":
        return RolloutBatch(**{
            name: [getattr(self, name)[i] for i in idxs]
            if getattr(self, name) else []
            for name in self.FIELDS
        })

    def clipped(self, horizon) -> "RolloutBatch":
        if horizon is None:
            return self
        return RolloutBatch(**{
            name: [r[:horizon] for r in getattr(self, name)]
            for name in self.FIELDS
        })


@dataclass
class EliteSet:
    """Result of one CEM iteration's selection step."""

    images: list        # elite rollouts, image part only (for logging)
    states: list        # elite regressed states
    scores: np.ndarray  # elite costs, ascending
    samples: np.ndarray  # latent samples to refit / re-evaluate


def run_cem(n_iters, n_candidates, sample_fn, evaluate_fn, select_fn,
            refit_fn):
    """The CEM optimization loop as a pure function.

    Each iteration: draw candidates, evaluate them to a RolloutBatch, select
    an EliteSet, refit the proposal. Returns the last EliteSet plus the
    per-iteration history (reference cem_planner.py:62-87 semantics).
    """
    history = []
    for _ in range(n_iters):
        samples = sample_fn(n_candidates)
        elite = select_fn(evaluate_fn(samples), samples)
        refit_fn(elite.samples, elite.scores)
        history.append(elite)
    return history[-1], history


class CEMPlanner:
    """Flat CEM: Gaussian proposals over model latents, cost-ranked elites."""

    def __init__(self, hp, simulator):
        self._hp = self._default_hparams().overwrite(hp)
        self._simulator = simulator
        self._cost_fcn = self._build_cost()
        self._sampler = self._build_sampler()
        self._call_logs = []  # one entry per __call__, drained by log_verbose

    def _default_hparams(self) -> ParamDict:
        return ParamDict(
            # optimization (reference cem_planner.py:24-37 key set)
            horizon=None,
            action_dim=None,
            n_iters=1,
            batch_size=64,
            max_rollout_bs=100,
            elite_frac=0.1,
            # cost
            cost_fcn=EuclideanPathLength,
            dense_cost=False,
            final_step_cost_weight=1.0,
            # proposal
            sampler=FlatCEMSampler,
            sampler_clip_val=float("inf"),
            initial_std=3e-1,
            # plan extraction + logging
            verbose=False,
            dump_planning_data=False,
            use_delta_state_actions=False,
            use_inferred_actions=True,
            max_seq_len=None,
        )

    def _build_cost(self):
        return self._hp.cost_fcn(self._hp.dense_cost,
                                 self._hp.final_step_cost_weight)

    def _build_sampler(self):
        return self._hp.sampler(
            self._hp.sampler_clip_val, self._hp.max_seq_len,
            self._hp.action_dim, self._hp.initial_std,
        )

    # ------------------------------------------------------------------
    # planning

    def __call__(self, state, goal_state):
        self._sampler.init()
        elite, history = run_cem(
            self._hp.n_iters, self._hp.batch_size,
            self._sample,
            lambda z: self._evaluate(state, goal_state, z),
            lambda rollouts, z: self._select_elites(rollouts, goal_state, z),
            self._sampler.fit,
        )

        # re-rollout the winning samples once more for the returned plan
        final = self._evaluate(state, goal_state, elite.samples)
        self._record_call(history, final, elite, goal_state)

        actions = self._extract_action_plan(final, elite.samples)
        return (
            final.predictions[0],
            actions[0] if len(actions) else None,
            final.latents[0],
            elite.scores[0],
        )

    def _sample(self, n_samples):
        with tracing.span("plan.sampler"):
            return self._sampler.sample(n_samples)

    def _evaluate(self, state, goal, samples) -> RolloutBatch:
        """Roll every candidate through the model, in device-batched chunks of
        at most max_rollout_bs, then clip to the planning horizon."""
        batch = RolloutBatch()
        for chunk in np.array_split(
                samples,
                max(1, -(-len(samples) // self._hp.max_rollout_bs))):
            batch.absorb(self._simulator.rollout(
                state, goal, chunk, self._hp.max_seq_len))
        return batch.clipped(self._hp.horizon)

    def _select_elites(self, rollouts: RolloutBatch, goal,
                       samples) -> EliteSet:
        scores = np.asarray(self._cost_fcn(rollouts.predictions, goal))
        n_elite = max(1, int(len(scores) * self._hp.elite_frac))
        order = np.argsort(scores)[:n_elite]
        picked = rollouts.take(order)
        return EliteSet(
            images=self._image_part(picked.predictions),
            states=picked.states,
            scores=scores[order],
            samples=np.asarray(samples)[order],
        )

    def _image_part(self, rollouts):
        """Image slice of flattened image(+latent) rollouts — only costs that
        declare the split (ImageCost) know the latent width."""
        if isinstance(self._cost_fcn, ImageCost):
            return self._cost_fcn.image_rollouts(rollouts)
        return rollouts

    def _extract_action_plan(self, final: RolloutBatch, samples):
        if self._hp.use_delta_state_actions:
            return [s[1:] - s[:-1] for s in final.states]
        if self._hp.use_inferred_actions:
            return final.actions
        return samples

    # ------------------------------------------------------------------
    # logging

    def _record_call(self, history, final: RolloutBatch, elite: EliteSet,
                     goal_state):
        entries = [
            AttrDict(
                elite_rollouts=e.images, elite_scores=e.scores,
                dists=self._sampler.get_dists(), goal_state=goal_state,
                elite_states=e.states,
            )
            for e in history
        ]
        entries.append(AttrDict(
            elite_rollouts=self._image_part(final.predictions),
            elite_scores=elite.scores,
            dists=self._sampler.get_dists(),
            goal_state=goal_state,
            elite_states=final.states,
        ))
        self._call_logs.append(entries)

    def log_verbose(self, logger, step, phase, i_tr, dump_dir):
        if self._hp.dump_planning_data:
            os.makedirs(os.path.join(dump_dir, "planning"), exist_ok=True)
            with open(os.path.join(
                    dump_dir, f"planning/traj{i_tr}_raw_data.pkl"), "wb") as f:
                pickle.dump(self._call_logs, f)
        self._call_logs = []

    @property
    def append_latent(self):
        return self._sampler.append_latent


class HierarchicalCEMPlanner(CEMPlanner):
    """CEM with layer-sequential tree-latent optimization: elite selection is
    delegated to the hierarchical sampler, which scores subgoals with a
    learned cost and freezes one tree layer per iteration."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self._hp.sampling_rates_per_layer is not None \
                and self._hp.n_iters != \
                len(self._hp.sampling_rates_per_layer) + 1:
            raise ValueError(
                "hierarchical CEM needs one iteration per scheduled layer "
                "plus a final-layer pass")

    def _default_hparams(self):
        p = super()._default_hparams()
        p.update(ParamDict(
            horizon=None,
            cost_fcn=LearnedCostEstimate,
            cost_config={},
            LL_cost_fcn=None,
            sampler=HierarchicalTreeCEMSampler,
            n_level_hierarchy=None,
            sampling_rates_per_layer=None,
            n_ll_samples=5,
        ))
        return p

    def _build_cost(self):
        cost_fcn = self._hp.cost_fcn(self._hp.cost_config)
        self._ll_cost_fcn = (
            cost_fcn if self._hp.LL_cost_fcn is None
            else self._hp.LL_cost_fcn(self._hp.dense_cost,
                                      self._hp.final_step_cost_weight)
        )
        return cost_fcn

    def _build_sampler(self):
        return self._hp.sampler(
            self._hp.sampler_clip_val, self._hp.max_seq_len,
            self._hp.action_dim, self._hp.initial_std,
            n_level_hierarchy=self._hp.n_level_hierarchy,
            sampling_rates_per_layer=self._hp.sampling_rates_per_layer,
            subgoal_cost_fcn=self._cost_fcn,
            ll_cost_fcn=self._ll_cost_fcn,
            n_ll_samples=self._hp.n_ll_samples,
        )

    def _select_elites(self, rollouts, goal, samples):
        if not isinstance(self._sampler, HierarchicalTreeCEMSampler):
            return super()._select_elites(rollouts, goal, samples)
        with tracing.span("plan.sampler"):
            best_rollouts, best_costs = self._sampler.optimize(
                rollouts.predictions, goal)
        # the optimizer froze one more layer: draw the follow-up candidates
        # under the updated schedule for the next iteration / final rollout
        return EliteSet(
            images=best_rollouts,
            states=rollouts.states,
            scores=best_costs,
            samples=self._sample(self._hp.batch_size),
        )


class ImageCEMPlanner(CEMPlanner):
    """Adds TB image strips of the elite plans per replan step / CEM iteration
    (reference cem_planner.py:222-255)."""

    def log_verbose(self, logger, step, phase, i_tr, dump_dir):
        if self._hp.verbose and logger is not None:
            for replan_idx, entries in enumerate(self._call_logs):
                for it_idx, entry in enumerate(entries):
                    strip = self._plan_strip(entry.elite_rollouts)
                    logger.log_images(
                        strip[None],
                        f"elite_trajs_{i_tr}_test/"
                        f"plan_r{replan_idx}_iter{it_idx}",
                        step, phase,
                    )
        super().log_verbose(logger, step, phase, i_tr, dump_dir)

    def _plan_strip(self, plans):
        """Stack elite plans into one [sum_H, T*W, C] strip: time unrolls
        along width, plans along height, short plans white-padded."""
        rows = []
        for plan in plans:
            frames = np.clip((np.asarray(plan) + 1) / 2, 0, 1)
            if self._hp.horizon and frames.shape[0] < self._hp.horizon:
                pad = np.ones(
                    (self._hp.horizon - frames.shape[0],) + frames.shape[1:])
                frames = np.concatenate([frames, pad])
            rows.append(np.concatenate(list(frames), axis=1))
        return np.concatenate(rows, axis=0) * 2 - 1


class HierarchicalImageCEMPlanner(HierarchicalCEMPlanner, ImageCEMPlanner):
    """Hierarchical tree optimization + image logging."""

    def log_verbose(self, *args, **kwargs):
        ImageCEMPlanner.log_verbose(self, *args, **kwargs)
