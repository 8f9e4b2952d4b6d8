"""GCP model as a CEM rollout engine (planning/cem/simulator.py of the JAX
package).

Reference: gcp/planning/cem/cem_simulator.py:7-107. Repeats the current state
and goal over the candidates, injects their latents z, runs the model in
prior 'plan' mode with a predicted length, and returns per-candidate numpy
rollouts: predictions (flattened frames [+ latents]), inferred actions,
regressed states, latents.

One model call per chunk of candidates, under `torch.inference_mode`, on the
model's device. Each output comes back to the host in one copy. The JAX
package padded every call to its largest candidate count so that one traced
graph served every call of a run; the padding rows were discarded, so the
port runs each call at its own count, with the same results. With z
injected, the predicted length is the one random draw left: the simulator
owns a seeded `torch.Generator` on the model's device for it.
"""
from __future__ import annotations

import numpy as np
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.planning.infra.sim.benchmarks import heartbeat

PLAN_KEYS = ("end_ind", "timeline_images", "timeline_latents", "actions",
             "regressed_state")


class GCPSimulator:
    """State-space simulator (flat vector observations).

    :param model: the port's TreeModel or SequentialModel in eval mode, on
        its device
    :param mesh: candidate sharding over several devices (the JAX package's
        SPMD mesh); not ported, so only None is accepted
    """

    def __init__(self, model, append_latent: bool, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "sharding CEM candidates over several devices is not ported "
                "(ROADMAP.md queue 1, item 12)")
        self._model = model
        self._append_latent = append_latent
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(self.device).manual_seed(0)
        self.host_bytes = 0  # bytes copied to the host by the last rollout

    @staticmethod
    def _observation(x) -> np.ndarray:
        return np.asarray(x, np.float32)

    def _prep_inputs(self, state, goal_state, samples, rollout_len):
        b = samples.shape[0]
        dev = self.device
        return AttrDict(
            I_0=torch.as_tensor(np.repeat(self._observation(state), b, 0), device=dev),
            I_g=torch.as_tensor(np.repeat(self._observation(goal_state), b, 0), device=dev),
            start_ind=torch.zeros((b,), dtype=torch.int64, device=dev),
            end_ind=torch.full((b,), rollout_len - 1, dtype=torch.int64, device=dev),
            z=torch.as_tensor(np.asarray(samples, np.float32), device=dev),
        )

    def run_model(self, inputs: AttrDict) -> AttrDict:
        """The planner-facing outputs of one 'plan' call, as numpy."""
        with torch.inference_mode():
            out = self._model(inputs, phase="plan", mode="prior", pred_length=True,
                              generator=self.generator)
            host = AttrDict({k: out[k].cpu().numpy() for k in PLAN_KEYS if k in out})
        self.host_bytes = sum(v.nbytes for v in host.values())
        return host

    def rollout(self, state, goal_state, samples, rollout_len) -> AttrDict:
        heartbeat()
        b = samples.shape[0]
        out = self.run_model(self._prep_inputs(state, goal_state, samples, rollout_len))
        end_ind = np.maximum(out.end_ind, 1)

        def cap(x, i):
            return np.asarray(x[i, : end_ind[i] + 1])

        predictions, actions, states, latents = [], [], [], []
        for i in range(b):
            frames = cap(out.timeline_images, i).reshape(end_ind[i] + 1, -1)
            lat = cap(out.timeline_latents, i)
            if self._append_latent:
                frames = np.concatenate([frames, lat], axis=-1)
            predictions.append(frames)
            latents.append(lat)
            if "actions" in out:
                actions.append(np.asarray(out.actions[i, : end_ind[i] + 1]))
            if "regressed_state" in out:
                states.append(cap(out.regressed_state, i))
        return AttrDict(
            predictions=predictions, actions=actions, states=states,
            latents=latents,
        )


def env2planner(img) -> np.ndarray:
    """Env images ([0, 255] or [0, 1], HWC, optionally with a camera axis)
    -> the planner's [-1, 1] float32 range (cem_simulator.py:85-96)."""
    img = np.asarray(img, np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    if img.ndim == 5:
        img = img[0]
    return img * 2.0 - 1.0


class GCPImageSimulator(GCPSimulator):
    """Image observations, converted to the planner's [-1, 1] range."""

    _observation = staticmethod(env2planner)


class ActCondGCPImageSimulator(GCPImageSimulator):
    """Action-conditioned variant (cem_simulator.py:100-107): the samples
    are action sequences [b, T, action_dim], fed to the model as
    `inputs.actions` with a pad mask of ones; no latent is injected."""

    def _prep_inputs(self, state, goal_state, samples, rollout_len):
        inputs = super()._prep_inputs(state, goal_state, samples, rollout_len)
        inputs.actions = inputs.pop("z")
        inputs.pad_mask = torch.ones(inputs.actions.shape[:2], device=self.device)
        return inputs
