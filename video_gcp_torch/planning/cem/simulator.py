"""GCP model as a CEM rollout engine (planning/cem/simulator.py of the JAX
package).

Reference: gcp/planning/cem/cem_simulator.py:7-107. Repeats the current state
and goal over the candidates, injects their latents z, runs the model in
prior 'plan' mode with a predicted length, and returns per-candidate numpy
rollouts: predictions (flattened frames [+ latents]), inferred actions,
regressed states, latents.

One model call per chunk of candidates, under `torch.inference_mode`, on the
model's device. Each output comes back to the host in one copy per chunk.
The JAX package padded every call to its largest candidate count so that
one traced graph served every call of a run; the padding rows were
discarded, so the port runs each call at its own count, with the same
results.

With z injected, the predicted length is the one random draw left. The
simulator draws it on the host, one uniform a candidate from its own seeded
CPU `torch.Generator`, and the model samples each length by the inverse CDF
of its predicted distribution (`seq_len_u`). So a call's lengths do not
depend on the device, or on how the candidates are split. The
action-conditioned simulator injects actions, not z: its replicas draw z
from seeded generators of their own devices.

Candidate sharding (`devices=[...]`, the JAX package's `mesh=`): one model
replica per distinct device; each call's candidates are padded, by
repeating the last, to a multiple of the device count and split into equal
chunks, one per device, each launched from this thread before any result is
fetched; the chunks are copied in order into one host array (pinned when
they come from the card), and the padding rows are dropped. The split
rollout draws the unsplit one's lengths; its values differ only by the
rounding of kernels that block their work by the batch size (up to 8.2e-7
on the CPU, tests/test_torch_parallel.py).
"""
from __future__ import annotations

import copy

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
    :param devices: split each call's candidates over these devices (one
        model replica each; the JAX package's SPMD mesh); None or one device
        runs every call whole on the model's device
    """

    draws_z = False  # z is injected: no replica draws from a generator

    def __init__(self, model, append_latent: bool, devices=None):
        self._model = model
        self._append_latent = append_latent
        self.device = next(model.parameters()).device
        self.devices = [torch.device(d) for d in (devices or [self.device])]
        replicas = {self.device: model}
        for d in self.devices:
            if d not in replicas:
                replicas[d] = copy.deepcopy(model).to(d)
        self._replicas = replicas
        self.generators = ({d: torch.Generator(d).manual_seed(0) for d in replicas}
                           if self.draws_z else {})
        self.host_generator = torch.Generator().manual_seed(0)  # the lengths' draws
        self._pad_bucket = 1  # the candidate count of the last call, padded
        self.host_bytes = 0  # bytes copied to the host by the last rollout

    @staticmethod
    def _observation(x) -> np.ndarray:
        return np.asarray(x, np.float32)

    def _prep_inputs(self, state, goal_state, samples, rollout_len):
        """The model's inputs for every candidate, on the host."""
        b = samples.shape[0]
        return AttrDict(
            I_0=torch.as_tensor(np.repeat(self._observation(state), b, 0)),
            I_g=torch.as_tensor(np.repeat(self._observation(goal_state), b, 0)),
            start_ind=torch.zeros((b,), dtype=torch.int64),
            end_ind=torch.full((b,), rollout_len - 1, dtype=torch.int64),
            z=torch.as_tensor(np.asarray(samples, np.float32)),
            seq_len_u=torch.rand((b,), generator=self.host_generator),
        )

    def run_model(self, inputs: AttrDict) -> AttrDict:
        """The planner-facing outputs of one 'plan' call, as numpy: the
        candidates split over `devices`, padded by repeating the last."""
        b, n = inputs.I_0.shape[0], len(self.devices)
        self._pad_bucket = -(-b // n) * n
        pad = self._pad_bucket - b
        if pad:
            inputs = AttrDict({k: torch.cat([v, v[-1:].expand((pad,) + v.shape[1:])])
                               for k, v in inputs.items()})
        per = self._pad_bucket // n
        with torch.inference_mode():
            outs = []
            for i, dev in enumerate(self.devices):  # every chunk launched first
                chunk = AttrDict({k: v[i * per:(i + 1) * per].to(dev, non_blocking=True)
                                  for k, v in inputs.items()})
                outs.append(self._replicas[dev](chunk, phase="plan", mode="prior",
                                                pred_length=True,
                                                generator=self.generators.get(dev)))
            keys = [k for k in PLAN_KEYS if k in outs[0]]
            if n == 1:
                host = AttrDict({k: outs[0][k].cpu().numpy() for k in keys})
            else:
                host = AttrDict()
                pin = any(d.type == "cuda" for d in self.devices)
                for k in keys:
                    x = outs[0][k]
                    whole = torch.empty((self._pad_bucket,) + x.shape[1:], dtype=x.dtype,
                                        pin_memory=pin)
                    for i, o in enumerate(outs):
                        whole[i * per:(i + 1) * per].copy_(o[k])
                    host[k] = whole.numpy()[:b]
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

    draws_z = True

    def _prep_inputs(self, state, goal_state, samples, rollout_len):
        inputs = super()._prep_inputs(state, goal_state, samples, rollout_len)
        inputs.actions = inputs.pop("z")
        inputs.pad_mask = torch.ones(inputs.actions.shape[:2])
        return inputs
