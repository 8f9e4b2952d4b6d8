"""The reference planner: the frozen GCP-tree, image simulator, hierarchical
image CEM and learned cost of this folder, with the weights mapped from the
pretrained npz by the reference's own copy of the mapping.

A request is planned as the program's ImageCEMPolicy._plan plans it:
`planner(start[None], goal[None])`, after np.random (the CEM sampler's draws) and
the simulator's host generator (the predicted lengths' draws) are seeded
with the request's seed.
"""
from __future__ import annotations

import numpy as np

from . import checkpoint
from .cem_planner import HierarchicalImageCEMPlanner
from .cost_fcn import ImageLearnedCostEstimate
from .model import build
from .sampler import ImageHierarchicalTreeCEMSampler
from .simulator import GCPImageSimulator


def planner(hparams: dict, cem_params: dict, weights: str, device):
    """The planner of a configuration's hparams and CEM parameters."""
    model = build(hparams, device).eval()
    state = checkpoint.load_model_state(weights)
    own = {k.split(".")[0] for k in model.state_dict()}
    model.load_state_dict({k: v for k, v in state.items() if k.split(".")[0] in own},
                          strict=True)
    params = dict(cem_params, sampler=ImageHierarchicalTreeCEMSampler,
                  cost_fcn=ImageLearnedCostEstimate,
                  cost_config=dict(checkpt_path=None, load_epoch=weights, input_dim=128,
                                   device=str(device)))
    params.setdefault("max_seq_len", hparams["max_seq_len"])
    return HierarchicalImageCEMPlanner(params, GCPImageSimulator(model, append_latent=True))


def plan(cem, start: np.ndarray, goal: np.ndarray, seed: int) -> dict:
    """One request: its plan (frames and latents) and cost."""
    np.random.seed(seed)
    cem._simulator.host_generator.manual_seed(seed)
    images, _, _, cost = cem(start[None], goal[None])
    cem.log_verbose(None, 0, "val", 0, None)  # drops the call's log
    return dict(images=np.asarray(images), cost=float(cost))

