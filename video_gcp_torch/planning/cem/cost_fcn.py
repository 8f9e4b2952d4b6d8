"""CEM cost functions (reference: gcp/planning/cem/cost_fcn.py:9-117).

CostFcns score CEM rollouts: dense (summed per-step) or final-step cost, with
a final-step weight. Rollouts arrive as lists of [T_i, D] numpy arrays from
the planner (variable plan lengths are a host-side concern; the batched model
evaluations behind LearnedCostEstimate run on the device).

A copy of planning/cem/cost_fcn.py of the JAX package. The learned cost is
the port's `CostModel` with the checkpoint's `cost_mdl.*` tensors, on the
run's device; its inputs go in one call without the JAX package's padding
to power-of-two sizes, which only spared re-tracing.
"""
from __future__ import annotations

import numpy as np

from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.attrdict import listdict2dictlist


class CostFcn:
    """Base class to define CEM cost functions."""

    def __init__(self, dense_cost, final_step_weight=1.0, *unused_args):
        self._dense_cost = dense_cost
        self._final_step_weight = final_step_weight

    def __call__(self, cem_outputs, goal):
        cost_per_step = self._compute(cem_outputs, goal)
        for i in range(len(cost_per_step)):
            cost_per_step[i][-1] *= self._final_step_weight
        if self._dense_cost:
            return np.array([np.sum(c) for c in cost_per_step])
        return np.array([c[-1] for c in cost_per_step])

    def _compute(self, cem_outputs, goal):
        raise NotImplementedError


class ImageCost:
    """Splits flattened image+latent rollouts (NHWC images). Costs that mix
    this in declare that their rollouts carry `input_dim` latent channels
    after the pixels; the planner asks for the image slice through
    image_rollouts() (explicit interface — reference probes hasattr on the
    private splitter, cem_planner.py:169-171)."""

    def image_rollouts(self, rollouts):
        """Image part of each flattened rollout, as [T, H, W, C] arrays."""
        return self._split_state_rollout(rollouts).image_rollout

    def _split_state_rollout(self, rollouts):
        def reshape_to_image(flat):
            assert flat.ndim == 2
            res = int(np.sqrt(flat.shape[1] / 3))
            return flat.reshape(flat.shape[0], res, res, 3)

        return listdict2dictlist(
            [
                AttrDict(
                    image_rollout=reshape_to_image(r[..., : -self.input_dim]),
                    latent_rollout=r[..., -self.input_dim:],
                )
                for r in rollouts
            ]
        )


class EuclideanDistance(CostFcn):
    """Euclidean distance between vals and goal."""

    def _compute(self, cem_outputs, goal):
        return [
            np.linalg.norm(out - goal[None], axis=-1) for out in cem_outputs
        ]


class EuclideanPathLength(CostFcn):
    """Euclidean length of the whole path to the goal."""

    def _compute(self, cem_outputs, goal):
        assert self._dense_cost, "path length needs dense cost"
        return [
            np.linalg.norm(
                np.concatenate([out[1:], goal[None]]) - out, axis=-1
            )
            for out in cem_outputs
        ]

    @staticmethod
    def gt_path_cost(seq, goal):
        """GT cost used by the cost-model trainer: cumulative path length."""
        path = np.concatenate([seq, goal[None]], 0)
        return float(np.linalg.norm(np.diff(path, axis=0), axis=-1).sum())

    def __init__(self, dense_cost=True, final_step_weight=1.0, *unused):
        super().__init__(dense_cost, final_step_weight)


class StepPathLength(CostFcn):
    """Cost equals the number of steps in the path."""

    def _compute(self, cem_outputs, goal):
        return [
            np.concatenate(
                [np.zeros(out.shape[0] - 1), np.array([float(out.shape[0])])]
            )
            for out in cem_outputs
        ]


class L2ImageCost(CostFcn, ImageCost):
    """L2 distance in image space."""

    LATENT_SIZE = 128

    def _compute(self, cem_outputs, goal_raw):
        image_sequences = self._split_state_rollout(cem_outputs).image_rollout
        goal = goal_raw * 2.0 - 1.0  # [1, H, W, C] raw in [0, 1]
        return [
            np.sqrt(np.sum((seq - goal) ** 2, axis=(1, 2, 3)))
            for seq in image_sequences
        ]

    @property
    def input_dim(self):
        return self.LATENT_SIZE


def make_test_time_cost_fn(checkpt_path, load_epoch="latest",
                           cost_params=None, device="cuda"):
    """Restore the cost model from a predictor checkpoint and return a
    callable(enc1, enc2) -> cost as numpy (TestTimeCostModel,
    cost_mdl.py:123-145: loads only the `cost_mdl` tensors). Runs on
    `device`, the card unless the caller asks for the CPU."""
    import torch

    from video_gcp_torch.models.aux_models import CostModel
    from video_gcp_torch.training import checkpoint as ckpt_lib

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("learned cost: no CUDA device; pass device='cpu' "
                           "to run on the CPU")
    path = ckpt_lib.resolve_resume(load_epoch, checkpt_path)
    if path is None:
        raise ValueError(f"no checkpoint under {checkpt_path}")
    prefix = "cost_mdl."
    sub = {k[len(prefix):]: v for k, v in ckpt_lib.load_model_state(path).items()
           if k.startswith(prefix)}
    if not sub:
        raise ValueError(f"{path} holds no cost_mdl tensors")
    p = dict(nz_mid=128, n_processing_layers=3)
    if cost_params:
        p.update(cost_params)
    in_size = sub["mlp.0.dense.0.weight"].shape[1] // 2
    model = CostModel(p, in_size)
    model.load_state_dict(sub, strict=True)
    model = model.to(device).eval()

    def run(e1, e2):
        with torch.inference_mode():
            a = torch.as_tensor(np.asarray(e1, np.float32), device=device)
            b = torch.as_tensor(np.asarray(e2, np.float32), device=device)
            return tracing.to_host(model(a, b), "cost.result").numpy()

    return run


class LearnedCostEstimate:
    """Learned cost network between latent states (TestTimeCostModel wrap).

    :param config: dict with either `model_fn(enc1, enc2) -> cost` (a callable
        closing over restored cost-model params) or `checkpt_path` pointing at
        a predictor checkpoint whose `cost_mdl` scope is restored
        (cost_fcn.py:87-95 / cost_mdl.py TestTimeCostModel).
    """

    def __init__(self, config):
        if "model_fn" in config:
            self.net = config["model_fn"]
        else:
            self.net = make_test_time_cost_fn(
                config["checkpt_path"], config.get("load_epoch", "latest"),
                config.get("cost_params", None), config.get("device", "cuda"),
            )
        self._input_dim = config.get("input_dim", 128)

    @tracing.spanned("plan.cost")
    def __call__(self, start_enc, goal_enc):
        return self._cost(*self._encodings(start_enc, goal_enc))

    def _encodings(self, start_enc, goal_enc):
        return start_enc, goal_enc

    def _cost(self, start_enc, goal_enc):
        if isinstance(start_enc, np.ndarray):
            return np.asarray(self.net(start_enc, goal_enc))[..., 0]
        if isinstance(start_enc, list):
            # one net call for ALL sequences' step pairs: the hierarchical
            # optimizer scores segments of every length
            pairs_a, pairs_b, sizes = [], [], []
            for seq, goal in zip(start_enc, goal_enc):
                seq_input = np.concatenate([seq, goal], 0)
                pairs_a.append(seq_input[:-1])
                pairs_b.append(seq_input[1:])
                sizes.append(seq_input.shape[0] - 1)
            per_step = np.asarray(self.net(
                np.concatenate(pairs_a), np.concatenate(pairs_b)))[..., 0]
            bounds = np.cumsum([0] + sizes)
            return np.array([per_step[a:b].sum()
                             for a, b in zip(bounds[:-1], bounds[1:])])
        raise ValueError("unsupported input type for learned cost")

    @property
    def input_dim(self):
        return self._input_dim


class ImageLearnedCostEstimate(LearnedCostEstimate, ImageCost):
    pass


class ImageWrappedLearnedCostFcn(LearnedCostEstimate, ImageCost):
    """Unpacks image+latent rollouts, scores latents against the final latent
    (goal-conditioned prediction, cost_fcn.py:108-117)."""

    def _encodings(self, start_enc, goal_enc):
        start_enc = self._split_state_rollout(start_enc).latent_rollout
        # the reference reuses the LAST rollout's full latent sequence as the
        # goal for every rollout (cost_fcn.py:115, goal-cond prediction hack)
        return start_enc, [start_enc[-1] for _ in range(len(start_enc))]
