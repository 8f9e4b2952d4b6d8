"""Planner policies: CEM planning with a trained GCP predictor
(planning/planner_policy.py of the JAX package).

Reference: gcp/planning/planner_policy.py:13-236. Loads the trained predictor
from a port checkpoint (`weights_ep*/state.pt`) or the JAX package's
pretrained npz, replans every `replan_interval` steps up to
`num_max_replans`, and executes the plan via inferred (inverse-model)
actions, delta-state actions, or closed-loop re-inference of actions from
the latent plan.

The model runs on `ag_params['device']`, the card unless the run asks for
the CPU; without a card a 'cuda' policy raises.
"""
from __future__ import annotations

import numpy as np
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.load import set_float32_precision
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.models.tree import TreeModel
from video_gcp_torch.planning.cem.cem_planner import CEMPlanner, ImageCEMPlanner
from video_gcp_torch.planning.cem.simulator import (
    ActCondGCPImageSimulator,
    GCPImageSimulator,
    GCPSimulator,
    env2planner,
)
from video_gcp_torch.planning.infra.policy.policy import Policy
from video_gcp_torch.planning.infra.sim.benchmarks import heartbeat
from video_gcp_torch.training import checkpoint as ckpt_lib


def localize_on_plan(enc, plan_flat, floor, window):
    """Pure localization step for progress-aware tracking: nearest plan index
    to `enc` within [floor, floor + window], and the waypoint index after it.

    :param enc: current frame encoding, any shape that flattens to [D]
    :param plan_flat: latent timeline [T, D]
    :param floor: monotone cursor floor (int)
    :param window: window size (int)
    :return: (target_idx, nearest_idx) 0-d int64 tensors
    """
    t = plan_flat.shape[0]
    d = torch.linalg.vector_norm(plan_flat - enc.reshape(1, -1), dim=-1)
    idx = torch.arange(t, device=plan_flat.device)
    d = torch.where((idx >= floor) & (idx <= floor + window), d,
                    torch.full_like(d, float("inf")))
    near = torch.argmin(d)
    return torch.clamp(near + 1, max=t - 1), near


def load_planner_weights(model, path) -> list:
    """Load the checkpoint at `path` into `model`: every tensor the model
    has, strictly by name and shape. Subtrees of modules that the model does
    not build (the cost model of a checkpoint trained with
    attach_cost_mdl) are dropped; returns their names."""
    state = ckpt_lib.load_model_state(path)
    dropped = sorted({k.split(".")[0] for k in state
                      if not hasattr(model, k.split(".")[0])})
    model.load_state_dict({k: v for k, v in state.items()
                           if k.split(".")[0] not in dropped}, strict=True)
    return dropped


def planning_mesh_devices(requested, device: torch.device):
    """The cards a simulator splits its candidates over (JAX
    planner_policy.py:143-167): n = min(requested, the visible cards),
    cuda:0 to cuda:n-1, and None (no split) unless n > 1 and the policy
    runs on the card."""
    if device.type != "cuda" or not requested:
        return None
    n = min(int(requested), torch.cuda.device_count())
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else None


class PlannerPolicy(Policy):
    def __init__(self, ag_params, policyparams, gpu_id=None, ngpu=None,
                 conversion_fcns=None, n_rooms=None):
        super().__init__()
        self.override_defaults(policyparams)
        self.verbose = self._hp.verbose
        self.log_dir = ag_params.get("log_dir", "/tmp")
        self.max_seq_len = ag_params["T"]
        self.device = torch.device(ag_params.get("device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("planner policy: no CUDA device; run with "
                               "--device cpu to plan on the CPU")
        params = dict(self._hp.params)
        params["batch_size"] = 1
        params.setdefault("max_seq_len", ag_params["T"])

        # build predictor + restore weights
        model_cls = self._hp.model_cls or TreeModel
        hp = default_hparams()
        hp.overwrite(params)
        self.planner_hp = hp
        set_float32_precision()
        self.planner = model_cls(dict(hp))
        self.dropped_subtrees = load_planner_weights(self.planner,
                                                     self._checkpoint_path())
        if self.dropped_subtrees:
            print(f"planner: checkpoint subtrees the model does not build, "
                  f"not loaded: {self.dropped_subtrees}")
        self.planner.to(device=self.device, memory_format=torch.channels_last).eval()

        self.current_exec_step = None
        self.image_plan = None
        self.action_plan = None
        self.latent_plan = None
        self.planner_outputs = []
        self.num_replans = 0

    def _checkpoint_path(self):
        assert self._hp.checkpt_path is not None
        load_epoch = "latest" if self._hp.load_epoch is None else self._hp.load_epoch
        path = ckpt_lib.resolve_resume(load_epoch, self._hp.checkpt_path)
        if path is None:
            raise ValueError(f"No checkpoint found at {self._hp.checkpt_path}")
        return path

    def _default_hparams(self):
        p = super()._default_hparams()
        p.update(dict(
            params={},
            model_cls=None,
            checkpt_path=None,
            load_epoch=None,
            logger=None,
            verbose=False,
            max_dump_rollouts=5,
            replan_interval=1,
            num_max_replans=10,
        ))
        return p

    def reset(self):
        super().reset()
        self.current_exec_step = None
        self.action_plan = None
        self.image_plan = None
        self.num_replans = 0
        self.planner_outputs = []

    def act(self, t=None, i_tr=None, images=None, goal_image=None):
        self.t = t
        self.i_tr = i_tr
        self.goal_image = goal_image
        output = AttrDict()
        if (
            self.image_plan is None
            or self.image_plan.shape[0] - 1 <= self.current_exec_step
            or (t % self._hp.replan_interval == 0
                and self.num_replans < self._hp.num_max_replans)
        ):
            self._plan(images[t], goal_image, t)
            self.num_replans += 1
        output.actions = self.get_action(images[t])
        self.current_exec_step += 1
        return output

    def get_action(self, current_image):
        assert self.action_plan is not None
        if np.size(self.action_plan) < 1:
            return 0.05 * np.random.rand(2)
        step = min(self.current_exec_step, len(self.action_plan) - 1)
        return self.action_plan[step]

    def _plan(self, image, goal_image, step):
        raise NotImplementedError


class CEMPolicy(PlannerPolicy):
    """State-based CEM planning; actions are delta-states
    (planner_policy.py:127-186)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cem_params = dict(self._hp.cem_params)
        cem_params.setdefault("max_seq_len", self.planner_hp["max_seq_len"])
        if "cost_config" in cem_params:  # the learned cost runs beside the model
            cem_params["cost_config"] = dict(cem_params["cost_config"],
                                             device=str(self.device))
        self._cem_simulator = self.simulator_type(
            self.planner, append_latent=True,
            devices=planning_mesh_devices(self._hp.planning_mesh_devices, self.device))
        planner_cls = self._hp.cem_planner or self.planner_type
        self._cem_planner = planner_cls(cem_params, self._cem_simulator)

    def _default_hparams(self):
        p = super()._default_hparams()
        p.update(dict(cem_planner=None, cem_params={},
                      # > 1: split each simulator call's CEM candidates over
                      # (up to) this many cards, one model replica each (the
                      # JAX package's SPMD planning; run.py --nworkers splits
                      # tasks instead)
                      planning_mesh_devices=0))
        return p

    def act(self, t=None, i_tr=None, state=None, goal=None,
            regression_state=None, images=None, run_super=False):
        if run_super:
            return super().act(t, i_tr, state, goal)
        self._images = images[:, 0] if images is not None and images.ndim == 5 \
            else images
        self._states = state
        return super().act(t, i_tr, state, goal)

    def _plan(self, state, goal, step):
        input_goal = goal[-1] if np.ndim(goal) > 1 else goal
        self.image_plan, action_plan, self.latent_plan, self.plan_cost = \
            self._cem_planner(state[None] if np.ndim(state) == 1 else state,
                              input_goal[None] if np.ndim(input_goal) == 1
                              else input_goal)
        self.current_exec_step = 0
        self.image_plan = np.asarray(self.image_plan)
        self.action_plan = self.image_plan[1:] - self.image_plan[:-1]

    def log_outputs_stateful(self, logger=None, global_step=None, phase=None,
                             dump_dir=None, **kwargs):
        self._cem_planner.log_verbose(logger, global_step, phase, self.i_tr,
                                      dump_dir)

    @property
    def simulator_type(self):
        return GCPSimulator

    @property
    def planner_type(self):
        return CEMPlanner


class ImageCEMPolicy(CEMPolicy):
    """Image-based CEM planning; inverse-model action execution, optionally
    closed-loop (planner_policy.py:189-236)."""

    def _default_hparams(self):
        p = super()._default_hparams()
        p.update(dict(closed_loop_execution=False, act_cond=False,
                      # > 0: progress-aware plan tracking (beyond the
                      # reference): localize the current frame's encoding on
                      # the plan's latent timeline within [floor, floor +
                      # window] and track the waypoint after the nearest one;
                      # the floor only moves forward
                      tracking_window=0))
        return p

    def act(self, t=None, i_tr=None, state=None, images=None, goal_image=None):
        self._images = images[:, 0] if images is not None and images.ndim == 5 \
            else images
        self._states = state
        return super().act(t, i_tr, images, goal_image, run_super=True)

    def _plan(self, state, goal, step):
        self.image_plan, self.action_plan, self.latent_plan, self.plan_cost = \
            self._cem_planner(state[None] if np.ndim(state) == 3 else state,
                              goal)
        self.current_exec_step = 0
        self._cursor_floor = 0

    def get_action(self, current_image):
        if self._hp.closed_loop_execution:
            if self._hp.tracking_window > 0:
                return self._infer_action_localized(current_image)
            target = self.latent_plan[
                min(self.current_exec_step + 1, len(self.latent_plan) - 1)
            ]
            return self._infer_action(current_image, target)
        return super().get_action(current_image)

    def _encode(self, current_img) -> torch.Tensor:
        """The encoder's latent of one env image, [1, nz_enc]."""
        img = env2planner(current_img)
        if img.ndim == 3:
            img = img[None]
        heartbeat()
        return self.planner.encoder(torch.as_tensor(img, device=self.device))[0]

    def _infer_action(self, current_img, target_latent):
        """Closed loop: re-infer the action from the current image's encoding
        to the planned next latent (planner_policy.py:222-227). Runs at every
        environment step."""
        with torch.inference_mode():
            enc = self._encode(current_img)
            target = torch.as_tensor(np.asarray(target_latent, np.float32),
                                     device=self.device)
            return self.planner.inv_mdl(enc, target[None]).cpu().numpy()[0]

    def _infer_action_localized(self, current_img):
        """Progress-aware closed loop (tracking_window > 0): localize the
        current encoding on the plan's latent timeline within [floor, floor +
        window], track the waypoint after the nearest one, and advance the
        monotone floor to the localized position. The window is read at
        every call."""
        with torch.inference_mode():
            enc = self._encode(current_img)
            plan = torch.as_tensor(np.asarray(self.latent_plan, np.float32),
                                   device=self.device)
            flat = plan.reshape(plan.shape[0], -1)
            tgt, near = localize_on_plan(enc, flat, self._cursor_floor,
                                         int(self._hp.tracking_window))
            action = self.planner.inv_mdl(enc, flat[tgt][None]).cpu().numpy()[0]
        self._cursor_floor = max(self._cursor_floor, int(near))
        return action

    @property
    def simulator_type(self):
        return GCPImageSimulator if not self._hp.act_cond \
            else ActCondGCPImageSimulator

    @property
    def planner_type(self):
        return ImageCEMPlanner
