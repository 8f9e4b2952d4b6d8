"""Behavioral cloning control policy at test time
(planning/infra/policy/bc_policy.py of the JAX package;
gcp/planning/infra/policy/bc_policy.py:9-98).

Restores a BCModel from a port checkpoint (`weights_ep*/state.pt`) and acts
one goal-conditioned step at a time on the env's images, keeping the
recurrent policy's hidden state from one `act` to the next until `reset`.
The model runs on `ag_params['device']`, the card unless the run asks for
the CPU; without a card a 'cuda' policy raises.
"""
from __future__ import annotations

import numpy as np
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.load import set_float32_precision
from video_gcp_torch.models.bc import BCModel
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.planning.infra.policy.policy import Policy
from video_gcp_torch.training import checkpoint as ckpt_lib


class BehavioralCloningPolicy(Policy):
    def __init__(self, ag_params, policyparams, gpu_id=None, ngpu=None,
                 conversion_fcns=None, n_rooms=None):
        super().__init__()
        self.override_defaults(policyparams)
        self.device = torch.device(ag_params.get("device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BC policy: no CUDA device; run with --device cpu "
                               "to act on the CPU")
        params = dict(self._hp.params)
        params["batch_size"] = 1
        hp = default_hparams()
        hp.overwrite(dict(reactive=True))
        hp.overwrite(params)
        set_float32_precision()
        self.model = BCModel(dict(hp))
        path = ckpt_lib.resolve_resume(self._hp.load_epoch or "latest",
                                       self._hp.checkpt_path)
        if path is None:
            raise ValueError(f"no BC checkpoint under {self._hp.checkpt_path}")
        self.model.load_state_dict(ckpt_lib.load_model_state(path), strict=True)
        self.model.to(device=self.device, memory_format=torch.channels_last).eval()
        self.hidden_var = None

    def _default_hparams(self):
        p = super()._default_hparams()
        p.update(dict(params={}, checkpt_path=None, model=None, logger=None,
                      load_epoch=None))
        return p

    def reset(self):
        super().reset()
        self.hidden_var = None

    @staticmethod
    def _preprocess_input(img) -> np.ndarray:
        """[0, 255] or [0, 1] images [N, H, W, C] -> [-1, 1] float32."""
        img = np.asarray(img, np.float32)
        assert img.ndim == 4
        if img.max() > 1.0:
            img = img / 255.0
        if img.min() >= 0.0:
            img = 2 * img - 1.0
        return img

    def act(self, t=None, i_tr=None, images=None, state=None, goal=None,
            goal_image=None):
        self.t = t
        self.i_tr = i_tr
        i0 = self._preprocess_input(images[t])
        ig_src = goal_image[-1] if np.ndim(goal_image) > 4 else goal_image
        ig = self._preprocess_input(ig_src)
        with torch.inference_mode():
            actions, self.hidden_var = self.model.act_single(
                torch.as_tensor(i0, device=self.device),
                torch.as_tensor(ig, device=self.device), self.hidden_var)
            return AttrDict(actions=actions.cpu().numpy()[0])

    @property
    def default_action(self):
        return np.zeros(self.model.hp["n_actions"])
