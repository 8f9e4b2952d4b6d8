"""Policy base class + reflection-based argument passing.

Reference: gcp/planning/infra/policy/policy.py:6-113 (Visual-Foresight fork).
``get_policy_args`` inspects the policy's act() signature and fills arguments
from the agent's observation dict / per-step agent data.

A numpy copy of planning/infra/policy/policy.py of the JAX package.
"""
from __future__ import annotations

import abc
import inspect

import numpy as np

from video_gcp_torch.core.params import ParamDict


def get_policy_args(policy, obs, t, i_tr, agent_data=None):
    policy_args = {}
    sig = inspect.signature(policy.act)
    for arg in sig.parameters:
        value = sig.parameters[arg].default
        if arg in obs:
            value = obs[arg]
        elif agent_data is not None and arg in agent_data:
            value = agent_data[arg]
        elif arg == "t":
            value = t
        elif arg == "i_tr":
            value = i_tr
        elif arg == "obs":
            value = obs
        elif arg == "agent_data":
            value = agent_data
        elif arg == "goal":
            value = agent_data["goal"]
        if value is inspect.Parameter.empty:
            raise ValueError(f"Required policy param {arg} not set by agent")
        policy_args[arg] = value
    return policy_args


class Policy(abc.ABC):
    def __init__(self):
        self._hp = self._default_hparams()

    def override_defaults(self, policyparams):
        for name, value in policyparams.items():
            if name == "type":
                continue
            if name in self._hp and _equal(value, self._hp[name]) \
                    and self._hp[name] is not None:
                raise ValueError(
                    f"Policy attribute {name} identical to default value"
                )
            self._hp[name] = value

    def _default_hparams(self) -> ParamDict:
        return ParamDict()

    @abc.abstractmethod
    def act(self, *args):
        """Returns a dict with at least key 'actions'."""

    def reset(self):
        pass

    def log_outputs_stateful(self, *args, **kwargs):
        pass


def _equal(a, b):
    try:
        r = a == b
        return bool(r) if isinstance(r, bool) else bool(np.all(r))
    except Exception:
        return False


class DummyPolicy:
    def __init__(self, ag_params, policyparams, gpu_id=None, ngpu=None):
        pass

    def act(self, *args):
        pass

    def reset(self):
        pass


class NullPolicy(Policy):
    """Zero actions every step."""

    def __init__(self, ag_params, policyparams, gpu_id=None, ngpu=None):
        super().__init__()
        self._adim = ag_params["adim"]

    def act(self):
        return dict(actions=np.zeros(self._adim))
