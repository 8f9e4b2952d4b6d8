"""Hyperparameter store with the "override must differ from default" rule
(gcp/prediction/training/base_trainer.py:9-14)."""
from __future__ import annotations

from typing import Any, Mapping

from .attrdict import AttrDict


class ParamDict(AttrDict):
    """AttrDict for hyperparameters with strict override semantics."""

    def override(self, params: Mapping[str, Any], strict: bool = True) -> "ParamDict":
        """Override defaults; with `strict`, an unknown key or a value equal to
        the default raises (catches stale config entries)."""
        for k, v in params.items():
            if strict and k not in self:
                raise KeyError(f"Cannot override untyped hyperparameter {k!r}")
            if strict and _safe_equal(self[k], v):
                raise ValueError(
                    f"Attempted to override hparam {k!r} with default value {v!r}")
            self[k] = v
        return self

    def overwrite(self, params: Mapping[str, Any]) -> "ParamDict":
        """Non-strict update (blox ParamDict.overwrite semantics)."""
        self.update(params)
        return self


def _safe_equal(a: Any, b: Any) -> bool:
    try:
        res = a == b
        if isinstance(res, bool):
            return res
        return bool(getattr(res, "all", lambda: False)())
    except Exception:
        return False
