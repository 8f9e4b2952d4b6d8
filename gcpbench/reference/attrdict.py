"""dict with attribute access (blox.AttrDict surface, core/attrdict.py of the
JAX package without the pytree registration)."""
from __future__ import annotations

from typing import Any


class AttrDict(dict):
    __slots__ = ()

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def copy(self) -> "AttrDict":
        return AttrDict(self)


def listdict2dictlist(lst: list) -> AttrDict:
    """[{k: v1}, {k: v2}] -> {k: [v1, v2]}. Keys taken from the first element."""
    if not lst:
        return AttrDict()
    return AttrDict({k: [d[k] for d in lst] for k in lst[0]})


_JAX_ATTRDICT = ("video_gcp_tpu.core.attrdict", "AttrDict")


