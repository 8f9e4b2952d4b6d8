"""dict with attribute access (blox.AttrDict surface, core/attrdict.py of the
JAX package without the pytree registration), and the reader of pickles that
hold either package's AttrDict."""
from __future__ import annotations

import pickle
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


class _Unpickler(pickle.Unpickler):
    """Reads the planning pickles of either package: the JAX package's
    AttrDict becomes this one, and no other class of the JAX package is
    imported. `from_jax` tells whether the pickle held the JAX package's
    AttrDict."""

    from_jax = False

    def find_class(self, module, name):
        if (module, name) == _JAX_ATTRDICT:
            self.from_jax = True
            return AttrDict
        if module.split(".")[0] == _JAX_ATTRDICT[0].split(".")[0]:
            raise pickle.UnpicklingError(
                f"{module}.{name}: the port reads no class of the JAX package "
                "but its AttrDict")
        return super().find_class(module, name)


def load_pickle(path, allow_jax: bool = True):
    """pickle.load of a task, score or observation pickle written by this
    package or, unless `allow_jax` is False, by the JAX package (told apart
    by the AttrDict it holds)."""
    with open(path, "rb") as f:
        unpickler = _Unpickler(f)
        data = unpickler.load()
    if unpickler.from_jax and not allow_jax:
        raise pickle.UnpicklingError(f"{path} was written by the JAX package")
    return data
