"""Technique library: register / deregister / retrieve parallelism plugins.

Counterpart of ``saturn_tpu/library/__init__.py``: an in-process registry of
``BaseTechnique`` classes. The default library holds ``dp`` only in this
slice; the other techniques, and the JAX package's optional dill persistence
of user techniques under ``SATURN_TPU_LIBRARY_PATH``, are later items
(``ROADMAP.md``): ``register`` raises while that variable is set.
"""

from __future__ import annotations

import os
from typing import Dict, List, Type, Union

from saturn_tpu_torch.core.strategy import Techniques
from saturn_tpu_torch.core.technique import BaseTechnique

_REGISTRY: Dict[str, Type[BaseTechnique]] = {}

_ENV_PATH = "SATURN_TPU_LIBRARY_PATH"


def register(name: str, technique_cls: Type[BaseTechnique]) -> None:
    """Register a technique class under ``name``."""
    if not (isinstance(technique_cls, type) and issubclass(technique_cls, BaseTechnique)):
        raise TypeError(
            f"{technique_cls!r} is not a subclass of BaseTechnique; "
            "techniques must implement search() and execute()"
        )
    if os.environ.get(_ENV_PATH):  # where the JAX package persists the class with dill
        raise NotImplementedError(
            f"library.register: {_ENV_PATH} is set, and persisting techniques is "
            "not carried by the PyTorch port yet (see ROADMAP.md, queue 1 item 3)"
        )
    _REGISTRY[name] = technique_cls


def deregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def retrieve(
    names: Union[None, str, Techniques, List] = None,
) -> Union[Type[BaseTechnique], List[Type[BaseTechnique]]]:
    """``None`` returns all (insertion order); a string or a ``Techniques``
    member returns one class; a list returns a list of classes."""
    if names is None:
        return list(_REGISTRY.values())
    if isinstance(names, (str, Techniques)):
        return _retrieve_one(names)
    return [_retrieve_one(n) for n in names]


def registered_names() -> List[str]:
    return list(_REGISTRY.keys())


def _retrieve_one(name) -> Type[BaseTechnique]:
    if isinstance(name, Techniques):
        for cls in _REGISTRY.values():
            if cls.__dict__.get("technique") is name:
                return cls
        raise KeyError(
            f"no registered technique implements {name!r}; "
            "call register_default_library() first"
        )
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"no technique registered under {name!r}")


def register_default_library() -> List[str]:
    """Register the built-in executors."""
    from saturn_tpu_torch.parallel import BUILTIN_TECHNIQUES

    for name, cls in BUILTIN_TECHNIQUES.items():
        register(name, cls)
    return list(BUILTIN_TECHNIQUES.keys())
