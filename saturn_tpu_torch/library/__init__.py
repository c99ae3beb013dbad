"""Technique library: register / deregister / retrieve parallelism plugins.

Counterpart of ``saturn_tpu/library/__init__.py``: an in-process registry
of ``BaseTechnique`` classes (the default library holds ``dp`` and
``offload``) and, where ``SATURN_TPU_LIBRARY_PATH`` is set, a store in
that directory through which a technique registered in one process is
found in the next.

The JAX package pickles each class with dill, by value, into
``<name>.udp``. The port uses the standard library only, and a file of its
own, ``<name>.technique.json``, so both packages can share one directory
and the port never unpickles a JAX ``.udp``. A record names where the class
is defined: its module and qualified name. Loading imports that module by
name. A class of a user's ``__main__`` script is the one exception: its
record also holds the script's file, which loading imports under a private
module name, so the script's ``if __name__ == "__main__":`` block does not
run. A class that no file or module defines by its name (typed into an
interactive session, or defined in a function) cannot be persisted, and
``register`` raises for it.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import inspect
import json
import logging
import os
import sys
import threading
from typing import Dict, List, Optional, Type, Union

from saturn_tpu_torch.core.strategy import Techniques
from saturn_tpu_torch.core.technique import BaseTechnique

log = logging.getLogger("saturn_tpu_torch")

_REGISTRY: Dict[str, Type[BaseTechnique]] = {}

_ENV_PATH = "SATURN_TPU_LIBRARY_PATH"
#: The suffix of the port's persisted techniques (the JAX package's: ``.udp``).
SUFFIX = ".technique.json"
FORMAT = 1

_import_lock = threading.Lock()


def _persist_dir() -> Optional[str]:
    return os.environ.get(_ENV_PATH)


def _record(cls: type) -> dict:
    """Where ``cls`` is defined, as a JSON-able record; raises ``ValueError``
    where no file holds it."""
    qualname = cls.__qualname__
    if "<locals>" in qualname:
        raise ValueError(f"cannot persist {qualname}: a class defined inside a function "
                         f"has no name to load it by; define it at a module's top level")
    rec = {"format": FORMAT, "module": cls.__module__, "qualname": qualname}
    if cls.__module__ != "__main__":
        try:
            found = _attr(sys.modules[cls.__module__], qualname)
        except (KeyError, AttributeError):
            found = None
        if found is not cls:
            raise ValueError(f"cannot persist {qualname}: no file defines it (module "
                             f"{cls.__module__!r} does not hold it by that name); define it "
                             f"in a module or a script file")
        return rec
    try:
        rec["file"] = os.path.abspath(inspect.getfile(cls))
    except (TypeError, OSError) as e:
        raise ValueError(f"cannot persist {qualname}: no file defines it ({e}); define it "
                         f"in a module or a script file") from e
    return rec


def _attr(obj, qualname: str):
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _load_record(name: str, rec: dict) -> type:
    """The class a record names (see the module docstring)."""
    if rec.get("format") != FORMAT:
        raise ValueError(f"technique {name!r}: record format {rec.get('format')!r}, "
                         f"this library reads {FORMAT}")
    module, qualname = rec["module"], rec["qualname"]
    if module != "__main__":
        return _attr(importlib.import_module(module), qualname)
    path = rec["file"]
    # one private module a file, so the techniques of one script share it
    private = "_saturn_tpu_torch_technique_" + hashlib.sha1(path.encode()).hexdigest()[:12]
    with _import_lock:
        mod = sys.modules.get(private)
        if mod is None or getattr(mod, "__file__", None) != path:
            spec = importlib.util.spec_from_file_location(private, path)
            if spec is None or spec.loader is None:
                raise ImportError(f"technique {name!r}: cannot import {path}")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[private] = mod
            try:
                spec.loader.exec_module(mod)
            except BaseException:
                del sys.modules[private]
                raise
    return _attr(mod, qualname)


def register(name: str, technique_cls: Type[BaseTechnique]) -> None:
    """Register a technique class under ``name``; under
    ``SATURN_TPU_LIBRARY_PATH`` also write its record there."""
    if not (isinstance(technique_cls, type) and issubclass(technique_cls, BaseTechnique)):
        raise TypeError(
            f"{technique_cls!r} is not a subclass of BaseTechnique; "
            "techniques must implement search() and execute()"
        )
    d = _persist_dir()
    rec = _record(technique_cls) if d else None
    _REGISTRY[name] = technique_cls
    if d:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name + SUFFIX)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)


def deregister(name: str) -> None:
    """Remove a technique, and its record under ``SATURN_TPU_LIBRARY_PATH``."""
    _REGISTRY.pop(name, None)
    d = _persist_dir()
    if d:
        p = os.path.join(d, name + SUFFIX)
        if os.path.exists(p):
            os.unlink(p)


def retrieve(
    names: Union[None, str, Techniques, List] = None,
) -> Union[Type[BaseTechnique], List[Type[BaseTechnique]]]:
    """``None`` returns all (insertion order, persisted ones loaded first);
    a string or a ``Techniques`` member returns one class; a list returns a
    list of classes. A name not in the process's registry is looked up in
    the store."""
    if names is None:
        _load_persisted_missing()
        return list(_REGISTRY.values())
    if isinstance(names, (str, Techniques)):
        return _retrieve_one(names)
    return [_retrieve_one(n) for n in names]


def registered_names() -> List[str]:
    _load_persisted_missing()
    return list(_REGISTRY.keys())


def _retrieve_one(name) -> Type[BaseTechnique]:
    if isinstance(name, Techniques):
        _load_persisted_missing()
        for cls in _REGISTRY.values():
            # own attribute only: a user subclass of a builtin that does not
            # claim the member itself must not shadow the builtin
            if cls.__dict__.get("technique") is name:
                return cls
        raise KeyError(
            f"no registered technique implements {name!r}; "
            "call register_default_library() first"
        )
    if name in _REGISTRY:
        return _REGISTRY[name]
    d = _persist_dir()
    if d:
        p = os.path.join(d, name + SUFFIX)
        if os.path.exists(p):
            with open(p) as f:
                cls = _load_record(name, json.load(f))
            if not (isinstance(cls, type) and issubclass(cls, BaseTechnique)):
                raise TypeError(f"technique {name!r} in {p} loads {cls!r}, "
                                f"not a BaseTechnique subclass")
            _REGISTRY[name] = cls
            return cls
    raise KeyError(f"no technique registered under {name!r}")


def _load_persisted_missing() -> None:
    """Load every persisted technique not registered in this process; one
    that fails to load is left out, as in JAX (which does not log it)."""
    d = _persist_dir()
    if not d or not os.path.isdir(d):
        return
    for fn in sorted(os.listdir(d)):
        if fn.endswith(SUFFIX):
            name = fn[: -len(SUFFIX)]
            if name not in _REGISTRY:
                try:
                    _retrieve_one(name)
                except Exception:
                    log.warning("persisted technique %r does not load; left out", name,
                                exc_info=True)


def register_default_library() -> List[str]:
    """Register the built-in executors."""
    from saturn_tpu_torch.parallel import BUILTIN_TECHNIQUES

    for name, cls in BUILTIN_TECHNIQUES.items():
        register(name, cls)
    return list(BUILTIN_TECHNIQUES.keys())
