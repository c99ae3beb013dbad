"""The port's technique library under ``SATURN_TPU_LIBRARY_PATH``
(``saturn_tpu_torch/library/__init__.py``) against the JAX package's
(``saturn_tpu/library/__init__.py``): a technique registered in one process
is found by name in the next, also one defined in a script's
``__main__``; ``deregister`` removes its file; ``retrieve(None)`` and
``registered_names`` load every persisted name; a user subclass of a
builtin that does not claim the builtin's ``Techniques`` member does not
shadow it; the two packages share one directory, each reading only its own
files (the port never unpickles a JAX ``.udp``). No tolerances: names,
classes and files are compared exactly.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import saturn_tpu_torch as sat
from saturn_tpu import library as jlib
from saturn_tpu.core.strategy import Techniques as JTechniques
from saturn_tpu_torch import library
from saturn_tpu_torch.core.strategy import Techniques
from saturn_tpu_torch.parallel.dp import DataParallel

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = '''
from saturn_tpu_torch import library
from saturn_tpu_torch.parallel.dp import DataParallel


class ScriptDP(DataParallel):
    name = "script-dp"


if __name__ == "__main__":
    library.register("script-dp", ScriptDP)
'''

READER = (
    "import json, sys\n"
    "from saturn_tpu_torch import library\n"
    "from saturn_tpu_torch.core.strategy import Techniques\n"
    "cls = library.retrieve(sys.argv[1])\n"
    "print(json.dumps({'qualname': cls.__qualname__, 'module': cls.__module__,\n"
    "                  'mro': [c.__qualname__ for c in cls.__mro__],\n"
    "                  'names': library.registered_names(),\n"
    "                  'all': [c.__qualname__ for c in library.retrieve(None)],\n"
    "                  'dp': [c.__qualname__ for c in library.retrieve(None)\n"
    "                         if c.__dict__.get('technique') is Techniques.DP],\n"
    "                  'main_ran': hasattr(sys.modules['__main__'], 'ScriptDP')}))\n"
)


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A library directory of the test's own, and both packages' registries
    empty for the test and restored after it."""
    d = tmp_path / "library"
    monkeypatch.setenv("SATURN_TPU_LIBRARY_PATH", str(d))
    saved, jsaved = dict(library._REGISTRY), dict(jlib._REGISTRY)
    library._REGISTRY.clear()
    jlib._REGISTRY.clear()
    yield d
    library._REGISTRY.clear()
    library._REGISTRY.update(saved)
    jlib._REGISTRY.clear()
    jlib._REGISTRY.update(jsaved)


def _run(args, store, cwd):
    env = dict(os.environ, SATURN_TPU_LIBRARY_PATH=str(store), PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, *args], env=env, cwd=cwd, check=True,
                         capture_output=True, text=True, timeout=300)
    return out.stdout


def test_main_class_persists_across_processes(store, tmp_path):
    """A dp subclass of a script's ``__main__`` registered in one process
    is retrieved by name in a second, loaded from the script's file without
    running its ``__main__`` block; ``retrieve(None)`` and the names list
    include it, and it does not shadow the builtin dp."""
    script = tmp_path / "user_script.py"
    script.write_text(SCRIPT)
    _run([str(script)], store, tmp_path)
    assert sorted(p.name for p in store.iterdir()) == ["script-dp" + library.SUFFIX]
    rec = json.loads((store / ("script-dp" + library.SUFFIX)).read_text())
    assert rec == {"format": library.FORMAT, "module": "__main__", "qualname": "ScriptDP",
                   "file": str(script)}
    got = json.loads(_run(["-c", READER, "script-dp"], store, tmp_path).strip())
    assert got["qualname"] == "ScriptDP" and got["module"].startswith("_saturn_tpu_torch")
    assert got["mro"][1] == "DataParallel" and not got["main_ran"]
    assert got["names"] == ["script-dp"] and got["all"] == ["ScriptDP"]
    assert got["dp"] == []  # the subclass claims no member of its own
    # a class that claims no member of its own never answers for one
    library.retrieve("script-dp")
    with pytest.raises(KeyError, match="no registered technique implements"):
        library.retrieve(Techniques.DP)
    library.register("dp", DataParallel)
    assert library.retrieve(Techniques.DP) is DataParallel


def test_importable_class_persists_by_reference(store, tmp_path):
    """A class of an importable module is loaded by its module's name: the
    same class object in the next process's import of it."""
    library.register("dp-again", DataParallel)
    got = json.loads(_run(["-c", READER, "dp-again"], store, tmp_path).strip())
    assert got["module"] == "saturn_tpu_torch.parallel.dp" and got["qualname"] == "DataParallel"
    library._REGISTRY.pop("dp-again")
    assert library.retrieve("dp-again") is DataParallel  # by its module's name


def test_deregister_removes_the_file(store):
    library.register("gone", DataParallel)
    path = store / ("gone" + library.SUFFIX)
    assert path.exists()
    library.deregister("gone")
    assert not path.exists() and "gone" not in library.registered_names()
    with pytest.raises(KeyError, match="no technique registered under 'gone'"):
        library.retrieve("gone")


def test_retrieve_none_loads_persisted_names(store, tmp_path):
    """Like JAX's ``retrieve(None)``: every persisted name not yet in the
    registry is loaded (in name order here); one whose file no longer loads
    is left out."""
    library.register("zeta", DataParallel)
    library.register("alpha", DataParallel)
    broken = tmp_path / "broken.py"
    broken.write_text("raise RuntimeError('not importable')\n")
    (store / ("broken" + library.SUFFIX)).write_text(json.dumps(
        {"format": library.FORMAT, "module": "__main__", "qualname": "X", "file": str(broken)}))
    for name in ("zeta", "alpha"):
        library._REGISTRY.pop(name)
    classes = library.retrieve(None)
    assert classes.count(DataParallel) >= 2
    names = library.registered_names()
    assert "alpha" in names and "zeta" in names and "broken" not in names
    with pytest.raises(RuntimeError, match="not importable"):
        library.retrieve("broken")


def test_both_packages_share_one_directory(store):
    """The JAX library's ``.udp`` (dill) and the port's ``.technique.json``
    sit side by side; neither package reads the other's file."""
    pytest.importorskip("dill")
    from saturn_tpu.parallel.dp import DataParallel as JDataParallel

    jlib.register("shared", JDataParallel)
    library.register("shared", DataParallel)
    jlib.register("jax-only", JDataParallel)
    assert sorted(p.name for p in store.iterdir()) == [
        "jax-only.udp", "shared" + library.SUFFIX, "shared.udp"]
    library._REGISTRY.pop("shared")
    jlib._REGISTRY.pop("shared")
    assert library.retrieve("shared") is DataParallel
    assert jlib.retrieve("shared") is JDataParallel
    assert "jax-only" not in library.registered_names()
    with pytest.raises(KeyError):
        library.retrieve("jax-only")
    assert jlib.retrieve(JTechniques.DP) is JDataParallel


def test_unpersistable_class_raises(store):
    """A class with no file or no module-level name cannot be recorded:
    ``register`` raises and registers nothing."""
    def local():
        class Local(DataParallel):
            pass
        return Local

    with pytest.raises(ValueError, match="inside a function"):
        library.register("local", local())
    ns = {}
    exec("from saturn_tpu_torch.parallel.dp import DataParallel\n"
         "class Typed(DataParallel):\n    pass\n", ns)
    with pytest.raises(ValueError, match="no file defines it"):
        library.register("typed", ns["Typed"])
    assert "local" not in library._REGISTRY and "typed" not in library._REGISTRY
    assert not store.exists()


def test_search_and_orchestrate_with_a_persisted_technique(store, tmp_path, monkeypatch):
    """The port's four calls with a technique loaded from the store, on the
    CPU: search profiles it and orchestrate trains the task to its end."""
    import torch

    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.gpt2 import build_gpt2
    from saturn_tpu_torch.models.loss import pretraining_loss
    from saturn_tpu_torch.utils import checkpoint as ckpt

    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    script = tmp_path / "user_script.py"
    script.write_text(SCRIPT)
    _run([str(script)], store, tmp_path)
    cls = library.retrieve("script-dp")
    task = sat.Task(get_model=lambda **kw: build_gpt2("test-tiny", **kw),
                    get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=4,
                                                           vocab_size=256, n_tokens=64 * 4 * 4),
                    loss_fn=pretraining_loss, hparams=sat.HParams(lr=1e-3, batch_count=4),
                    name="persisted", save_dir=str(tmp_path / "ck"))
    topo = SliceTopology([torch.device("cpu")])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sat.search([task], technique_names=["script-dp"], topology=topo)
        assert type(task.strategies[1].executor) is cls
        result = sat.orchestrate([task], topology=topo, interval=30.0)
    finally:
        torch.set_num_threads(n)
    assert result["completed"] == ["persisted"] and ckpt.saved_step(task.ckpt_path) == 4
