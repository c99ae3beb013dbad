"""The PyTorch port stands alone: no file of ``saturn_tpu_torch/`` nor
``chip_smoke.py`` imports JAX, flax, optax, the JAX package or dill (which
the card's machine lacks), and importing the port leaves JAX unloaded."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ("jax", "jaxlib", "flax", "optax", "saturn_tpu")
FORBIDDEN = JAX + ("dill",)  # torch itself loads dill where it is installed
SOURCES = sorted((ROOT / "saturn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, saturn_tpu_torch, saturn_tpu_torch.models.gpt2, "
        "saturn_tpu_torch.parallel.dp, saturn_tpu_torch.executor.orchestrator, "
        "saturn_tpu_torch.trial_runner.evaluator, saturn_tpu_torch.native, "
        "saturn_tpu_torch.solver.native_sched, saturn_tpu_torch.solver.anytime, "
        "saturn_tpu_torch.health, saturn_tpu_torch.analysis, "
        "saturn_tpu_torch.durability, saturn_tpu_torch.resilience, "
        "saturn_tpu_torch.utils.metrics, saturn_tpu_torch.utils.profile_cache, "
        "saturn_tpu_torch.utils.trace, saturn_tpu_torch.utils.compile_cache, "
        "saturn_tpu_torch.models.ingest, saturn_tpu_torch.data.corpus_gen, "
        "saturn_tpu_torch.examples.lm_sweep, saturn_tpu_torch.library, "
        "saturn_tpu_torch.twin.runner, saturn_tpu_torch.tenancy.compile_ahead, "
        "saturn_tpu_torch.analysis.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (JAX,)
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
