"""The port stands alone: no module of ``src/repro_torch`` and nothing in
``chip_smoke.py`` imports jax, jaxlib or the reference package ``repro``,
and importing the serving or the training entry point loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    assert path.exists(), path
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serve_import_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_guarded_training_modules_are_covered():
    """The modules of the guarded training path are among the files
    checked above."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in _sources()[:-1]}
    assert {"checkpoint/manager.py", "runtime/fault_tolerance.py", "runtime/chaos.py",
            "data/pipeline.py", "optim/adamw.py", "launch/train.py"} <= names


def test_train_import_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.checkpoint, repro_torch.runtime\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sharding_modules_are_covered():
    """The modules of the sharded step and the dry run are among the files
    checked above, and the dry run's import loads neither jax nor repro."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in _sources()[:-1]}
    assert {"launch/sharding.py", "launch/specs.py", "launch/dryrun.py", "launch/mesh.py",
            "models/context.py", "models/parallel.py", "core/collectives.py"} <= names
    code = (
        "import sys\n"
        "import repro_torch.launch.dryrun, repro_torch.models.parallel\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
