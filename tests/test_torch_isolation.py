"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports JAX or the reference package, and
``chip_smoke.py`` refuses to report without a card or outside a checkout.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and (
                    getattr(node.func, "attr", None) == "import_module"
                    or getattr(node.func, "id", None) == "__import__"):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_importing_every_port_module_loads_neither_jax_nor_reference():
    script = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[1])\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script,
                           str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


def _run_smoke(path: Path, cwd: Path, hide_card: bool):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if hide_card:
        env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a host with one
    return subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=False)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO / "chip_smoke.py", REPO, hide_card=True)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    proc = _run_smoke(alone, tmp_path, hide_card=False)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
