"""No module under portbench/ imports JAX, jaxlib or the JAX package, and
the references import nothing of the port; the command refuses to run
without a card and prints no result."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
SOURCES = sorted(PORTBENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    """The top-level name of every module a file imports (whole names)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "neptune_tpu"}


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not top_level_imports(path) & {"neptune_tpu_torch", "portbench"}


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "neptune_tpu_torch_like", sys)
    assert "neptune_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "neptune_tpu.config", sys)
    assert harness.forbidden_modules() == ["neptune_tpu"]


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", NEPTUNE_TORCH_CACHE_DIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(PORTBENCH / "run.py"), "--workload", "jacobi8192_apply",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "needs 1 CUDA device" in proc.stderr
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
