"""No module of the benchmark imports JAX or the reference package
(``repro``, compared by whole top-level name: the port ``repro_torch``
begins with it), and the plain reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain_numpy(path):
    """Plain NumPy, and plain PyTorch for the all-lane replay."""
    assert top_level_imports(path) <= {"__future__", "dataclasses", "typing", "numpy",
                                       "torch", "portbench"}
    assert "repro_torch" not in path.read_text()


def test_import_check_compares_whole_names():
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_without_the_program_it_exits_nonzero_and_prints_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the benchmark's
    own files, a run fails before any result."""
    import os
    import shutil
    import subprocess
    import sys

    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "steady-mfi.load085.r64k", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
