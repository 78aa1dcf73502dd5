"""What a run may load: nothing of JAX or the JAX package (``repro``), by
whole top-level module names, in the harness's sources or in the
process; and the plain reference nothing of the program either."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path: Path):
    """Top-level names of every module the file imports (absolute ones;
    ``importlib`` calls by name are read as strings too)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(spec.HERE)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_the_whole_name_is_compared():
    sys.path.insert(0, str(spec.ROOT / "portbench"))
    try:
        import run as run_module
    finally:
        sys.path.pop(0)
    try:
        sys.modules["repro_torch.fake"] = object()
        assert "repro" not in run_module.forbidden_modules()
        sys.modules["repro.fake"] = object()
        assert "repro" in run_module.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch.fake", None)
        sys.modules.pop("repro.fake", None)


def test_the_reference_imports_nothing_of_the_program():
    refs = [p for p in (spec.HERE / "configs").glob("*.py")]
    assert refs
    for p in refs:
        got = _imports(p)
        assert not got & (FORBIDDEN | {"repro_torch"}), p
        assert got <= {"__future__", "math", "typing", "torch", "portbench"}
    # and what the reference imports of the harness is the program-free part
    assert not _imports(spec.HERE / "dims.py") & {"repro_torch"}
    assert not _imports(spec.HERE / "weights.py") & {"repro_torch"}


def test_a_run_loads_no_jax(tmp_path):
    """A small run in a fresh process: nothing of JAX is loaded by the
    harness or the program's serving path."""
    code = (
        "import sys; sys.path[:0] = ['portbench/tests', 'src', '.']\n"
        "import conftest\n"
        "conftest.run_small('granite-3-8b.serve-docs', seconds=1.0)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        f"set({sorted(FORBIDDEN)!r}))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite-3-8b.serve-docs", "--seed", str(2**31 + 11),
         "--seconds", "1", "--trace", "0", *args], cwd=cwd,
        capture_output=True, text=True, env=env, timeout=300)


def test_run_without_a_card_prints_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_with_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
