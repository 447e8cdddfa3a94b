"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Names are compared whole, by the
part before the first dot: ``s1s2_torch`` begins with ``s1s2`` and is not it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NEVER = {"jax", "jaxlib", "flax", "s1s2", "msgpack", "ml_dtypes"}
PROGRAM = {"s1s2_torch"}


def imports(path: Path):
    """The full name of every module that ``path`` imports."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def top_level_imports(path: Path):
    return (name.split(".")[0] for name in imports(path))


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_by_whole_top_level_name(path):
    assert not set(top_level_imports(path)) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert not names & (NEVER | PROGRAM)
    own = {n for n in imports(path) if n.split(".")[0] == "benchmark"}
    assert own <= {"benchmark.reference"}  # of the benchmark, only the reference itself
    assert names - {"benchmark"} <= {"__future__", "contextlib", "math", "typing", "numpy",
                                     "torch"}


def test_the_whole_name_check():
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell

    saved = dict(sys.modules)
    try:
        sys.modules["s1s2_torch_fake"] = sys.modules["os"]
        assert cell.forbidden_modules() == []
        sys.modules["s1s2.core"] = sys.modules["os"]
        assert cell.forbidden_modules() == ["s1s2"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {never}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
import time, torch
from benchmark.harness import cell
r = cell.run("unet96_eps.dpm5_int8.b64", 7, 0.1, False, time.perf_counter(),
             device=torch.device("cpu"),
             overrides={{"arch": {{"base_ch": 8}}, "mix": {{"batch": 2, "size": 32, "calib_n": 2}}}})
assert r["correct"], r
assert cell.forbidden_modules() == []
print("ok")
"""


def test_a_run_with_jax_blocked():
    code = BLOCKER.format(never=sorted(NEVER), root=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr[-3000:]
