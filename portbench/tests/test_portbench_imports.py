"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (tramp_tpu_torch is not tramp_tpu), and the
plain references import nothing of the program."""
import ast
import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT
from portbench.run import FORBIDDEN, forbidden_modules

SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def top_level_imports(path):
    "Top-level names of the absolute imports of a file."
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_check_compares_whole_top_level_names():
    assert forbidden_modules({"tramp_tpu_torch": 0, "tramp_tpu_torch.ops": 0,
                              "jaxtyping": 0, "numpy": 0}) == []
    assert forbidden_modules({"jax.numpy": 0, "tramp_tpu.ops": 0,
                              "flax": 0, "jaxlib": 0}) == [
        "flax", "jax.numpy", "jaxlib", "tramp_tpu.ops"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "tramp_tpu"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


def test_the_references_import_nothing_of_the_program():
    for path in sorted((ROOT / "portbench" / "reference").glob("*.py")):
        imported = top_level_imports(path)
        assert "tramp_tpu_torch" not in imported, path
        assert imported <= {"torch", "math", "contextlib", "numpy"}, path


def test_a_dry_run_loads_no_jax():
    """A whole run of a cell on the CPU in a fresh process: it ends with its
    result line, which it prints only when no forbidden module is loaded."""
    code = ("import sys; from portbench.tests.helpers import small_run; "
            "small_run('relu_net_f64.lanes2048'); "
            "import portbench.run as r; "
            "print('loaded', r.forbidden_modules(), "
            "sorted(m for m in sys.modules if m.startswith('tramp')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-2])["correct"] is True
    assert lines[-1].startswith("loaded [] ")
    assert "'tramp_tpu_torch'" in lines[-1]
