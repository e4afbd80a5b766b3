"""No module of the benchmark imports JAX, the JAX package or the old
benchmarks, and the reference imports nothing of the program either.
Names compare whole, by their part before the first dot: ``repro_torch``
is not ``repro``."""

import ast
import pathlib
import subprocess
import sys

import pytest

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: pathlib.Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PERFBENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_forbidden_import(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})


def test_whole_names():
    assert "repro_torch" not in FORBIDDEN and "repro_torch".split(".")[0] != "repro"


def test_a_run_loads_no_forbidden_module():
    """Import what a run imports, in a fresh process, and read sys.modules."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from perfbench import harness\n"
            "from perfbench.drivers import pathology_dataset\n"
            "import repro_torch.app.pipeline\n"
            "print(harness.forbidden_modules())") % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
