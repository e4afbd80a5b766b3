"""``repro_torch``, ``chip_smoke.py`` and ``tools/`` stand alone: no jax, nothing of
``repro``; and the copied runtime keeps its lock-guard discipline."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_repro_imports(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch.app, repro_torch.engine, repro_torch.runtime\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.core.sa_serve\n"
        "import repro_torch.kernels.ssm_scan, repro_torch.runtime.tensors\n"
        "import repro_torch.kernels.flash_attention, repro_torch.models.attention\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.study, repro_torch.runtime.objstore\n"
        "import repro_torch.runtime.net, repro_torch.runtime.simulator\n"
        "import repro_torch.service, repro_torch.service.__main__\n"
        "from repro_torch.service import StudyServer, StudySpec, ServiceClient\n"
        "from repro_torch.app import TABLE1_SPACE\n"
        "StudySpec(sampler='moat', n_trajectories=1).resolve(TABLE1_SPACE)  # the lazy import\n"
        "from repro_torch.app import run_dataset_study, run_adaptive_study, run_fleet_study\n"
        "from repro_torch.app.pipeline import pathology_service_build\n"
        "import repro_torch.optim, repro_torch.optim.grad_compression, repro_torch.checkpoint\n"
        "import repro_torch.data, repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.tree\n"
        "from repro_torch.models import forward_train\n"
        "from repro_torch.models.layers import cross_entropy\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_static_analysis_strict_on_port():
    proc = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "--strict", str(PORT)],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
