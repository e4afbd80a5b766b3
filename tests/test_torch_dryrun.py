"""The port's dry-run (``repro_torch.launch.dryrun``) and its cost model
(``repro_torch.launch.hlo_analysis``): the closed forms equal the JAX
package's, the roofline under the port's H100 figures, and dry-run cells on
fake worlds (a subprocess each: a fake process group lives for its
process), with per-rank parameter bytes equal to those JAX's layout
implies."""

import itertools
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest

from repro.configs import ARCH_IDS, SHAPES, get_config, reduced_config
from repro.dist import sharding as jsh
from repro.launch import hlo_analysis as jhlo
from repro.launch import inputs as jinputs
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import hlo_analysis as thlo

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the keys of the JAX package's records (repro/launch/dryrun.py run_cell)
RECORD_KEYS = {
    "arch", "shape", "mesh", "status", "n_chips", "lower_s", "compile_s", "bytes_per_device",
    "arg_bytes", "temp_bytes", "out_bytes", "collectives", "compute_s", "memory_s",
    "collective_s", "hlo_flops_per_chip", "hlo_bytes_per_chip", "collective_bytes_per_chip",
    "dominant", "roofline_fraction_compute", "analysis", "model_flops_global",
    "useful_flops_ratio",
}


@pytest.mark.parametrize("arch,shape_name", list(itertools.product(ARCH_IDS, list(SHAPES))))
def test_closed_forms_equal_jax(arch, shape_name):
    cfg, tcfg = get_config(arch), tget_config(arch)
    shape, tshape = SHAPES[shape_name], TSHAPES[shape_name]
    assert thlo.ssm_scan_costs(tcfg, tshape) == jhlo.ssm_scan_costs(cfg, shape)
    for n in (1, 256, 512):
        assert thlo.model_flops(tcfg, tshape, n) == jhlo.model_flops(cfg, shape, n)


def test_roofline_terms_under_the_h100_figures():
    hw = thlo.HW
    assert (hw["peak_flops"], hw["hbm_bw"], hw["ici_bw"]) == (989.4e12, 3.35e12, 450e9)
    assert "H100" in hw["name"]
    cost = {"flops": 3.0e14, "bytes accessed": 2.0e12}
    coll = thlo.collective_bytes([("all-reduce", 1e9), ("all-gather", 5e8), ("all-gather", 5e8)])
    assert coll["total"] == 2 * 1e9 + 1e9 and coll["n_all-gather"] == 2 and coll["ops"] == 3
    t = thlo.roofline_terms(cost, coll, 256)
    assert t["compute_s"] == 3.0e14 / 989.4e12
    assert t["memory_s"] == 2.0e12 / 3.35e12
    assert t["collective_s"] == 3e9 / 450e9
    assert t["dominant"] == "memory_s"
    assert t["roofline_fraction_compute"] == t["compute_s"] / t["memory_s"]


CELL = r"""
import json, sys
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.mesh import make_mesh_from_devices

arch, shape = sys.argv[1], sys.argv[2]
fake_world(8)
mesh = make_mesh_from_devices((4, 2), ("data", "model"), device_type="cpu")
rec = run_cell(arch, shape, False, cfg=reduced_config(get_config(arch)), mesh=mesh)
print(json.dumps(rec))
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}


@pytest.mark.parametrize("arch,shape_name", [("yi_6b", "train_4k"),
                                             ("granite_moe_1b_a400m", "prefill_32k"),
                                             ("zamba2_2p7b", "decode_32k")])
def test_reduced_cell_on_a_fake_4x2_world(arch, shape_name):
    proc = subprocess.run([sys.executable, "-c", CELL, arch, shape_name], capture_output=True,
                          text=True, timeout=120, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec.get("traceback")
    assert RECORD_KEYS <= set(rec)
    assert rec["n_chips"] == 8 and rec["analysis"] == "full-depth"
    assert rec["hlo_flops_per_chip"] > 0 and rec["temp_bytes"] > 0
    # the parameters' bytes on rank 0, as JAX's at-rest layout implies
    cfg = reduced_config(get_config(arch))
    ctx = jsh.make_ctx(jax.sharding.AbstractMesh((4, 2), ("data", "model")), mode="train")
    p = jinputs.params_specs(cfg)
    want = 0
    for leaf, sh in zip(jax.tree.leaves(p), jax.tree.leaves(jsh.param_shardings(p, ctx))):
        shape = [n // (4 if sh.spec[d:d + 1] == ("data",) else 1)
                 for d, n in enumerate(leaf.shape)]
        want += math.prod(shape) * leaf.dtype.itemsize
    assert rec["param_bytes"] == want


def test_cli_writes_the_records_and_resumes(tmp_path):
    out = tmp_path / "dryrun.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "rwkv6_1p6b",
           "--shape", "decode_32k", "--mesh", "single", "--out", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert RECORD_KEYS <= set(rec)
    # a cell already ok in --out is not run again
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=_env(), cwd=ROOT)
    assert proc.returncode == 0 and "..." not in proc.stdout
    assert "done: 1 ok, 0 skip, 0 fail" in proc.stdout
