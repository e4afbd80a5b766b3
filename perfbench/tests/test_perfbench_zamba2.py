"""The Zamba2 serve cell on the CPU: a tiny cell of the ``zamba2_serve``
driver (8 layers of width 64, two shared blocks over three hybrid ids,
batch 2 of 16 tokens, 4 steps) found by its files alone, traced and
untraced; faults in the timed path that read ``correct`` false; the
parent's refusal; the full-width plan under the cell's memory budget; and
the new rooflines' bounds and ``serve.mfu``'s operation count against
hand-reckoned values at one shape."""

import contextlib
import json
import pathlib
import shutil
import sys

import pytest
import torch

from perfbench import harness
from perfbench.rooflines import flash_attention, ssm_scan, zamba2_flops

ROOT = pathlib.Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "tiny.serve_sa"
SEED = 2**31 + 505


def _published():
    return {k: v for k, v in json.loads((ROOT / "perfbench" / "configs" / "zamba2_7b.json")
                                        .read_text()).items()}


def _tiny_config():
    return dict(_published(), hidden_size=64, attention_hidden_size=128, num_attention_heads=4,
                num_key_value_heads=4, attention_head_dim=32, ffn_hidden_size=128,
                vocab_size=256, mamba_d_state=16, mamba_headdim=16, n_mamba_heads=8,
                num_hidden_layers=8, hybrid_layer_ids=[1, 4, 6], adapter_rank=8)


def _tiny_cell():
    cell = json.loads((ROOT / "perfbench" / "workloads" / "zamba2_7b.serve_sa.json").read_text())
    cell.update(config="zamba2_tiny", batch=2, prompt_len=16, max_len=20, gen_len=4,
                hbm_budget_bytes=10**9, dataset={"seed": 5, "items": 2},
                limits={"conf_gap": 0.003, "logprob_regret": 0.1})
    return cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout-like folder with the tiny cell's data files, the metric
    readers, and a BENCHMARK.json that gives the cell every metric."""
    root = tmp_path_factory.mktemp("checkout")
    for sub, stem, data in (("configs", "zamba2_tiny", _tiny_config()),
                            ("workloads", CELL, _tiny_cell())):
        path = root / "perfbench" / sub / f"{stem}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copytree(ROOT / "perfbench" / "metrics", root / "perfbench" / "metrics")
    return root


def test_the_cell_runs_from_its_files_alone(root):
    result = harness.run_cell(root, CELL, SEED, 0.2, False, device=CPU)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % 8 == 0
    assert set(result["metrics"]) == {"sa_runs_per_s", "peak_device_gib", "setup_s"}
    assert set(result["checks"]) == {"conf_gap", "logprob_regret"}


def test_traced_run_reads_the_decode_spans(root):
    """On the CPU the device readers read nothing; the span readers read
    the window's synced task spans (the generate tasks' time a step, and
    the pathology cells' dispatch efficiency, which this cell does not
    list); the tile readers find no tile."""
    result = harness.run_cell(root, CELL, SEED + 1, 0.2, True, device=CPU)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"planner.tasks_per_run", "serve.decode_ms_per_step",
                                      "dispatch.efficiency"}
    assert result["metrics"]["serve.decode_ms_per_step"]["value"] > 0


def _patched(module, name, make):
    @contextlib.contextmanager
    def patch():
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        try:
            yield
        finally:
            setattr(module, name, orig)
    return patch


def _no_adapter(orig):
    def mlp(o, bp, up, cfg):
        return orig(o, bp, dict(up, adapter_b=torch.zeros_like(up["adapter_b"])), cfg)
    return mlp


def _hotter(orig):
    return lambda cfg, params, x_last: orig(cfg, params, x_last) * 1.5


@pytest.mark.parametrize("fault", ["adapter_dropped", "logits_scaled"])
def test_a_fault_reads_not_correct(root, fault):
    from repro_torch.models import zamba2

    patch = {"adapter_dropped": _patched(zamba2, "_mlp", _no_adapter),
             "logits_scaled": _patched(zamba2, "_logits", _hotter)}[fault]
    result = harness.run_cell(root, CELL, SEED, 0.0, False, device=CPU, patch=patch)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_control_reads_not_correct(root):
    cell, config, mod = harness.find_cell(root, CELL)
    driver = mod.Driver(config, cell, SEED, CPU)
    driver.setup()
    with driver.patch(None):
        driver.run_item(0)
    numbers = driver.check(control=True)["numbers"]
    limits = cell["limits"]
    assert all(numbers[k] <= v for k, v in limits.items())
    assert any(numbers["control_" + k] > v for k, v in limits.items())


def test_a_program_without_the_model_refuses_in_set_up(root, monkeypatch):
    """The parent commit's port has no ``configs.zamba2_7b``: set-up exits
    at once, before it draws a weight."""
    import repro_torch.configs

    cell, config, mod = harness.find_cell(root, CELL)
    monkeypatch.delattr(repro_torch.configs, "zamba2_7b", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.configs.zamba2_7b", None)
    with pytest.raises(SystemExit, match="no Zamba2 model"):
        mod.Driver(config, cell, SEED, CPU).setup()


def test_full_width_plan_holds_one_prompt_cache():
    """The cell's study at full width, planned without the model: RMSR keeps
    one active path under the 16 GiB budget (a prompt's cache is 12.1 GB),
    and runs 2 prefills, 4 generates and 8 scores."""
    from repro_torch.configs import zamba2_7b
    from repro_torch.core import Workflow, sa_serve
    from repro_torch.engine import ClusterSpec, MemoryBudget, plan_study

    cell = json.loads((ROOT / "perfbench" / "workloads" / "zamba2_7b.serve_sa.json").read_text())
    cfg = zamba2_7b.from_hf(_published())
    prompts = {p: torch.zeros((cell["batch"], cell["prompt_len"]), dtype=torch.int32).numpy()
               for p in range(cell["prompts_per_item"])}
    stage = sa_serve.build_serve_stage(cfg, {"embed": torch.empty(0, device="meta")}, prompts,
                                       gen_len=cell["gen_len"], max_len=cell["max_len"])
    assert stage.tasks[0].output_bytes == 12_095_877_120
    sets = [tuple(sorted({"prompt_id": p, "rep_penalty": rp, "top_k": cell["top_k"],
                          "threshold": th}.items()))
            for p in prompts for rp in cell["rep_penalty"] for th in cell["threshold"]]
    plan = plan_study(Workflow(stages=(stage,)), sets,
                      memory=MemoryBudget(bytes=cell["hbm_budget_bytes"]),
                      cluster=ClusterSpec(n_workers=cell["n_workers"]), policy=cell["policy"])
    assert (plan.tasks_total, plan.tasks_executed, plan.active_paths) == (24, 14, 1)
    assert plan.peak_bytes <= cell["hbm_budget_bytes"] < 2 * stage.tasks[0].output_bytes


def test_ssm_scan_bound_by_hand():
    # B 1, S 64, H 2, N 4, P 8: bytes 2·128·(8+4+4+8) + 4·128 + 4·2·32 = 6912;
    # operations 5·1·64·2·4·8 = 20480, over 67e12 (the larger)
    assert ssm_scan.bound_s(1, 64, 2, 4, 8) == pytest.approx(max(6912 / 3.35e12, 20480 / 67e12))
    # Zamba2-7B's prefill: 0.9816 ms of operations against 0.4990 ms of bytes
    assert ssm_scan.bound_s(8, 3584, 112, 64, 64) == pytest.approx(65_766_686_720 / 67e12)


def test_flash_attention_bound_by_hand():
    # B 1, S 4, H 1, D 16: 10 causal pairs, 4·16·10 = 640 operations; 512 bytes
    assert flash_attention.bound_s(1, 4, 1, 16) == pytest.approx(max(512 / 3.35e12,
                                                                     640 / 989.4e12))
    # Zamba2-7B's prefill: 8·3584·3585/2 pairs, 4·32·224 a pair: 1.490 ms
    assert flash_attention.bound_s(8, 3584, 32, 224) == pytest.approx(
        4 * 32 * 224 * 51_394_560 / 989.4e12)


def test_mfu_operation_count_by_hand():
    c = _published()
    # Mamba2 3584·(7168+7424+112) + 7168·3584 = 78,389,248 a layer; a use
    # 7168·3·7168 + 7168·3584 + 3584·28672 + 14336·3584 + 128·(3584+28672)
    # + 3584² = 350,945,280
    assert zamba2_flops.matmul_weights(c) == 81 * 78_389_248 + 13 * 350_945_280
    token = 2 * 10_911_817_728 + 81 * 5 * 112 * 64 * 64
    head = 2 * 3584 * 32000
    assert zamba2_flops.decode_flops(c, 8, 3600) == 8 * token + 8 * head + 13 * 4 * 32 * 224 * 8 * 3600
    assert zamba2_flops.prefill_flops(c, 2, 10) == (20 * token + 2 * head
                                                    + 13 * 4 * 32 * 224 * 2 * 55)


def _fake_trace(device, spans_profiled=(), cell=None):
    """A Trace whose profiled item spans 0..1000 ns."""
    return harness.Trace(cell or {"batch": 8, "prompt_len": 3584}, _published(), [], [(0, 1, 8)],
                         {}, 1, device, (0, 1000), [])


def test_roofline_readers_on_a_trace():
    from importlib import util

    def reader(name):
        spec = util.spec_from_file_location(name, ROOT / "perfbench" / "metrics" / f"{name}.py")
        mod = util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    bound = ssm_scan.bound_s(8, 3584, 112, 64, 64)
    ns = int(bound * 1e9)
    dev = [("void ssm_state_kernel<bf16>", 0, ns), ("ssm_carry_kernel", ns, ns + ns),
           ("void ssm_output_kernel<bf16>", 2 * ns, 4 * ns), ("gemm", 0, 10)]
    assert reader("ssm_scan_roofline")(_fake_trace(dev)) == pytest.approx(25.0, rel=1e-6)
    fb = int(flash_attention.bound_s(8, 3584, 32, 224) * 1e9)
    dev = [("flash_fwd_wgmma_kernel<14>", 0, 2 * fb)] * 3
    assert reader("flash_attention_roofline")(_fake_trace(dev)) == pytest.approx(50.0, rel=1e-6)
    for name in ("ssm_scan_roofline", "flash_attention_roofline", "serve.mfu",
                 "device.idle_in_decode"):
        assert reader(name)(_fake_trace([])) is None, name
