"""The Granite 4.0-H serve cell on the CPU: a tiny cell of the
``granite_serve`` driver (one period of 10 layers of width 64, 8 experts,
top 3, batch 2 of 16 Zipfian ids, 4 steps) found by its files alone, traced
and untraced; faults in the timed path that read ``correct`` false; the
control; the parent's refusal; the Zipf draw from its seed; the full-width
plan under the cell's memory budget; and the new readers' bounds and
operation counts against hand-reckoned values."""

import contextlib
import json
import pathlib
import shutil
import sys
from importlib import util

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.drivers import granite_serve
from perfbench.rooflines import granite_hybrid_flops, ssm_scan

ROOT = pathlib.Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "tiny.granite_serve_sa"
SEED = 2**31 + 707


def _published():
    return json.loads((ROOT / "perfbench" / "configs" / "granite_4_0_h_small.json").read_text())


def _cell():
    return json.loads((ROOT / "perfbench" / "workloads" / "granite4h_small.serve_sa.json")
                      .read_text())


def _tiny_config():
    pub = _published()
    return dict(pub, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                intermediate_size=32, shared_intermediate_size=64, vocab_size=256,
                mamba_d_state=16, mamba_d_head=16, mamba_n_heads=8, num_hidden_layers=10,
                layer_types=pub["layer_types"][:10], num_local_experts=8, num_experts_per_tok=3)


def _tiny_cell():
    return dict(_cell(), config="granite_tiny", batch=2, prompt_len=16, max_len=20, gen_len=4,
                hbm_budget_bytes=10**9, dataset=dict(_cell()["dataset"], seed=5, items=2),
                limits={"conf_gap": 0.0004, "logprob_regret": 0.03, "mean_logprob_regret": 0.002})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout-like folder with the tiny cell's data files, the metric
    readers, and a BENCHMARK.json that gives the cell every metric."""
    root = tmp_path_factory.mktemp("checkout")
    for sub, stem, data in (("configs", "granite_tiny", _tiny_config()),
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
    assert set(result["checks"]) == {"conf_gap", "logprob_regret", "mean_logprob_regret"}


def test_traced_run_reads_the_span_metrics(root):
    """On the CPU the device readers, and the readers of the port's spans
    in the profiled item, read nothing; the synced task spans' readers do."""
    result = harness.run_cell(root, CELL, SEED + 1, 0.2, True, device=CPU)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"planner.tasks_per_run", "serve.decode_ms_per_step",
                                      "dispatch.efficiency"}


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


def _no_shared(orig):
    def moe(x, params, *, k, dropless):
        return orig(x, dict(params, shared_down=torch.zeros_like(params["shared_down"])), k=k,
                    dropless=dropless)
    return moe


def _hotter(orig):
    return lambda cfg, params, x_last: orig(cfg, params, x_last) * 1.5


@pytest.mark.parametrize("fault", ["shared_expert_dropped", "logits_scaled"])
def test_a_fault_reads_not_correct(root, fault):
    from repro_torch.models import granite_hybrid, moe

    patch = {"shared_expert_dropped": _patched(moe, "moe_ffn_shared", _no_shared),
             "logits_scaled": _patched(granite_hybrid, "_logits", _hotter)}[fault]
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
    # the mean separates the two on its own
    assert numbers["control_mean_logprob_regret"] > limits["mean_logprob_regret"]


def test_the_mean_regret_reads_every_compared_position(root):
    """``mean_logprob_regret`` is the mean, over every position the check
    compares, of the reference's best log-probability less that of the
    program's token. The tiny program takes the reference's best token
    everywhere (0); with its last token of every row replaced by the
    reference's second best, the mean is those rows' top-two gaps over all
    the compared positions, and ``logprob_regret`` the largest gap."""
    cell, config, mod = harness.find_cell(root, CELL)
    driver = mod.Driver(config, cell, SEED, CPU)
    driver.setup()
    with driver.patch(None):
        driver.run_item(0)
    assert driver.check()["numbers"]["mean_logprob_regret"] == 0.0
    rec, gaps = driver.items[0], {}
    for rid, ps in enumerate(driver.sets):
        ps = dict(ps)
        prompt, ids = driver.dataset[rec["entry"]][ps["prompt_id"]], rec["ids"][rid]
        for b in range(ids.shape[0]):
            tokens = torch.cat([torch.from_numpy(prompt[b]).long(), ids[b, :-1]])
            # the last position's context and penalty leave out its own token
            top = driver._scored(tokens, ids[b], ps["rep_penalty"], "float32")[-1].topk(2)
            ids[b, -1] = top.indices[1]
            gaps[tuple(ids[b].tolist())] = float(top.values[0] - top.values[1])
    scored, compared = driver._scored, []

    def record(tokens, ids, rep_penalty, precision):
        compared.append(gaps[tuple(ids.tolist())])
        return scored(tokens, ids, rep_penalty, precision)

    driver._scored = record
    numbers = driver.check()["numbers"]
    assert len(compared) == cell["check"]["runs"] * cell["check"]["sequences"]
    assert numbers["mean_logprob_regret"] == pytest.approx(
        sum(compared) / (len(compared) * cell["gen_len"]), rel=1e-5)
    assert numbers["logprob_regret"] == pytest.approx(max(compared), rel=1e-5)


def test_a_program_without_the_model_refuses_in_set_up(root, monkeypatch):
    """The parent commit's port has no ``configs.granite_4_0_h_small``:
    set-up exits at once, before it draws a weight."""
    import repro_torch.configs

    cell, config, mod = harness.find_cell(root, CELL)
    monkeypatch.delattr(repro_torch.configs, "granite_4_0_h_small", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.configs.granite_4_0_h_small", None)
    with pytest.raises(SystemExit, match="no Granite 4.0-H model"):
        mod.Driver(config, cell, SEED, CPU).setup()


def test_the_zipf_draw_from_its_seed(root):
    """The dataset is the seed's: the same seed draws the same ids, another
    seed others. Rank r is drawn ∝ r^-1.1 over the vocab: the most frequent
    id of 100352 takes 1 / H(100352, 1.1) = 13.5% of the ids, and the
    ranks' counts fall as the law says."""
    vocab, exponent, shape = 100352, 1.1, (8, 4096)
    rng = np.random.default_rng([2147484031, 5])
    perm = rng.permutation(vocab)
    ids = granite_serve.zipf_ids(rng, vocab, exponent, perm, shape)
    rng2 = np.random.default_rng([2147484031, 5])
    assert np.array_equal(granite_serve.zipf_ids(rng2, vocab, exponent, rng2.permutation(vocab),
                                                 shape), ids)
    assert ids.dtype == np.int32 and ids.shape == shape
    harmonic = float((np.arange(1, vocab + 1, dtype=np.float64) ** -exponent).sum())
    assert harmonic == pytest.approx(7.4233, abs=1e-4)
    counts = np.bincount(ids.ravel(), minlength=vocab)
    n = ids.size
    for rank in (1, 2, 10):  # expected share 1 / (rank^1.1 · H), within 4 standard deviations
        share = rank ** -exponent / harmonic
        assert abs(counts[perm[rank - 1]] - n * share) < 4 * (n * share * (1 - share)) ** 0.5
    assert counts[perm[0]] == counts.max()
    other = np.random.default_rng([2147484032, 5])
    assert not np.array_equal(granite_serve.zipf_ids(other, vocab, exponent,
                                                     other.permutation(vocab), shape), ids)


def test_full_width_plan_holds_two_prompt_caches():
    """The cell's study at full width, planned without the model: a
    prompt's cache is 1.77 GB, so the 4 GiB budget holds two; the plan runs
    2 prefills, 4 generates and 8 scores."""
    from repro_torch.configs import granite_4_0_h_small
    from repro_torch.core import Workflow, sa_serve
    from repro_torch.engine import ClusterSpec, MemoryBudget, plan_study

    cell = _cell()
    cfg = granite_4_0_h_small.from_hf(_published())
    prompts = {p: np.zeros((cell["batch"], cell["prompt_len"]), dtype=np.int32)
               for p in range(cell["prompts_per_item"])}
    stage = sa_serve.build_serve_stage(cfg, {"embed": torch.empty(0, device="meta")}, prompts,
                                       gen_len=cell["gen_len"], max_len=cell["max_len"])
    assert stage.tasks[0].output_bytes == 1_767_817_216
    sets = [tuple(sorted({"prompt_id": p, "rep_penalty": rp, "top_k": cell["top_k"],
                          "threshold": th}.items()))
            for p in prompts for rp in cell["rep_penalty"] for th in cell["threshold"]]
    plan = plan_study(Workflow(stages=(stage,)), sets,
                      memory=MemoryBudget(bytes=cell["hbm_budget_bytes"]),
                      cluster=ClusterSpec(n_workers=cell["n_workers"]), policy=cell["policy"])
    assert (plan.tasks_total, plan.tasks_executed) == (24, 14)
    assert 2 * stage.tasks[0].output_bytes <= cell["hbm_budget_bytes"]
    assert plan.peak_bytes <= cell["hbm_budget_bytes"]


def test_operation_count_by_hand():
    c = _published()
    # Mamba2 4096·(8192+8192+256+128) + 8192·4096 = 102,236,160 a layer;
    # attention 2·4096·4096 + 2·4096·1024 = 41,943,040; MoE a layer: router
    # 4096·72, ten experts 10·3·4096·768, the shared 3·4096·1536 = 113,541,120
    assert granite_hybrid_flops.matmul_weights(c) == (36 * 102_236_160 + 4 * 41_943_040
                                                      + 40 * 113_541_120)
    token = 2 * 8_389_918_720 + 36 * 5 * 128 * 128 * 64
    assert token == 16_968_581_120
    head = 2 * 4096 * 100352
    assert granite_hybrid_flops.decode_flops(c, 8, 4100) == (8 * token + 8 * head
                                                             + 4 * 4 * 32 * 128 * 8 * 4100)
    assert granite_hybrid_flops.prefill_flops(c, 2, 10) == (20 * token + 2 * head
                                                            + 4 * 4 * 32 * 128 * 2 * 55)
    # the cell's prefill: 8 × 4096 tokens, 5.604e14 operations (0.566 s at the bf16 peak)
    assert granite_hybrid_flops.prefill_flops(c, 8, 4096) == 560_432_163_061_760


def test_ssm_scan_bound_at_the_published_state():
    # B 8, S 4096, H 128, N 128, P 64: 5·N·P operations a token and head,
    # 1.718e11 / 67e12 = 2.564 ms, against 3.27 GB of bytes (0.977 ms)
    ops = 5 * 8 * 4096 * 128 * 128 * 64
    nbytes = 2 * 8 * 4096 * 128 * (64 + 128 + 128 + 64) + 4 * 8 * 4096 * 128 + 4 * 8 * 128 * 128 * 64
    assert ssm_scan.bound_s(8, 4096, 128, 128, 64) == pytest.approx(ops / 67e12)
    assert nbytes / 3.35e12 < ops / 67e12


def _reader(name):
    spec = util.spec_from_file_location(name, ROOT / "perfbench" / "metrics" / f"{name}.py")
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _trace(device, profiled_spans=()):
    """A Trace of the cell whose profiled item spans 0..1000 ns."""
    return harness.Trace(_cell(), _published(), [], [(0, 1, 8)], {}, 1, device, (0, 1000),
                         list(profiled_spans))


def test_readers_on_a_trace(monkeypatch):
    from repro_torch import trace

    bound = ssm_scan.bound_s(8, 4096, 128, 128, 64)
    ns = int(bound * 1e9)
    dev = [("void ssm_state_kernel<bf16>", 0, ns), ("ssm_carry_kernel", ns, ns + ns),
           ("void ssm_output_kernel<bf16>", 2 * ns, 4 * ns), ("gemm", 0, 10)]
    assert _reader("granite.ssm_scan_roofline")(_trace(dev)) == pytest.approx(25.0, rel=1e-6)
    # the device busy 0..400 and 700..800 ns; prefill tasks open 100..500 and 600..900
    dev = [("k", 0, 400), ("k", 700, 800)]
    tasks = [("prefill", "serve task", 100, 500), ("prefill", "serve task", 600, 900),
             ("generate", "serve task", 0, 1000)]
    assert _reader("device.idle_in_prefill")(_trace(dev, tasks)) == pytest.approx(30.0)
    # two prefills of 40 layers, one sync each, read from the port's spans
    spans = []
    for start in (10, 500):
        sp = trace.Span("serve.prefill", "serve", None, {"tokens": 32768, "batch": 8})
        sp.start_ns = start
        spans.append(sp)
        for i in range(40):
            d = trace.Span("moe.dispatch", "moe", sp, {"pairs": 327680, "syncs": 1})
            d.start_ns = start + i
            spans.append(d)
    monkeypatch.setattr(trace, "records", lambda: spans)
    assert _reader("moe.syncs_per_prefill")(_trace(dev)) == 40.0
    ops = 2 * granite_hybrid_flops.prefill_flops(_published(), 8, 4096)
    from perfbench.rooflines.tensor_peaks import BF16_OPS_PER_S
    assert _reader("granite.serve.mfu")(_trace(dev)) == pytest.approx(
        100.0 * ops / (1e-6 * BF16_OPS_PER_S))
    for name in ("granite.ssm_scan_roofline", "device.idle_in_prefill", "moe.syncs_per_prefill",
                 "granite.serve.mfu"):
        assert _reader(name)(_trace([])) is None, name
