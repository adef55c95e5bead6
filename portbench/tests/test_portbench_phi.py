"""The φ cell on the CPU: its driver at a tiny size against the reference's
copy, its planted faults and controls caught, its files found by name,
its FLOP arithmetic.

The tiny cell keeps the real cell's traffic, every kind of layer and the
driver; it cuts the model's widths, depth, experts and vocabulary, the
corpus and the batch, and runs the model in float32, where the φ limits
the real cell sets from bf16 readings at full width would not separate
the program from an fp8 cast of its experts at width 64: here the
program reads ~1e-6 and the faults 1e-3 or more (``TINY_LIMITS``)."""
import dataclasses
import json
import shutil

import pytest
import torch

from conftest import BENCH, REPO, make_copy
from portbench import phi_readings, phi_work, run

CELL = "dsv2lite-msmarco1m.phi-q256-t64-k10"
TINY = "tiny-dsv2.tiny-phi"
TINY_ARCH = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
                 moe_d_ff=32, vocab_size=256, n_routed_experts=8, top_k=2,
                 kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                 v_head_dim=16, dtype="float32")
#: float32 at width 64: the program reads ~1e-6 (rel) and ~1e-12 (cos);
#: the faults and controls 1e-3 and 1e-6 or more
TINY_LIMITS = {"phi_rel_err": 1e-4, "phi_cos_gap": 1e-8,
               "moe_routed_err": 1e-4}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(root, bench dir) of a copy holding the tiny φ cell."""
    torch.set_num_threads(2)
    dst = tmp_path_factory.mktemp("phi")
    bench = make_copy(dst)
    cfg = json.loads((bench / "configs"
                      / "dsv2lite-msmarco1m.json").read_text())
    cfg.update(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=4, intermediate_size=96,
               moe_intermediate_size=32, vocab_size=256, n_routed_experts=8,
               num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=16, v_head_dim=16, corpus_passages=3000,
               torch_dtype="float32", arch="tiny-dsv2")
    cfg["index"]["vectors_per_bucket"] = 400
    (bench / "configs" / "tiny-dsv2.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "phi-q256-t64-k10.json")
                    .read_text())
    tr.update(batch=16, warmup_seconds=0.0, check_batches=2)
    (bench / "traffic" / "tiny-phi.json").write_text(json.dumps(tr))
    limits = json.loads((bench / "limits" / f"{CELL}.json").read_text())
    limits.update(TINY_LIMITS)
    (bench / "limits" / f"{TINY}.json").write_text(json.dumps(limits))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": TINY, "config": "tiny-dsv2",
                              "traffic": "tiny-phi", "chips": 1,
                              "why": f"{CELL} cut for the CPU"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst, bench


@pytest.fixture
def tiny_arch(monkeypatch):
    import repro_torch.configs as configs
    real = configs.get_arch
    full = real("deepseek-v2-lite")
    arch = dataclasses.replace(full, name="tiny-dsv2", model=dataclasses
                               .replace(full.model, **TINY_ARCH))
    monkeypatch.setattr(configs, "get_arch",
                        lambda n: arch if n == "tiny-dsv2" else real(n))


def _run(tiny, trace=False, seed=2**31 + 5):
    root, bench = tiny
    return run.run_cell(TINY, seed, 0.5, trace, "cpu", root=root,
                        bench_dir=bench)


def test_tiny_cell_agrees_with_the_reference(tiny, tiny_arch):
    res = _run(tiny)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["check"]["moe_dropped_pairs"]["value"] == 0
    assert res["check"]["phi_rel_err"]["value"] < 1e-5
    assert set(res["metrics"]) == {"knn_qps", "batch_p95_ms", "setup_s"}


def test_tiny_cell_traced(tiny, tiny_arch):
    """On the CPU no device metric is read; ``mfu`` (host clock) and the
    index's rows scanned (its counter) are."""
    res = _run(tiny, trace=True)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"mfu", "rows_scanned_per_query"}
    # nprobe 8 of the tiny index's 8 buckets: every row
    assert res["metrics"]["rows_scanned_per_query"]["value"] == 3000
    assert 0 < res["metrics"]["mfu"]["value"] < 100


@pytest.mark.parametrize("who", sorted(phi_readings.CONTROLS))
def test_control_or_fault_is_caught(tiny, tiny_arch, who):
    with phi_readings.CONTROLS[who]():
        res = _run(tiny, seed=424242)
    assert not res["correct"], res["check"]
    over = {n for n, r in res["check"].items() if r["value"] > r["limit"]}
    assert over & {"phi_rel_err", "phi_cos_gap", "moe_routed_err",
                   "moe_dropped_pairs"}, over
    if who == "capacity_1.25":
        assert "moe_dropped_pairs" in over
    else:
        # the routed experts' own number sees each change to them
        assert "moe_routed_err" in over


def test_the_benchmark_draws_the_weights(tiny, tiny_arch):
    """The program's model holds what ``phi_weights`` draws from the seed,
    and a second draw gives the same values; a layout other than the
    reference's raises."""
    import repro_torch.configs as configs
    from portbench import phi_weights
    from repro_torch.models.transformer import LM

    cfg = json.loads((tiny[1] / "configs" / "tiny-dsv2.json").read_text())
    lm = LM(configs.get_arch("tiny-dsv2").model, device="cpu")
    phi_weights.load(cfg, 11, lm)
    top = phi_weights.top(cfg, 11, "cpu")
    assert torch.equal(lm.lm_head, top["lm_head"])
    for i in (0, 2):
        stack, j = (lm.layers, 0) if i == 0 else (lm.moe_layers, 1)
        drawn = phi_weights.layer(cfg, 11, i, "cpu")
        assert set(drawn) == set(stack.keys())
        for name, t in drawn.items():
            assert torch.equal(stack[name][j], t), (i, name)
    assert not torch.equal(phi_weights.layer(cfg, 12, 2, "cpu")["router"],
                           drawn["router"])
    # the router's logits on a normalised token: standard deviation 3
    assert drawn["router"].std().item() * 64 ** 0.5 == pytest.approx(
        phi_weights.ROUTER_STD, rel=0.1)
    with pytest.raises(ValueError, match="holds"):
        phi_weights.load(dict(cfg, n_shared_experts=0), 11, lm)


def test_a_model_other_than_the_configuration_s_fails(tiny, monkeypatch):
    """The driver runs the configuration's model or none: a config field
    that differs from the file raises before any work."""
    import repro_torch.configs as configs
    real = configs.get_arch
    full = real("deepseek-v2-lite")
    arch = dataclasses.replace(full, model=dataclasses.replace(
        full.model, **dict(TINY_ARCH, top_k=3)))
    monkeypatch.setattr(configs, "get_arch", lambda n: arch)
    with pytest.raises(ValueError, match="num_experts_per_tok"):
        _run(tiny)


def test_the_cell_s_files_are_found_by_name():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    traced = [m["name"] for m in run.cell_metrics(spec, CELL, True)]
    assert {"mfu", "phi_device_ms_per_batch", "phi_host_idle_share",
            "device_ms_per_batch", "device_idle_share",
            "index_host_idle_share", "rows_scanned_per_query",
            "probe_signatures_per_batch",
            "host_copy_bytes_per_query"} == set(traced)
    assert [m["name"] for m in run.cell_metrics(spec, CELL, False)] == [
        "knn_qps", "batch_p95_ms", "device_peak_gb", "setup_s"]
    for name in traced:
        assert (BENCH / "metrics" / f"{name}.py").exists(), name
    cs = run.cell_spec(CELL)
    assert cs["traffic"]["driver"] == "phi_search"
    assert (BENCH / "drivers" / "phi_search.py").exists()
    assert set(cs["limits"]) >= {"phi_rel_err", "phi_cos_gap",
                                 "moe_routed_err", "moe_dropped_pairs",
                                 "rank_gap"}


def test_the_reference_s_copy_is_the_program_s_file():
    """The benchmark judges with its own copy, which is the plain
    reference the tests hold the port to."""
    copy = (BENCH / "deepseek_v2_ref.py").read_bytes()
    assert copy == (REPO / "src" / "repro_torch" / "models"
                    / "deepseek_v2_ref.py").read_bytes()


def test_phi_flops_at_the_published_widths():
    """One φ call of 256 texts x 64 tokens: 4.91 GFLOP a token, 80.47
    TFLOP a call; by hand from the published widths."""
    cfg = json.loads((BENCH / "configs" / "dsv2lite-msmarco1m.json")
                     .read_text())
    d, s = 2048, 64
    proj = d * 16 * 192 + d * 576 + 512 * 16 * 256 + 16 * 128 * d
    attn = 16 * (192 + 128) * s / 2
    moe = d * 64 + (6 + 2) * 3 * d * 1408
    want = 2 * (27 * (proj + attn) + 3 * d * 10944 + 26 * moe
                + d * 102400)
    assert phi_work.token_flops(cfg, s) == want
    assert phi_work.call_flops(cfg, 256, s) == pytest.approx(80.4694e12,
                                                             rel=1e-5)


def test_no_card_no_result_for_the_phi_cell(tmp_path):
    import subprocess
    import sys
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
