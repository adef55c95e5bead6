"""The Mellum2 cell on the CPU: its driver at a tiny size against the plain
reference, its controls caught, its files found by name, its FLOP and
roofline arithmetic.

The tiny cell keeps the real cell's traffic, both kinds of layer, YaRN and
the driver; it cuts the model's widths, depth, experts, window and
vocabulary, the positions, the corpus, and runs the model in float32,
where the program reads ~1e-6 and every control 1e-3 or more
(``TINY_LIMITS``)."""
import dataclasses
import json

import pytest
import torch

from conftest import BENCH, REPO, make_copy
from portbench import mellum2_readings, mellum2_work, phi_readings, run

CELL = "mellum2-govreport.doc-b1-t32k-k10"
TINY = "tiny-mellum2.tiny-doc"
KINDS = ("sliding_attention",) * 3 + ("full_attention",)
TINY_ARCH = dict(n_layers=8, d_model=64, n_heads=8, n_kv_heads=2,
                 head_dim=16, moe_d_ff=32, vocab_size=256,
                 n_routed_experts=8, top_k=2, layer_types=KINDS * 2,
                 sliding_window=8, dtype="float32")
#: float32 at width 64: the program reads ~1e-6 (rel) and ~1e-12 (cos);
#: the controls 1e-3 and 1e-6 or more
TINY_LIMITS = {"phi_rel_err": 1e-4, "phi_cos_gap": 1e-8,
               "moe_routed_err": 1e-4, "attn_window_err": 1e-4}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(root, bench dir) of a copy holding the tiny Mellum2 cell."""
    torch.set_num_threads(2)
    dst = tmp_path_factory.mktemp("mellum2")
    bench = make_copy(dst)
    cfg = json.loads((bench / "configs" / "mellum2-govreport.json")
                     .read_text())
    cfg.update(num_hidden_layers=8, hidden_size=64, num_attention_heads=8,
               num_key_value_heads=2, head_dim=16, moe_intermediate_size=32,
               vocab_size=256, num_experts=8, num_experts_per_tok=2,
               sliding_window=8, layer_types=list(KINDS * 2),
               mlp_layer_types=["sparse"] * 8, corpus_reports=3000,
               torch_dtype="float32", arch="tiny-mellum2")
    cfg["phi"]["max_tokens"] = 40
    cfg["index"]["vectors_per_bucket"] = 400
    (bench / "configs" / "tiny-mellum2.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "doc-b1-t32k-k10.json")
                    .read_text())
    tr.update(text_bytes=[20, 60], warmup_seconds=0.0, check_batches=3)
    (bench / "traffic" / "tiny-doc.json").write_text(json.dumps(tr))
    limits = json.loads((bench / "limits" / f"{CELL}.json").read_text())
    limits.update(TINY_LIMITS)
    (bench / "limits" / f"{TINY}.json").write_text(json.dumps(limits))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": TINY, "config": "tiny-mellum2",
                              "traffic": "tiny-doc", "chips": 1,
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
    full = real("mellum2-12b-a2.5b")
    arch = dataclasses.replace(full, name="tiny-mellum2", model=dataclasses
                               .replace(full.model, **TINY_ARCH))
    monkeypatch.setattr(configs, "get_arch",
                        lambda n: arch if n == "tiny-mellum2" else real(n))


def _run(tiny, trace=False, seed=2**31 + 9):
    root, bench = tiny
    return run.run_cell(TINY, seed, 0.5, trace, "cpu", root=root,
                        bench_dir=bench)


def test_tiny_cell_agrees_with_the_reference(tiny, tiny_arch):
    res = _run(tiny)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["check"]["moe_dropped_pairs"]["value"] == 0
    for name in TINY_LIMITS:
        assert res["check"][name]["value"] < 1e-5, name
    assert set(res["metrics"]) == {"knn_qps", "batch_p95_ms", "setup_s"}


def test_tiny_cell_traced(tiny, tiny_arch):
    """On the CPU no device metric is read (the attention rooflines read
    device time); ``mfu`` (host clock) and the index's rows scanned (its
    counter) are."""
    res = _run(tiny, trace=True)
    assert res["correct"], res["check"]
    assert {"mfu", "rows_scanned_per_query"} == set(res["metrics"])
    assert res["metrics"]["rows_scanned_per_query"]["value"] == 3000


@pytest.mark.parametrize("who", ["fp8_routed", "fp8_attention",
                                 "sliding_full", "window_960", "plain_rope"])
def test_control_is_caught(tiny, tiny_arch, who):
    controls = {**phi_readings.CONTROLS, **mellum2_readings.CONTROLS}
    with controls[who]():
        res = _run(tiny, seed=515151)
    assert not res["correct"], res["check"]
    over = {n for n, r in res["check"].items() if r["value"] > r["limit"]}
    assert over & set(TINY_LIMITS), over
    # each control's own number sees it
    assert ("moe_routed_err" if who == "fp8_routed"
            else "attn_window_err") in over, over


def test_the_benchmark_draws_the_weights(tiny, tiny_arch):
    """The program's model holds what ``mellum2_weights`` draws from the
    seed; a second draw gives the same values, another seed others."""
    import repro_torch.configs as configs
    from portbench import mellum2_weights
    from repro_torch.models.transformer import LM

    cfg = json.loads((tiny[1] / "configs" / "tiny-mellum2.json")
                     .read_text())
    lm = LM(configs.get_arch("tiny-mellum2").model, device="cpu")
    mellum2_weights.load(cfg, 11, lm)
    assert torch.equal(lm.lm_head, mellum2_weights.top(cfg, 11,
                                                       "cpu")["lm_head"])
    drawn = mellum2_weights.layer(cfg, 11, 5, "cpu")
    assert set(drawn) == set(lm.moe_layers.keys())
    for name, t in drawn.items():
        assert torch.equal(lm.moe_layers[name][5], t), name
    assert not torch.equal(mellum2_weights.layer(cfg, 12, 5, "cpu")["wq"],
                           drawn["wq"])


def test_a_model_other_than_the_configuration_s_fails(tiny, monkeypatch):
    import repro_torch.configs as configs
    real = configs.get_arch
    full = real("mellum2-12b-a2.5b")
    arch = dataclasses.replace(full, model=dataclasses.replace(
        full.model, **dict(TINY_ARCH, sliding_window=16)))
    monkeypatch.setattr(configs, "get_arch", lambda n: arch)
    with pytest.raises(ValueError, match="sliding_window"):
        _run(tiny)


def test_the_cell_s_files_are_found_by_name():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    traced = [m["name"] for m in run.cell_metrics(spec, CELL, True)]
    assert {"mfu", "phi_device_ms_per_batch", "phi_host_idle_share",
            "device_ms_per_batch", "device_idle_share",
            "index_host_idle_share", "rows_scanned_per_query",
            "probe_signatures_per_batch", "host_copy_bytes_per_query",
            "swa_roofline_share", "full_attn_roofline_share"} == set(traced)
    assert [m["name"] for m in run.cell_metrics(spec, CELL, False)] == [
        "knn_qps", "batch_p95_ms", "device_peak_gb", "setup_s"]
    for name in traced:
        assert (BENCH / "metrics" / f"{name}.py").exists(), name
    cs = run.cell_spec(CELL)
    assert cs["traffic"]["driver"] == "phi_doc_search"
    assert cs["config"]["reduced"] == [] and cs["config"]["assumed"]
    assert set(cs["limits"]) >= set(TINY_LIMITS) | {"moe_dropped_pairs",
                                                    "rank_gap"}


def test_the_configuration_holds_the_catalog_s_numbers():
    """Every key of the published config.json, as published."""
    cfg = json.loads((BENCH / "configs" / "mellum2-govreport.json")
                     .read_text())
    assert (cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"], cfg["num_experts"], cfg["num_experts_per_tok"],
            cfg["moe_intermediate_size"], cfg["sliding_window"],
            cfg["vocab_size"]) == (28, 2304, 32, 4, 128, 64, 8, 896, 1024,
                                   98304)
    assert cfg["layer_types"] == list(KINDS * 7)
    full = cfg["rope_parameters"]["full_attention"]
    assert (full["rope_type"], full["factor"],
            full["original_max_position_embeddings"]) == ("yarn", 16, 8192)


#: the flash kernels' names as the H100's trace of the cell holds them
FLASH = "void (anonymous namespace)::flash_fwd_wgmma<128, 128, false, {}>" \
    "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, " \
    "float*, float*, int, int, int, int, float, int, int)"


def test_roofline_readers():
    """Least time a batch over the kind's kernels' device time a batch (each
    kernel's mean time x its launches a batch); None where the trace holds
    no such kernel (a parent without the window instantiation)."""
    from portbench.drivers import phi_doc_search
    kernels = [(FLASH.format("true"), 84, 0.1232), (FLASH.format("false"),
                                                    28, 0.5180),
               ("void (anonymous namespace)::flash_fwd<128, 128, true>(...)",
                4, 0.0), ("nvjet_tst_192x192", 400, 0.3),
               ("void (anonymous namespace)::flash_fwd_wgmma<128, 128, "
                "false>(...)", 4, 0.0)]
    found = phi_doc_search.attn_kernels(kernels)
    assert found == {"window": [FLASH.format("true"), kernels[2][0]],
                     "full": [FLASH.format("false")]}
    obs = {"trace": {"batches": 4, "kernels": kernels,
                     "attn_kernels": found},
           "attn_least_s": {"window": 0.0115, "full": 0.0623}}
    for name, want in (("swa_roofline_share", 0.0115 / (0.1232 / 4)),
                       ("full_attn_roofline_share", 0.0623 / (0.5180 / 4))):
        reader = run.load_file(BENCH / "metrics" / f"{name}.py", name)
        assert reader.read(obs) == pytest.approx(100 * want)
        empty = dict(obs["trace"], attn_kernels={"window": [], "full": []})
        assert reader.read(dict(obs, trace=empty)) is None
        assert reader.read(dict(obs, trace=dict(
            obs["trace"], attn_kernels=None))) is None
        assert reader.read(dict(obs, trace=None)) is None


def test_least_times_at_the_cell_s_shape():
    """A window launch: 1,024-key band x 32 heads x 512 FLOPs a pair at 989
    TFLOP/s (bytes take 0.18 ms of it); a full launch the causal half."""
    cfg = json.loads((BENCH / "configs" / "mellum2-govreport.json")
                     .read_text())
    band = 1024 * 1025 // 2 + (32768 - 1024) * 1024
    assert mellum2_work.attn_least_s(cfg, "window", 1, 32768) == \
        pytest.approx(21 * band * 32 * 512 / 989e12)
    assert mellum2_work.attn_least_s(cfg, "full", 1, 32768) == \
        pytest.approx(7 * 32768 * 32769 / 2 * 32 * 512 / 989e12)
