"""DeepSeek-V2-Lite in the port against its plain float32 reference
(``models/deepseek_v2_ref.py``), on the CPU at a small size that keeps
every kind of part: a dense layer 0, two MoE layers, MLA without q-LoRA,
YaRN RoPE with DeepSeek's pairing, 8 routed experts top-2 with 2 shared,
the gate unnormalised, dropless routing.  Also: YaRN's numbers at the
published widths, dropless routing against capacity routing on
padding-heavy rows, the φ service's spans and counters, and every other
arch leaving the port's new config fields off."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import (AIPMConfig, ASSIGNED, PandaDBConfig,
                                 arch_names, get_arch)
from repro_torch.core import PandaDB
from repro_torch.core.aipm import model_embedding_extractor
from repro_torch.models import deepseek_v2_ref as ref
from repro_torch.models import layers, moe
from repro_torch.models.transformer import LM
from repro_torch.obs.trace import phases

torch.set_num_threads(1)

FULL = get_arch("deepseek-v2-lite").model
SMALL = dataclasses.replace(
    FULL, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    moe_d_ff=32, vocab_size=256, n_routed_experts=8, top_k=2,
    n_shared_experts=2, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=16, v_head_dim=16, dtype="float32")


def hf_config(cfg) -> dict:
    """``cfg`` under the published config.json's keys, as the reference
    reads them."""
    y = cfg.yarn
    return {"num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "intermediate_size": cfg.d_ff,
            "moe_intermediate_size": cfg.moe_d_ff,
            "vocab_size": cfg.vocab_size,
            "n_routed_experts": cfg.n_routed_experts,
            "n_shared_experts": cfg.n_shared_experts,
            "num_experts_per_tok": cfg.top_k,
            "first_k_dense_replace": cfg.first_dense_layers,
            "kv_lora_rank": cfg.kv_lora_rank, "q_lora_rank": None,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_eps,
            "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": 1,
            "rope_scaling": {
                "type": "yarn", "factor": y.factor,
                "original_max_position_embeddings": y.original_max_position,
                "beta_fast": y.beta_fast, "beta_slow": y.beta_slow,
                "mscale": y.mscale, "mscale_all_dim": y.mscale_all_dim}}


def weights(lm: LM):
    """(top, layer) as the reference takes them: the model's own tensors."""
    def layer(i):
        stack, j = (lm.layers, i) if i < lm.n_dense else (
            lm.moe_layers, i - lm.n_dense)
        return {name: p[j] for name, p in stack.items()}
    return {"embed": lm.embed, "final_norm": lm.final_norm,
            "lm_head": lm.lm_head}, layer


def small_lm(cfg=SMALL, seed=3) -> LM:
    return LM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def texts(seed, n, lo=4, hi=24):
    """Lowercase texts, most shorter than the 24 positions: padding-heavy
    rows."""
    rng = np.random.default_rng(seed)
    return [rng.integers(97, 123, int(rng.integers(lo, hi + 1)),
                         dtype=np.uint8) for _ in range(n)]


# ---------------------------------------------------------------------------
# YaRN at the published widths
# ---------------------------------------------------------------------------


def test_yarn_at_the_published_widths():
    """low / high and the softmax scale of DeepSeek-V2-Lite's YaRN: 10, 23
    and 192^-1/2 m(40, 0.707)^2 = 0.114721; the port's frequencies are the
    reference's."""
    y, dr = FULL.yarn, FULL.qk_rope_head_dim
    assert layers.yarn_range(y, dr, FULL.rope_theta) == (10, 23)
    assert ref.yarn_range(hf_config(FULL)) == (10, 23)
    scale = layers.yarn_softmax_scale(y, FULL.qk_nope_head_dim + dr)
    assert scale == pytest.approx(0.114721, abs=5e-7)
    assert ref.softmax_scale(hf_config(FULL)) == pytest.approx(scale,
                                                               rel=1e-12)
    # float32 on both sides, f_inter written two ways: a rounding apart
    torch.testing.assert_close(layers.yarn_inv_freq(y, dr, FULL.rope_theta),
                               ref.inv_freq(hf_config(FULL)), rtol=1e-6,
                               atol=0)
    cos, sin = layers.rotary_cos_sin(torch.arange(64), dr, FULL.rope_theta,
                                     yarn=y)
    rcos, rsin = ref.cos_sin(hf_config(FULL), 64, "cpu")
    # the reference repeats each frequency for the pair's second half;
    # m(mscale) / m(mscale_all_dim) = 1 scales both
    assert torch.allclose(cos, rcos[:, :dr // 2], atol=1e-6)
    assert torch.allclose(sin, rsin[:, :dr // 2], atol=1e-6)


def test_published_widths():
    c = FULL
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff, c.moe_d_ff,
            c.vocab_size, c.n_routed_experts, c.n_shared_experts, c.top_k,
            c.first_dense_layers, c.kv_lora_rank, c.q_lora_rank,
            c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
            c.rms_eps, c.tie_embeddings) == (
        27, 2048, 16, 10944, 1408, 102400, 64, 2, 6, 1, 512, 0, 128, 64,
        128, 1e-6, False)
    assert not c.norm_topk_prob
    assert c.dropless and c.dtype == "bfloat16"
    assert 15.6e9 < c.param_count() < 15.8e9
    # ~2.45 B active a token, the embedding's lookup aside
    assert 2.4e9 < c.active_param_count() - c.vocab_size * c.d_model < 2.5e9


# ---------------------------------------------------------------------------
# port against reference
# ---------------------------------------------------------------------------


def test_logits_match_the_reference():
    """Float32 on both sides, the same products grouped and summed in
    another order (grouped experts, heads fused into one product): ~1e-6
    of logits of order 3, so 1e-4 leaves room and catches any term left
    out."""
    lm = small_lm()
    top, layer = weights(lm)
    tokens = torch.randint(0, 256, (5, 24),
                           generator=torch.Generator().manual_seed(1))
    tokens[:, 10:] = 0
    got, _ = lm.forward(tokens)
    with torch.no_grad():
        want = ref.logits(hf_config(SMALL), tokens, top, layer)
    assert want.abs().max() > 1.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_the_full_forward():
    """MLA's absorbed decode through the cache, with YaRN's pairing,
    against the reference's full forward: float32, tolerance as above."""
    lm = small_lm()
    top, layer = weights(lm)
    tokens = torch.randint(1, 256, (3, 12),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = ref.logits(hf_config(SMALL), tokens, top, layer)
    last, cache = lm.prefill(tokens[:, :10])
    torch.testing.assert_close(last, want[:, 9], rtol=1e-4, atol=1e-4)
    full = lm.init_cache(3, 12)
    for key in cache:
        for dst, src in zip(full[key], cache[key]):
            dst[:, :, :10] = src
    for pos in (10, 11):
        step, full = lm.decode_step(full, tokens[:, pos:pos + 1],
                                    torch.full((3,), pos))
        torch.testing.assert_close(step, want[:, pos], rtol=1e-4,
                                   atol=1e-4)


def test_phi_matches_the_reference():
    """φ through the extractor (bytes to tokens, the forward, the mean over
    positions, the cut) against the reference's φ, before and after the
    normalisation; float32, tolerance as above."""
    lm = small_lm()
    top, layer = weights(lm)
    fn = model_embedding_extractor(lm, 16, max_tokens=24)
    raws = texts(5, 6)
    with torch.no_grad():
        want = ref.phi(hf_config(SMALL), ref.text_tokens(raws, 256, 24), top,
                       layer, 16).numpy()
    got = fn.raw(raws)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    unit = want / np.linalg.norm(want, axis=1, keepdims=True)
    # fn normalises what fn.raw gives: a caller's wrapper sees it
    kept, inner = [], fn.raw
    fn.raw = lambda r: kept.append(inner(r)) or kept[-1]
    vecs = fn(raws)
    np.testing.assert_allclose(vecs, unit, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        vecs, kept[0] / np.linalg.norm(kept[0], axis=1, keepdims=True))


def test_routed_experts_match_the_reference_layer_by_layer():
    """The reference's ``tap`` sees each MoE layer's input once; on it the
    program's routed experts (``moe_ffn`` with the shared ones left out)
    give the reference's routed sum: float32, ~1e-7 of it."""
    lm = small_lm()
    top, layer = weights(lm)
    cfg = hf_config(SMALL)
    seen = []

    def tap(i, h, w):
        want = ref.moe(dict(cfg, n_shared_experts=0), h, w)
        flat = {n: p[i - lm.n_dense] for n, p in lm.moe_layers.items()
                if not n.startswith("shared_")}
        got, _ = moe.moe_ffn(moe.nest_moe_params(flat), h,
                             dataclasses.replace(SMALL, n_shared_experts=0))
        seen.append((i, float((got - want).norm() / want.norm())))

    tokens = ref.text_tokens(texts(3, 4), 256, 24)
    with torch.no_grad():
        plain = ref.phi(cfg, tokens, top, layer, 16)
        tapped = ref.phi(cfg, tokens, top, layer, 16, tap)
    assert torch.equal(plain, tapped)
    assert [i for i, _ in seen] == list(range(SMALL.first_dense_layers,
                                              SMALL.n_layers))
    assert max(e for _, e in seen) < 1e-5, seen


def _dropped() -> int:
    return moe.METRICS.counter("moe.dropped_pairs").value


def test_dropless_drops_nothing_where_capacity_does():
    """On padding-heavy rows (token 0 at most positions routes alike),
    dropless routing drops 0 pairs and matches the reference; capacity
    routing at 1.25 drops pairs and misses it by far more than the
    tolerance."""
    raws = texts(7, 8, lo=2, hi=6)
    lm = small_lm()
    top, layer = weights(lm)
    with torch.no_grad():
        want = ref.phi(hf_config(SMALL), ref.text_tokens(raws, 256, 24), top,
                       layer, 16).numpy()
    d0 = _dropped()
    got = model_embedding_extractor(lm, 16, max_tokens=24).raw(raws)
    assert _dropped() == d0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    capped = small_lm(dataclasses.replace(SMALL, dropless=False,
                                          capacity_factor=1.25))
    bad = model_embedding_extractor(capped, 16, max_tokens=24).raw(raws)
    assert _dropped() > d0
    err = np.linalg.norm(bad - want, axis=1) / np.linalg.norm(want, axis=1)
    assert err.max() > 1e-2, err


def test_dropless_is_capacity_routing_that_drops_nothing():
    """With room for every pair, the grouped dropless experts and the
    capacity dispatch give the same output and aux loss."""
    cfg = dataclasses.replace(SMALL, capacity_factor=16.0)
    g = torch.Generator().manual_seed(4)
    params = moe.init_moe_params(cfg, torch.float32, torch.device("cpu"), g)
    x = torch.randn(3, 10, cfg.d_model, generator=g)
    a, aux_a = moe.moe_ffn(params, x, cfg)
    b, aux_b = moe.moe_ffn(params, x, dataclasses.replace(cfg,
                                                          dropless=False))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux_a, aux_b)


def test_gate_options():
    probs = torch.softmax(torch.randn(4, 5, 8, generator=torch.Generator()
                                      .manual_seed(5)), dim=-1)
    renorm, idx = moe._gate(probs, dataclasses.replace(
        SMALL, norm_topk_prob=True))
    raw, idx2 = moe._gate(probs, SMALL)
    assert torch.equal(idx, idx2)
    assert torch.equal(raw, torch.gather(probs, -1, idx))
    torch.testing.assert_close(renorm, raw / raw.sum(-1, keepdim=True))


def test_grouped_mm_is_a_product_an_expert():
    g = torch.Generator().manual_seed(6)
    # rows of 16-byte multiples, as the grouped product asks
    x, w = torch.randn(11, 8, generator=g), torch.randn(4, 8, 8, generator=g)
    ends = torch.tensor([3, 3, 9, 11], dtype=torch.int32)
    want = torch.cat([x[0:3] @ w[0], x[3:9] @ w[2], x[9:11] @ w[3]])
    torch.testing.assert_close(moe.grouped_mm(x, w, ends), want)


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


def test_phi_spans_and_counters_through_the_aipm_service():
    """A φ request through PandaDB's AIPM service, profiled with every
    thread recorded: the worker's spans nest as documented, the counters
    count the call's rows, tokens and (token, expert) pairs."""
    from torch._C._profiler import _ExperimentalConfig
    lm = small_lm()
    db = PandaDB(PandaDBConfig(aipm=AIPMConfig(auto_batch=False)),
                 device="cpu")
    db.register_extractor("textvec", model_embedding_extractor(
        lm, 16, max_tokens=24), batch_size=4)
    raws = texts(9, 6)
    c = moe.METRICS.counters_view()
    before = {n: c.get(n, 0) for n in ("phi.calls", "phi.rows", "phi.tokens",
                                       "moe.pairs", "moe.dropped_pairs")}
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            got = db.aipm.extract_sync("textvec", list(enumerate(raws)))
    finally:
        db.aipm.shutdown()
    assert sorted(got) == list(range(6))
    names = [e.name for e in prof.events()]
    for span in ("aipm.execute", "phi.extract", "phi.forward", "phi.pool",
                 "lm.layer", "lm.attn", "lm.ffn", "moe.ffn", "moe.route",
                 "moe.experts", "moe.shared", "lm.head"):
        assert span in names, span
    assert names.count("aipm.execute") == 1
    assert names.count("phi.forward") == 2          # two slices of 4 rows
    assert names.count("lm.layer") == 2 * SMALL.n_layers
    fwd = [e for e in prof.events() if e.name == "phi.forward"]
    inside = {c.name for e in fwd for c in e.cpu_children}
    assert {"lm.layer", "lm.head"} <= inside
    c = moe.METRICS.counters_view()
    delta = {n: c[n] - before[n] for n in before}
    n_moe = SMALL.n_layers - SMALL.first_dense_layers
    assert delta == {"phi.calls": 2, "phi.rows": 6, "phi.tokens": 6 * 24,
                     "moe.pairs": 6 * 24 * SMALL.top_k * n_moe,
                     "moe.dropped_pairs": 0}
    most = moe.METRICS.gauge("moe.max_expert_pairs").value
    assert 0 < most <= 2 * 24 * SMALL.top_k


def test_no_span_opens_when_nothing_records():
    with phases(None, "x") as ph:
        assert ph is None
    with profile(activities=[ProfilerActivity.CPU]):
        with phases(None, "x") as ph:
            assert ph is not None


# ---------------------------------------------------------------------------
# every other arch as before
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in arch_names()
                                  if get_arch(n).family == "lm"])
def test_existing_archs_leave_the_new_fields_off(name):
    c = get_arch(name).model
    assert (c.yarn, c.norm_topk_prob, c.dropless) == (None, True, False)


def test_registered_outside_the_reference_grid():
    assert "deepseek-v2-lite" not in arch_names()
    assert "deepseek-v2-lite" not in ASSIGNED
    assert get_arch("deepseek-v2-lite").name == "deepseek-v2-lite"
    # DeepSeek's YaRN scales MLA's softmax by m(mscale_all_dim)^2; a GQA
    # model takes YaRN in transformers' form (attention_factor) only
    with pytest.raises(ValueError, match="mscale_all_dim"):
        LM(dataclasses.replace(SMALL, kv_lora_rank=0), device="meta")
