"""Mellum2-12B-A2.5B in the port against its plain float32 reference
(``portbench/mellum2_ref.py``, loaded by path from the checkout: the
benchmark's and the tests' one copy), on the CPU at a small size that keeps
every kind of part: sliding-window and full GQA layers (3 + 1, twice), a
window of 8 at 40 positions, YaRN with an ``attention_factor`` on the full
layers, 8 experts top 2 renormalised, no shared expert, no dense layer.
Also: the sliding window of the plain attention against a brute-force
masked softmax, the registered arch against the published keys, YaRN's
numbers at the published widths, the attention spans, the paths that
refuse a window, and the cell's FLOP count."""
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ASSIGNED, arch_names, get_arch
from repro_torch.configs.base import YarnRope
from repro_torch.core.aipm import model_embedding_extractor
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import layers, moe
from repro_torch.models.attention import chunked_attention
from repro_torch.models.transformer import LM

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("sliding_attention",) * 3 + ("full_attention",)
FULL = get_arch("mellum2-12b-a2.5b").model
SMALL = dataclasses.replace(
    FULL, n_layers=8, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    moe_d_ff=32, vocab_size=256, n_routed_experts=8, top_k=2,
    layer_types=KINDS * 2, sliding_window=8, dtype="float32",
    yarn=YarnRope(factor=4.0, original_max_position=16, beta_fast=32.0,
                  beta_slow=1.0, attention_factor=0.1 * math.log(4) + 1))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{name}", ROOT / "portbench" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("mellum2_ref")


def hf_config(cfg) -> dict:
    """``cfg`` under the published config.json's keys, as the reference
    reads them."""
    y = cfg.yarn
    return {"num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "moe_intermediate_size": cfg.moe_d_ff,
            "vocab_size": cfg.vocab_size, "num_experts": cfg.n_routed_experts,
            "num_experts_per_tok": cfg.top_k,
            "norm_topk_prob": cfg.norm_topk_prob, "rms_norm_eps": cfg.rms_eps,
            "sliding_window": cfg.sliding_window,
            "layer_types": list(cfg.layer_types),
            "rope_parameters": {
                "full_attention": {
                    "rope_type": "yarn", "rope_theta": cfg.rope_theta,
                    "factor": y.factor,
                    "original_max_position_embeddings":
                        y.original_max_position,
                    "beta_fast": y.beta_fast, "beta_slow": y.beta_slow,
                    "attention_factor": y.attention_factor},
                "sliding_attention": {"rope_type": "default",
                                      "rope_theta": cfg.rope_theta}}}


def weights(lm: LM):
    """(top, layer) as the reference takes them: the model's own tensors."""
    return ({"embed": lm.embed, "final_norm": lm.final_norm,
             "lm_head": lm.lm_head},
            lambda i: {name: p[i] for name, p in lm.moe_layers.items()})


def small_lm(cfg=SMALL, seed=3) -> LM:
    return LM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def texts(seed, n, lo=10, hi=60):
    """Lowercase texts around the 40 positions: some cut, some padded."""
    rng = np.random.default_rng(seed)
    return [rng.integers(97, 123, int(rng.integers(lo, hi + 1)),
                         dtype=np.uint8) for _ in range(n)]


# ---------------------------------------------------------------------------
# the published configuration
# ---------------------------------------------------------------------------


def test_published_widths():
    c = FULL
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.moe_d_ff, c.vocab_size, c.n_routed_experts, c.n_shared_experts,
            c.top_k, c.first_dense_layers, c.sliding_window, c.rms_eps,
            c.rope_theta, c.tie_embeddings, c.qk_norm) == (
        28, 2304, 32, 4, 128, 896, 98304, 64, 0, 8, 0, 1024, 1e-6, 500000.0,
        False, False)
    assert c.layer_types == KINDS * 7
    assert [c.window(i) for i in range(4)] == [1024, 1024, 1024, 0]
    assert c.norm_topk_prob and c.dropless and c.dtype == "bfloat16"
    assert (c.yarn.factor, c.yarn.original_max_position, c.yarn.beta_fast,
            c.yarn.beta_slow) == (16.0, 8192, 32.0, 1.0)
    assert c.yarn.attention_factor == pytest.approx(0.1 * math.log(16) + 1,
                                                    rel=1e-15)
    # 12.15 B parameters, ~2.44 B active a token
    assert 12.14e9 < c.param_count() < 12.16e9
    assert 2.43e9 < c.active_param_count() < 2.45e9


def test_registered_arch_is_the_configuration_file_s():
    """The benchmark's configuration (the catalog's keys as published) and
    the registered arch agree key for key."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "mellum2-govreport.json").read_text())
    assert cfg["arch"] == "mellum2-12b-a2.5b"
    assert hf_config(FULL) == {k: cfg[k] for k in hf_config(FULL)}
    assert (cfg["intermediate_size"], cfg["tie_word_embeddings"],
            cfg["attention_bias"]) == (FULL.d_ff, False, False)
    assert set(cfg["mlp_layer_types"]) == {"sparse"}
    assert "mellum2-12b-a2.5b" not in arch_names()
    assert "mellum2-12b-a2.5b" not in ASSIGNED


def test_yarn_at_the_published_widths():
    """transformers' YaRN for the full layers, written out: dims below 18
    keep theta^(-2i/128), dims from 35 on are divided by 16, a linear ramp
    between; cos and sin times 0.1 ln 16 + 1 = 1.27726."""
    y, theta = FULL.yarn, FULL.rope_theta
    assert layers.yarn_range(y, 128, theta) == (18, 35)
    extra = 1.0 / theta ** (torch.arange(0, 128, 2, dtype=torch.float64)
                            / 128)
    ramp = ((torch.arange(64, dtype=torch.float64) - 18) / 17).clamp(0, 1)
    want = extra / 16 * ramp + extra * (1 - ramp)
    got = layers.yarn_inv_freq(y, 128, theta)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)
    rfreq, rscale = ref.inv_freq(hf_config(FULL), "full_attention")
    torch.testing.assert_close(rfreq, got, rtol=1e-6, atol=0)
    assert rscale == pytest.approx(1.2772588722239782, rel=1e-15)
    cos, sin = layers.rotary_cos_sin(torch.arange(64), 128, theta, yarn=y)
    rcos, rsin = ref.cos_sin(hf_config(FULL), "full_attention", 64, "cpu")
    assert torch.allclose(cos, rcos[:, :64], atol=1e-6)
    assert torch.allclose(sin, rsin[:, :64], atol=1e-6)
    assert float(cos[0, 0]) == pytest.approx(1.2772588722239782, rel=1e-6)
    # the sliding layers: plain RoPE, no scale; the port's frequencies are
    # exp(-ln theta i / 64), ~1e-6 of them from theta^(-i / 64) in float32,
    # so the angles at position p differ by up to ~p 1e-6
    pcos, _ = layers.rotary_cos_sin(torch.arange(64), 128, theta)
    scos, _ = ref.cos_sin(hf_config(FULL), "sliding_attention", 64, "cpu")
    assert torch.allclose(pcos, scos[:, :64], atol=2e-4)
    assert float(scos[:, 0].abs().max()) == pytest.approx(1.0)


def test_lm_refuses_what_it_does_not_run():
    with pytest.raises(ValueError, match="layer_types"):
        LM(dataclasses.replace(SMALL, layer_types=KINDS), device="meta")
    with pytest.raises(ValueError, match="layer_types"):
        LM(dataclasses.replace(SMALL, sliding_window=0), device="meta")
    with pytest.raises(ValueError, match="mscale_all_dim"):
        LM(dataclasses.replace(SMALL, yarn=dataclasses.replace(
            SMALL.yarn, mscale_all_dim=1.0)), device="meta")


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


def _brute(q, k, v, window):
    """Masked softmax over whole rows, float64: key j seen by the row at
    position p iff p - window < j <= p."""
    b, sq, h, d = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    qf = q.double().permute(0, 2, 1, 3)
    kf = k.double().permute(0, 2, 1, 3).repeat_interleave(g, 1)
    vf = v.double().permute(0, 2, 1, 3).repeat_interleave(g, 1)
    p = torch.arange(sq)[:, None] + (skv - sq)
    j = torch.arange(skv)[None, :]
    seen = (j <= p) & (j > p - window)
    s = (qf @ kf.transpose(-1, -2)) * d ** -0.5
    s = s.masked_fill(~seen, float("-inf"))
    return (torch.softmax(s, -1) @ vf).permute(0, 2, 1, 3)


@pytest.mark.parametrize("sq,skv,window,block_kv", [
    (40, 40, 1, 16),        # each row sees itself alone
    (40, 40, 40, 16),       # w = S: causal
    (40, 40, 97, 7),        # w > S
    (50, 50, 11, 16),       # w not a multiple of the block
    (30, 70, 9, 8),         # Sq < Skv: rows right-aligned
])
def test_window_of_the_plain_attention(sq, skv, window, block_kv):
    g = torch.Generator().manual_seed(sq + skv + window)
    q = torch.randn(2, sq, 4, 16, generator=g)
    k = torch.randn(2, skv, 2, 16, generator=g)
    v = torch.randn(2, skv, 2, 16, generator=g)
    got = flash_attention_ref(q, k, v, window=window, block_kv=block_kv)
    torch.testing.assert_close(got.double(), _brute(q, k, v, window),
                               rtol=1e-5, atol=1e-6)
    # the wrapper's CPU path is the plain version
    assert torch.equal(flash_ops.flash_attention(q, k, v, window=window,
                                                 block_kv=block_kv), got)
    if window >= skv:
        assert torch.equal(got, flash_attention_ref(q, k, v,
                                                    block_kv=block_kv))


@pytest.mark.parametrize("sq,skv,window,want", [
    (40, 40, 0, 40 * 41 // 2), (40, 40, 8, 8 * 9 // 2 + 32 * 8),
    (40, 40, 1, 40), (40, 40, 64, 40 * 41 // 2),
    (30, 70, 9, 30 * 9), (10, 70, 0, 10 * 70 - 45)])
def test_attention_pairs_count_the_band(sq, skv, window, want):
    assert flash_ops.attention_pairs(2, 3, sq, skv, True, window) == \
        6 * want


def test_a_window_needs_causal():
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="window"):
        flash_ops.flash_attention(x, x, x, causal=False, window=2)


# ---------------------------------------------------------------------------
# port against reference
# ---------------------------------------------------------------------------


def test_logits_match_the_reference():
    """Float32 on both sides, the same products grouped and summed in
    another order (grouped experts, heads fused into one product, the
    online softmax): ~1e-6 of logits of order 3, so 1e-4 leaves room and
    catches any term left out, the window's 8 keys or YaRN's scale."""
    lm = small_lm()
    top, layer = weights(lm)
    tokens = torch.randint(0, 256, (3, 40),
                           generator=torch.Generator().manual_seed(1))
    tokens[:, 30:] = 0
    got, _ = lm.forward(tokens)
    with torch.no_grad():
        want = ref.logits(hf_config(SMALL), tokens, top, layer)
    assert want.abs().max() > 1.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # every part is seen: without the window, or with plain RoPE on the
    # full layers, the reference is far off
    for other in (dict(hf_config(SMALL), sliding_window=40),
                  dict(hf_config(SMALL), rope_parameters=dict(
                      hf_config(SMALL)["rope_parameters"],
                      full_attention={"rope_type": "default",
                                      "rope_theta": SMALL.rope_theta}))):
        with torch.no_grad():
            off = ref.logits(other, tokens, top, layer)
        assert (off - got).abs().max() > 1e-2


def test_phi_matches_the_reference():
    """φ through the extractor (bytes to tokens, the forward, the mean over
    positions, the cut) against the reference's φ; float32, tolerance as
    above."""
    lm = small_lm()
    top, layer = weights(lm)
    fn = model_embedding_extractor(lm, 16, max_tokens=40)
    raws = texts(5, 4)
    with torch.no_grad():
        want = ref.phi(hf_config(SMALL), ref.text_tokens(raws, 256, 40), top,
                       layer, 16).numpy()
    np.testing.assert_allclose(fn.raw(raws), want, rtol=1e-4, atol=1e-5)
    unit = want / np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(fn(raws), unit, rtol=1e-4, atol=1e-5)


def test_each_layer_matches_the_reference_on_its_input():
    """The reference's ``tap`` sees each part's input; on it the program's
    attention (``LM.attention``, both kinds) and experts (``moe_ffn``) give
    the reference's: float32, ~1e-7 of them."""
    lm = small_lm()
    top, layer = weights(lm)
    cfg = hf_config(SMALL)
    rope = {kind: ref.cos_sin(cfg, kind, 40, "cpu") for kind in set(KINDS)}
    seen = []

    def tap(part, i, h, w):
        if part == "attn":
            want = ref.attention(cfg, i, h, w, *rope[KINDS[i % 4]])
            got = lm.attention(i, h)
        else:
            want = ref.moe(cfg, h, w)
            got, _ = moe.moe_ffn(moe.nest_moe_params(
                {n: p[i] for n, p in lm.moe_layers.items()}), h, SMALL)
        seen.append((part, i, float((got - want).norm() / want.norm())))

    tokens = ref.text_tokens(texts(3, 2), 256, 40)
    with torch.no_grad():
        ref.phi(cfg, tokens, top, layer, 16, tap)
    assert [(p, i) for p, i, _ in seen] == [
        (p, i) for i in range(8) for p in ("attn", "moe")]
    assert max(e for _, _, e in seen) < 1e-5, seen


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_attention_spans():
    """A forward profiled: ``lm.attn.window`` once a sliding layer and
    ``lm.attn.full`` once a full one, each inside ``lm.attn``."""
    lm = small_lm()
    tokens = torch.randint(0, 256, (2, 40),
                           generator=torch.Generator().manual_seed(4))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lm.forward(tokens)
    names = [e.name for e in prof.events()]
    assert names.count("lm.layer") == 8
    assert names.count("lm.attn.window") == 6
    assert names.count("lm.attn.full") == 2
    for e in prof.events():
        if e.name in ("lm.attn.window", "lm.attn.full"):
            assert e.cpu_parent is not None \
                and e.cpu_parent.name == "lm.attn", e.cpu_parent


# ---------------------------------------------------------------------------
# the paths that refuse a window
# ---------------------------------------------------------------------------


def test_decode_of_a_windowed_model_raises():
    lm = small_lm()
    cache = lm.init_cache(2, 12)
    with pytest.raises(NotImplementedError, match="windowed decode"):
        lm.decode_step(cache, torch.ones(2, 1, dtype=torch.long),
                       torch.zeros(2, dtype=torch.long))


def test_training_a_windowed_model_raises():
    lm = small_lm()
    tokens = torch.randint(0, 256, (2, 12),
                           generator=torch.Generator().manual_seed(5))
    with pytest.raises(NotImplementedError, match="gradient"):
        lm.loss_fn(tokens, tokens)
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="windowed"):
        chunked_attention(x, x, x, window=4)


def test_uneven_head_shards_of_a_windowed_layer_raise(monkeypatch):
    """The DTensor path for heads that do not divide the mesh
    (``LM._gqa_local``) takes no window."""
    lm = small_lm()
    monkeypatch.setattr(LM, "_heads_uneven", lambda self, x: True)
    with pytest.raises(NotImplementedError, match="uneven"):
        lm.forward(torch.zeros(1, 8, dtype=torch.long))


# ---------------------------------------------------------------------------
# the cell's work
# ---------------------------------------------------------------------------


def test_work_of_the_cell_s_batch(monkeypatch):
    """One report of 32,768 positions, by hand from the published widths:
    217.93 TFLOP, of which 11.36 the 21 sliding layers' band and 61.57 the
    7 full layers' causal half."""
    monkeypatch.syspath_prepend(str(ROOT))
    work = _load("mellum2_work")
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "mellum2-govreport.json").read_text())
    s, d = 32768, 2304
    band = 1024 * 1025 // 2 + (s - 1024) * 1024
    window = 21 * 32 * band * 2 * 2 * 128
    full = 7 * 32 * (s * (s + 1) // 2) * 2 * 2 * 128
    proj = d * 32 * 128 + 2 * d * 4 * 128 + 32 * 128 * d
    token = 2 * (28 * (proj + d * 64 + 8 * 3 * d * 896) + d * 98304)
    assert work.attention_flops(cfg, "window", 1, s) == window
    assert work.attention_flops(cfg, "full", 1, s) == full
    assert work.call_flops(cfg, 1, s) == s * token + window + full
    assert work.call_flops(cfg, 1, s) == pytest.approx(217.93e12, rel=1e-4)
    assert window == pytest.approx(11.36e12, rel=1e-3)
    assert full == pytest.approx(61.57e12, rel=1e-4)
