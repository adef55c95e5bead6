"""Two-sided tests of the port's LM serving path against the reference.

The same numpy-seeded inputs, and the reference's own initialised
parameters (loaded with ``params_from_jax``), go through ``repro``'s LM
(under ``make_smoke_mesh()`` with ``base_rules``/``decode_rules``, as
tests/test_models_lm.py runs it) and ``repro_torch``'s LM on the CPU, where
attention takes the kernels' plain versions.  The CUDA kernels run in
tests/test_torch_cuda.py.

Tolerances: layers 1e-6 (the same float32 ops in the same order); logits,
caches and embeddings 1e-4 / 1e-5 (float32 products summed in another order
by XLA and by torch); greedy tokens and query rows identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import TransformerConfig as RefCfg
from repro.core import PandaDB as RefDB
from repro.core.aipm import model_embedding_extractor as ref_extractor
from repro.distributed.sharding import base_rules, decode_rules
from repro.launch.mesh import make_smoke_mesh
from repro.models import layers as ref_layers
from repro.models.transformer import LM as RefLM
from repro_torch.configs import arch_names, get_arch, reduced
from repro_torch.configs.base import TransformerConfig
from repro_torch.core import PandaDB
from repro_torch.core.aipm import model_embedding_extractor
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import layers
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import LM, params_from_jax

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

LOGITS = dict(rtol=1e-4, atol=1e-4)

# the "dense" and "qknorm" configs of tests/test_models_lm.py
CFGS = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256, dtype="float32"),
    "qknorm": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=256, qk_norm=True,
                   dtype="float32"),
    "mha_tied": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                     head_dim=16, d_ff=96, vocab_size=256,
                     tie_embeddings=True, dtype="float32"),
    # the "moe" and "mla" configs of tests/test_models_lm.py
    "moe": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=128, moe_d_ff=32, vocab_size=256,
                n_routed_experts=8, n_shared_experts=2, top_k=2,
                dtype="float32", capacity_factor=4.0),
    "mla": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                vocab_size=256, kv_lora_rank=32, q_lora_rank=48,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                dtype="float32"),
    "mla_no_q_lora": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256, kv_lora_rank=32,
                          q_lora_rank=0, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16,
                          dtype="float32"),
}

# deepseek-v2-236b cut to a small size on both sides: MLA and MoE together,
# a dense first layer, shared experts; every other setting the arch's own
DSV2_CUT = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
                moe_d_ff=32, vocab_size=256, n_routed_experts=8, top_k=3,
                kv_lora_rank=32, q_lora_rank=24, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, dtype="float32",
                capacity_factor=4.0, grad_accum=1, fsdp=False)

#: the port's own TransformerConfig fields, which the reference's config
#: lacks, each at the value that leaves an arch as the reference runs it
PORT_ONLY = {"yarn": None, "norm_topk_prob": True, "dropless": False,
             "layer_types": (), "sliding_window": 0}


def same_config(port, ref) -> bool:
    """The port's config is the reference's, its own fields off."""
    p = dataclasses.asdict(port)
    own = {k: p.pop(k) for k in PORT_ONLY}
    return own == PORT_ONLY and p == dataclasses.asdict(ref)


LM_ARCHS = ["llama3-8b", "qwen3-14b", "stablelm-12b", "deepseek-moe-16b",
            "deepseek-v2-236b"]


@pytest.fixture(scope="module")
def mesh():
    return make_smoke_mesh()


def _pair(name, seed=0, **over):
    """(reference LM, its params, the port's LM holding the same params);
    ``name`` "dsv2_cut" is deepseek-v2-236b reduced to ``DSV2_CUT``."""
    if name == "dsv2_cut":
        rcfg = dataclasses.replace(ref_get_arch("deepseek-v2-236b").model,
                                   **DSV2_CUT, **over)
        ref = RefLM(rcfg)
        params = ref.init(jax.random.key(seed))
        port = LM(reduced(get_arch("deepseek-v2-236b").model, **DSV2_CUT,
                          **over), device="cpu")
        params_from_jax(port, jax.tree.map(np.asarray, params))
        return ref, params, port
    kw = dict(CFGS[name], **over)
    ref = RefLM(RefCfg(**kw))
    params = ref.init(jax.random.key(seed))
    port = LM(TransformerConfig(**kw), device="cpu")
    params_from_jax(port, jax.tree.map(np.asarray, params))
    return ref, params, port


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LM_ARCHS)
def test_arch_configs_match_reference(name):
    ref, port = ref_get_arch(name), get_arch(name)
    assert same_config(port.model, ref.model)
    assert {k: dataclasses.asdict(v) for k, v in port.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.shapes.items()}
    assert port.model.param_count() == ref.model.param_count()
    assert (port.name, port.family, port.source) == \
        (ref.name, ref.family, ref.source)


def test_arch_registry_holds_every_lm_arch():
    """The five transformer archs of the reference's registry, beside its
    six GNN archs and its recsys arch, and no other; autoint resolves to
    the reference's ArchSpec."""
    from repro.configs import arch_names as ref_arch_names
    lm = [n for n in ref_arch_names() if ref_get_arch(n).family == "lm"]
    assert sorted(lm) == sorted(LM_ARCHS)
    assert arch_names() == ref_arch_names()
    ref, port = ref_get_arch("autoint"), get_arch("autoint")
    assert (port.name, port.family, port.source) == \
        (ref.name, ref.family, ref.source)
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert {k: dataclasses.asdict(v) for k, v in port.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.shapes.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("autoint-bonus")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm_matches_reference(fused, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    ref = ref_layers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                              1e-5, fused=fused)
    port = layers.rms_norm(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(scale), 1e-5, fused=fused)
    assert port.dtype == tdt
    tol = dict(rtol=1e-6, atol=1e-6) if dtype is np.float32 else \
        dict(rtol=1e-2, atol=1e-2)          # one bf16 rounding of the output
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (128, 500_000.0),
                                            (160, 10_000.0)])
def test_rotary_matches_reference(head_dim, theta):
    """cos/sin tables within 1e-6 at positions 0..8.  XLA's and torch's
    float32 exp may differ by one ulp in a frequency, and an angle pos *
    freq carries that ulp times pos, so further out the tables are held
    to pos * 2**-22 (two ulps of the largest angle)."""
    rng = np.random.default_rng(head_dim)
    for n_pos, tol in ((9, 1e-6), (4096, 4096 * 2.0 ** -22)):
        pos = np.arange(n_pos, dtype=np.int32)
        cos_r, sin_r = ref_layers.rotary_cos_sin(jnp.asarray(pos), head_dim,
                                                 theta)
        cos_p, sin_p = layers.rotary_cos_sin(torch.from_numpy(pos), head_dim,
                                             theta)
        np.testing.assert_allclose(cos_p.numpy(), np.asarray(cos_r),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(sin_p.numpy(), np.asarray(sin_r),
                                   rtol=0, atol=tol)
    # the rotation itself on shared tables; [S, D/2] and [B, S, D/2] tables
    x = rng.standard_normal((2, 40, 3, head_dim)).astype(np.float32)
    c, s = (np.array(t[:40]) for t in (cos_r, sin_r))
    for cc, ss in ((c, s), (np.stack([c, c]), np.stack([s, s]))):
        ref = ref_layers.apply_rotary(jnp.asarray(x), jnp.asarray(cc),
                                      jnp.asarray(ss))
        port = layers.apply_rotary(torch.from_numpy(x), torch.from_numpy(cc),
                                   torch.from_numpy(ss))
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv_matches_reference(n_rep):
    from repro.models.attention import repeat_kv as ref_repeat_kv
    from repro_torch.models.attention import repeat_kv
    k = np.random.default_rng(n_rep).standard_normal((2, 5, 3, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        repeat_kv(torch.from_numpy(k), n_rep).numpy(),
        np.asarray(ref_repeat_kv(jnp.asarray(k), n_rep)))


@pytest.mark.parametrize("sq,skv,d,dv", [
    (40, 40, 32, 16), (40, 40, 192, 128),      # Dv != D (MLA's prefill)
    (4, 8, 32, 32), (16, 64, 32, 32),          # Sq < Skv
    (24, 24, 80, 80),                           # a width the kernel pads
])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_reference(sq, skv, d, dv, causal):
    """The model layer's chunked_attention at every shape the reference's
    serves: the reference on repeat_kv'd keys and values (its k takes H
    heads), the port's on the grouped ones, within 1e-5."""
    from repro.models.attention import chunked_attention as ref_chunked
    from repro.models.attention import repeat_kv as ref_repeat_kv
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(sq + skv + d + dv)
    h, kvh = 4, 2
    q = rng.standard_normal((2, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((2, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((2, skv, kvh, dv)).astype(np.float32)
    ref = ref_chunked(jnp.asarray(q), ref_repeat_kv(jnp.asarray(k), 2),
                      ref_repeat_kv(jnp.asarray(v), 2), causal=causal,
                      block_kv=8)
    port = chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, block_kv=8)
    assert port.shape == (2, sq, h, dv)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("h,kvh,d,dv", [(8, 2, 64, 32), (16, 2, 192, 128),
                                        (32, 2, 32, 32), (8, 2, 96, 96)])
def test_decode_attention_matches_reference(h, kvh, d, dv):
    """The model layer's decode_attention at Dv != D, G = 16 and D = 96."""
    from repro.models.attention import decode_attention as ref_decode
    from repro_torch.models.attention import decode_attention
    rng = np.random.default_rng(h * d + dv)
    b, s = 2, 70
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, dv)).astype(np.float32)
    pos = np.asarray([s - 1, 33], np.int32)
    ref = ref_decode(*(jnp.asarray(x) for x in (q, k, v, pos)))
    port = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, pos)))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_init_statistics():
    """Truncated normal at +-2 sigma with sigma = fan_in^-1/2; embedding
    0.02 * normal; drawn from the generator given."""
    gen = torch.Generator().manual_seed(3)
    w = layers.dense_init_(torch.empty(256, 512), 256, gen)
    sigma = 256 ** -0.5
    assert float(w.abs().max()) <= 2 * sigma + 1e-7
    # a normal truncated at +-2 has std 0.8796
    assert abs(float(w.std()) / sigma - 0.8796) < 0.01
    e = layers.embed_init_(torch.empty(512, 256), gen)
    assert abs(float(e.std()) - 0.02) < 0.001
    again = layers.dense_init_(torch.empty(256, 512), 256,
                               torch.Generator().manual_seed(3))
    assert torch.equal(w, again)


def test_lm_param_shapes_match_reference_tree():
    for name in CFGS:
        kw = CFGS[name]
        tree = jax.eval_shape(RefLM(RefCfg(**kw)).init, jax.random.key(0))
        port = LM(TransformerConfig(**kw), device="cpu")
        n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
        n_port = sum(p.numel() for p in port.parameters())
        assert n_ref == n_port, name
        attn = tree["dense_layers"]["attn"]
        key = "wq_b" if "wq_b" in attn else "wq"
        assert tuple(port.layers[key].shape) == attn[key].shape
        for stack, lp in (("dense_layers", port.layers),
                          ("moe_layers", port.moe_layers)):
            if stack not in tree:
                assert lp is None
                continue
            ref_leaves = jax.tree_util.tree_leaves_with_path(tree[stack])
            assert len(ref_leaves) == len(lp)
            for path, leaf in ref_leaves:
                names = [p.key for p in path]
                mine = f"shared_{names[-1]}" if "shared" in names \
                    else names[-1]
                assert tuple(lp[mine].shape) == leaf.shape, (stack, names)
                assert str(lp[mine].dtype).split(".")[1] == str(leaf.dtype)
        # trainable since the training slice; serving runs under no_grad
        assert all(p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("name", ["moe", "mla", "mla_no_q_lora", "dsv2_cut"])
def test_moe_and_mla_configs_build(name):
    """LM and build_model build MoE, MLA and MoE + MLA configs: the two
    stacks, and the parameters ``param_count()`` counts plus the final norm
    (and MLA's latent norm scales, which it leaves out)."""
    cfg = TransformerConfig(**CFGS[name]) if name in CFGS else \
        reduced(get_arch("deepseek-v2-236b").model, **DSV2_CUT)
    for model in (LM(cfg, device="cpu"), build_model(cfg, device="cpu")):
        n_dense = cfg.first_dense_layers if cfg.is_moe else cfg.n_layers
        assert model.n_dense == n_dense
        assert model.n_moe == cfg.n_layers - n_dense
        assert (model.moe_layers is None) == (not cfg.is_moe)
        norms = cfg.d_model + (cfg.n_layers * (cfg.kv_lora_rank
                                               + cfg.q_lora_rank)
                               if cfg.is_mla else 0)
        assert sum(p.numel() for p in model.parameters()) == \
            cfg.param_count() + norms
        cache = model.init_cache(2, 5)
        assert sorted(cache) == (["dense", "moe"] if cfg.is_moe
                                 else ["dense"])


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(**CFGS["dense"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_arch("llama3-8b"))
    assert LM(cfg, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CFGS) + ["dsv2_cut"])
def test_forward_and_prefill_cache_match_reference(name, mesh):
    ref, params, port = _pair(name)
    toks = _tokens(1, 2, 24)
    with jax.set_mesh(mesh):
        logits, _, cache = ref.forward(params, jnp.asarray(toks),
                                       base_rules(mesh), collect_cache=True)
        last, _ = ref.prefill(params, jnp.asarray(toks), base_rules(mesh))
    got, got_cache = port.forward(torch.from_numpy(toks), collect_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **LOGITS)
    assert sorted(got_cache) == sorted(cache)
    for key in cache:
        for r, p in zip(cache[key], got_cache[key]):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), **LOGITS)
    p_last, p_cache = prefill_step(port, torch.from_numpy(toks))
    np.testing.assert_allclose(p_last.numpy(), np.asarray(last), **LOGITS)
    assert all(torch.equal(a, b) for key in cache
               for a, b in zip(p_cache[key], got_cache[key]))


@pytest.mark.parametrize("name", list(CFGS) + ["dsv2_cut"])
def test_teacher_forced_decode_matches_reference(name, mesh):
    """16 decode steps from an empty cache, fed the same tokens, give the
    reference's logits and caches."""
    ref, params, port = _pair(name, seed=1)
    b, s = 2, 16
    toks = _tokens(2, b, s)
    cache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                         ref.cache_spec(b, s))
    pcache = port.init_cache(b, s)
    drules = decode_rules(mesh)
    with jax.set_mesh(mesh):
        for t in range(s):
            pos = np.full((b,), t, np.int32)
            lg, cache = ref.decode_step(params, cache,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.asarray(pos), drules)
            plg, pcache2 = serve_step(port, pcache, torch.from_numpy(
                toks[:, t:t + 1]), torch.from_numpy(pos))
            assert pcache2 is pcache               # updated in place
            np.testing.assert_allclose(plg.numpy(), np.asarray(lg), **LOGITS)
    for key in cache:
        for r, p in zip(cache[key], pcache[key]):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), **LOGITS)


def test_decode_drops_rows_past_the_cache(mesh):
    """A row whose pos >= max_seq leaves its cache row untouched (the
    reference's mode="drop"), while the other row is written; logits
    agree with the reference's for both rows."""
    ref, params, port = _pair("dense", seed=2)
    b, s = 2, 8
    toks = _tokens(3, b, 1)
    pos = np.asarray([3, s + 2], np.int32)
    rng = np.random.default_rng(5)
    init = [rng.standard_normal((2, b, s, 2, 16)).astype(np.float32)
            for _ in range(2)]
    cache = {"dense": tuple(jnp.asarray(x) for x in init)}
    pcache = {"dense": tuple(torch.from_numpy(x.copy()) for x in init)}
    with jax.set_mesh(mesh):
        lg, cache = ref.decode_step(params, cache, jnp.asarray(toks),
                                    jnp.asarray(pos), decode_rules(mesh))
    plg, pcache = port.decode_step(pcache, torch.from_numpy(toks),
                                   torch.from_numpy(pos))
    np.testing.assert_allclose(plg.numpy(), np.asarray(lg), **LOGITS)
    for r, p, x in zip(cache["dense"], pcache["dense"], init):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **LOGITS)
        np.testing.assert_array_equal(p.numpy()[:, 1], x[:, 1])  # dropped
        assert not np.array_equal(p.numpy()[:, 0, 3], x[:, 0, 3])


def test_mla_decode_drops_rows_past_the_cache(mesh):
    """The same for MLA's latent caches ([n, B, S, dc] and [n, B, S, dr]),
    over both stacks of the deepseek-v2 cut."""
    ref, params, port = _pair("dsv2_cut", seed=2)
    b, s = 2, 8
    toks = _tokens(3, b, 1)
    pos = np.asarray([s + 2, 5], np.int32)
    rng = np.random.default_rng(6)
    init = {key: [rng.standard_normal((n, b, s, w)).astype(np.float32)
                  for w in (32, 8)]
            for key, n in (("dense", 1), ("moe", 2))}
    cache = {k: tuple(jnp.asarray(x) for x in v) for k, v in init.items()}
    pcache = {k: tuple(torch.from_numpy(x.copy()) for x in v)
              for k, v in init.items()}
    with jax.set_mesh(mesh):
        lg, cache = ref.decode_step(params, cache, jnp.asarray(toks),
                                    jnp.asarray(pos), decode_rules(mesh))
    plg, pcache = port.decode_step(pcache, torch.from_numpy(toks),
                                   torch.from_numpy(pos))
    np.testing.assert_allclose(plg.numpy(), np.asarray(lg), **LOGITS)
    for key in init:
        for r, p, x in zip(cache[key], pcache[key], init[key]):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), **LOGITS)
            np.testing.assert_array_equal(p.numpy()[:, 0], x[:, 0])
            assert not np.array_equal(p.numpy()[:, 1, 5], x[:, 1, 5])


@pytest.mark.parametrize("name", ["dense", "qknorm", "moe", "mla",
                                  "mla_no_q_lora", "dsv2_cut"])
def test_greedy_generation_matches_reference(name, mesh):
    """Prefill a prompt, then 12 greedy steps: identical tokens."""
    ref, params, port = _pair(name, seed=4)
    b, prompt, steps = 3, 10, 12
    max_seq = prompt + steps
    toks = _tokens(6, b, prompt)
    with jax.set_mesh(mesh):
        last, pre = ref.prefill(params, jnp.asarray(toks), base_rules(mesh))
        cache = jax.tree.map(
            lambda sd, c: jnp.zeros(sd.shape, sd.dtype).at[:, :, :prompt]
            .set(c), ref.cache_spec(b, max_seq), pre)
        ref_out, nxt = [], jnp.argmax(last, axis=-1)
        for t in range(steps):
            ref_out.append(np.asarray(nxt))
            pos = jnp.full((b,), prompt + t, jnp.int32)
            lg, cache = ref.decode_step(params, cache, nxt[:, None], pos,
                                        decode_rules(mesh))
            nxt = jnp.argmax(lg, axis=-1)
    plast, ppre = port.prefill(torch.from_numpy(toks))
    pcache = port.init_cache(b, max_seq)
    for key in pcache:
        for dst, src in zip(pcache[key], ppre[key]):
            dst[:, :, :prompt] = src
    port_out, pnxt = [], plast.argmax(-1)
    for t in range(steps):
        port_out.append(pnxt.numpy())
        pos = torch.full((b,), prompt + t, dtype=torch.int32)
        lg, pcache = port.decode_step(pcache, pnxt[:, None], pos)
        pnxt = lg.argmax(-1)
    np.testing.assert_array_equal(np.stack(port_out), np.stack(ref_out))


def test_attention_on_cpu_takes_the_plain_versions():
    _, _, port = _pair("dense")
    before = (flash_ops.launches.n, decode_ops.launches.n)
    _, cache = port.prefill(torch.from_numpy(_tokens(7, 1, 8)))
    full = port.init_cache(1, 9)
    full["dense"][0][:, :, :8] = cache["dense"][0]
    port.decode_step(full, torch.zeros(1, 1, dtype=torch.long),
                     torch.tensor([8]))
    assert (flash_ops.launches.n, decode_ops.launches.n) == before


def test_params_from_jax_rejects_a_mismatched_tree():
    ref, params, port = _pair("dense")
    tree = jax.tree.map(np.asarray, params)
    tree["dense_layers"]["attn"]["q_norm"] = np.ones((2, 16), np.float32)
    with pytest.raises(ValueError, match="attn keys"):
        params_from_jax(port, tree)
    tree = jax.tree.map(np.asarray, params)
    tree["embed"] = tree["embed"][:10]
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(port, tree)


@pytest.mark.parametrize("name,edit,match", [
    ("moe", lambda t: t["moe_layers"]["moe"].pop("shared"), "moe keys"),
    ("moe", lambda t: t.pop("moe_layers"), "top-level keys"),
    ("moe", lambda t: t["moe_layers"]["moe"]["experts"].pop("w_up"),
     "experts keys"),
    ("mla", lambda t: t["dense_layers"]["attn"].pop("wq_a"), "attn keys"),
    ("mla_no_q_lora", lambda t: t["dense_layers"]["attn"].update(
        wq_a=np.zeros(1)), "attn keys"),
    ("dsv2_cut", lambda t: t["moe_layers"].update(
        mlp=t["moe_layers"].pop("moe")), "moe_layers keys"),
])
def test_params_from_jax_rejects_mismatched_moe_and_mla_trees(name, edit,
                                                              match):
    _, params, port = _pair(name)
    tree = jax.tree.map(np.asarray, params)
    edit(tree)
    with pytest.raises(ValueError, match=match):
        params_from_jax(port, tree)


def test_llama3_reduced_as_the_train_smoke_cuts_it(mesh):
    """llama3-8b cut as launch/train.py's smoke config cuts it (2 layers,
    d_model 128, head_dim 32, float32): the card/CPU parity config of the
    smoke run, here against the reference."""
    over = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                head_dim=32, d_ff=256, vocab_size=512, dtype="float32",
                grad_accum=1, fsdp=False)
    cfg = reduced(get_arch("llama3-8b").model, **over)
    rcfg = dataclasses.replace(ref_get_arch("llama3-8b").model, **over)
    ref = RefLM(rcfg)
    params = ref.init(jax.random.key(5))
    port = params_from_jax(LM(cfg, device="cpu"),
                           jax.tree.map(np.asarray, params))
    toks = _tokens(8, 2, 33, vocab=512)
    with jax.set_mesh(mesh):
        logits, _, _ = ref.forward(params, jnp.asarray(toks),
                                   base_rules(mesh))
    got, _ = port.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **LOGITS)


# ---------------------------------------------------------------------------
# the LM as phi (AIPM)
# ---------------------------------------------------------------------------

# The reference extractor computes ``byte % vocab_size`` on a uint8 array,
# which NumPy 2 refuses for vocab_size > 255 (ROADMAP Queue C), so the
# two-sided phi tests use a vocabulary of 251.
PHI_VOCAB = 251


def _texts():
    rng = np.random.default_rng(3)
    texts = [b"graph databases store relationships",
             b"graph databases store relationships!",
             bytes(rng.integers(0, 255, 64, dtype=np.uint8)),
             b"a vector index over the extracted sub-properties",
             b"x" * 80]
    return texts


@pytest.mark.parametrize("dim", [16, 64, 300])
def test_model_embedding_extractor_matches_reference(dim, mesh):
    ref, params, port = _pair("dense", vocab_size=PHI_VOCAB)
    raws = [np.frombuffer(t, np.uint8) for t in _texts()]
    with jax.set_mesh(mesh):
        want = ref_extractor(ref, params, base_rules(mesh), dim=dim)(raws)
    got = model_embedding_extractor(port, dim=dim)(raws)
    assert got.dtype == np.float32 and got.shape == (len(raws), dim)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_lm_phi_query_matches_reference(mesh):
    """examples/train_lm_e2e.py's PandaDB query, with the LM as phi, through
    both PandaDBs: the same rows, before and after an index is built."""
    ref, params, port = _pair("dense", seed=3, vocab_size=PHI_VOCAB)
    query = ("MATCH (x:Doc), (y:Doc) WHERE x.name='a' "
             "AND x.blob->textvec ~: y.blob->textvec RETURN y.name")
    texts = _texts()
    names = ["a", "b", "c", "d", "e"]
    rows = []
    with jax.set_mesh(mesh):
        for db, fn in (
                (RefDB(), ref_extractor(ref, params, base_rules(mesh),
                                        dim=64)),
                (PandaDB(device="cpu"),
                 model_embedding_extractor(port, dim=64))):
            db.register_extractor("textvec", fn, batch_size=8)
            for name, t in zip(names, texts):
                db.graph.create_node("Doc", name=name, blob=t)
            before = sorted(r["y.name"] for r in db.query(query))
            db.build_index("textvec", "blob")
            after = sorted(r["y.name"] for r in db.query(query))
            db.aipm.shutdown()
            rows.append((before, after))
    assert rows[0] == rows[1]
    assert "b" in rows[1][0]                   # the near-duplicate is found
