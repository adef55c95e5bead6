"""Two-sided tests of the port's MoE layer (``repro_torch.models.moe``)
against the reference's (``repro.models.moe``).

The same numpy-seeded inputs and parameters go through both.  Tolerances:
float32 layer outputs and aux losses 1e-5 (the same float32 products summed
in another order); indices, slots and drop decisions identical.

Where an expert overflows its capacity the two differ by design: the port
drops the pairs past the capacity and writes nothing for them, while the
reference's scatter writes slot 0 of that expert once for each dropped pair
(ROADMAP Queue C).  Those cases are held against a numpy statement of the
intended semantics, and the reference's overwrite is asserted as found.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import TransformerConfig as RefCfg
from repro.distributed.sharding import base_rules
from repro.launch.mesh import make_smoke_mesh
from repro.models import moe as ref_moe
from repro_torch.configs.base import TransformerConfig
from repro_torch.models import moe

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

LAYER = dict(rtol=1e-5, atol=1e-5)

# the "moe" config of tests/test_models_lm.py
MOE = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
           d_ff=128, moe_d_ff=32, vocab_size=256, n_routed_experts=8,
           n_shared_experts=2, top_k=2, dtype="float32", capacity_factor=4.0)


@pytest.fixture(scope="module")
def mesh():
    return make_smoke_mesh()


def _ref_params(kw, seed):
    return ref_moe.init_moe_params(jax.random.key(seed), RefCfg(**kw),
                                   jnp.float32)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "planted_ties", "all_equal",
                                  "zeros"])
def test_router_topk_matches_reference(case):
    rng = np.random.default_rng(0)
    probs = rng.random((3, 7, 10)).astype(np.float32)
    if case == "planted_ties":
        # the top value repeated at experts 2, 5 and 9 of every row, and a
        # tie at the k-th place
        probs[..., [2, 5, 9]] = 2.0
        probs[..., [0, 7]] = 1.5
    elif case == "all_equal":
        probs[:] = 0.1
    elif case == "zeros":
        probs[:] = 0.0                    # the renormalisation's clamp
    for k in (1, 3, 4):
        rw, ri = ref_moe.router_topk(jnp.asarray(probs), k)
        w, i = moe.router_topk(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _ref_dispatch(ids, e, cap):
    st, sv = jax.vmap(lambda r: ref_moe._dispatch_indices(r, e, cap))(
        jnp.asarray(ids, jnp.int32))
    return np.asarray(st), np.asarray(sv)


def _intended_dispatch(ids, e, cap):
    """The capacity semantics in numpy: each expert keeps its first ``cap``
    pairs in pair order; a dropped pair writes nothing."""
    g, t = ids.shape
    slot_pair = np.zeros((g, e * cap), np.int64)
    valid = np.zeros((g, e * cap), bool)
    pair_slot = np.full((g, t), -1, np.int64)
    for r in range(g):
        fill = np.zeros(e, np.int64)
        for p in range(t):
            x = ids[r, p]
            if fill[x] < cap:
                slot = x * cap + fill[x]
                slot_pair[r, slot], valid[r, slot] = p, True
                pair_slot[r, p] = slot
                fill[x] += 1
    return slot_pair, valid, pair_slot


@pytest.mark.parametrize("g,t,e,cap,seed", [
    (1, 12, 4, 12, 0), (3, 40, 8, 40, 1), (4, 96, 16, 24, 2),
    (2, 6, 64, 1, 3),                   # decode: six distinct experts, C = 1
])
def test_dispatch_matches_reference_without_overflow(g, t, e, cap, seed):
    rng = np.random.default_rng(seed)
    if cap == 1:
        ids = np.stack([rng.permutation(e)[:t] for _ in range(g)])
    else:
        ids = rng.integers(0, e, (g, t))
    counts = np.stack([np.bincount(r, minlength=e) for r in ids])
    assert counts.max() <= cap                  # no expert overflows
    st, sv = _ref_dispatch(ids, e, cap)
    slot_pair, valid, pair_slot = moe._dispatch_indices(
        torch.from_numpy(ids), e, cap)
    np.testing.assert_array_equal(slot_pair.numpy(), st)
    np.testing.assert_array_equal(valid.numpy(), sv)
    want = _intended_dispatch(ids, e, cap)
    for got, w in zip((slot_pair, valid, pair_slot), want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_drops_overflow_without_writing(seed):
    """Experts picked more often than their capacity: the port keeps each
    expert's first pairs and drops the rest (a numpy statement of it), and
    the reference's drops overwrite slot 0 of a full expert with pair 0."""
    ids = np.asarray([[0, 1, 1, 1, 2, 1, 1]])
    st, sv = _ref_dispatch(ids, 3, 2)
    np.testing.assert_array_equal(st, [[0, 0, 0, 2, 4, 0]])   # [1, 2] lost
    np.testing.assert_array_equal(sv, [[True, False, True, True, True,
                                        False]])
    got = moe._dispatch_indices(torch.from_numpy(ids), 3, 2)
    np.testing.assert_array_equal(got[0].numpy(), [[0, 0, 1, 2, 4, 0]])
    np.testing.assert_array_equal(got[2].numpy(),
                                  [[0, 2, 3, -1, 4, -1, -1]])
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, (3, 50)) ** 2 // 3   # skewed: 0 and 1 overflow
    want = _intended_dispatch(ids, 6, 5)
    got = moe._dispatch_indices(torch.from_numpy(ids), 6, 5)
    assert (want[2] == -1).sum() > 0
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), w)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("over", [{}, dict(n_shared_experts=0),
                                  dict(top_k=3, n_routed_experts=6)])
def test_moe_ffn_matches_reference(mesh, seed, over):
    """Output and aux loss at the "moe" config (capacity factor 4.0: no
    expert overflows at these shapes)."""
    kw = dict(MOE, **over)
    params = _ref_params(kw, seed)
    x = np.random.default_rng(seed).standard_normal((3, 20, 64)).astype(
        np.float32)
    with jax.set_mesh(mesh):
        ref_out, ref_aux = ref_moe.moe_ffn(params, jnp.asarray(x),
                                           RefCfg(**kw), base_rules(mesh))
    out, aux = moe.moe_ffn(_to_torch(params), torch.from_numpy(x),
                           TransformerConfig(**kw))
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **LAYER)
    np.testing.assert_allclose(float(aux), float(ref_aux), **LAYER)


def _moe_loop(params, x, cfg):
    """The layer one token at a time in numpy (float64): each choice an
    expert keeps (its first ``capacity`` (token, choice) pairs of the row)
    adds its weight times the expert's SwiGLU; shared experts always."""
    silu = lambda z: z / (1 + np.exp(-z))     # noqa: E731
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    x = x.astype(np.float64)
    b, s, d = x.shape
    cap = moe.expert_capacity(s, cfg)
    logits = x @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    for r in range(b):
        fill = np.zeros(cfg.n_routed_experts, int)
        for t in range(s):
            top = np.argsort(-probs[r, t], kind="stable")[:cfg.top_k]
            w = probs[r, t, top] / probs[r, t, top].sum()
            for j, ex in enumerate(top):
                if fill[ex] < cap:
                    fill[ex] += 1
                    e = {n: p["experts"][n][ex] for n in p["experts"]}
                    h = silu(x[r, t] @ e["w_gate"]) * (x[r, t] @ e["w_up"])
                    out[r, t] += w[j] * (h @ e["w_down"])
    if cfg.n_shared_experts:
        sp = p["shared"]
        out += (silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return out


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 4.0])
def test_moe_ffn_capacity_semantics(capacity_factor):
    """At a capacity factor that overflows experts, the layer is the
    token-by-token statement of the capacity semantics (and at 4.0, where
    nothing overflows, the same statement holds)."""
    kw = dict(MOE, capacity_factor=capacity_factor)
    cfg = TransformerConfig(**kw)
    params = _ref_params(kw, 3)
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(
        np.float32)
    out, _ = moe.moe_ffn(_to_torch(params), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), _moe_loop(params, x, cfg),
                               **LAYER)


def test_moe_ffn_bf16_runs_in_the_input_dtype():
    kw = dict(MOE, dtype="bfloat16")
    cfg = TransformerConfig(**kw)
    params = moe.init_moe_params(cfg, torch.bfloat16, torch.device("cpu"),
                                 torch.Generator().manual_seed(0))
    assert params["router"].dtype == torch.float32
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(1))
    out, aux = moe.moe_ffn(params, x.to(torch.bfloat16), cfg)
    want, want_aux = moe.moe_ffn(
        jax.tree.map(lambda t: t.float(), params), x.to(torch.bfloat16)
        .float(), dataclasses.replace(cfg, dtype="float32"))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    # the bf16 layer against its float32 twin on the same (bf16) values:
    # a few bf16 roundings of the products
    torch.testing.assert_close(out.float(), want, rtol=5e-2, atol=5e-2)
    assert abs(float(aux) - float(want_aux)) <= 1e-3


def test_init_and_axes_match_reference():
    kw = MOE
    tree = jax.eval_shape(lambda k: ref_moe.init_moe_params(
        k, RefCfg(**kw), jnp.bfloat16), jax.random.key(0))
    port = moe.init_moe_params(TransformerConfig(**kw), torch.bfloat16,
                               torch.device("cpu"),
                               torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).split(".")[1]), port)
    assert got == shapes
    assert moe.moe_param_axes(TransformerConfig(**kw)) == \
        ref_moe.moe_param_axes(RefCfg(**kw))
    no_shared = dict(kw, n_shared_experts=0)
    assert moe.moe_param_axes(TransformerConfig(**no_shared)) == \
        ref_moe.moe_param_axes(RefCfg(**no_shared))
    std = float(port["experts"]["w_down"].float().std())
    assert abs(std / 32 ** -0.5 - 0.8796) < 0.02   # truncated at +-2 sigma
