"""Two-sided tests of the port's GNN family against the reference.

The same numpy-seeded inputs go through ``repro`` (JAX, on the CPU) and
``repro_torch`` (on the CPU, where ``gather_scatter`` takes its plain
version), with the reference's parameters loaded by
``gnn_params_from_jax``: the message-passing primitives, the six models'
logits and gradients, the Wigner matrices and spherical harmonics, the
neighbour sampler, the cells and sharding rules, and one
``gnn_train_step`` against the reference's ``gnn_bundle(...).fn``.

Tolerances: the primitives 1e-6 (the same float32 operations; the sums in
edge order on both sides, ``sym_norm_coeff``'s rsqrt to 2 ulps); logits
2e-5 absolute and gradients 1e-4 of the largest gradient of each leaf
(float32 products summed in another order by XLA and by torch; the Wigner
matrices' powers and complex64 rotations add a few ulps at l_max 6);
Wigner matrices and spherical harmonics at l <= 6 within 2e-5 (XLA's CPU
cos, sin and atan2 are not correctly rounded, and little_d sums powers up
to the 12th against coefficients up to ~1e3); the sampler's arrays
identical; the train step's loss, gradient norm and updated parameters
1e-4.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import GNNConfig as RefGNNConfig
from repro.configs.base import GraphShape as RefGraphShape
from repro.data import sampler as ref_sampler
from repro.launch import gnn_steps as ref_steps
from repro.launch.mesh import make_smoke_mesh
from repro.models.gnn import build_gnn as ref_build_gnn
from repro.models.gnn import common as ref_common
from repro.models.gnn import wigner as ref_wigner
from repro.training.optimizer import init_opt_state as ref_init_opt_state
from repro_torch.configs import get_arch
from repro_torch.configs.base import GNNConfig, GraphShape
from repro_torch.data import sampler
from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
from repro_torch.launch import gnn_steps
from repro_torch.models.gnn import build_gnn, common, gnn_params_from_jax
from repro_torch.models.gnn import wigner
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.tree import flatten_with_paths

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)


GNN_ARCHS = ["gcn-cora", "graphsage-reddit", "schnet", "equiformer-v2",
             "gat-bonus", "gin-bonus"]
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
PRIM = dict(rtol=0, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _graph(seed, n=40, e=160, d=12, masked=0.2, empty=3):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    # the last `empty` nodes get no edge; the others one at least
    dst = np.concatenate([np.arange(n - empty), rng.integers(
        0, n - empty, e - n + empty)]).astype(np.int32)
    mask = (rng.random(e) >= masked).astype(np.float32)
    return feats, pos, src, dst, mask


# ---------------------------------------------------------------------------
# configs and primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_gnn_configs_match_reference(name):
    ref, port = ref_get_arch(name), get_arch(name)
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert {k: dataclasses.asdict(v) for k, v in port.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.shapes.items()}
    assert (port.name, port.family, port.source) == \
        (ref.name, ref.family, ref.source)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("trail", [(), (3, 2)])
def test_gather_scatter_matches_reference(weighted, reduce, trail):
    """Sum, mean (dividing by every edge into a node, masked ones too) and
    max, with empty rows, masked edges and trailing feature dims."""
    rng = np.random.default_rng(1)
    n, e = 30, 120
    x = rng.standard_normal((n,) + trail).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 4, e).astype(np.int32)
    w = (rng.standard_normal(e) * (rng.random(e) > 0.3)).astype(np.float32)
    kw = {"edge_weight": w} if weighted else {}
    want = ref_common.gather_scatter(jnp.asarray(x), jnp.asarray(src),
                                     jnp.asarray(dst), n, reduce=reduce,
                                     **{k: jnp.asarray(v)
                                        for k, v in kw.items()})
    got = common.gather_scatter(_t(x), _t(src), _t(dst), n, reduce=reduce,
                                **{k: _t(v) for k, v in kw.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)
    if reduce == "max":
        assert np.isneginf(got.numpy()[n - 4:]).all()
    else:
        assert (got.numpy()[n - 4:] == 0).all()


def test_gather_scatter_mean_counts_masked_edges():
    """Node 0 gets a weight-1 and a weight-0 edge: the mean is half the
    weighted message, in both packages."""
    x = np.array([[2.0], [4.0], [8.0]], np.float32)
    src, dst = np.array([1, 2], np.int32), np.array([0, 0], np.int32)
    w = np.array([1.0, 0.0], np.float32)
    got = common.gather_scatter(_t(x), _t(src), _t(dst), 3, _t(w), "mean")
    want = ref_common.gather_scatter(jnp.asarray(x), jnp.asarray(src),
                                     jnp.asarray(dst), 3, jnp.asarray(w),
                                     "mean")
    assert float(got[0, 0]) == float(want[0, 0]) == 2.0


def test_gather_scatter_plain_sums_in_edge_order():
    """The plain version's float32 rows are ((0 + m0) + m1) + ... in edge
    order, bit for bit: the order the kernel sums in, so the card's result
    can equal the CPU's."""
    rng = np.random.default_rng(2)
    n, e, d = 50, 2000, 7
    x = (rng.standard_normal((n, d)) * 10 ** rng.uniform(-3, 3, (n, 1))
         ).astype(np.float32)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.standard_normal(e).astype(np.float32)
    want = np.zeros((n, d), np.float32)
    for i in range(e):
        want[dst[i]] = want[dst[i]] + x[src[i]] * w[i]
    got = gather_scatter_ref(_t(x), _t(src), _t(dst), n, _t(w))
    assert np.array_equal(got.numpy(), want)


def test_gather_scatter_reversed_plain_sums_in_edge_order():
    """The gradient's exact yardstick: the plain sum over the reversed edges
    with the mean's per-edge weights ``w / max(count_dst, 1)`` adds each
    row of d x in edge order, bit for bit (the order the kernel's backward
    sums in over the CSR by source), and agrees with the plain version's
    autograd gradient, which on the CPU adds in another order, within 1e-5
    of each element's sum |w g|."""
    rng = np.random.default_rng(4)
    n, e, d = 40, 1500, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    g = (rng.standard_normal((n, d)) * 10 ** rng.uniform(-3, 3, (n, 1))
         ).astype(np.float32)
    src = rng.integers(0, n, e)
    src[::3] = 11                                  # a hub source
    dst = rng.integers(0, n - 3, e)
    w = (rng.standard_normal(e) * (rng.random(e) > 0.2)).astype(np.float32)
    count = np.maximum(np.bincount(dst, minlength=n), 1).astype(np.float32)
    for reduce in ("sum", "mean"):
        ws = w / count[dst] if reduce == "mean" else w
        want = np.zeros((n, d), np.float32)
        for i in range(e):
            want[src[i]] = want[src[i]] + g[dst[i]] * ws[i]
        got = gather_scatter_ref(_t(g), _t(dst), _t(src), n, _t(ws), "sum")
        assert np.array_equal(got.numpy(), want), reduce
        xg = _t(x).requires_grad_()
        (auto,) = torch.autograd.grad(
            gather_scatter_ref(xg, _t(src), _t(dst), n, _t(w), reduce), xg,
            _t(g))
        lim = 1e-5 * gather_scatter_ref(_t(np.abs(g)), _t(dst), _t(src), n,
                                        _t(np.abs(ws)), "sum")
        assert ((auto - got).abs() <= lim).all(), reduce


@pytest.mark.parametrize("n,e,empty,lead", [(60, 2000, 7, 3), (1, 50, 0, 0),
                                            (30, 0, 0, 0), (500, 300, 40, 9)])
def test_edge_csr_search_matches_bincount(n, e, empty, lead):
    """``_csr`` builds ``ptr`` by a search of the sorted keys (no host
    sync on the card): ``ptr``, ``perm`` and ``col`` identical to the
    ``bincount`` construction, with empty rows, ``lead`` empty rows first
    and ``empty`` last, in both directions."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    rng = np.random.default_rng(n + e)
    src = torch.from_numpy(rng.integers(0, n, e)).to(torch.int32)
    dst = torch.from_numpy(rng.integers(lead, max(n - empty, lead + 1), e)
                           ).to(torch.int32)
    for key, other in ((dst, src), (src, dst)):
        ptr, perm, col = gs_ops._csr(key, other, n)
        want_perm = torch.sort(key, stable=True).indices
        want_ptr = torch.zeros(n + 1, dtype=torch.int64)
        torch.cumsum(torch.bincount(key, minlength=n), 0, out=want_ptr[1:])
        assert ptr.dtype == torch.int64 and col.dtype == torch.int32
        assert torch.equal(ptr, want_ptr)
        assert torch.equal(perm, want_perm)
        assert torch.equal(col, other[want_perm].to(torch.int32))


@pytest.mark.parametrize("n,e,long_min", [(1000, 3000, 64), (90, 3000, 544),
                                          (10, 20_000, 1024), (200, 0, 64)])
def test_edge_csr_lists_long_rows(n, e, long_min):
    """Each CSR lists its rows of at least ``long_row_min`` edges (16 times
    the mean row, taken as at least 4, at most LONG_ROW), in index order,
    first in ``long_rows``, with their number in ``n_long``: a row of
    exactly the threshold is long, one edge fewer is not, each way."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    assert gs_ops.long_row_min(e, n) == long_min
    assert gs_ops.long_row_min(61_859_328, 2_449_029) == 16 * 26
    assert gs_ops.long_row_min(10_752, 2_708) == 64
    assert gs_ops.long_row_min(10 ** 9, 10 ** 6) == gs_ops.LONG_ROW
    rng = np.random.default_rng(n + e)
    # rows n - 2 and n - 1 take exactly long_min and long_min - 1 edges
    # each way, where the graph has that many; the rest avoid them
    plant = min(e // 2, long_min)
    rest = e - 2 * plant + (plant > 0)
    key = np.concatenate([np.full(plant, n - 2),
                          np.full(max(plant - 1, 0), n - 1),
                          rng.integers(0, n - 2, rest)])
    src, dst = rng.permutation(key), rng.permutation(key)
    csr = gs_ops.EdgeCSR.build(_t(src).to(torch.int32),
                               _t(dst).to(torch.int32), n)
    for rows, k in ((csr.rows, dst), (csr.transposed(), src)):
        cnt = np.bincount(k, minlength=n)
        want = np.flatnonzero(cnt >= long_min)
        if plant == long_min:
            assert n - 2 in want and n - 1 not in want
        got = int(rows.n_long[0])
        assert rows.long_min == long_min and rows.n_long.dtype == torch.int32
        assert got == want.size
        assert np.array_equal(rows.long_rows[:got].numpy(), want)


def test_segment_softmax_and_mean_match_reference():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((100, 2)).astype(np.float32)
    scores[:5] = -np.inf                           # a segment of -inf only
    seg = np.concatenate([np.zeros(5), rng.integers(1, 10, 95)]).astype(
        np.int32)
    got = common.segment_softmax(_t(scores), _t(seg), 12)
    want = ref_common.segment_softmax(jnp.asarray(scores), jnp.asarray(seg),
                                      12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)
    data = rng.standard_normal((100, 3)).astype(np.float32)
    np.testing.assert_allclose(
        common.segment_mean(_t(data), _t(seg), 12).numpy(),
        np.asarray(ref_common.segment_mean(jnp.asarray(data),
                                           jnp.asarray(seg), 12)), **PRIM)


def test_degree_and_sym_norm_match_reference():
    _, _, src, dst, mask = _graph(4)
    for m in (None, mask):
        kw_t = {} if m is None else {"edge_mask": _t(m)}
        kw_j = {} if m is None else {"edge_mask": jnp.asarray(m)}
        np.testing.assert_array_equal(
            common.degree(_t(dst), 40, **kw_t).numpy(),
            np.asarray(ref_common.degree(jnp.asarray(dst), 40, **kw_j)))
        np.testing.assert_allclose(
            common.sym_norm_coeff(_t(src), _t(dst), 40, **kw_t).numpy(),
            np.asarray(ref_common.sym_norm_coeff(jnp.asarray(src),
                                                 jnp.asarray(dst), 40,
                                                 **kw_j)), rtol=3e-7, atol=0)


def test_chunked_gather_scatter_matches_reference():
    feats, _, src, dst, mask = _graph(5, e=96)

    def msg_ref(rows, s, d):
        return rows * 2.0 + jnp.asarray(d, jnp.float32)[:, None]

    def msg_port(rows, s, d):
        return rows * 2.0 + d.to(torch.float32)[:, None]

    want = ref_common.chunked_gather_scatter(
        jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst), 40, msg_ref,
        32, (12,), jnp.asarray(mask))
    got = common.chunked_gather_scatter(_t(feats), _t(src), _t(dst), 40,
                                        msg_port, 32, (12,), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)


# ---------------------------------------------------------------------------
# the six models
# ---------------------------------------------------------------------------

MODELS = {
    "gcn": dict(kind="gcn"),
    "graphsage": dict(kind="graphsage"),
    "graphsage_max": dict(kind="graphsage", aggregator="max"),
    "gin": dict(kind="gin"),
    "gat": dict(kind="gat", n_heads=2, d_hidden=4),
    "schnet": dict(kind="schnet", n_rbf=16, cutoff=8.0),
    "equiformer_l2": dict(kind="equiformer_v2", l_max=2, m_max=1, n_heads=2,
                          n_rbf=8, cutoff=5.0),
    "equiformer_l6": dict(kind="equiformer_v2", l_max=6, m_max=2, n_heads=2,
                          n_rbf=8, cutoff=5.0, d_hidden=4),
}
#: run in ``test_torch_equiformer.py``, beside the chunked path's tests
EQUIFORMER = ["equiformer_l2", "equiformer_l6"]


def _pair(name, d_in=12, n_out=3, seed=0):
    kw = dict(dict(n_layers=2, d_hidden=8, n_classes=n_out), **MODELS[name])
    ref = ref_build_gnn(RefGNNConfig(**kw))
    params = ref.init(jax.random.key(seed), d_in, n_out)
    port = build_gnn(GNNConfig(**kw), d_in, n_out, device="cpu")
    gnn_params_from_jax(port, jax.tree.map(np.asarray, params))
    return ref, params, port


def _grads_close(port, grads_tree, rtol=1e-4):
    """Each reference gradient leaf against the port's, unstacked where
    the reference stacks layers; within rtol of the leaf's largest."""
    grads = {n: p.grad for n, p in port.named_parameters()}
    stacked = {"schnet": "interactions", "equiformer_v2": "layers"}.get(
        port.cfg.kind)
    seen = 0
    for path, g in flatten_with_paths(jax.tree.map(np.asarray,
                                                   grads_tree)).items():
        top, _, rest = path.partition("/")
        parts = ([(f"{top}.{i}.{rest.replace('/', '.')}", g[i])
                  for i in range(g.shape[0])] if top == stacked
                 else [(path.replace("/", "."), g)])
        for name, want in parts:
            seen += 1
            scale = max(float(np.abs(want).max()), 1e-6)
            np.testing.assert_allclose(grads[name].numpy(), want, rtol=0,
                                       atol=rtol * scale, err_msg=name)
    assert seen == len(grads)


def check_model_against_reference(name):
    # GraphSAGE's max gives an empty row -inf, and its logits NaN, in both
    # packages: there every node gets an edge
    feats, pos, src, dst, mask = _graph(6, empty=0 if name.endswith("max")
                                        else 3)
    ref, params, port = _pair(name)
    args = (jnp.asarray(feats), jnp.asarray(pos), jnp.asarray(src),
            jnp.asarray(dst), jnp.asarray(mask), 40)
    # the logits and the gradient of sum(logits^2) from one trace
    want, vjp = jax.vjp(lambda p: ref.node_logits(p, *args), params)
    (grads,) = vjp(2.0 * want)
    got = port(_t(feats), _t(pos), _t(src), _t(dst), _t(mask), 40)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    got.square().sum().backward()
    _grads_close(port, grads)


@pytest.mark.parametrize("name", [m for m in MODELS if m not in EQUIFORMER])
def test_gnn_logits_and_grads_match_reference(name):
    check_model_against_reference(name)


def test_params_from_jax_rejects_a_mismatched_tree():
    ref, params, port = _pair("gin")
    tree = jax.tree.map(np.asarray, params)
    tree["head"] = tree["head"][:, :2]
    with pytest.raises(ValueError, match="head"):
        gnn_params_from_jax(port, tree)
    del tree["layers"][1]
    with pytest.raises(ValueError, match="layers.1"):
        gnn_params_from_jax(port, tree)


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_build_model_builds_each_gnn_on_the_cpu_only_when_asked(
        name, monkeypatch):
    spec = get_arch(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(spec)
    cell = gnn_steps.cell_of(spec, spec.shapes["molecule"])
    model = gnn_steps.gnn_model(spec, cell, device="cpu")
    ref = ref_build_gnn(ref_get_arch(name).model)
    shapes = jax.eval_shape(lambda k: ref.init(k, cell.d_feat, cell.n_out),
                            jax.random.key(0))
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in model.parameters())


# ---------------------------------------------------------------------------
# Wigner matrices and spherical harmonics
# ---------------------------------------------------------------------------


def _directions():
    rng = np.random.default_rng(8)
    r = rng.standard_normal((24, 3))
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    eps = 1e-4
    special = np.array([[0, 0, 1], [0, 0, -1], [eps, 0, 1], [0, eps, -1],
                        [-1, 0, 0], [-1, 1e-7, 0], [-1, -1e-7, 0],
                        [1, 0, 0], [0, 1, 0]], np.float64)
    special /= np.linalg.norm(special, axis=1, keepdims=True)
    return np.concatenate([r, special]).astype(np.float32)


@pytest.mark.parametrize("l", range(7))
def test_edge_wigner_matches_reference(l):
    """At l <= 6, r̂ near +z and -z and on the -x axis (atan2's branch)
    included: within 2e-5 (entries are O(1))."""
    rhat = _directions()
    got = wigner.edge_wigner(l, _t(rhat)).numpy()
    want = np.asarray(ref_wigner.edge_wigner(l, jnp.asarray(rhat)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_real_sph_harm_matches_reference():
    rhat = _directions()
    got = wigner.real_sph_harm(6, _t(rhat)).numpy()
    want = np.asarray(ref_wigner.real_sph_harm(6, jnp.asarray(rhat)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    y = wigner.real_sph_harm(6, _t(rhat))
    yz = wigner.real_sph_harm(6, torch.tensor([[0.0, 0.0, 1.0]]))[0]
    for l, sl in enumerate(wigner.l_slices(6)):   # D^l takes r̂ to +z
        rot = torch.einsum("eij,ej->ei", wigner.edge_wigner(l, _t(rhat)),
                           y[:, sl])
        np.testing.assert_allclose(rot.numpy(), yz[sl].expand_as(rot),
                                   rtol=0, atol=5e-5)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def test_random_graph_and_sampler_blocks_equal_reference():
    g = sampler.random_graph(600, avg_degree=6, d_feat=10, n_classes=4,
                             seed=3)
    rg = ref_sampler.random_graph(600, avg_degree=6, d_feat=10, n_classes=4,
                                  seed=3)
    for field in ("ptr", "idx", "feats", "labels"):
        assert np.array_equal(getattr(g, field), getattr(rg, field)), field
    s = sampler.NeighborSampler(g, fanout=(5, 3), seed=4)
    rs = ref_sampler.NeighborSampler(rg, fanout=(5, 3), seed=4)
    blocks = [s.sample_block(np.arange(8))] + list(s.batches(16, 2))
    want = [rs.sample_block(np.arange(8))] + list(rs.batches(16, 2))
    for b, wb in zip(blocks, want):
        assert sorted(b) == sorted(wb)
        for k in b:
            assert b[k].dtype == wb[k].dtype and np.array_equal(b[k], wb[k])
    # an isolated node samples itself
    star = sampler.CSRGraph.from_edges(
        5, np.arange(4), np.full(4, 4, np.int64),
        np.zeros((5, 2), np.float32), np.zeros(5, np.int64))
    b = sampler.NeighborSampler(star, (3,)).sample_block(np.array([4, 1]))
    assert set(b["node_ids"][2:5].tolist()) <= {0, 1, 2, 3}
    assert (b["node_ids"][5:] == 1).all()


def test_power_law_edges_are_random_graphs_endpoints():
    rng = np.random.default_rng(11)
    src, dst = sampler.power_law_edges(rng, 300, 300 * 4)
    g = sampler.CSRGraph.from_edges(300, src, dst,
                                    np.zeros((300, 1), np.float32),
                                    np.zeros(300, np.int64))
    rg = ref_sampler.random_graph(300, 4, 1, 2, seed=11)
    assert np.array_equal(g.ptr, rg.ptr) and np.array_equal(g.idx, rg.idx)


# ---------------------------------------------------------------------------
# cells, rules and the train step
# ---------------------------------------------------------------------------

STAND_INS = {
    "1": dict(axis_names=("data", "model"), shape={"data": 1, "model": 1}),
    "2x4": dict(axis_names=("data", "model"), shape={"data": 2, "model": 4}),
}


@pytest.mark.parametrize("mesh", list(STAND_INS))
@pytest.mark.parametrize("name", GNN_ARCHS)
def test_cell_of_and_rules_match_reference(name, mesh):
    m = STAND_INS[mesh]
    port_mesh = SimpleNamespace(**m)
    ref_mesh = SimpleNamespace(**m, size=int(np.prod(list(
        m["shape"].values()))))
    for shape in SHAPES:
        cell = gnn_steps.cell_of(get_arch(name), get_arch(name).shapes[shape],
                                 port_mesh)
        want = ref_steps.cell_of(ref_get_arch(name),
                                 ref_get_arch(name).shapes[shape], ref_mesh)
        assert dataclasses.asdict(cell) == dataclasses.asdict(want), shape
        rules = gnn_steps.gnn_rules(port_mesh, shard_nodes=cell.shard_nodes,
                                    channel_shard=cell.channel_shard)
        ref_rules = ref_steps.gnn_rules(ref_mesh,
                                        shard_nodes=want.shard_nodes,
                                        channel_shard=want.channel_shard)
        assert rules.rules == ref_rules.rules, shape


@pytest.mark.parametrize("kind", ["node", "minibatch", "graph"])
def test_gnn_train_step_matches_reference_bundle(kind):
    """One step of the reference's ``gnn_bundle(...).fn`` on a one-device
    CPU mesh against ``gnn_train_step``: loss, gradient norm and every
    parameter after AdamW within 1e-4."""
    rng = np.random.default_rng(12)
    if kind == "graph":
        arch, shape = "schnet", dict(kind="batched", n_nodes=6, n_edges=10,
                                     batch_graphs=4, d_feat=0)
        over = dict(n_rbf=16, d_hidden=8, n_layers=2)
    else:
        arch = "graphsage-reddit"
        shape = (dict(kind="full_graph", n_nodes=50, n_edges=300, d_feat=9)
                 if kind == "node" else
                 dict(kind="minibatch", n_nodes=200, n_edges=1200, d_feat=9,
                      batch_nodes=4, fanout=(3, 2)))
        over = dict(d_hidden=16, n_classes=5)
    ref_spec = dataclasses.replace(
        ref_get_arch(arch), model=dataclasses.replace(
            ref_get_arch(arch).model, **over))
    spec = dataclasses.replace(get_arch(arch), model=dataclasses.replace(
        get_arch(arch).model, **over))
    ref_shape, port_shape = RefGraphShape("s", **shape), GraphShape("s", **shape)
    bundle = ref_steps.gnn_bundle(ref_spec, ref_shape, make_smoke_mesh())
    cell = gnn_steps.cell_of(spec, port_shape)
    assert dataclasses.asdict(cell) == bundle.meta["cell"]
    n, e = cell.n_nodes, cell.n_edges
    e_real = e - 7
    arrays = {"feats": rng.standard_normal((n, cell.d_feat)).astype(
                  np.float32),
              "src": rng.integers(0, n, e_real).astype(np.int32),
              "dst": rng.integers(0, n, e_real).astype(np.int32)}
    if cell.graph_level:
        arrays["graph_ids"] = np.repeat(np.arange(cell.n_graphs),
                                        n // cell.n_graphs).astype(np.int32)
        arrays["target"] = rng.standard_normal(cell.n_graphs).astype(
            np.float32)
        arrays["pos"] = rng.standard_normal((n, 3)).astype(np.float32)
    else:
        arrays["labels"] = rng.integers(-1, 5, n).astype(np.int32)
    batch = gnn_steps.gnn_batch(cell, arrays, "cpu")
    ref_batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    model = ref_build_gnn(ref_spec.model)
    params = model.init(jax.random.key(1), cell.d_feat, cell.n_out)
    port = gnn_steps.gnn_model(spec, cell, device="cpu")
    gnn_params_from_jax(port, jax.tree.map(np.asarray, params))
    new_params, _, met = bundle.fn(params, ref_init_opt_state(params),
                                   ref_batch)
    opt = init_opt_state(dict(port.named_parameters()))
    opt, got = gnn_steps.gnn_train_step(port, opt, batch, cell)
    assert int(opt["step"]) == 1
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(met[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    want = gnn_params_from_jax(
        gnn_steps.gnn_model(spec, cell, device="cpu"),
        jax.tree.map(np.asarray, new_params))
    for (name, p), (_, q) in zip(port.named_parameters(),
                                 want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_gnn_batch_pads_and_stores_big_graphs_in_bf16():
    cell = gnn_steps.GNNCell(n_nodes=600_000, n_edges=1024, d_feat=2,
                             n_out=3, needs_pos=False, shard_nodes=False,
                             channel_shard=False, chunk=None)
    batch = gnn_steps.gnn_batch(cell, {
        "feats": np.ones((599_990, 2), np.float32),
        "src": np.arange(1000, dtype=np.int32),
        "dst": np.arange(1000, dtype=np.int32),
        "labels": np.zeros(599_990, np.int32)}, "cpu")
    assert batch["feats"].dtype == torch.bfloat16
    assert batch["feats"].shape == (600_000, 2)
    assert batch["edge_mask"].sum() == 1000 and batch["src"].shape == (1024,)
    assert (batch["labels"][599_990:] == -1).all()
