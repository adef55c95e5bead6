"""Two-sided kernel tests: the port's scan wrappers against the reference.

Inputs come from a numpy seed and go to both packages.  The reference runs
as tests/test_kernels.py runs it: the Pallas kernel in interpret mode
(``force_pallas=True``, k <= 64) and its XLA twin.  The port's wrappers take
their plain PyTorch version here, because the tensors lie on the CPU; the
CUDA kernels themselves run in tests/test_torch_cuda.py, which skips on a
host without a card.

Tolerances: ids must be identical.  Scores agree within rtol=atol=1e-5,
the slack of float32 sums taken in another order (XLA's dot vs torch's);
with integer-valued inputs those sums are exact and ids cannot flip on a
rounding difference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ivf_scan.ops import ivf_scan_topk as ivf_ref_jax
from repro.kernels.pq_scan.ops import pq_adc_topk as pq_ref_jax
from repro.kernels.topk_merge.ops import merge_topk_dev as merge_ref_jax
from repro.kernels.topk_merge.ref import merge_topk_ref as merge_ref_np
from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk
from repro_torch.kernels.ivf_scan.ref import (ivf_scan_select_ref,
                                              ivf_scan_topk_ref)
from repro_torch.kernels.pq_scan import ops as pq_ops
from repro_torch.kernels.pq_scan.ops import pq_adc_topk
from repro_torch.kernels.pq_scan.ref import pq_adc_select_ref, pq_adc_topk_ref
from repro_torch.kernels.topk import (order_keys, radix_select_ref,
                                      sort_survivors, stable_topk)
from repro_torch.kernels.topk_merge import ops as merge_ops
from repro_torch.kernels.topk_merge.ops import merge_topk_dev
from repro_torch.kernels.topk_merge.ref import (merge_select_ref,
                                               merge_topk_ref)

TOL = dict(rtol=1e-5, atol=1e-5)


def _int_mat(rng, *shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _assert_same(port, ref):
    pv, pi = (np.asarray(x) for x in port)
    rv, ri = (np.asarray(x) for x in ref)
    assert pi.shape == ri.shape
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, **TOL)


# ---------------------------------------------------------------------------
# ivf_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qn,n,d,k,metric", [
    (4, 300, 16, 8, "l2"), (3, 513, 32, 16, "ip"), (5, 1000, 8, 64, "l2"),
    (2, 128, 16, 1, "cosine"), (7, 777, 24, 10, "l2"),
])
def test_ivf_scan_matches_pallas_kernel(qn, n, d, k, metric):
    rng = np.random.default_rng(qn * 1000 + n)
    q, c = _int_mat(rng, qn, d), _int_mat(rng, n, d)
    ref = ivf_ref_jax(jnp.asarray(q), jnp.asarray(c), k, metric=metric,
                      force_pallas=True)
    port = ivf_scan_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                         metric=metric)
    _assert_same(port, ref)


@pytest.mark.parametrize("k", [65, 300, 999])
def test_ivf_scan_large_k_matches_xla_twin(k):
    """k past the reference's k <= 64 kernel gate: the twin is the
    reference there, and the port serves every k <= n_valid."""
    rng = np.random.default_rng(k)
    q, c = _int_mat(rng, 6, 16), _int_mat(rng, 999, 16)
    ref = ivf_ref_jax(jnp.asarray(q), jnp.asarray(c), k)
    port = ivf_scan_topk(torch.from_numpy(q), torch.from_numpy(c), k)
    _assert_same(port, ref)


@pytest.mark.parametrize("n_valid", [1, 255, 256, 300])
def test_ivf_scan_n_valid_masks_tail(n_valid):
    rng = np.random.default_rng(n_valid)
    q, c = _int_mat(rng, 3, 8), _int_mat(rng, 512, 8)
    ref = ivf_ref_jax(jnp.asarray(q), jnp.asarray(c), 16, n_valid=n_valid,
                      force_pallas=True)
    port = ivf_scan_topk(torch.from_numpy(q), torch.from_numpy(c), 16,
                         n_valid=n_valid)
    _assert_same(port, ref)
    assert int(np.asarray(port[1]).max()) < n_valid


def test_ivf_scan_duplicate_rows_tie_to_lower_row():
    """Exact duplicates tie: the lower row goes first, as lax.top_k."""
    rng = np.random.default_rng(5)
    base = _int_mat(rng, 40, 8)
    c = np.concatenate([base, base, base])       # every row three times
    q = _int_mat(rng, 4, 8)
    port = ivf_scan_topk(torch.from_numpy(q), torch.from_numpy(c), 30)
    ref = ivf_ref_jax(jnp.asarray(q), jnp.asarray(c), 30, force_pallas=True)
    _assert_same(port, ref)
    v, i = (np.asarray(x) for x in port)
    for row_v, row_i in zip(v, i):
        for a in range(len(row_v) - 1):
            if row_v[a] == row_v[a + 1]:
                assert row_i[a] < row_i[a + 1]


@pytest.mark.parametrize("k", [1, 10, 64, 256, 700])
def test_ivf_tile_decomposition_equals_plain(k):
    """The CUDA route in plain torch (the scores, the radix selection of
    each row's k survivors in row order, their stable sort) equals the
    plain top-k bitwise and the JAX package's ivf_scan_topk (its Pallas
    kernel in interpret mode where k <= 64, else its XLA twin), heavy ties
    included, for k from 1 past the old 256-row tile."""
    rng = np.random.default_rng(k)
    q, c = _int_mat(rng, 5, 8, lo=-1, hi=2), _int_mat(rng, 1100, 8, lo=-1,
                                                      hi=2)
    from repro_torch.kernels.ivf_scan.ref import scores_ref
    s = scores_ref(torch.from_numpy(q), torch.from_numpy(c), "l2")
    got = sort_survivors(*radix_select_ref(s, c.shape[0], k), k)
    pv, pi = ivf_scan_topk_ref(torch.from_numpy(q), torch.from_numpy(c), k)
    np.testing.assert_array_equal(got[1].numpy(), pi.numpy())
    np.testing.assert_array_equal(got[0].numpy(), pv.numpy())
    _assert_same(got, ivf_ref_jax(jnp.asarray(q), jnp.asarray(c), k,
                                  force_pallas=k <= 64))


def test_ivf_scan_on_cpu_never_launches():
    """A CPU tensor takes the plain version; the launch count stays put."""
    before = ivf_ops.launches.n
    rng = np.random.default_rng(0)
    ivf_scan_topk(torch.from_numpy(_int_mat(rng, 2, 8)),
                  torch.from_numpy(_int_mat(rng, 50, 8)), 5)
    assert ivf_ops.launches.n == before


def _select_case(name):
    """(q, corpus, k, n_valid, metric) of one selection case."""
    rng = np.random.default_rng(len(name))
    if name == "ties_across_tiles":
        # 40 rows repeated 40 times: every score ties 40 ways, the copies
        # 40 rows apart across the 256-row tiles; k cuts inside a tie group
        base = _int_mat(rng, 40, 4, lo=-1, hi=2)
        return _int_mat(rng, 4, 4, lo=-1, hi=2), np.tile(base, (40, 1)), \
            333, -1, "l2"
    if name == "all_equal_rows":
        return _int_mat(rng, 3, 8), np.zeros((600, 8), np.float32), 250, \
            -1, "l2"
    if name == "k_one":
        return _int_mat(rng, 5, 8), _int_mat(rng, 2000, 8), 1, -1, "l2"
    if name == "k_is_n_valid":
        return _int_mat(rng, 3, 8), _int_mat(rng, 1537, 8), 1500, 1500, "l2"
    if name == "k_past_256_tiles":
        # survivors spread over more than 256 tiles of 256 rows
        return _int_mat(rng, 2, 4, lo=-1, hi=2), \
            _int_mat(rng, 70_000, 4, lo=-1, hi=2), 65_600, -1, "l2"
    if name == "padding_rows":
        # the rows past n_valid copy the queries: they would score best
        q = _int_mat(rng, 3, 8)
        c = np.concatenate([_int_mat(rng, 777, 8), np.repeat(q, 80, 0)])
        return q, c, 700, 777, "l2"
    if name == "integer_ip":
        return _int_mat(rng, 4, 16, lo=-9, hi=10), \
            _int_mat(rng, 3000, 16, lo=-9, hi=10), 900, -1, "ip"
    raise KeyError(name)


SELECT_CASES = ["ties_across_tiles", "all_equal_rows", "k_one",
                "k_is_n_valid", "k_past_256_tiles", "padding_rows",
                "integer_ip"]


@pytest.mark.parametrize("case", SELECT_CASES)
def test_radix_select_matches_stable_topk(case):
    """The CUDA route's selection (threshold by radix select, then the
    rows above it and the first rows at it) in plain torch, against the
    full stable sort."""
    q, c, k, n_valid, metric = _select_case(case)
    q, c = torch.from_numpy(q), torch.from_numpy(c)
    got = ivf_scan_select_ref(q, c, k, metric=metric, n_valid=n_valid)
    want = ivf_scan_topk_ref(q, c, k, metric=metric, n_valid=n_valid)
    _assert_same(got, want)
    assert got[1].dtype == torch.int32
    assert int(got[1].max()) < (n_valid if n_valid >= 0 else c.shape[0])


@pytest.mark.parametrize("case", SELECT_CASES)
def test_radix_select_matches_reference(case):
    """The same selection against the JAX package's ivf_scan_topk (its
    Pallas kernel in interpret mode where k <= 64, else its XLA twin)."""
    q, c, k, n_valid, metric = _select_case(case)
    ref = ivf_ref_jax(jnp.asarray(q), jnp.asarray(c), k, metric=metric,
                      n_valid=n_valid, force_pallas=k <= 64)
    got = ivf_scan_select_ref(torch.from_numpy(q), torch.from_numpy(c), k,
                              metric=metric, n_valid=n_valid)
    _assert_same(got, ref)


def test_radix_select_keeps_row_order_and_signed_zeros():
    """Survivors come out in column order; -0 and +0 tie (the first in
    column order wins), and -inf / huge values sort where they belong."""
    s = torch.tensor([[0.0, -0.0, 5.0, -1.0, -np.inf, 2.0 ** 120, -0.0, 0.0]])
    vals, cols = radix_select_ref(s, 8, 4)
    assert cols.tolist() == [[0, 1, 2, 5]]
    assert vals.tolist() == [[0.0, -0.0, 5.0, 2.0 ** 120]]
    vals, cols = radix_select_ref(s, 7, 6)
    assert cols.tolist() == [[0, 1, 2, 3, 5, 6]]
    keys = order_keys(torch.tensor([-np.inf, -1.0, -0.0, 0.0, 1e-30, 2.0]))
    assert keys.tolist() == sorted(keys.tolist())
    assert keys[2] == keys[3]


def test_stable_topk_breaks_ties_by_index():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf, -np.inf]])
    v, i = stable_topk(s, 6)
    assert i.tolist() == [[1, 2, 4, 3, 0, 5]]


# ---------------------------------------------------------------------------
# pq_scan (plain and extended)
# ---------------------------------------------------------------------------


def _pq_inputs(rng, qn, n, m, ksub, integer=True):
    luts = (rng.integers(-8, 9, (qn, m, ksub)).astype(np.float32) if integer
            else rng.standard_normal((qn, m, ksub)).astype(np.float32))
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    return luts, codes


@pytest.mark.parametrize("qn,n,m,ksub,k", [
    (3, 300, 4, 16, 8), (4, 513, 8, 256, 64), (2, 1000, 16, 32, 10),
    (5, 64, 2, 4, 64),
])
def test_pq_scan_matches_pallas_kernel(qn, n, m, ksub, k):
    rng = np.random.default_rng(n + m)
    luts, codes = _pq_inputs(rng, qn, n, m, ksub)
    ref = pq_ref_jax(jnp.asarray(luts), jnp.asarray(codes), k,
                     force_pallas=True)
    port = pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes), k)
    _assert_same(port, ref)


@pytest.mark.parametrize("k", [65, 800])
def test_pq_scan_large_k_float_luts_match_twin_bitwise(k):
    """Float LUTs: the sum order j = 0..M-1 is the twin's, so scores agree
    bitwise, not just within tolerance."""
    rng = np.random.default_rng(k)
    luts, codes = _pq_inputs(rng, 4, 1500, 16, 64, integer=False)
    rv, ri = pq_ref_jax(jnp.asarray(luts), jnp.asarray(codes), k)
    pv, pi = pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("force_pallas,k", [(True, 16), (False, 200)])
def test_pq_ext_bias_cterm_matches_reference(force_pallas, k):
    rng = np.random.default_rng(k)
    qn, n, mb = 4, 700, 6
    luts, codes = _pq_inputs(rng, qn, n, 8, 32)
    bias = rng.integers(-5, 6, n).astype(np.float32)
    rb = rng.integers(0, mb, n).astype(np.int32)
    cs = rng.integers(-9, 10, (qn, mb)).astype(np.float32)
    ref = pq_ref_jax(jnp.asarray(luts), jnp.asarray(codes), k,
                     bias=jnp.asarray(bias), row_bucket=jnp.asarray(rb),
                     cscores=jnp.asarray(cs), force_pallas=force_pallas)
    port = pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes), k,
                       bias=torch.from_numpy(bias),
                       row_bucket=torch.from_numpy(rb),
                       cscores=torch.from_numpy(cs))
    _assert_same(port, ref)


@pytest.mark.parametrize("force_pallas,k", [(True, 32), (False, 120)])
def test_pq_ext_probe_mask_starved_queries(force_pallas, k):
    """Queries probing fewer than k rows pad their tail with (-inf, -1)."""
    rng = np.random.default_rng(3 + k)
    qn, n, mb = 5, 400, 8
    luts, codes = _pq_inputs(rng, qn, n, 4, 16)
    rb = np.sort(rng.integers(0, mb, n)).astype(np.int32)
    pm = np.zeros((qn, mb), bool)
    pm[0, :] = True
    pm[1, 0] = True                  # starved: one bucket only
    pm[3, [2, 5]] = True
    pm[4, 7] = True
    ref = pq_ref_jax(jnp.asarray(luts), jnp.asarray(codes), k,
                     row_bucket=jnp.asarray(rb), probe_mask=jnp.asarray(pm),
                     force_pallas=force_pallas)
    port = pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes), k,
                       row_bucket=torch.from_numpy(rb),
                       probe_mask=torch.from_numpy(pm))
    _assert_same(port, ref)
    v, i = (np.asarray(x) for x in port)
    assert np.all((i == -1) == ~np.isfinite(v))
    assert np.all(i[2] == -1)        # query 2 probes nothing


def _pq_route_case(name):
    """(luts, codes, k, n_valid, extended inputs) of one case of the kernel
    route, numpy arrays."""
    rng = np.random.default_rng(len(name) + 9)
    if name.startswith("heavy_ties"):
        luts, codes = _pq_inputs(rng, 3, 900, 4, 4)    # 4^4 distinct codes
        return luts, codes, int(name.split("_")[-1]), -1, {}
    if name == "float_luts_k_past_256":
        luts, codes = _pq_inputs(rng, 4, 1500, 16, 64, integer=False)
        return luts, codes, 700, -1, {}
    if name == "padding_rows":
        luts, codes = _pq_inputs(rng, 3, 1000, 8, 16)
        codes[777:] = codes[:223]                      # the tail ties the head
        return luts, codes, 300, 777, {}
    if name == "k_one":
        luts, codes = _pq_inputs(rng, 5, 2000, 8, 16)
        return luts, codes, 1, -1, {}
    if name == "ext_bias_cterm":
        qn, n, mb = 4, 700, 6
        luts, codes = _pq_inputs(rng, qn, n, 8, 32)
        return luts, codes, 200, -1, dict(
            bias=rng.integers(-5, 6, n).astype(np.float32),
            row_bucket=rng.integers(0, mb, n).astype(np.int32),
            cscores=rng.integers(-9, 10, (qn, mb)).astype(np.float32))
    if name == "starved_probe_mask":
        qn, n, mb = 5, 400, 8
        luts, codes = _pq_inputs(rng, qn, n, 4, 16)
        pm = np.zeros((qn, mb), bool)
        pm[0, :] = True
        pm[1, 0] = True                                # fewer rows than k
        pm[3, [2, 5]] = True
        pm[4, 7] = True
        return luts, codes, 120, -1, dict(
            row_bucket=np.sort(rng.integers(0, mb, n)).astype(np.int32),
            probe_mask=pm)
    raise KeyError(name)


PQ_ROUTE_CASES = ["heavy_ties_5", "heavy_ties_256", "heavy_ties_900",
                  "float_luts_k_past_256", "padding_rows", "k_one",
                  "ext_bias_cterm", "starved_probe_mask"]


@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("case", PQ_ROUTE_CASES)
def test_pq_tile_decomposition_equals_plain(case, segments):
    """The CUDA route in plain torch (scores with non-probed rows at NEG,
    the radix selection of the survivors in row order, each row whole or
    cut into segments as with few queries, their stable sort, NEG back to
    (-inf, -1)) equals the plain top-k bitwise and the JAX package's
    pq_adc_topk (its Pallas kernel in interpret mode where k <= 64, else
    its XLA twin), ties, padding and starved queries included."""
    luts, codes, k, nv, ext = _pq_route_case(case)
    n_valid = nv if nv >= 0 else codes.shape[0]
    n_seg = max(1, min(segments, n_valid // (k + 3)))
    t_ext = {key: torch.from_numpy(a) for key, a in ext.items()}
    got = pq_adc_select_ref(torch.from_numpy(luts), torch.from_numpy(codes),
                            k, n_valid=nv, n_seg=n_seg, **t_ext)
    want = pq_adc_topk_ref(torch.from_numpy(luts), torch.from_numpy(codes),
                           k, n_valid=nv, **t_ext)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    ref = pq_ref_jax(jnp.asarray(luts), jnp.asarray(codes), k, n_valid=nv,
                     force_pallas=k <= 64,
                     **{key: jnp.asarray(a) for key, a in ext.items()})
    _assert_same(got, ref)
    if "probe_mask" in ext:                       # query 1: one bucket
        n0 = int((ext["row_bucket"] == 0).sum())
        assert n0 < k
        assert (got[1][1, n0:] == -1).all() and (got[1][1, :n0] >= 0).all()


def test_pq_scan_on_cpu_never_launches():
    before = (pq_ops.launches.n, pq_ops.ext_launches.n)
    rng = np.random.default_rng(1)
    luts, codes = _pq_inputs(rng, 2, 30, 2, 4)
    pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes), 4)
    pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes), 4,
                bias=torch.zeros(30))
    assert (pq_ops.launches.n, pq_ops.ext_launches.n) == before


@pytest.mark.parametrize("qn,m,ksub,slots", [
    (1, 16, 256, 1), (6, 16, 256, 1), (7, 16, 256, 4), (256, 16, 256, 4),
    (256, 8, 16, 4), (256, 64, 256, 1), (256, 256, 256, None),
])
def test_pq_query_slots(qn, m, ksub, slots):
    """Query slots of a scoring block: 4 past 6 queries where four LUTs fit
    shared memory, else 1; a LUT that does not fit alone raises."""
    if slots is None:
        with pytest.raises(ValueError):
            pq_ops.query_slots(qn, m, ksub)
    else:
        assert pq_ops.query_slots(qn, m, ksub) == slots


def test_pq_cscores_without_row_bucket_raises():
    with pytest.raises(ValueError):
        pq_adc_topk(torch.zeros(1, 2, 4), torch.zeros(3, 2,
                                                      dtype=torch.uint8),
                    2, cscores=torch.zeros(1, 2))


# ---------------------------------------------------------------------------
# topk_merge (k-way shard reduce)
# ---------------------------------------------------------------------------


def _merge_inputs(p, qn, kk, pad_frac=0.0, seed=0, id_base=0):
    """Per-shard top-k windows with optional (-inf, -1) tail padding, as
    tests/test_kernels.py makes them (``id_base`` lifts the ids)."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((p, qn, kk)).astype(np.float32)
    vals = -np.sort(-vals, axis=2)
    ids = rng.integers(0, 10_000, (p, qn, kk)).astype(np.int64) + id_base
    if pad_frac > 0:
        n_pad = max(1, int(kk * pad_frac))
        vals[:, :, kk - n_pad:] = -np.inf
        ids[:, :, kk - n_pad:] = -1
    return vals, ids


def _merge_port(vals, ids, k, n_valid=-1):
    v, i = merge_topk_dev(torch.from_numpy(vals), torch.from_numpy(ids), k,
                          n_valid=n_valid)
    return v.numpy(), i.numpy()


def _assert_merge_same(port, *refs):
    pv, pi = port
    for ref in refs:
        rv, ri = (np.asarray(x) for x in ref)
        assert pi.shape == ri.shape
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pv, rv)      # the merge does no sums


def _merge_case(name):
    """The reference's test_topk_merge_* inputs: (vals, ids, k, n_valid)."""
    if name.startswith("shapes"):
        p, qn, kk, k = (int(x) for x in name.split("_")[1:])
        return (*_merge_inputs(p, qn, kk, seed=p * 100 + qn), k, -1)
    if name == "padded_shards":
        return (*_merge_inputs(2, 8, 10, pad_frac=0.8, seed=3), 10, -1)
    if name == "all_padding_shard":
        vals, ids = _merge_inputs(3, 6, 8, seed=5)
        vals[1], ids[1] = -np.inf, -1
        return vals, ids, 8, -1
    if name == "everything_padding":
        return (np.full((2, 3, 4), -np.inf, np.float32),
                np.full((2, 3, 4), -1, np.int64), 4, -1)
    if name.startswith("n_valid"):
        nv = int(name.split("_")[-1])
        return (*_merge_inputs(4, 5, 5, seed=nv), 16, nv)
    if name == "tie_order":
        return (np.zeros((3, 4, 6), np.float32),
                np.arange(72).reshape(3, 4, 6).astype(np.int64), 9, -1)
    if name == "kernel_blocks":
        return (*_merge_inputs(4, 130, 16, pad_frac=0.25, seed=9), 16, -1)
    raise KeyError(name)


MERGE_CASES = ["shapes_2_1_1_1", "shapes_2_4_10_10", "shapes_8_16_10_10",
               "shapes_4_130_16_7", "shapes_3_8_5_32", "padded_shards",
               "all_padding_shard", "everything_padding", "n_valid_1",
               "n_valid_7", "n_valid_13", "n_valid_19", "tie_order",
               "kernel_blocks"]


@pytest.mark.parametrize("case", MERGE_CASES)
def test_topk_merge_matches_pallas_kernel(case):
    """The reference's test_topk_merge_* cases: the port's merge equals the
    Pallas kernel (interpret mode) and the numpy oracle, values bitwise."""
    vals, ids, k, nv = _merge_case(case)
    pallas = merge_ref_jax(jnp.asarray(vals), jnp.asarray(ids), k,
                           n_valid=nv, force_pallas=True)
    port = _merge_port(vals, ids, k, n_valid=nv)
    _assert_merge_same(port, pallas, merge_ref_np(vals, ids, k, n_valid=nv))
    pv, pi = port
    assert np.array_equal(pi == -1, ~np.isfinite(pv))
    if case == "padded_shards":      # 2 shards x 2 real rows < k = 10
        assert np.isinf(pv[:, 4:]).all() and (pi[:, 4:] == -1).all()
    if case == "all_padding_shard":  # 2 live shards x 8 rows >= k = 8
        assert (pi >= 0).all()
    if case == "tie_order":
        flat = np.transpose(ids, (1, 0, 2)).reshape(4, 18)
        np.testing.assert_array_equal(pi, flat[:, :9])


@pytest.mark.parametrize("p,qn,kk,k,pad", [(4, 5, 300, 1000, 0.3),
                                           (3, 7, 100, 65, 0.0),
                                           (8, 2, 40, 320, 0.5)])
def test_topk_merge_large_k_matches_xla_twin(p, qn, kk, k, pad):
    """k past the reference's k <= 64 kernel gate: the twin is the
    reference there, and the port serves every k <= n_valid."""
    vals, ids = _merge_inputs(p, qn, kk, pad_frac=pad, seed=k)
    ref = merge_ref_jax(jnp.asarray(vals), jnp.asarray(ids), k)
    _assert_merge_same(_merge_port(vals, ids, k), ref,
                       merge_ref_np(vals, ids, k))


def test_topk_merge_keeps_int64_ids():
    """Ids past 2**31 survive the merge (the reference's JAX runs without
    x64 and would cut them to int32)."""
    vals, ids = _merge_inputs(4, 6, 12, pad_frac=0.25, seed=2,
                              id_base=3 << 31)
    pv, pi = _merge_port(vals, ids, 20)
    assert pi.dtype == np.int64 and pi.max() > 2 ** 31
    _assert_merge_same((pv, pi), merge_ref_np(vals, ids, 20))


@pytest.mark.parametrize("p,qn,kk,k,n_valid,pad,id_dtype", [
    (2, 3, 10, 10, 20, 0.5, np.int64), (3, 4, 6, 9, 18, 0.0, np.int64),
    (4, 5, 64, 256, 256, 0.2, np.int64), (4, 3, 75, 40, 290, 0.4, np.int64),
    (8, 2, 125, 1000, 1000, 0.3, np.int64),
    (3, 2, 100, 300, 300, 0.0, np.int64),
    (5, 3, 130, 600, 640, 0.1, np.int64),
    (4, 6, 50, 120, 190, 0.3, np.int32),
])
def test_topk_merge_tile_decomposition_equals_plain(p, qn, kk, k, n_valid,
                                                    pad, id_dtype):
    """The CUDA route for wide windows in plain torch (columns clamped to
    CLAMP, the radix selection of the survivors in column order, their
    stable sort, -inf restored, ids gathered by column) equals the plain
    merge bitwise and the JAX package's numpy oracle, and its Pallas
    kernel (interpret mode) where k <= 64, ties, padding, an n_valid cut
    inside a shard, an odd shard count and int32 ids included.  (XLA's
    CPU top_k does not break ties by index when k is the whole row, so
    its twin is held on tie-free windows, in
    test_topk_merge_large_k_matches_xla_twin.)"""
    vals, ids = _merge_inputs(p, qn, kk, pad_frac=pad, seed=kk + k)
    ids = ids.astype(id_dtype)
    if p == 3:
        vals = np.round(vals)                          # heavy ties
    tv, ti = merge_select_ref(torch.from_numpy(vals), torch.from_numpy(ids),
                              k, n_valid=n_valid)
    pv, pi = merge_topk_ref(torch.from_numpy(vals), torch.from_numpy(ids),
                            k, n_valid=n_valid)
    assert ti.dtype == pi.dtype == torch.from_numpy(ids).dtype
    np.testing.assert_array_equal(ti.numpy(), pi.numpy())
    np.testing.assert_array_equal(tv.numpy(), pv.numpy())
    refs = [merge_ref_np(vals, ids, k, n_valid=n_valid)]
    if k <= 64:
        refs.append(merge_ref_jax(jnp.asarray(vals), jnp.asarray(ids), k,
                                  n_valid=n_valid, force_pallas=True))
    _assert_merge_same((tv.numpy(), ti.numpy()), *refs)


def test_topk_merge_on_cpu_never_launches():
    before = merge_ops.launches.n
    vals, ids = _merge_inputs(2, 3, 4, seed=1)
    _merge_port(vals, ids, 5)
    assert merge_ops.launches.n == before


# ---------------------------------------------------------------------------
# flash_attention / decode_attention (the LM's two attention kernels)
# ---------------------------------------------------------------------------

from repro.kernels.decode_attention.decode_attention import (  # noqa: E402
    decode_attention_pallas,
)
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_pallas,
)
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models.attention import chunked_attention as chunked_jax  # noqa: E402
from repro.models.attention import decode_attention as decode_jax  # noqa: E402
from repro.models.attention import repeat_kv as repeat_kv_jax  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    bf16_probs_slack,
    flash_attention_ref,
)

# float32 attention: the reference test's tolerance for the Pallas kernel
# against chunked_attention (sums in another order); bf16: test_kernels._tol
ATTN_F32 = dict(rtol=1e-4, atol=1e-4)
ATTN_BF16 = dict(rtol=2e-2, atol=2e-2)


def _attn_inputs(seed, b, s, h, kvh, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))


@pytest.mark.parametrize("b,s,h,d,bq,bkv", [
    (1, 128, 1, 32, 64, 64),
    (2, 256, 4, 64, 128, 128),
    (1, 512, 2, 128, 256, 128),
    (2, 256, 2, 64, 64, 256),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_chunked(b, s, h, d, bq, bkv, causal):
    """The shapes of test_kernels.test_flash_attention_shapes: the port's
    plain version against the Pallas kernel (interpret mode) and against
    the reference model's chunked_attention."""
    q, k, v = _attn_inputs(s + d, b, s, h, h, d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=bq,
                                    block_kv=bkv, interpret=True)
    chunked = chunked_jax(jq, jk, jv, causal=causal, block_kv=bkv)
    port = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=causal, block_kv=bkv)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **ATTN_F32)
    np.testing.assert_allclose(port.numpy(), np.asarray(chunked), **ATTN_F32)


@pytest.mark.parametrize("h,kvh", [(4, 1), (8, 2), (8, 8), (16, 2)])
@pytest.mark.parametrize("bf16_probs", [False, True])
def test_flash_plain_gqa_matches_repeat_kv(h, kvh, bf16_probs):
    """Grouped heads read in place equal the reference's chunked_attention
    on repeat_kv'd keys and values, with and without bf16 weights."""
    b, s, d = 2, 96, 32
    q, k, v = _attn_inputs(h * 10 + kvh, b, s, h, kvh, d)
    g = h // kvh
    ref = chunked_jax(jnp.asarray(q), repeat_kv_jax(jnp.asarray(k), g),
                      repeat_kv_jax(jnp.asarray(v), g), causal=True,
                      block_kv=32, bf16_probs=bf16_probs)
    port = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           bf16_probs=bf16_probs, block_kv=32)
    # bf16 weights: a one-ulp fp32 difference can round a weight to the
    # neighbouring bf16 value (2**-8 relative), so the bf16 tolerance holds
    np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                               **(ATTN_BF16 if bf16_probs else ATTN_F32))


def test_flash_plain_bf16_matches_pallas():
    q, k, v = _attn_inputs(5, 1, 256, 2, 2, 64)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref = flash_attention_pallas(*jx, interpret=True)
    port = flash_attention(*(torch.from_numpy(np.asarray(x, np.float32))
                             .to(torch.bfloat16) for x in jx))
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_BF16)


@pytest.mark.parametrize("s,block", [(100, 32), (64, 1024), (97, 97),
                                     (130, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_any_length_matches_exact(s, block, causal):
    """A sequence the key block does not divide (the Pallas kernel asserts
    there) agrees with the reference's materialised-scores oracle."""
    q, k, v = _attn_inputs(s, 2, s, 2, 2, 32)
    ref = attention_ref(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    port = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=causal, block_kv=block)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **ATTN_F32)


def _within(got, want, slack, rtol=1e-4, atol=1e-4):
    diff = (got.float() - want.float()).abs()
    return bool((diff <= atol + rtol * want.float().abs() + slack).all())


def test_flash_bf16_probs_slack_covers_weight_noise():
    """Weights that differ by float32 noise round to bf16 alike except on a
    bf16 midpoint: the slack covers the port against the reference's
    chunked_attention (XLA's exp) and against weights scaled by 1 + 2^-18,
    and without it those outputs fail the float32 limit."""
    b, s, h, kvh, d, blk = 2, 192, 4, 2, 32, 32
    q, k, v = _attn_inputs(11, b, s, h, kvh, d)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = flash_attention_ref(tq, tk, tv, bf16_probs=True, block_kv=blk)
    slack = bf16_probs_slack(tq, tk, tv, block_kv=blk)
    g = h // kvh
    jax_out = torch.from_numpy(np.array(chunked_jax(
        jnp.asarray(q), repeat_kv_jax(jnp.asarray(k), g),
        repeat_kv_jax(jnp.asarray(v), g), causal=True, block_kv=blk,
        bf16_probs=True)))
    noisy = flash_attention_ref(tq, tk, tv, scale=d ** -0.5 * (1 + 2 ** -18),
                                bf16_probs=True, block_kv=blk)
    for other in (jax_out, noisy):
        assert _within(other, want, slack)
    assert not _within(noisy, want, 0.0)
    assert float(slack.max()) < 2.0 ** -8 * float(np.abs(v).max())


@pytest.mark.parametrize("bf16_probs", [False, True])
def test_flash_limit_fails_a_dropped_key_tile(bf16_probs):
    """The card checks' limit (rtol 1e-2, atol 1e-4, plus the slack with
    bf16 weights) fails an output that lost 32 keys' values on the longest
    rows, as chip_smoke.py's planted fault does at full size."""
    b, s, h, kvh, d, blk = 1, 512, 4, 2, 64, 128
    q, k, v = _attn_inputs(12, b, s, h, kvh, d)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = flash_attention_ref(tq, tk, tv, bf16_probs=bf16_probs,
                               block_kv=blk)
    slack = bf16_probs_slack(tq, tk, tv, block_kv=blk) if bf16_probs else 0.0
    vf = tv.clone()
    vf[:, s // 2:s // 2 + 32] = 0
    bad = flash_attention_ref(tq, tk, vf, bf16_probs=bf16_probs, block_kv=blk)
    rows = slice(s - 64, s)
    sl = slack[:, rows] if bf16_probs else 0.0
    assert _within(want[:, rows], want[:, rows], sl, rtol=1e-2)
    assert not _within(bad[:, rows], want[:, rows], sl, rtol=1e-2)


def test_flash_rejects_unequal_lengths():
    """k and v of unequal lengths (or heads) do not fit; q may be shorter
    or longer than them (test_flash_plain_unequal_lengths_match_chunked)."""
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 12, 2, 16)
    with pytest.raises(ValueError, match="v \\[B,Skv,KVH,Dv\\]"):
        flash_attention(q, k, torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="v \\[B,Skv,KVH,Dv\\]"):
        flash_attention(q, k, torch.zeros(1, 12, 1, 16))
    with pytest.raises(ValueError, match="KVH must divide H"):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))


def _chunked_ref(q, k, v, causal, block_kv=None, bf16_probs=False):
    """The reference chunked_attention on repeat_kv'd k and v, numpy out."""
    g = q.shape[2] // k.shape[2]
    blk = block_kv or k.shape[1]
    return np.asarray(chunked_jax(
        jnp.asarray(q), repeat_kv_jax(jnp.asarray(k), g),
        repeat_kv_jax(jnp.asarray(v), g), causal=causal, block_kv=blk,
        bf16_probs=bf16_probs))


def _qkv(seed, b, sq, skv, h, kvh, d, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, dv)).astype(np.float32))


# the two-sided attention tests below: float32 sums in another order
ATTN_ABS = dict(rtol=0, atol=1e-5)


@pytest.mark.parametrize("sq,skv", [(4, 8), (16, 64), (1, 37)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_unequal_lengths_match_chunked(sq, skv, causal):
    """q shorter than k and v: its rows right-aligned at i + Skv - Sq, as
    the reference's chunked_attention places them."""
    q, k, v = _qkv(sq * 100 + skv, 2, sq, skv, 4, 2, 32, 32)
    port = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=causal, block_kv=8)
    assert port.shape == (2, sq, 4, 32)
    np.testing.assert_allclose(port.numpy(), _chunked_ref(q, k, v, causal),
                               **ATTN_ABS)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_longer_queries_match_chunked(causal):
    """q longer than k and v: under causal the rows at negative positions
    see no key, and the reference's -1e30 scores weigh every key alike."""
    q, k, v = _qkv(3, 1, 12, 4, 2, 1, 16, 16)
    port = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=causal, block_kv=3)
    np.testing.assert_allclose(port.numpy(), _chunked_ref(q, k, v, causal),
                               **ATTN_ABS)
    if causal:       # row 0 sits at position -8: the mean of the values
        np.testing.assert_allclose(port.numpy()[0, 0, 0], v[0, :, 0].mean(0),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("d,dv", [(32, 16), (192, 128), (16, 48)])
@pytest.mark.parametrize("bf16_probs", [False, True])
def test_flash_plain_value_width_matches_chunked(d, dv, bf16_probs):
    """v at its own width Dv (MLA's prefill: q and k at 192, v at 128)."""
    q, k, v = _qkv(d + dv, 2, 40, 40, 4, 2, d, dv)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    port = flash_attention(tq, tk, tv, bf16_probs=bf16_probs, block_kv=8)
    assert port.shape == (2, 40, 4, dv)
    want = torch.from_numpy(np.array(_chunked_ref(q, k, v, True, 8,
                                                  bf16_probs)))
    # bf16 weights: a weight within float32 noise of a bf16 midpoint may
    # round either way, by at most the slack
    slack = bf16_probs_slack(tq, tk, tv, block_kv=8) if bf16_probs else 0.0
    assert _within(port, want, slack, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d,dv", [(80, 80), (80, 48), (100, 7)])
def test_flash_plain_unlisted_width_matches_chunked(d, dv):
    """Widths the kernel is not compiled for (on the card they are padded
    with zero columns) agree with the reference at their own widths, the
    scale that of the true D."""
    q, k, v = _qkv(d, 1, 24, 24, 4, 1, d, dv)
    port = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(port.numpy(), _chunked_ref(q, k, v, True),
                               **ATTN_ABS)


@pytest.mark.parametrize("d,dv,want", [(16, 16, (16, 16)), (80, 80, (128, 128)),
                                       (192, 100, (192, 128)), (1, 200, (256, 256)),
                                       (161, 161, (192, 192)), (48, 16, (64, 64))])
def test_flash_pads_to_the_smallest_compiled_pair(d, dv, want):
    assert flash_ops.compiled_dims(d, dv) == want
    assert want in flash_ops.HEAD_DIMS


@pytest.mark.parametrize("d,dv", [(288, 288), (64, 320), (0, 16)])
def test_attention_rejects_heads_past_256(d, dv):
    """A deliberate narrowing: the kernels take head widths up to 256, so
    the port serves no wider head, on the CPU either."""
    with pytest.raises(ValueError, match="not served"):
        flash_attention(torch.zeros(1, 4, 2, d), torch.zeros(1, 4, 2, d),
                        torch.zeros(1, 4, 2, dv))
    if d:
        with pytest.raises(ValueError, match="not served"):
            decode_attention(torch.zeros(1, 1, 2, d), torch.zeros(1, 4, 2, d),
                             torch.zeros(1, 4, 2, dv), torch.tensor([1]))


def test_flash_on_cpu_never_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(flash_ops, "_launch",
                        lambda *a: calls.append(a) or pytest.fail("launched"))
    before = flash_ops.launches.n
    q, k, v = _attn_inputs(1, 1, 16, 2, 1, 16)
    flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert flash_ops.launches.n == before and not calls


# ---------------------------------------------------------------------------
# the flash-attention backward (plain version) and the forward's statistics
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref,
)
from repro_torch.models.attention import (  # noqa: E402
    chunked_attention as chunked_port,
)


def _bwd_inputs(seed, b, sq, skv, h, kvh, d, dv, dtype):
    """q, k, v, dO as numpy float32 (rounded to bf16 values for bf16)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, dv),
                        (b, sq, h, dv))]
    if dtype == "bfloat16":
        xs = [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
              for x in xs]
    return xs


def _jax_grads(q, k, v, do, causal, dtype, bf16_probs=False):
    """jax.grad of the reference's chunked_attention (repeat_kv'd k, v) at
    <dO, out>, in the inputs' dtype, as numpy float32."""
    import jax
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    g = q.shape[2] // k.shape[2]
    dof = jnp.asarray(do, jd).astype(jnp.float32)

    def f(q, k, v):
        out = chunked_jax(q, repeat_kv_jax(k, g), repeat_kv_jax(v, g),
                          causal=causal, block_kv=k.shape[1],
                          bf16_probs=bf16_probs)
        return jnp.sum(out.astype(jnp.float32) * dof)

    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x, jd)
                                              for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _torch(x, dtype):
    return torch.from_numpy(np.array(x)).to(getattr(torch, dtype))


def _bf16_ulp(x):
    """One bf16 ulp of |x| (2^-7 of the power of two at or below it)."""
    x = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7).astype(np.float32)


def _assert_grads_close(got, want, dtype):
    """float32: within 1e-5.  bf16: within two bf16 ulps of the tensor's
    largest gradient: one for rounding either side's float32 gradient to
    bf16, one for D = rowsum(dO o) taken from the forward's bf16 output o,
    where the reference differentiates through its float32 o (and, for dk
    and dv, sums the G heads of repeat_kv in bf16).  Measured: at most 1.125
    ulps over this file's cases."""
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:
            limit = 2 * _bf16_ulp(np.abs(w).max())
            assert np.abs(g - w).max() <= limit, float(np.abs(g - w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])          # G 1 and 4
@pytest.mark.parametrize("d,dv", [(32, 32), (48, 32), (192, 128)])
@pytest.mark.parametrize("sq,skv", [(24, 24), (12, 40), (40, 12)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_jax_grad_and_autograd(dtype, h, kvh, d, dv,
                                                       sq, skv, causal):
    """flash_attention_bwd_ref (fed the plain forward's o, m, l) against
    jax.grad of the reference's chunked_attention and torch autograd of
    flash_attention_ref: G = 1 and 4, a padded width (48), MLA's (192,
    128), Sq < Skv and Sq > Skv (rows that see no key under causal)."""
    q, k, v, do = _bwd_inputs(sq * 7 + skv + d + h, 2, sq, skv, h, kvh, d,
                              dv, dtype)
    tq, tk, tv, tdo = (_torch(x, dtype) for x in (q, k, v, do))
    o, m, l = flash_attention(tq, tk, tv, causal=causal, block_kv=7,
                              return_stats=True)
    got = flash_attention_bwd(tq, tk, tv, o, m, l, tdo, causal=causal,
                              block_kv=5)
    assert [x.dtype for x in got] == [tq.dtype] * 3
    assert [x.shape for x in got] == [tq.shape, tk.shape, tv.shape]
    _assert_grads_close(got, _jax_grads(q, k, v, do, causal, dtype), dtype)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = flash_attention_ref(*leaves, causal=causal, block_kv=9)
    (out.float() * tdo.float()).sum().backward()
    _assert_grads_close(got, [x.grad.float().numpy() for x in leaves], dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_autograd_uses_the_backward(causal):
    """The model's chunked_attention under autograd (the forward with its
    statistics, flash_attention_bwd as the gradient) against the
    reference's jax.grad; no graph without gradients."""
    q, k, v, do = _bwd_inputs(31, 2, 20, 20, 8, 2, 32, 32, "float32")
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = chunked_port(*leaves, causal=causal, block_kv=8)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    _assert_grads_close([x.grad for x in leaves],
                        _jax_grads(q, k, v, do, causal, "float32"),
                        "float32")
    with torch.no_grad():
        assert chunked_port(*leaves, causal=causal).grad_fn is None


def test_flash_bwd_bf16_probs_is_the_unrounded_gradient():
    """With bf16_probs the forward rounds its weights to bf16 and the
    backward recomputes them in float32: dv is the unrounded function's
    gradient (jax.grad with float32 weights, within 1e-5); dq and dk lie
    within 2^-8 of their largest value from it, since D = rowsum(dO o)
    takes the forward's o, whose weights moved by at most 2^-9 of
    themselves (measured: ~1e-3); and all three within 2^-7 of the largest
    value from jax.grad through the rounded weights (measured: ~4e-3)."""
    q, k, v, do = _bwd_inputs(41, 2, 64, 64, 4, 2, 32, 32, "float32")
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = chunked_port(*leaves, causal=True, block_kv=16, bf16_probs=True)
    out.backward(torch.from_numpy(do))
    got = [x.grad.numpy() for x in leaves]
    unrounded = _jax_grads(q, k, v, do, True, "float32")
    np.testing.assert_allclose(got[2], unrounded[2], rtol=0, atol=1e-5)
    for g, w in zip(got[:2], unrounded[:2]):
        assert np.abs(g - w).max() <= 2.0 ** -8 * np.abs(w).max()
    rounded = _jax_grads(q, k, v, do, True, "float32", bf16_probs=True)
    for g, w in zip(got, rounded):
        assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max()


# the limit the card holds the bf16 backward kernel to (chip_smoke.py's
# BWD_TOL): |delta| <= rtol |want| + atol max |want| of the tensor
BWD_BF16_TOL = (1e-2, 2.0 ** -10)


def _bwd_over_limit(got, want):
    """For each of dq, dk, dv: the largest |delta| over its limit (> 1
    fails)."""
    rtol, atol = BWD_BF16_TOL
    return [float(((g.float() - w.float()).abs()
                   / (rtol * w.float().abs()
                      + atol * w.float().abs().max())).max())
            for g, w in zip(got, want)]


def _bwd_rounding_case(seed, **terms):
    """The float32 plain gradient of a causal GQA case in bf16 (S = 1,024,
    8 query heads on 2 key heads of 64) and the same with the kernel's
    operand rounding (flash_attention_bwd_ref's p_terms, ds_terms)."""
    q, k, v, do = (_torch(x, "bfloat16") for x in _bwd_inputs(
        seed, 1, 1024, 1024, 8, 2, 64, 64, "bfloat16"))
    o, m, l = flash_attention(q, k, v, return_stats=True)
    return (flash_attention_bwd_ref(q, k, v, o, m, l, do, **terms),
            flash_attention_bwd_ref(q, k, v, o, m, l, do))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flash_bwd_kernel_rounding_within_the_card_limit(seed):
    """The bf16 kernel's operand rounding, emulated in plain torch: P
    enters dv and dS enters dq and dk as bf16 hi + lo (p_terms=2,
    ds_terms=2).  Against the float32 plain gradient of the same bf16
    inputs it stays within the card's limit, three seeds.  The rounding
    must move the result, or the case would guard nothing."""
    got, want = _bwd_rounding_case(seed, p_terms=2, ds_terms=2)
    assert any(not torch.equal(g, w) for g, w in zip(got, want))
    assert max(_bwd_over_limit(got, want)) <= 1.0


def test_flash_bwd_p_as_one_bf16_term_breaks_the_card_limit():
    """Why the kernel keeps P's lo term: P rounded once to bf16 before
    P^T dO (p_terms=1) puts dv past the card's limit on this seed, while
    dq and dk, whose dS keeps two terms, stay within it."""
    got, want = _bwd_rounding_case(7, p_terms=1, ds_terms=2)
    over = _bwd_over_limit(got, want)
    assert over[0] <= 1.0 and over[1] <= 1.0 and over[2] > 1.0, over


@pytest.mark.parametrize("causal", [True, False])
def test_flash_stats_are_the_row_max_and_sum(causal):
    """m = the row's largest scaled score (-1e30 for a row that sees no
    key), l = sum of exp(score - m), from scores built outright."""
    q, k, v, _ = _bwd_inputs(5, 1, 12, 8, 4, 2, 16, 16, "float32")
    _, m, l = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, block_kv=3, return_stats=True)
    kk = np.repeat(k, 2, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) * 16 ** -0.5
    if causal:
        s = np.where(np.arange(12)[:, None] + 8 - 12 >= np.arange(8)[None],
                     s, -1e30)
    want_m = s.max(-1)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=1e-6)
    np.testing.assert_allclose(
        l.numpy(), np.exp(s - want_m[..., None]).sum(-1), rtol=1e-5)
    if causal:                  # rows 0-3 sit before key 0: weights 1 / 8
        assert (m.numpy()[:, :, :4] == np.float32(-1e30)).all()
        np.testing.assert_array_equal(l.numpy()[:, :, :4], 8.0)


@pytest.mark.parametrize("d,dv", [(288, 288), (64, 320)])
def test_flash_bwd_rejects_heads_past_256(d, dv):
    z = torch.zeros
    with pytest.raises(ValueError, match="not served"):
        flash_attention_bwd(z(1, 4, 2, d), z(1, 4, 2, d), z(1, 4, 2, dv),
                            z(1, 4, 2, dv), z(1, 2, 4), z(1, 2, 4),
                            z(1, 4, 2, dv))


def test_flash_launch_wrappers_refuse_cpu_tensors():
    """The card paths' own checks run (and refuse CPU tensors) before any
    library is loaded."""
    q, k, v, do = (torch.from_numpy(x) for x in _bwd_inputs(
        3, 1, 16, 16, 2, 1, 16, 16, "float32"))
    o, m, l = flash_attention(q, k, v, return_stats=True)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_ops._launch(q, k, v, True, 0.25, False, True)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_ops._launch_bwd(q, k, v, o, m, l, do, True, 0.25)


def test_flash_bwd_on_cpu_never_launches(monkeypatch):
    monkeypatch.setattr(flash_ops, "_launch_bwd",
                        lambda *a: pytest.fail("launched"))
    before = flash_ops.bwd_launches.n
    q, k, v, do = (torch.from_numpy(x) for x in _bwd_inputs(
        2, 1, 16, 16, 2, 1, 16, 16, "float32"))
    o, m, l = flash_attention(q, k, v, return_stats=True)
    flash_attention_bwd(q, k, v, o, m, l, do)
    assert flash_ops.bwd_launches.n == before


@pytest.mark.parametrize("b,s,h,kvh,d,splits,bs", [
    (1, 512, 4, 4, 64, 1, 512),
    (2, 2048, 8, 2, 64, 4, 256),
    (2, 1024, 16, 8, 128, 2, 512),
    (4, 4096, 8, 1, 64, 8, 512),
])
def test_decode_plain_matches_pallas_and_model(b, s, h, kvh, d, splits, bs):
    """The shapes of test_kernels.test_decode_attention_shapes: the port's
    plain version against the Pallas kernel (interpret mode) and the
    reference model's grouped decode_attention."""
    rng = np.random.default_rng(s + h)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    pos = rng.integers(1, s, b).astype(np.int32)
    jx = [jnp.asarray(x) for x in (q, k, v, pos)]
    pallas = decode_attention_pallas(*jx, n_splits=splits, block_s=bs,
                                     interpret=True)
    model = decode_jax(*jx)
    port = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, pos)))
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **ATTN_F32)
    np.testing.assert_allclose(port.numpy(), np.asarray(model), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pos", [[0, 0], [255, 0], [255, 255], [300, 17]])
def test_decode_plain_edge_positions(pos):
    """pos = 0 (one key), pos = S - 1 (every key) and pos past S (every key;
    the model's cache write drops such a row) agree with the reference."""
    rng = np.random.default_rng(sum(pos))
    q = rng.standard_normal((2, 1, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    ref = decode_jax(*(jnp.asarray(x) for x in (q, k, v, p)))
    port = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, p)))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if pos[0] == 0:
        # one visible key: the output is that key's value row
        np.testing.assert_allclose(port.numpy()[0, 0, :4], v[0, 0, 0][None]
                                   .repeat(4, 0), rtol=1e-6, atol=1e-6)


def test_decode_plain_bf16_matches_pallas():
    rng = np.random.default_rng(9)
    q = jnp.asarray(rng.standard_normal((2, 1, 4, 64)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((2, 1024, 2, 64)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((2, 1024, 2, 64)), jnp.bfloat16)
    pos = jnp.asarray([100, 900], jnp.int32)
    ref = decode_attention_pallas(q, k, v, pos, n_splits=2, interpret=True)
    port = decode_attention(*(torch.from_numpy(np.asarray(x, np.float32))
                              .to(torch.bfloat16) for x in (q, k, v)),
                            torch.from_numpy(np.array(pos)))
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **ATTN_BF16)


def test_decode_split_partials_combine_to_plain():
    """The CUDA design in plain torch: each row's visible keys [0, pos]
    cut into chunks of C keys (the last one shorter), each chunk's partial
    (m, l, acc) taken in stages of 64 keys with one online-softmax step a
    stage, and only the row's ceil(n_vis / C) chunks combined as the
    reference's epilogue does, equals the plain version, Dv != D and pos
    past S included."""
    rng = np.random.default_rng(4)
    b, s, h, kvh, d, dv, c, tk = 4, 1000, 8, 2, 32, 24, 256, 64
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kvh, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kvh, dv))
                         .astype(np.float32))
    pos = torch.tensor([0, 3, 500, s + 5], dtype=torch.int32)
    g = h // kvh
    qg = (q * d ** -0.5).reshape(b, kvh, g, d)
    out = torch.zeros(b, kvh, g, dv)
    for bi in range(b):
        n_vis = min(s, int(pos[bi]) + 1)
        parts = []
        for lo in range(0, n_vis, c):          # chunks past n_vis: no block
            m = torch.full((kvh, g), -1e30)
            l = torch.zeros(kvh, g)
            acc = torch.zeros(kvh, g, dv)
            for t0 in range(lo, min(lo + c, n_vis), tk):
                t1 = min(t0 + tk, lo + c, n_vis)
                sc = torch.einsum("kgd,skd->kgs", qg[bi], k[bi, t0:t1])
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "kgs,skd->kgd", p, v[bi, t0:t1])
                m = m_new
            parts.append((m, l, acc))
        assert len(parts) == -(-n_vis // c)
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        w = torch.exp(m - m.amax(0))
        out[bi] = (acc * w[..., None]).sum(0) / torch.clamp(
            (l * w).sum(0), min=1e-30)[..., None]
    np.testing.assert_allclose(out.reshape(b, 1, h, dv).numpy(),
                               decode_attention_ref(q, k, v, pos).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,kvh,d,dv", [
    (8, 2, 64, 32),      # Dv != D
    (16, 2, 192, 128),   # MLA's widths
    (32, 2, 64, 64),     # G = 16
    (8, 4, 96, 96),      # a width the old kernel did not take
    (24, 1, 20, 36),     # G = 24 (two row groups on the card), odd widths
])
def test_decode_plain_widths_and_groups_match_reference(h, kvh, d, dv):
    """Dv != D, G past 8 and widths outside the old kernel's list, against
    the reference model's decode_attention and, where v has q's width, the
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(h + d + dv)
    b, s = 3, 300
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, dv)).astype(np.float32)
    pos = np.asarray([s - 1, 0, 137], np.int32)
    jx = [jnp.asarray(x) for x in (q, k, v, pos)]
    port = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, pos)))
    assert port.shape == (b, 1, h, dv)
    np.testing.assert_allclose(port.numpy(), np.asarray(decode_jax(*jx)),
                               rtol=0, atol=1e-5)
    if d == dv:
        pallas = decode_attention_pallas(*jx, n_splits=3, block_s=100,
                                         interpret=True)
        np.testing.assert_allclose(port.numpy(), np.asarray(pallas), rtol=0,
                                   atol=1e-5)


def test_decode_on_cpu_never_launches(monkeypatch):
    monkeypatch.setattr(decode_ops, "_launch",
                        lambda *a: pytest.fail("launched"))
    before = decode_ops.launches.n
    decode_attention(torch.zeros(1, 1, 4, 16), torch.zeros(1, 8, 2, 16),
                     torch.zeros(1, 8, 2, 16), torch.tensor([3]))
    assert decode_ops.launches.n == before
