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
from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk
from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
from repro_torch.kernels.pq_scan import ops as pq_ops
from repro_torch.kernels.pq_scan.ops import pq_adc_topk
from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref
from repro_torch.kernels.topk import merge_tile_candidates, stable_topk

TOL = dict(rtol=1e-5, atol=1e-5)


def _int_mat(rng, *shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _assert_same(port, ref):
    pv, pi = (np.asarray(x) for x in port)
    rv, ri = (np.asarray(x) for x in ref)
    assert pi.shape == ri.shape
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, **TOL)


def _tile_emulation(scores: torch.Tensor, k: int, tile: int = 256):
    """The CUDA kernels' decomposition in plain torch: per tile of `tile`
    rows a (value desc, row asc) sort, its first L = min(k, tile) kept, then
    the wrapper's stable merge."""
    qn, n = scores.shape
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    s = torch.cat([scores, torch.full((qn, pad), -3e38)], 1) if pad else scores
    rows = torch.arange(n_tiles * tile, dtype=torch.int32).expand(qn, -1)
    topl = min(k, tile)
    v, pos = torch.sort(s.reshape(qn, n_tiles, tile), dim=2,
                        descending=True, stable=True)
    r = torch.gather(rows.reshape(qn, n_tiles, tile), 2, pos.to(torch.int64))
    return merge_tile_candidates(v[:, :, :topl].reshape(qn, -1),
                                 r[:, :, :topl].reshape(qn, -1), k)


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
    """Per-tile top-L + stable merge (what the CUDA kernel and its wrapper
    compute) equals the plain top-k, ties included, for k below, at and
    above the tile width."""
    rng = np.random.default_rng(k)
    q, c = _int_mat(rng, 5, 8, lo=-1, hi=2), _int_mat(rng, 1100, 8, lo=-1,
                                                      hi=2)
    from repro_torch.kernels.ivf_scan.ref import scores_ref
    s = scores_ref(torch.from_numpy(q), torch.from_numpy(c), "l2")
    tv, ti = _tile_emulation(s, k)
    pv, pi = ivf_scan_topk_ref(torch.from_numpy(q), torch.from_numpy(c), k)
    np.testing.assert_array_equal(ti.numpy(), pi.numpy())
    np.testing.assert_array_equal(tv.numpy(), pv.numpy())


def test_ivf_scan_on_cpu_never_launches():
    """A CPU tensor takes the plain version; the launch count stays put."""
    before = ivf_ops.launches.n
    rng = np.random.default_rng(0)
    ivf_scan_topk(torch.from_numpy(_int_mat(rng, 2, 8)),
                  torch.from_numpy(_int_mat(rng, 50, 8)), 5)
    assert ivf_ops.launches.n == before


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


def test_pq_tile_decomposition_equals_plain():
    rng = np.random.default_rng(9)
    luts, codes = _pq_inputs(rng, 3, 900, 4, 4)       # heavy ties
    from repro_torch.kernels.pq_scan.ref import pq_scores_ref
    s = pq_scores_ref(torch.from_numpy(luts), torch.from_numpy(codes))
    for k in (5, 256, 900):
        tv, ti = _tile_emulation(s, k)
        pv, pi = pq_adc_topk_ref(torch.from_numpy(luts),
                                 torch.from_numpy(codes), k)
        np.testing.assert_array_equal(ti.numpy(), pi.numpy())
        np.testing.assert_array_equal(tv.numpy(), pv.numpy())


def test_pq_scan_on_cpu_never_launches():
    before = (pq_ops.launches.n, pq_ops.ext_launches.n)
    rng = np.random.default_rng(1)
    luts, codes = _pq_inputs(rng, 2, 30, 2, 4)
    pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes), 4)
    pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes), 4,
                bias=torch.zeros(30))
    assert (pq_ops.launches.n, pq_ops.ext_launches.n) == before


def test_pq_cscores_without_row_bucket_raises():
    with pytest.raises(ValueError):
        pq_adc_topk(torch.zeros(1, 2, 4), torch.zeros(3, 2,
                                                      dtype=torch.uint8),
                    2, cscores=torch.zeros(1, 2))
