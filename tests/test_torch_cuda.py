"""The port's CUDA kernels and its device path on the card, against the
plain versions and the CPU run of the same port.

Every test here needs a CUDA card and ``nvcc`` and skips without one.  The
file imports torch and the port only, so it also runs on a host without
JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Integer-valued inputs make every float32 sum exact, so the kernels must
agree with the plain versions bitwise, ties included; PQ sums run in the
plain version's order and agree bitwise on float inputs too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk
from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
from repro_torch.kernels.pq_scan import ops as pq_ops
from repro_torch.kernels.pq_scan.ops import pq_adc_topk
from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the CUDA kernels cannot "
                    "run on the CPU")
    return torch.device("cuda")


def _int(rng, *shape, lo=-3, hi=4):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


def _one_hot(rng, rows, d):
    x = np.zeros((rows, d), np.float32)
    x[np.arange(rows), rng.integers(0, d, rows)] = rng.integers(1, 6, rows)
    return torch.from_numpy(x)


@pytest.mark.parametrize("qn,n,d,k,metric,n_valid", [
    (37, 5000, 128, 10, "l2", 4999), (8, 257, 16, 300, "ip", 257),
    (300, 3000, 64, 64, "l2", 2900), (5, 1000, 32, 256, "cosine", 1000),
    (9, 700, 128, 700, "l2", 700),
])
def test_ivf_kernel_matches_plain(cuda, qn, n, d, k, metric, n_valid):
    rng = np.random.default_rng(n + k)
    q, c = _int(rng, qn, d).to(cuda), _int(rng, n, d).to(cuda)
    if metric == "cosine":
        # one nonzero per row: normalising is exact, so are the scores
        q, c = (_one_hot(rng, rows, d).to(cuda) for rows in (qn, n))
    before = ivf_ops.launches.n
    kv, ki = ivf_scan_topk(q, c, k, metric=metric, n_valid=n_valid)
    pv, pi = ivf_scan_topk_ref(q, c, min(k, n_valid), metric=metric,
                               n_valid=n_valid)
    torch.cuda.synchronize()
    assert ivf_ops.launches.n == before + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


def test_ivf_kernel_duplicate_rows_tie_to_lower_row(cuda):
    rng = np.random.default_rng(1)
    base = _int(rng, 300, 32)
    c = torch.cat([base, base, base]).to(cuda)
    q = _int(rng, 11, 32).to(cuda)
    kv, ki = ivf_scan_topk(q, c, 40)
    pv, pi = ivf_scan_topk_ref(q, c, 40)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("k", [10, 256, 800])
def test_pq_kernels_match_plain(cuda, k):
    rng = np.random.default_rng(k)
    qn, n, mb = 19, 6000, 9
    luts = torch.randn(qn, 16, 256, generator=torch.Generator().manual_seed(k))
    luts = luts.to(cuda)
    codes = torch.from_numpy(rng.integers(0, 256, (n, 16)).astype(
        np.uint8)).to(cuda)
    before = (pq_ops.launches.n, pq_ops.ext_launches.n)
    kv, ki = pq_adc_topk(luts, codes, k, n_valid=n - 3)
    pv, pi = pq_adc_topk_ref(luts, codes, k, n_valid=n - 3)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    rb = torch.from_numpy(rng.integers(0, mb, n).astype(np.int32)).to(cuda)
    pm = torch.from_numpy(rng.random((qn, mb)) < 0.3)
    pm[0] = False                                  # a starved query
    ext = dict(bias=torch.randn(n, device=cuda), row_bucket=rb,
               cscores=torch.randn(qn, mb, device=cuda),
               probe_mask=pm.to(cuda))
    kv, ki = pq_adc_topk(luts, codes, k, **ext)
    pv, pi = pq_adc_topk_ref(luts, codes, k, **ext)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert bool((ki[0] == -1).all())
    assert (pq_ops.launches.n, pq_ops.ext_launches.n) == \
        (before[0] + 1, before[1] + 1)


def test_index_on_card_matches_cpu(cuda):
    """One index state on the card and on the CPU: every search mode gives
    the same ids and scores."""
    from repro_torch.configs.pandadb import VectorIndexConfig
    from repro_torch.core.vector_index import IVFIndex
    rng = np.random.default_rng(3)
    n, d, m = 5000, 32, 8
    st = {"vectors": rng.integers(-3, 4, (n, d)).astype(np.float32),
          "centroids": rng.integers(-2, 3, (m, d)).astype(np.float32),
          "bucket_of": np.sort(rng.integers(0, m, n)),
          "ids": np.arange(n) * 3,
          "codebooks": rng.integers(-2, 3, (8, 16, 4)).astype(np.float32),
          "codes": rng.integers(0, 16, (n, 8)).astype(np.uint8)}
    for residual in (False, True):
        cfg = VectorIndexConfig(dim=d, pq_m=8, pq_bits=4, nprobe=3,
                                pq_residual=residual, rerank_mult=2)
        if residual:
            st["code_bias"] = rng.integers(-9, 9, n).astype(np.float32)
        on_card = IVFIndex.from_state(st, cfg, device=cuda)
        on_cpu = IVFIndex.from_state(st, cfg, device="cpu")
        q = rng.integers(-3, 4, (64, d)).astype(np.float32)
        for kw in (dict(mode="float"), dict(mode="adc"),
                   dict(mode="fused"), dict(mode="adc", rerank=False),
                   dict(mode="float", nprobe=m)):
            a = on_card.search_many(q, 50, **kw)
            b = on_cpu.search_many(q, 50, **kw)
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[0], b[0])


def test_query_on_card_matches_cpu(cuda):
    from repro_torch.core import PandaDB
    from repro_torch.core.aipm import feature_hash_extractor
    from repro_torch.data.synthetic_graph import SNBConfig, build_snb

    def make(device):
        db = PandaDB(device=device)
        db.register_extractor("face", feature_hash_extractor(dim=128))
        build_snb(db, SNBConfig(n_persons=800, n_identities=260))
        db.build_index("face", "photo")
        return db

    card, cpu = make(cuda), make("cpu")
    text = ("MATCH (n:Person)-[:knows]->(m:Person) WHERE n.photo->face ~: "
            "m.photo->face RETURN n.name, m.name")
    before = ivf_ops.launches.n
    assert card.query(text) == cpu.query(text)
    assert ivf_ops.launches.n > before
