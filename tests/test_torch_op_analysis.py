"""The port's operation count (``launch/op_analysis.py``) against the
reference's HLO analyzer (``launch/hlo_analysis.py``), and the kernel
wrappers' ``work`` and meta paths.

The reference's five programs (``tests/test_hlo_analysis.py``) run in
torch: a matmul's FLOPs are exactly 2 M K N and within 1% of the
reference's count of the same product compiled by XLA; a loop of 10 layers
counts 10 times one layer (the reference's scan trip count), nested loops
of 3 and 4 count 12 times; an elementwise program's bytes lie in
[nbytes, 8 nbytes].  ``repeat`` scales a block by its trip count.  Each
wrapper on meta tensors records its kernel's ``work`` once, returns the
kernel's shapes and dtypes, and runs neither the kernel nor the plain
version; on CPU tensors it runs the plain version and records nothing.
The bounds that ``chip_smoke.py``'s phase 1 prints come from the same
``work``: at the shapes of ``PERF.md`` §6 they are pinned within 0.1%.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze as ref_analyze
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gather_scatter import ops as gs_ops
from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.kernels.pq_scan import ops as pq_ops
from repro_torch.kernels.topk_merge import ops as merge_ops
from repro_torch.launch.mesh import HW, peak_flops
from repro_torch.launch.op_analysis import analyze, repeat

# one intra-op thread: the timing-driven tests beside this file under -n 6
# must not be starved of cores
torch.set_num_threads(1)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_single_matmul_flops_match_reference():
    a, b = torch.zeros(64, 128), torch.zeros(128, 256)
    an = analyze(lambda x, y: x @ y, a, b)
    assert an.flops == 2 * 64 * 128 * 256
    ref = ref_analyze(jax.jit(lambda x, y: x @ y).lower(
        jnp.zeros((64, 128)), jnp.zeros((128, 256))).compile().as_text())
    assert an.flops == pytest.approx(ref.flops, rel=0.01)
    assert an.top_flops(1)[0][0] == "aten.mm"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_of_layers_counts_every_layer(device):
    x = torch.zeros(32, 32, device=device)
    ws = torch.zeros(10, 32, 32, device=device)

    def fn(h, ws):
        for w in ws:
            h = torch.tanh(h @ w)
        return h

    an = analyze(fn, x, ws)
    assert an.flops == 10 * 2 * 32 * 32 * 32
    one = analyze(lambda h, w: torch.tanh(h @ w), x, ws[0])
    assert an.bytes_accessed == pytest.approx(10 * one.bytes_accessed,
                                              rel=0.05)


def test_nested_loops_count_the_trip_product():
    x = torch.zeros(16, 16)

    def fn(h):
        for _ in range(4):
            g = h
            for _ in range(3):
                g = torch.tanh(g @ g)
            h = g
        return h

    assert analyze(fn, x).flops == 12 * 2 * 16 ** 3


def test_bytes_positive_and_bounded():
    a = torch.zeros(256, 256)
    an = analyze(lambda x: (x + 1.0) * 2.0, a)
    nbytes = 256 * 256 * 4
    assert nbytes <= an.bytes_accessed <= 8 * nbytes
    assert an.peak_bytes >= 2 * nbytes        # the argument and a result


def test_analysis_tables_and_dict():
    an = analyze(lambda x: torch.relu(x @ x).sum(), torch.zeros(8, 8))
    d = an.as_dict()
    for key in ("flops", "bytes_accessed", "collective_bytes",
                "collectives", "kernels", "top_flops", "top_bytes",
                "peak_bytes", "repeats"):
        assert key in d
    assert d["collective_bytes"] == 0.0 and not d["collectives"]
    assert {k for k, _ in an.top_bytes()} >= {"aten.mm", "aten.relu"}
    assert not build.counting_work()


def test_repeat_scales_a_block_by_its_trip_count():
    x, w = _meta(64, 64), _meta(64, 64)

    def fn(x, w):
        x = x @ w
        with repeat(7):
            y = torch.exp(x @ w)
        return y

    an = analyze(fn, x, w)
    one = analyze(lambda x, w: torch.exp(x @ w), x, w)
    assert an.flops == 8 * 2 * 64 ** 3
    assert an.repeats == [7]
    assert an.bytes_accessed == pytest.approx(
        7 * one.bytes_accessed + 3 * 64 * 64 * 4)
    with repeat(3):                           # no analysis: nothing to do
        assert not build.counting_work()


@pytest.fixture
def no_kernels(monkeypatch):
    """Any kernel library load or plain version call raises."""
    def boom(*a, **k):
        raise AssertionError("a kernel or a plain version ran on meta")
    for mod, names in ((build, ["load"]),
                       (flash_ops, ["flash_attention_ref",
                                    "flash_attention_bwd_ref", "load"]),
                       (decode_ops, ["decode_attention_ref", "load"]),
                       (gs_ops, ["gather_scatter_ref", "load"]),
                       (ivf_ops, ["ivf_scan_topk_ref", "load"]),
                       (pq_ops, ["pq_adc_topk_ref", "load"]),
                       (merge_ops, ["merge_topk_ref", "load"])):
        for n in names:
            monkeypatch.setattr(mod, n, boom)


def _one_entry(an, name, work):
    assert set(an.kernels) == {name}
    assert an.kernels[name] == {"calls": 1.0, "flops": work[0],
                                "bytes": work[1]}


def test_attention_wrappers_on_meta(no_kernels):
    bf = torch.bfloat16
    q, k, v = _meta(2, 64, 8, 32, dtype=bf), _meta(2, 80, 2, 32, dtype=bf), \
        _meta(2, 80, 2, 16, dtype=bf)
    out = {}
    an = analyze(lambda: out.update(o=flash_ops.flash_attention(
        q, k, v, return_stats=True)))
    o, m, l = out["o"]
    assert o.shape == (2, 64, 8, 16) and o.dtype == bf and o.is_meta
    assert m.shape == l.shape == (2, 8, 64) and m.dtype == torch.float32
    _one_entry(an, "flash_attention", flash_ops.work(q, k, v, True))
    # 2 rows x 8 heads x (64 x 16 + 64 x 65 / 2) pairs, 2 (32 + 16) each
    assert an.flops == 2 * 8 * (64 * 16 + 64 * 65 / 2) * 2 * 48

    an = analyze(lambda: out.update(g=flash_ops.flash_attention_bwd(
        q, k, v, o, m, l, o)))
    assert [t.shape for t in out["g"]] == [q.shape, k.shape, v.shape]
    _one_entry(an, "flash_attention_bwd", flash_ops.bwd_work(q, k, v, True))

    cache_k, cache_v = _meta(2, 100, 2, 32, dtype=bf), \
        _meta(2, 100, 2, 16, dtype=bf)
    pos = _meta(2, dtype=torch.int32)
    an = analyze(lambda: out.update(d=decode_ops.decode_attention(
        q[:, :1], cache_k, cache_v, pos)))
    assert out["d"].shape == (2, 1, 8, 16) and out["d"].is_meta
    # no positions on meta: every cache row counts
    _one_entry(an, "decode_attention",
               (200 * 2.0 * 8 * 48, (200 * 2 * 48 + 2 * 8 * 48) * 2 + 8))


def test_autograd_attention_on_meta_records_forward_and_backward(no_kernels):
    from repro_torch.models.attention import chunked_attention
    q = _meta(1, 32, 4, 16).requires_grad_()
    k = _meta(1, 32, 2, 16).requires_grad_()

    def step():
        chunked_attention(q, k, k, causal=True).sum().backward()

    an = analyze(step)
    assert {n: e["calls"] for n, e in an.kernels.items()} == {
        "flash_attention": 1.0, "flash_attention_bwd": 1.0}


def test_gather_scatter_on_meta_forward_and_gradient(no_kernels):
    x = _meta(50, 8).requires_grad_()
    src, dst = _meta(300, dtype=torch.int32), _meta(300, dtype=torch.int32)
    w = _meta(300)
    out = {}

    def step():
        y = gs_ops.gather_scatter(x, src, dst, 40, w, "mean")
        out["y"] = y
        y.sum().backward()

    an = analyze(step)
    assert out["y"].shape == (40, 8) and x.grad.shape == (50, 8)
    fwd = gs_ops.work(50, 40, 8, 300, 4, 4, weighted=True, ptr_rows=40,
                      mean=True)
    bwd = gs_ops.work(40, 50, 8, 300, 4, 4, weighted=True, ptr_rows=40)
    k = an.kernels["gather_scatter"]
    assert k == {"calls": 2.0, "flops": fwd[0] + bwd[0],
                 "bytes": fwd[1] + bwd[1]}


def test_embedding_bag_on_meta_counts_no_row_pointer(no_kernels):
    from repro_torch.models.recsys.embedding_bag import embedding_bag_dense
    table = _meta(3, 1000, 16)
    ids = _meta(64, 3, 4, dtype=torch.int32)
    out = {}
    an = analyze(lambda: out.update(y=embedding_bag_dense(table, ids)))
    assert out["y"].shape == (64, 3, 16)
    _one_entry(an, "gather_scatter", gs_ops.work(
        3000, 192, 16, 768, 4, 4, weighted=False, ptr_rows=0, mean=True))


def test_scans_and_merge_on_meta(no_kernels):
    q, corpus = _meta(3, 64), _meta(1000, 64)
    out = {}
    an = analyze(lambda: out.update(r=ivf_ops.ivf_scan_topk(q, corpus, 10,
                                                           "ip")))
    v, i = out["r"]
    assert v.shape == i.shape == (3, 10) and i.dtype == torch.int32
    _one_entry(an, "ivf_scan", (2.0 * 3 * 1000 * 64,
                                4 * (3 * 64 + 1000 * 64) + 8 * 3 * 10))
    luts, codes = _meta(2, 8, 256), _meta(500, 8, dtype=torch.uint8)
    an = analyze(lambda: out.update(p=pq_ops.pq_adc_topk(luts, codes, 5)))
    assert out["p"][0].shape == (2, 5)
    _one_entry(an, "pq_scan", pq_ops.work(luts, codes, 5, 500))
    vals, ids = _meta(4, 3, 10), _meta(4, 3, 10, dtype=torch.int64)
    an = analyze(lambda: out.update(t=merge_ops.merge_topk_dev(vals, ids,
                                                              10)))
    assert out["t"][1].dtype == torch.int64 and out["t"][0].shape == (3, 10)
    _one_entry(an, "topk_merge", (0.0, 4 * 3 * 40 + 8 * 3 * 10 + 12 * 3 * 10))


def test_cpu_wrappers_run_the_plain_version_and_record_nothing():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 8, generator=g)
    an = analyze(flash_ops.flash_attention, q, q, q)
    assert an.kernels == {} and an.flops > 0     # the plain version's mm
    x = torch.randn(20, 4, generator=g)
    e = torch.randint(0, 20, (50,), generator=g)
    an = analyze(gs_ops.gather_scatter, x, e, e.flip(0), 20)
    assert an.kernels == {} and an.bytes_accessed > 0


def _bound_ms(work, dtype=torch.float32):
    flops, n_bytes = work
    return max(n_bytes / HW["hbm_bw"], flops / peak_flops(dtype)) * 1e3


def test_phase_one_bounds_from_work_are_pinned():
    """PERF.md §6's bounds, from the wrappers' ``work`` at phase 1's
    shapes, within 0.1%."""
    bf = torch.bfloat16
    q = _meta(8, 4096, 32, 128, dtype=bf)
    kv = _meta(8, 4096, 8, 128, dtype=bf)
    assert _bound_ms(flash_ops.work(q, kv, kv), bf) == pytest.approx(
        1.1120, rel=1e-3)
    q2, kv2 = q[:2], kv[:2]
    assert _bound_ms(flash_ops.bwd_work(q2, kv2, kv2), bf) == pytest.approx(
        0.6950, rel=1e-3)
    # the spread case's seeded positions hold 129,165 visible rows of the
    # 8 x 32,768-position cache
    pos = torch.full((8,), 16144, dtype=torch.int32)
    pos[0], pos[-1] = 32767, 0
    pos[1] += 129165 - int((pos.long() + 1).sum())
    cache = _meta(8, 32768, 8, 128, dtype=bf)
    assert _bound_ms(decode_ops.work(q[:, :1], cache, cache, pos), bf) \
        == pytest.approx(0.1580, rel=1e-3)
    n, e = 2449029, 61859328
    assert _bound_ms(gs_ops.work(n, n, 128, e, 4, 4, weighted=True,
                                 ptr_rows=n, mean=True)) \
        == pytest.approx(0.9022, rel=1e-3)
    assert _bound_ms(ivf_ops.work(_meta(1, 1248), _meta(1_000_000, 1248),
                                  100)) == pytest.approx(1.4902, rel=1e-3)
    # AutoInt's bag at train_batch: uniform ids touch 8,992,637 rows; its
    # gradient writes the 39 tables' dense 39,000,000 x 16
    bags, ids = 65536 * 39, 65536 * 39 * 4
    assert _bound_ms(gs_ops.work(8_992_637, bags, 16, ids, 4, 4,
                                 weighted=False, ptr_rows=0, mean=True)) \
        == pytest.approx(0.2328, rel=1e-3)
    assert _bound_ms(gs_ops.work(bags, 39_000_000, 16, ids, 4, 4,
                                 weighted=False, ptr_rows=0)) \
        == pytest.approx(0.8061, rel=1e-3)
    luts, codes = _meta(256, 16, 256), _meta(1_000_000, 16, dtype=torch.uint8)
    assert _bound_ms(pq_ops.work(luts, codes, 800, 1_000_000)) \
        == pytest.approx(0.0611, rel=1e-2)


def test_gather_scatter_kernel_path_records_its_csr(monkeypatch):
    """The card path's autograd function, its launches stood in for by
    zeros on the CPU: a built CSR counts its row pointer, a uniform one
    (an embedding bag's) none, forward and gradient."""
    monkeypatch.setattr(gs_ops, "launch", lambda x, rows, w, mean, dt,
                        scale=None: torch.zeros(rows.ptr.numel() - 1,
                                                x.shape[1], dtype=dt))
    g = torch.Generator().manual_seed(1)
    src = torch.randint(0, 50, (300,), generator=g)
    dst = torch.randint(0, 40, (300,), generator=g)
    x = torch.randn(50, 8, generator=g).requires_grad_()
    csr = gs_ops.EdgeCSR.build(src, dst, 40, 50)
    assert csr.uniform is False
    an = analyze(lambda: gs_ops._GatherScatter.apply(
        x, torch.ones(300), csr, True).sum().backward())
    fwd = gs_ops.work(50, 40, 8, 300, 4, 4, weighted=True, ptr_rows=40,
                      mean=True)
    bwd = gs_ops.work(40, 50, 8, 300, 4, 4, weighted=True, ptr_rows=40)
    assert an.kernels["gather_scatter"] == {
        "calls": 2.0, "flops": fwd[0] + bwd[0], "bytes": fwd[1] + bwd[1]}
    bag = gs_ops.EdgeCSR.regular(src[:280].to(torch.int32), 4, 50)
    assert bag.uniform is True
    an = analyze(lambda: gs_ops._GatherScatter.apply(x, None, bag, True))
    assert an.kernels["gather_scatter"]["bytes"] == gs_ops.work(
        50, 70, 8, 280, 4, 4, weighted=False, ptr_rows=0, mean=True)[1]


def test_roofline_takes_the_link_term():
    from repro_torch.launch.op_analysis import Analysis, roofline
    an = Analysis(flops=1e12, bytes_accessed=1e9, collective_bytes=1e11)
    r = roofline(an, HW["peak_flops_bf16"])
    assert r["collective_s"] == 1e11 / HW["link_bw"] == 2.0
    assert r["dominant"] == "collective"
    an.collective_bytes = 0.0
    assert roofline(an, HW["peak_flops_bf16"])["dominant"] == "compute"


_LOCAL = """
import json
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.op_analysis import analyze, repeat
mesh = make_fake_mesh((4, 2), ("data", "model"))
m, k, n = 1024, 512, 256
a = DTensor.from_local(torch.empty(m // 4, k // 2, device="meta"), mesh,
                       [Shard(0), Shard(1)], run_check=False,
                       shape=(m, k), stride=(k, 1))
b = DTensor.from_local(torch.empty(k // 2, n, device="meta"), mesh,
                       [Replicate(), Shard(0)], run_check=False,
                       shape=(k, n), stride=(n, 1))

def fn(a, b):
    with repeat(2):
        c = a @ b                      # a partial sum over model
        c.redistribute(mesh, [Shard(0), Replicate()])

an = analyze(fn, a, b)
print(json.dumps({"flops": an.flops, "collectives": an.collectives,
                  "top": an.top_collectives(), "peak": an.peak_bytes,
                  "repeats": an.repeats}))
"""


def test_a_dtensor_product_is_counted_on_its_local_shards():
    """Beneath DTensor's dispatch: the local product's FLOPs (not the
    global one's), the all-reduce DTensor runs at its local result's
    bytes, scaled by ``repeat``; its sharding propagation's fake tensors
    are not counted.  In a process of its own (a fake group of 8)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _LOCAL], capture_output=True,
                         text=True, timeout=300, cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    local = (1024 // 4) * 256 * 4                 # [M/4, N] float32
    assert res["flops"] == 2 * 2 * (1024 // 4) * (512 // 2) * 256
    assert res["collectives"] == {"all-reduce": {"count": 2.0,
                                                 "bytes": 2.0 * local}}
    assert res["top"] == [["all-reduce float32[256, 256]", 2.0 * local]]
    assert res["repeats"] == [2]
    # the arguments' local shards and the local results: less than the
    # argument shards beside one global result
    assert 0 < res["peak"] < 2 * local + 1024 * 256 * 4
