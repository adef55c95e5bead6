#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--persons N] [--pq-rows N] [--profile]
                          [--out results.json]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once), then runs five phases and fails if any fails:

1. kernels against plain: each kernel's wrapper against its plain PyTorch
   version on the card, at the main paths' shapes (IVF: Q in {256, 930},
   N = 200,000, d = 128, k in {10, 64, 20,001}; PQ: Q = 256, N = 1,000,000,
   M = 16, K = 256, k' in {80, 800}; merge: P in {2, 4, 8} shard windows
   of K in {10, 100, 10,002} for Q in {1, 256, 4096}), with a ragged
   ``n_valid``, exact duplicate rows and cross-shard ties, (-inf, -1)
   padding, an all-padding shard, starved probe masks and int64 ids past
   2**31.  Integer-valued vectors keep the IVF sums exact, the PQ sums run
   in the plain version's order and the merge does no arithmetic, so ids
   must be equal and max |delta| <= 1e-4 (0 for the merge).  Prints kernel,
   plain and library (one PyTorch call of the same function) times.
2. serving: ``PandaDB(device="cuda")`` over an SNB graph of ``--persons``
   persons (100,000 by default) with 128-d faces and the IVF-Flat face
   index; a ``QueryServer`` answers the semantic and structured requests
   below, the unfiltered ``knows`` var-var query among them.
3. PQ: ``IVFIndex.search_many`` on 1,000,000 SIFT-like vectors (pq_m=16),
   Q = 256, k in {10, 100}, in ``adc``, residual ``adc`` and ``fused`` mode,
   each held against the float ``search_exact`` by recall (>= 0.90; the
   card reads 0.94 at k=10 and 0.98 at k=100 on this data).
4. cluster: ``ShardedPandaDB(n_shards=4, device="cuda")`` over 100,000
   persons written through the coordinator as ``launch/serve.py::
   build_cluster`` does, 128-d faces, four IVF-Flat pieces on the card.  A
   ``QueryServer`` over it answers the cluster requests; ``knn`` at Q = 256, k in {10, 100} is held against
   the merged single index; phase 3's residual 1M-row index, cut in four,
   serves a fused scatter-gather by recall (>= 0.90); a 2 x 2
   ``ReplicatedPandaDB`` at 20,000 persons loses a replica halfway through
   a closed loop and must fail no request.
5. parity: the serving requests at 5,000 persons, and the cluster's
   requests and kNN at 5,000 persons, card against CPU: rows identical,
   kNN ids identical wherever neighbouring scores differ by more than 1e-4.

Launch counts are zeroed just before each main path (phases 2-3, the
single node; phase 4, the cluster) and read just after it; every kernel of
a path must have launched on it.  ``--profile`` runs each serving request,
each PQ search mode, one cluster kNN and one fan-out request once more,
after the main path's run and uncounted, under ``torch.profiler`` and
``cProfile``: host wall time, device busy time (CUDA kernels and copies,
which run on one stream), the idle share ``1 - busy / wall``, and the
kernels and host functions that took the most time.

The second-to-last line holds the kernels' numbers as JSON, the line before
it the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/repro_torch`` beside this file, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 peak outside tensor cores
SIM_THRESHOLD = 0.80           # the executor's similarity threshold
FACE_DIM = 128                 # the faces of every serving phase
KNN_GAP = 1e-4                 # kNN ids must agree where scores differ more
CLUSTER_PERSONS = 100_000      # persons of the 4-shard cluster phase

SERVE_REQUESTS = [
    ("knows_var_var",
     "MATCH (n:Person)-[:knows]->(m:Person) WHERE n.photo->face ~: "
     "m.photo->face RETURN n.name, m.name"),
    ("age_var_var_limit",
     "MATCH (n:Person), (m:Person) WHERE n.age < 19 AND n.photo->face ~: "
     "m.photo->face RETURN n.name, m.name LIMIT 100"),
    ("create_from_source",
     "MATCH (p:Person) WHERE p.photo->face ~: createFromSource($src)->face "
     "RETURN p.name"),
    ("structured_team",
     "MATCH (n:Person)-[:workFor]->(t:Team) WHERE n.name='person_3' "
     "RETURN t.name"),
    ("structured_age",
     "MATCH (n:Person) WHERE n.age > 70 RETURN n.name, n.age LIMIT 20"),
]


def log(*a) -> None:
    print(*a, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(torch, fn, top: int = 5) -> dict:
    """One call of ``fn`` under ``torch.profiler`` and ``cProfile``: host
    wall ms, device busy ms, idle share, and the ``top`` kernels (device
    time) and host functions (own time) by time."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        host.enable()
        fn()
        torch.cuda.synchronize()
        host.disable()
        wall = (time.perf_counter() - t0) * 1e3
    busy, kernels = 0.0, []
    for ev in prof.key_averages():
        # kernel and copy rows only: an operator row repeats its kernels
        dev_us = ev.self_device_time_total
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            busy += dev_us / 1e3
            kernels.append((dev_us / 1e3, ev.count, ev.key[:80]))
    funcs = [(tt * 1e3, nc, f"{name} ({Path(file).name}:{line})")
             for (file, line, name), (_, nc, tt, _, _)
             in pstats.Stats(host).stats.items()]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "device_top": [{"name": n, "ms": ms, "calls": c}
                           for ms, c, n in sorted(kernels, reverse=True)[:top]],
            "host_top": [{"name": n, "ms": ms, "calls": c}
                         for ms, c, n in sorted(funcs, reverse=True)[:top]]}


def bound(n_bytes: float, n_ops: float):
    """Least time on the card: bytes over the memory rate vs float32
    operations over the float32 peak; the larger one bounds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: kernels against plain
# ---------------------------------------------------------------------------


def phase_kernels(torch, pq_rows: int):
    import numpy as np
    from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
    from repro_torch.kernels.pq_scan.ops import pq_adc_topk
    from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}

    # -- ivf_scan: integer vectors (exact sums); the second half of the
    # corpus repeats the first (ties); the last 37 rows are padding
    n, d = 200_000, 128
    half = rng.integers(-3, 4, (n // 2, d)).astype(np.float32)
    corpus = torch.from_numpy(np.concatenate([half, half])).to(dev)
    n_valid = n - 37
    worst = 0.0
    main = None
    for qn in (256, 930):
        q = torch.from_numpy(rng.integers(-3, 4, (qn, d)).astype(
            np.float32)).to(dev)
        for k in (10, 64, 20_001):
            kv, ki = ivf_scan_topk(q, corpus, k, n_valid=n_valid)
            pv, pi = ivf_scan_topk_ref(q, corpus, k, n_valid=n_valid)
            torch.cuda.synchronize()
            same = bool(torch.equal(ki, pi))
            err = float((kv - pv).abs().max())
            worst = max(worst, err)
            ms = time_ms(torch, lambda: ivf_scan_topk(q, corpus, k,
                                                      n_valid=n_valid))
            plain_ms = time_ms(torch, lambda: ivf_scan_topk_ref(
                q, corpus, k, n_valid=n_valid))
            c2 = (corpus * corpus).sum(1)

            def library():
                s = -((q * q).sum(1, keepdim=True) - 2.0 * (q @ corpus.T)
                      + c2[None, :])
                return torch.topk(s[:, :n_valid], k)

            lib_ms = time_ms(torch, library)
            b_ms, b_by = bound(4 * (qn * d + n * d) + 8 * qn * k,
                               2.0 * qn * n * d)
            log(f"[kernels] ivf_scan Q={qn} N={n} d={d} k={k} "
                f"n_valid={n_valid}: ids_equal={same} max_abs_err={err} "
                f"ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f}"
                f" bound_ms={b_ms:.4f} ({b_by})")
            check(same, f"ivf_scan ids differ at Q={qn} k={k}")
            check(err <= 1e-4, f"ivf_scan max|delta| {err} at Q={qn} k={k}")
            if qn == 930 and k == 20_001:
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            shape=f"Q={qn} N={n} d={d} k={k}")
            del kv, ki, pv, pi
    out["ivf_scan"] = dict(main, max_abs_err=worst)
    del corpus, half
    torch.cuda.empty_cache()

    # -- pq_scan / pq_scan_ext: float LUTs, sums in the plain order
    qn, m, ksub, mb = 256, 16, 256, 10
    n = pq_rows
    gen = torch.Generator(device=dev).manual_seed(1)
    luts = torch.randn(qn, m, ksub, device=dev, generator=gen)
    codes = torch.randint(0, ksub, (n, m), device=dev, generator=gen,
                          dtype=torch.uint8)
    rb = torch.sort(torch.randint(0, mb, (n,), device=dev, generator=gen,
                                  dtype=torch.int32)).values
    bias = torch.randn(n, device=dev, generator=gen)
    cs = torch.randn(qn, mb, device=dev, generator=gen)
    pm = torch.rand(qn, mb, device=dev, generator=gen) < 0.4
    pm[0] = False                     # a query that probes nothing
    pm[1] = False
    pm[1, 3] = True                   # a query that probes one bucket
    ext_kw = dict(bias=bias, row_bucket=rb, cscores=cs, probe_mask=pm)
    table = luts.reshape(qn, m * ksub).T.contiguous()     # [M*K, Q]
    flat_codes = codes.long() + torch.arange(m, device=dev) * ksub
    for name, kw in (("pq_scan", {}), ("pq_scan_ext", ext_kw)):
        worst = 0.0
        for k in (80, 800):
            nv = n - 5 if not kw else n
            kv, ki = pq_adc_topk(luts, codes, k, n_valid=nv, **kw)
            pv, pi = pq_adc_topk_ref(luts, codes, k, n_valid=nv, **kw)
            torch.cuda.synchronize()
            same = bool(torch.equal(ki, pi))
            fin = torch.isfinite(pv)
            same_inf = bool(torch.equal(fin, torch.isfinite(kv)))
            err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
            worst = max(worst, err)
            ms = time_ms(torch, lambda: pq_adc_topk(luts, codes, k,
                                                    n_valid=nv, **kw))
            plain_ms = time_ms(torch, lambda: pq_adc_topk_ref(
                luts, codes, k, n_valid=nv, **kw))

            def library():
                # one embedding_bag gathers and sums every row's M entries
                s = torch.nn.functional.embedding_bag(
                    flat_codes, table, mode="sum").T
                if kw:
                    s = s + bias[None, :] + cs[:, rb.long()]
                    s = s.masked_fill(~pm[:, rb.long()], -torch.inf)
                return torch.topk(s[:, :nv], k)

            lib_ms = time_ms(torch, library)
            n_bytes = 4 * qn * m * ksub + n * m + 8 * qn * k
            n_ops = float(qn) * n * m
            if kw:
                n_bytes += 8 * n + 5 * qn * mb
                n_ops += 2.0 * qn * n
            b_ms, b_by = bound(n_bytes, n_ops)
            starved = ""
            if kw:
                check(bool((ki[0] == -1).all()), "starved query not padded")
                starved = f" starved_pad_ok=True"
            log(f"[kernels] {name} Q={qn} N={n} M={m} K={ksub} k'={k}: "
                f"ids_equal={same} max_abs_err={err}{starved} ms={ms:.3f} "
                f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
                f"bound_ms={b_ms:.4f} ({b_by})")
            check(same and same_inf, f"{name} ids differ at k'={k}")
            check(err <= 1e-4, f"{name} max|delta| {err} at k'={k}")
            if k == 800:
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            shape=f"Q={qn} N={n} M={m} K={ksub} k'={k}")
            del kv, ki, pv, pi
        out[name] = dict(main, max_abs_err=worst)
    del luts, codes, rb, bias, cs, pm, table, flat_codes
    torch.cuda.empty_cache()
    out["topk_merge"] = kernel_topk_merge(torch, dev)
    return out


def merge_windows(torch, dev, p: int, qn: int, kk: int, gen):
    """P shard windows [P, Q, K] as a scatter-gather stacks them: rows
    sorted, values on a 1/64 grid (ties inside a window) with shard 1 a
    copy of shard 0 (exact ties across shards), the last tenth of every
    window (-inf, -1) padding, shard 2 all padding when P >= 4, int64 ids
    up to 2**40."""
    v = torch.randn(p, qn, kk, device=dev, generator=gen)
    v = (torch.round(v * 64) / 64).sort(dim=2, descending=True).values
    v[1] = v[0]
    ids = torch.randint(0, 1 << 40, (p, qn, kk), device=dev, generator=gen)
    pad = max(1, kk // 10)
    v[:, :, kk - pad:] = -torch.inf
    ids[:, :, kk - pad:] = -1
    if p >= 4:
        v[2] = -torch.inf
        ids[2] = -1
    return v.contiguous(), ids.contiguous()


def kernel_topk_merge(torch, dev):
    from repro_torch.kernels.topk_merge.ops import merge_topk_dev
    from repro_torch.kernels.topk_merge.ref import merge_topk_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    worst, main = 0.0, None
    for p in (2, 4, 8):
        for qn in (1, 256, 4096):
            for kk in (10, 100, 10_002):
                vals, ids = merge_windows(torch, dev, p, qn, kk, gen)
                c = p * kk
                nv = c - kk // 2          # cuts into the last shard
                k = kk
                kv, ki = merge_topk_dev(vals, ids, k, n_valid=nv)
                pv, pi = merge_topk_ref(vals, ids, k, n_valid=nv)
                torch.cuda.synchronize()
                same = bool(torch.equal(ki, pi))
                fin = torch.isfinite(pv)
                same_inf = bool(torch.equal(fin, torch.isfinite(kv)))
                err = (float((kv[fin] - pv[fin]).abs().max())
                       if fin.any() else 0.0)
                worst = max(worst, err)
                ms = time_ms(torch, lambda: merge_topk_dev(vals, ids, k,
                                                           n_valid=nv))
                plain_ms = time_ms(torch, lambda: merge_topk_ref(
                    vals, ids, k, n_valid=nv))

                def library():
                    flat = vals.permute(1, 0, 2).reshape(qn, c)
                    flat = flat.masked_fill(
                        torch.arange(c, device=dev) >= nv, -torch.inf)
                    tv, tp = torch.topk(flat, k)
                    return tv, torch.gather(
                        ids.permute(1, 0, 2).reshape(qn, c), 1, tp)

                lib_ms = time_ms(torch, library)
                # values read once; ids read and (value, id) written for
                # the k chosen columns only
                b_ms, b_by = bound(4.0 * qn * c + 8.0 * qn * k
                                   + 12.0 * qn * k, 0.0)
                log(f"[kernels] topk_merge P={p} Q={qn} K={kk} k={k} "
                    f"n_valid={nv}: ids_equal={same} max_abs_err={err} "
                    f"ms={ms:.3f} plain_ms={plain_ms:.3f} "
                    f"library_ms={lib_ms:.3f} bound_ms={b_ms:.4f} ({b_by})")
                check(same and same_inf,
                      f"topk_merge ids differ at P={p} Q={qn} K={kk}")
                check(err == 0.0, f"topk_merge max|delta| {err} at P={p} "
                      f"Q={qn} K={kk}")
                if (p, qn, kk) == (4, 256, 10):    # the cluster kNN's merge
                    main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                shape=f"P={p} Q={qn} K={kk} k={k}")
                del vals, ids, kv, ki, pv, pi
        torch.cuda.empty_cache()
    return dict(main, max_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 2 / 4: serving
# ---------------------------------------------------------------------------


def build_db(n_persons: int, device: str):
    from repro_torch.core import PandaDB
    from repro_torch.core.aipm import feature_hash_extractor
    from repro_torch.data.synthetic_graph import SNBConfig, build_snb

    db = PandaDB(device=device)
    db.register_extractor("face", feature_hash_extractor(dim=128))
    made = build_snb(db, SNBConfig(n_persons=n_persons,
                                   n_identities=n_persons // 3))
    db.build_index("face", "photo")
    return db, made["persons"]


def photo_of(db, nid: int) -> bytes:
    col = db.graph.store.node_props.column("photo")
    return db.graph.blobs.read(int(col.values[nid]))


def single_requests(db, persons):
    """SERVE_REQUESTS as (name, text, params), the probe with person 7's
    photo."""
    return [(name, text, {"src": photo_of(db, persons[7])}
             if "$src" in text else None) for name, text in SERVE_REQUESTS]


def serve(db, requests, device: str):
    """Every (name, text, params) request through one QueryServer:
    {name: (rows, ms)}."""
    from repro_torch.serving.engine import QueryServer

    server = QueryServer(db, n_workers=2)
    server.start()
    out = {}
    try:
        for name, text, params in requests:
            t0 = time.perf_counter()
            rows, err = server.submit(text, params=params).get(timeout=1800)
            if device != "cpu":
                import torch
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if err is not None:
                raise PhaseFailed(f"request {name} failed: {err!r}")
            out[name] = (rows, ms)
    finally:
        server.close()
    return out


def face_of(db, persons, name: str):
    import numpy as np
    nid = persons[int(name.split("_")[1])]
    col = db.graph.store.node_props.column("photo")
    return np.asarray(db.phi_for_blobs("face", [int(col.values[nid])])[0])


def phase_serving(torch, n_persons: int, prof=None):
    t0 = time.perf_counter()
    db, persons = build_db(n_persons, "cuda")
    idx = db.indexes["face"]
    log(f"[serving] built SNB persons={n_persons} nodes={db.graph.n_nodes} "
        f"face index rows={idx.n_total} buckets={idx.centroids.shape[0]} "
        f"dim={idx.vectors.shape[1]} on {idx.t_vectors.device} "
        f"({idx.t_vectors.numel() * 4 / 1e6:.1f} MB) "
        f"in {time.perf_counter() - t0:.1f}s")
    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    before = ivf_ops.launches.n
    answers = serve(db, single_requests(db, persons), "cuda")
    check(ivf_ops.launches.n > before, "serving launched no ivf_scan")
    for name, (rows, ms) in answers.items():
        log(f"[serving] {name}: rows={len(rows)} latency_ms={ms:.1f}")
    knows, _ = answers["knows_var_var"]
    check(len(knows) > 0, "knows var-var query answered no rows")
    for r in knows[:50]:
        a, b = face_of(db, persons, r["n.name"]), face_of(db, persons,
                                                          r["m.name"])
        check(float(a @ b) >= SIM_THRESHOLD - 1e-4,
              f"pair {r} below the similarity threshold")
    check(0 < len(answers["age_var_var_limit"][0]) <= 100,
          "LIMIT query row count")
    probe = {r["p.name"] for r in answers["create_from_source"][0]}
    check("person_7" in probe, "createFromSource probe missed its own photo")
    check(len(answers["structured_team"][0]) == 1, "structured team query")
    if prof is not None:
        session = db.session()
        for name, text in SERVE_REQUESTS:
            params = ({"src": photo_of(db, persons[7])}
                      if "$src" in text else {})
            prof(f"serving {name}",
                 lambda: session.run(text, params).fetchall())
    db.aipm.shutdown()
    return {name: {"rows": len(rows), "latency_ms": ms}
            for name, (rows, ms) in answers.items()}


def phase_parity(n_persons: int = 5000):
    from repro_torch.cluster import FaultInjector
    from repro_torch.launch.serve import build_cluster

    card, persons = build_db(n_persons, "cuda")
    cpu, _ = build_db(n_persons, "cpu")
    a = serve(card, single_requests(card, persons), "cuda")
    b = serve(cpu, single_requests(cpu, persons), "cpu")
    for name, _ in SERVE_REQUESTS:
        check(a[name][0] == b[name][0],
              f"parity: {name} rows differ card vs cpu")
        log(f"[parity] {name}: rows={len(a[name][0])} identical card/cpu")
    card.aipm.shutdown()
    cpu.aipm.shutdown()
    out = {}
    card, cpu = (build_cluster(n_persons, 4, 1, FaultInjector(0),
                               device=d, dim=FACE_DIM)
                 for d in ("cuda", "cpu"))
    a = serve(card, cluster_requests(card), "cuda")
    b = serve(cpu, cluster_requests(cpu), "cpu")
    for name in a:
        check(a[name][0] == b[name][0],
              f"parity: cluster {name} rows differ card vs cpu")
        log(f"[parity] cluster {name}: rows={len(a[name][0])} identical "
            f"card/cpu")
    q = unit_queries(3, 256)
    for k in (10, 100):
        out[f"cluster_knn_k{k}"] = compare_knn(
            f"[parity] cluster knn k={k} card vs cpu", card.knn("face", q, k),
            cpu.knn("face", q, k))
    card.close()
    cpu.close()
    return out


# ---------------------------------------------------------------------------
# phase 4: cluster
# ---------------------------------------------------------------------------


def compare_knn(label: str, got, want) -> dict:
    """kNN (vals, ids) against a reference run: the same -inf padding, max
    |delta| <= KNN_GAP over finite scores, and the same ids at every
    position whose score differs from both neighbours' by more than
    KNN_GAP (a closer pair may swap on one rounding)."""
    import numpy as np
    gv, gi = got
    wv, wi = want
    fin = np.isfinite(wv)
    check(bool((np.isfinite(gv) == fin).all()), f"{label}: padding differs")
    err = float(np.abs(gv[fin] - wv[fin]).max()) if fin.any() else 0.0
    gap = np.full(wv.shape, np.inf, np.float32)
    with np.errstate(invalid="ignore"):
        d = np.abs(np.diff(wv, axis=1))
    d = np.where(np.isfinite(d), d, np.inf)
    gap[:, 1:] = d
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    sep = gap > KNN_GAP
    id_miss = int((gi != wi)[sep].sum())
    bitwise = int((gv == wv).sum())
    log(f"{label}: max_abs_err={err} ids_differ_where_separated={id_miss} "
        f"of {int(sep.sum())} ids_equal={int((gi == wi).sum())} "
        f"values_bitwise_equal={bitwise} of {wv.size}")
    check(err <= KNN_GAP, f"{label}: max|delta| {err}")
    check(id_miss == 0, f"{label}: {id_miss} separated ids differ")
    return {"max_abs_err": err, "ids_differ_where_separated": id_miss,
            "values_bitwise_equal": bitwise, "values": int(wv.size)}


def unit_queries(seed: int, n: int):
    """``n`` random unit vectors: queries at the faces' own scale (the
    extractor returns unit vectors), so scores stay within [-4, 0]."""
    import numpy as np
    q = np.random.default_rng(seed).standard_normal((n, FACE_DIM))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def cluster_photo(c, nid: int) -> bytes:
    owner = c.read_db(c.owner_of(nid))
    col = owner.graph.store.node_props.column("photo")
    return owner.graph.blobs.read(int(col.values[nid]))


def cluster_requests(c):
    """launch/serve.py's CLUSTER_QUERIES plus the createFromSource probe
    with person 7's photo, as (name, text, params)."""
    from repro_torch.launch.serve import CLUSTER_QUERIES
    names = ("age_limit", "name_scan", "routed_lookup", "knows_expand")
    out = [(name, *(q if isinstance(q, tuple) else (q, None)))
           for name, q in zip(names, CLUSTER_QUERIES)]
    out.append(("create_from_source",
                "MATCH (p:Person) WHERE p.photo->face ~: "
                "createFromSource($src)->face RETURN p.name",
                {"src": cluster_photo(c, 7)}))
    return out


def phase_cluster(torch, n_persons: int, shared: dict, prof=None):
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from repro_torch.cluster import FaultInjector
    from repro_torch.core.vector_index import IVFIndex, scatter_gather_knn
    from repro_torch.launch.serve import CLUSTER_QUERIES, build_cluster
    from repro_torch.serving.engine import QueryServer

    out = {}
    t0 = time.perf_counter()
    c = build_cluster(n_persons, 4, 1, FaultInjector(0), device="cuda",
                      dim=FACE_DIM)
    pieces = c.index_pieces("face")
    check(all(p.t_vectors.device.type == "cuda" for p in pieces),
          "an index piece is not on the card")
    out["build_s"] = time.perf_counter() - t0
    log(f"[cluster] built persons={n_persons} shards={c.n_shards} on "
        f"{c.device}: piece rows {[p.n_total for p in pieces]} buckets="
        f"{pieces[0].centroids.shape[0]} dim={pieces[0].vectors.shape[1]} "
        f"in {out['build_s']:.1f}s")

    answers = serve(c, cluster_requests(c), "cuda")
    for name, (rows, ms) in answers.items():
        log(f"[cluster] {name}: rows={len(rows)} latency_ms={ms:.1f}")
    out["requests"] = {name: {"rows": len(rows), "latency_ms": ms}
                       for name, (rows, ms) in answers.items()}
    check(len(answers["age_limit"][0]) == 5, "cluster LIMIT row count")
    check(answers["name_scan"][0] == [{"n.age": 21.0}], "cluster name scan")
    check(answers["routed_lookup"][0] == [{"p.name": "person_3"}],
          "cluster routed lookup")
    knows = answers["knows_expand"][0]
    check(len(knows) > 0 and all(
        r["m.__self__"] == int(r["n.name"].split("_")[1]) + 1
        for r in knows), "cluster knows expand rows")
    check("person_7" in {r["p.name"] for r in answers["create_from_source"][0]},
          "cluster createFromSource probe missed its own photo")

    q = unit_queries(2, 256)
    merged = IVFIndex.merge_pieces(pieces)
    for k in (10, 100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = c.knn("face", q, k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        res = compare_knn(f"[cluster] knn Q=256 k={k} vs merged index",
                          got, merged.search_many(q, k))
        out[f"knn_k{k}"] = dict(res, ms=ms)
        log(f"[cluster] knn Q=256 k={k}: ms={ms:.1f}")
    del merged
    if prof is not None:
        prof("cluster knn Q=256 k=10", lambda: c.knn("face", q, 10))
        session = c.session()
        text = dict((n, t) for n, t, _ in cluster_requests(c))["knows_expand"]
        prof("cluster fan-out knows_expand",
             lambda: session.run(text).fetchall())
    c.close()

    # phase 3's residual 1M-row IVF-PQ index, cut in four: a fused scan per
    # shard with the re-rank budget split, merged on the card
    idx, queries = shared.pop("pq_index"), shared.pop("pq_queries")
    pq_pieces = idx.shard(4)
    with ThreadPoolExecutor(4) as pool:
        for k in (10, 100):
            _, truth = idx.search_exact(queries, k)
            _, single = idx.search_many(queries, k, mode="fused")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, ids = scatter_gather_knn(pq_pieces, queries, k, mode="fused",
                                        split_rerank_budget=True, pool=pool)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            hits = sum(len(set(a.tolist()) & set(e.tolist()) - {-1})
                       for a, e in zip(ids, truth))
            recall = hits / (len(queries) * k)
            same = float((ids == single).mean())
            log(f"[cluster] pq fused 4 shards Q={len(queries)} "
                f"N={idx.n_total} k={k}: recall@{k}={recall:.4f} "
                f"ids_equal_unsharded={same:.4f} ms={ms:.1f}")
            check(bool(np.isfinite(v).all()), "sharded pq non-finite")
            check(recall >= 0.90, f"sharded pq recall@{k} {recall}")
            out[f"pq_fused_k{k}"] = {"recall": recall, "ms": ms,
                                     "ids_equal_unsharded": same}
    del idx, pq_pieces
    torch.cuda.empty_cache()

    # chaos: a replica of shard 0 is fail-stopped halfway through a closed
    # loop; failover and hedged reads must mask it
    faults = FaultInjector(seed=0)
    rc = build_cluster(20_000, 2, 2, faults, device="cuda", dim=FACE_DIM)
    qk = unit_queries(5, 64)
    before = rc.knn("face", qk, 10)
    server = QueryServer(rc, n_workers=2)
    duration = 8.0
    killer = threading.Timer(duration / 2, faults.fail_stop, args=(0, 0))
    killer.start()
    try:
        stats = server.run_closed_loop(CLUSTER_QUERIES, n_clients=4,
                                       duration_s=duration)
    finally:
        killer.cancel()
    counts = server.route_counts()
    after = rc.knn("face", qk, 10)
    summary = stats.summary()
    log(f"[cluster] chaos 2x2 persons=20000: requests={summary['requests']} "
        f"p50_ms={summary['p50_ms']:.1f} p99_ms={summary['p99_ms']:.1f} "
        f"failed={counts.get('serve_failed')} failovers="
        f"{counts.get('failovers')} hedges_fired={counts.get('hedges_fired')}"
        f" replica_0_0_alive={rc.replica_sets[0].alive[0]}")
    check(summary["requests"] > 0, "chaos loop served nothing")
    check(counts.get("serve_failed", 0) == 0 and
          counts["serve_completed"] == counts["serve_submitted"],
          f"chaos: requests failed {counts}")
    check(not rc.replica_sets[0].alive[0] and counts["failovers"] >= 1,
          "chaos: the kill did not land or no failover was counted")
    check(bool(np.array_equal(before[1], after[1])),
          "chaos: kNN ids changed after the kill")
    rc.close()
    out["chaos"] = {"requests": summary["requests"],
                    "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
                    "failovers": counts["failovers"],
                    "hedges_fired": counts["hedges_fired"]}
    return out


# ---------------------------------------------------------------------------
# phase 3: PQ
# ---------------------------------------------------------------------------


def phase_pq(torch, n_rows: int, shared: dict, prof=None):
    import numpy as np
    from repro_torch.configs.pandadb import VectorIndexConfig
    from repro_torch.core.vector_index import IVFIndex
    from repro_torch.data.synthetic_graph import sift_like_vectors

    # the reference PQ bench's data: clusters of ~100 rows, queries a
    # small perturbation of corpus rows
    vecs = sift_like_vectors(n_rows, dim=128, n_clusters=n_rows // 100,
                             seed=0)
    rng = np.random.default_rng(1)
    queries = (vecs[rng.choice(n_rows, 256, replace=False)]
               + rng.standard_normal((256, 128)) * 0.01).astype(np.float32)
    out = {}
    # ten buckets, as a 1M-row BatchIndexing gets (n / vectors_per_bucket);
    # centroids and codebooks come from a 10% sample, the other rows join
    # by DynamicIndexing (insert_many) and one compaction
    sample = n_rows // 10
    for residual in (False, True):
        cfg = VectorIndexConfig(dim=128, pq_m=16, pq_residual=residual,
                                min_buckets=10)
        t0 = time.perf_counter()
        idx = IVFIndex.build(vecs[:sample], ids=np.arange(sample), cfg=cfg,
                             device="cuda")
        idx.insert_many(vecs[sample:], np.arange(sample, n_rows))
        idx.compact()
        check(idx.pending_count == 0 and idx.t_codes.shape[0] == n_rows,
              "PQ index not compacted onto the card")
        log(f"[pq] residual={residual} index rows={idx.n_total} "
            f"buckets={idx.centroids.shape[0]} codes on {idx.t_codes.device}"
            f" ({idx.t_codes.numel() / 1e6:.1f} MB) + vectors "
            f"({idx.t_vectors.numel() * 4 / 1e6:.1f} MB) built in "
            f"{time.perf_counter() - t0:.1f}s")
        modes = ("adc", "fused")
        for k in (10, 100):
            _, truth = idx.search_exact(queries, k)
            for mode in modes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v, ids = idx.search_many(queries, k, mode=mode)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                hits = sum(len(set(a.tolist()) & set(e.tolist()) - {-1})
                           for a, e in zip(ids, truth))
                recall = hits / (len(queries) * k)
                label = f"{mode}{'_residual' if residual else ''}"
                log(f"[pq] {label} Q={len(queries)} N={n_rows} k={k}: "
                    f"recall@{k}={recall:.4f} ms={ms:.1f}")
                check(bool(np.isfinite(v).all()), f"{label} non-finite")
                check(recall >= 0.90, f"{label} recall@{k} {recall}")
                out[f"{label}_k{k}"] = {"recall": recall, "ms": ms}
        if prof is not None and not residual:
            for mode in ("float", "adc", "fused"):
                for k in (10, 100):
                    prof(f"pq {mode} k={k}",
                         lambda: idx.search_many(queries, k, mode=mode))
        if residual:       # the cluster phase shards this one
            shared["pq_index"], shared["pq_queries"] = idx, queries
        del idx
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--persons", type=int, default=100_000)
    ap.add_argument("--pq-rows", type=int, default=1_000_000)
    ap.add_argument("--profile", action="store_true",
                    help="profile each serving request and PQ search mode "
                         "once more (uncounted)")
    ap.add_argument("--out", default=None,
                    help="also write every phase's numbers to this JSON file")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    from repro_torch.kernels.pq_scan import ops as pq_ops
    from repro_torch.kernels.topk_merge import ops as merge_ops

    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    results = {"card": card[0] if card else "", "phases": {}}
    counters = {"ivf_scan": ivf_ops.launches, "pq_scan": pq_ops.launches,
                "pq_scan_ext": pq_ops.ext_launches,
                "topk_merge": merge_ops.launches}
    failed = []
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {sorted(build.SOURCES)} in {time.perf_counter() - t0:.1f}s")
    for name, text in build.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            results["phases"][name] = fn(*a)
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f}s")
        except Exception as e:                       # noqa: BLE001
            failed.append(name)
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s: "
                f"{type(e).__name__}: {e}")

    profiles = results["profile"] = {}

    def prof(label, fn):
        # an extra call for the profilers: its launches are not counted
        saved = {c: c.n for c in counters.values()}
        try:
            profiles[label] = p = profiled(torch, fn)
        finally:
            for c, n in saved.items():
                c.n = n
        log(f"[profile] {label}: wall_ms={p['wall_ms']:.1f} device_busy_ms="
            f"{p['device_busy_ms']:.2f} idle_share={p['idle_share']:.4f}")
        for side in ("device_top", "host_top"):
            for e in p[side]:
                log(f"[profile]   {side[:-4]} {e['ms']:.2f} ms "
                    f"/ {e['calls']}: {e['name']}")

    def main_path(label, needs, *phases):
        """Run one main path's phases with every count zeroed just before
        and read just after; each kernel in ``needs`` must have launched."""
        for c in counters.values():
            c.reset()
        for phase in phases:
            run(*phase)
        got = {name: c.n for name, c in counters.items()}
        log(f"[main path] {label} launches {got}")
        for name in needs:
            if got[name] <= 0:
                failed.append(f"{name} never launched on the {label} path")
        return got

    maybe_prof = prof if args.profile else None
    shared = {}
    run("kernels", phase_kernels, torch, args.pq_rows)
    single = main_path(
        "single-node", ("ivf_scan", "pq_scan", "pq_scan_ext"),
        ("serving", phase_serving, torch, args.persons, maybe_prof),
        ("pq", phase_pq, torch, args.pq_rows, shared, maybe_prof))
    cluster = main_path(
        "cluster", ("topk_merge", "ivf_scan"),
        ("cluster", phase_cluster, torch, CLUSTER_PERSONS, shared,
         maybe_prof))
    launches = {name: single[name] + cluster[name] for name in counters}
    run("parity", phase_parity)

    meta = {
        "ivf_scan": ("src/repro_torch/csrc/ivf_scan.cu",
                     "src/repro/kernels/ivf_scan/ivf_scan.py:53"),
        "pq_scan": ("src/repro_torch/csrc/pq_scan.cu",
                    "src/repro/kernels/pq_scan/pq_scan.py:106"),
        "pq_scan_ext": ("src/repro_torch/csrc/pq_scan.cu",
                        "src/repro/kernels/pq_scan/pq_scan.py:153"),
        "topk_merge": ("src/repro_torch/csrc/topk_merge.cu",
                       "src/repro/kernels/topk_merge/topk_merge.py:57"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        k = results["phases"].get("kernels", {}).get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": k.get("max_abs_err"),
                        "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
                        "bound_ms": k.get("bound_ms"),
                        "bound_by": k.get("bound_by"),
                        "library_ms": k.get("library_ms"),
                        "shape": k.get("shape")})
    results["kernels"] = kernels
    results["launches"] = {"single_node": single, "cluster": cluster}
    results["seconds"] = time.perf_counter() - t_start
    results["failed"] = failed
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    log(f"[done] {results['seconds']:.1f}s failed={failed}")
    if failed:
        return 1
    print(results["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
