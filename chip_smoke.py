#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--persons N] [--pq-rows N] [--profile]
                          [--out results.json]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once), then runs four phases and fails if any fails:

1. kernels against plain: each kernel's wrapper against its plain PyTorch
   version on the card, at the main path's shapes (IVF: Q in {256, 930},
   N = 200,000, d = 128, k in {10, 64, 20,001}; PQ: Q = 256, N = 1,000,000,
   M = 16, K = 256, k' in {80, 800}), with a ragged ``n_valid``, exact
   duplicate rows (ties) and starved probe masks.  Integer-valued vectors
   keep the IVF sums exact, and the PQ sums run in the plain version's
   order, so ids must be equal and max |delta| <= 1e-4.  Prints kernel,
   plain and library (one PyTorch call of the same function) times.
2. serving: ``PandaDB(device="cuda")`` over an SNB graph of ``--persons``
   persons (100,000 by default) with 128-d faces and the IVF-Flat face
   index; a ``QueryServer`` answers the semantic and structured requests
   below, the unfiltered ``knows`` var-var query among them.  Launch counts
   are zeroed just before this phase and read after phase 3.
3. PQ: ``IVFIndex.search_many`` on 1,000,000 SIFT-like vectors (pq_m=16),
   Q = 256, k in {10, 100}, in ``adc``, residual ``adc`` and ``fused`` mode,
   each held against the float ``search_exact`` by recall (>= 0.90; the
   card reads 0.94 at k=10 and 0.98 at k=100 on this data).
4. parity: the serving requests at 5,000 persons, card against CPU: rows
   identical.

``--profile`` runs each serving request and each PQ search mode once more,
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
    return out


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


def serve(db, persons, device: str):
    """Every request through one QueryServer: {name: (rows, ms)}."""
    from repro_torch.serving.engine import QueryServer

    server = QueryServer(db, n_workers=2)
    server.start()
    out = {}
    try:
        for name, text in SERVE_REQUESTS:
            params = ({"src": photo_of(db, persons[7])}
                      if "$src" in text else None)
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
    answers = serve(db, persons, "cuda")
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
    card, persons = build_db(n_persons, "cuda")
    cpu, _ = build_db(n_persons, "cpu")
    a, b = serve(card, persons, "cuda"), serve(cpu, persons, "cpu")
    for name, _ in SERVE_REQUESTS:
        check(a[name][0] == b[name][0],
              f"parity: {name} rows differ card vs cpu")
        log(f"[parity] {name}: rows={len(a[name][0])} identical card/cpu")
    card.aipm.shutdown()
    cpu.aipm.shutdown()


# ---------------------------------------------------------------------------
# phase 3: PQ
# ---------------------------------------------------------------------------


def phase_pq(torch, n_rows: int, prof=None):
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

    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    results = {"card": card[0] if card else "", "phases": {}}
    counters = {"ivf_scan": ivf_ops.launches, "pq_scan": pq_ops.launches,
                "pq_scan_ext": pq_ops.ext_launches}
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

    run("kernels", phase_kernels, torch, args.pq_rows)
    for c in counters.values():
        c.reset()
    run("serving", phase_serving, torch, args.persons,
        prof if args.profile else None)
    serving_ivf = ivf_ops.launches.n
    run("pq", phase_pq, torch, args.pq_rows, prof if args.profile else None)
    launches = {name: c.n for name, c in counters.items()}
    log(f"[main path] launches {launches} (ivf_scan while serving: "
        f"{serving_ivf})")
    if serving_ivf <= 0:
        failed.append("serving launched no ivf_scan")
    for name, n in launches.items():
        if n <= 0:
            failed.append(f"{name} never launched on the main path")
    run("parity", phase_parity)

    meta = {
        "ivf_scan": ("src/repro_torch/csrc/ivf_scan.cu",
                     "src/repro/kernels/ivf_scan/ivf_scan.py:53"),
        "pq_scan": ("src/repro_torch/csrc/pq_scan.cu",
                    "src/repro/kernels/pq_scan/pq_scan.py:106"),
        "pq_scan_ext": ("src/repro_torch/csrc/pq_scan.cu",
                        "src/repro/kernels/pq_scan/pq_scan.py:153"),
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
    results["launches"] = launches
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
