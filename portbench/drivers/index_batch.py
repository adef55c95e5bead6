"""Closed-loop batched kNN through ``IVFIndex.search_many``, one client.

Set-up builds the index with ``IVFIndex.build`` from the configuration's
rows, made from the seed, on the run's device, and warms up on the
traffic's own batch shape for ``warmup_seconds`` (a run's first seconds
are slower until the rate settles).  The window then sends batches of
``batch`` distinct queries from the configuration's query set, each as
soon as the one before has returned (``search_many`` returns host arrays,
so a call ends when its answers are on the host), for ``seconds``; a
traced run profiles the window's last ``trace_seconds``.  Once the window
has closed, the index's state and a sample of the batches' answers, drawn
from the seed, are judged against the plain reference (``check.py``).
"""
from __future__ import annotations

import gc
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, data, devtrace, roofline

NAME = "portbench.search_many"


def run(ctx: dict) -> dict:
    from repro_torch.configs.pandadb import VectorIndexConfig
    from repro_torch.core.vector_index import IVFIndex

    cfg, tr, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], \
        ctx["device"]
    log = ctx["log"]
    index_spec = cfg["index"]
    t_imports = time.perf_counter()
    rows, queries = data.make_vectors(cfg["vectors"], int(cfg["n_queries"]),
                                      seed, dev)
    t_data = time.perf_counter()
    index = IVFIndex.build(rows, cfg=VectorIndexConfig(
        dim=rows.shape[1], metric=index_spec["metric"],
        vectors_per_bucket=int(index_spec["vectors_per_bucket"]),
        min_buckets=int(index_spec["min_buckets"]),
        nprobe=int(index_spec["nprobe"]),
        kmeans_iters=int(index_spec["kmeans_iters"]),
        pq_m=int(index_spec["pq_m"])), seed=seed, device=dev)
    t_build = time.perf_counter()
    k, nprobe, batch = int(tr["k"]), int(tr["nprobe"]), int(tr["batch"])
    draws = data.batch_draws(seed, len(queries), batch)
    # warm up on this traffic's shapes until the rate has settled
    t_warm, n_warm = time.perf_counter(), 0
    while n_warm < 3 or time.perf_counter() - t_warm < float(
            tr["warmup_seconds"]):
        index.search_many(queries[next(draws)], k, nprobe)
        n_warm += 1
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx["t_start"]
    log(f"[index_batch] {len(rows)} rows, {index.centroids.shape[0]} "
        f"buckets, set-up {setup_s:.3f} s: imports "
        f"{t_imports - ctx['t_start']:.3f}, data {t_data - t_imports:.3f}, "
        f"build {t_build - t_data:.3f}, warm-up "
        f"{time.perf_counter() - t_build:.3f}")

    # the window: one client, closed loop.  A traced run records only its
    # last ``trace_seconds``: a profile of every launch of a long window
    # takes longer to read than a run may last
    trace_s = min(float(tr["trace_seconds"]), ctx["seconds"]) \
        if ctx["trace"] else 0.0
    if trace_s:
        with devtrace.profiled(True):   # the profiler's own start-up, once
            pass
    pick = np.random.default_rng([int(seed), 2])
    sample, n_keep = [], int(tr["check_batches"])
    lat, batches = [], []
    failed = 0
    rows0 = index.scan_rows
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def one_batch() -> None:
        nonlocal failed
        qi = next(draws)
        t1 = time.perf_counter()
        try:
            with record_function(NAME):
                vals, ids = index.search_many(queries[qi], k, nprobe)
        except Exception:  # a failed batch is counted, the run goes on
            if not failed:
                log(traceback.format_exc())
            failed += len(qi)
            return
        lat.append(time.perf_counter() - t1)
        batches.append(qi)
        # reservoir sample of the answers, from the seed
        j = len(batches) - 1
        if j < n_keep:
            sample.append((qi, vals, ids))
        else:
            r = int(pick.integers(0, j + 1))
            if r < n_keep:
                sample[r] = (qi, vals, ids)

    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx["seconds"] - trace_s:
            one_batch()
        untraced = len(batches)
        with devtrace.profiled(trace_s > 0) as prof:
            with record_function(devtrace.WINDOW):
                while time.perf_counter() - t0 < ctx["seconds"]:
                    one_batch()
            window_s = time.perf_counter() - t0
    finally:
        gc.enable()
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = devtrace.summarize(prof) if prof is not None else None
    scanned = index.scan_rows - rows0
    state = {"centroids": np.array(index.centroids, np.float32),
             "bucket_of": np.array(index.bucket_of),
             "ids": np.array(index.ids)}
    del index
    if cuda:
        torch.cuda.empty_cache()

    # the comparison, after the window and the peak's reading
    t_check = time.perf_counter()
    numbers = check.build_numbers(rows, index_spec, seed, state, dev)
    found = check.search_numbers(rows, queries, sample, state,
                                 index_spec["metric"], k, nprobe, dev)
    compared = found.pop("answers")
    numbers.update(found)
    probe = roofline.probe_masks(queries, state["centroids"],
                                 index_spec["metric"], nprobe)
    sizes = np.bincount(state["bucket_of"].astype(np.int64),
                        minlength=state["centroids"].shape[0])
    work = roofline.knn_work(batches, probe, sizes, rows.shape[1], k)
    if summary is not None:
        summary["batches"] = len(batches) - untraced
        summary["least_s"] = roofline.knn_work(
            batches[untraced:], probe, sizes, rows.shape[1], k)["least_s"]
    tenth = max(1, len(lat) // 10)
    log(f"[index_batch] {len(batches)} batches in {window_s:.3f} s (mean "
        f"ms of the first and last tenth: {1e3 * np.mean(lat[:tenth]):.3f}, "
        f"{1e3 * np.mean(lat[-tenth:]):.3f}); comparison "
        f"{time.perf_counter() - t_check:.3f} s")
    return {"attempted": len(batches) * batch + failed, "failed": failed,
            "setup_s": setup_s,
            "window_s": window_s, "batches": len(batches),
            "queries": len(batches) * batch, "latencies_s": lat,
            "peak_window_bytes": peak_window,
            "memory_peak_bytes": max(peak_setup, peak_window),
            "scan_rows": scanned, "work": work, "trace": summary,
            "numbers": numbers, "compared": compared}
