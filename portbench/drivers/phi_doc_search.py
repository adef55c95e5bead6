"""Closed-loop document ingest, one client: a report's φ, then its kNN.

A PandaDB node registers the configuration's LM (``get_arch(cfg["arch"])``,
built by the port's ``LM`` in bf16 on the run's device, with the weights
``mellum2_weights.py`` draws there from the seed) as the document φ
through ``model_embedding_extractor`` and the AIPM service, as the
executor does.  Each batch draws ``batch`` fresh lowercase report texts of
``text_bytes`` from the seed, extracts their vectors through
``db.aipm.extract_sync`` (the AIPM worker runs the forward over
``max_tokens`` positions, the report cut or zero-padded to them, and the
pooling) and searches the reports' index with ``IVFIndex.search_many``; a
batch's latency runs from the request to the answers on the host.
Set-up builds the index over the configuration's reports (seeded unit
vectors standing in for their φ vectors), builds the model and warms up on
the traffic's own shapes.  A traced run profiles the window's last
``trace_seconds`` with every thread recorded (the forward runs on the AIPM
worker's thread), and reads the device time of the kernels inside the
program's ``phi.forward`` spans and the flash kernels the program
launches inside its ``lm.attn.window`` and ``lm.attn.full`` spans
(:func:`attn_kernels`).

Once the window has closed, a sample of its batches, drawn from the seed,
is judged against the plain float32 reference (``mellum2_ref.py``, run
layer by layer on the run's device with the weights drawn again):
``phi_rel_err``, the largest ||p - r|| / ||r|| of a text, p the vector the
window's φ call normalised (kept as the call returned it) and r the
reference's; ``phi_cos_gap``, the largest 1 - cos between the vector the
window's search was given and r; ``moe_routed_err``, over the layers the
largest ||P - R|| / ||R||, R the reference's experts' weighted sum on that
layer's input (every position of the sample), P the program's
(``moe.moe_ffn``) on the same input in the program's dtype;
``attn_window_err``, the same for the attention of the first sliding and
the first full layer (``LM.attention`` against the reference's);
``moe_dropped_pairs``, the (token, expert) pairs the MoE layers dropped
from the model's build to the end of the comparison (the program's
counter); and the index's numbers (``check.py``) over the window's own φ
vectors.
"""
from __future__ import annotations

import gc
import re
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from portbench import (check, devtrace, mellum2_ref, mellum2_weights,
                       mellum2_work)
from portbench.drivers.phi_search import (_phi_device_s, _profiled,
                                          passages, text_draws)

NAME = "portbench.phi_doc_search"

#: the port's ``TransformerConfig`` field each published key sets
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "moe_intermediate_size": "moe_d_ff",
          "vocab_size": "vocab_size", "num_experts": "n_routed_experts",
          "num_experts_per_tok": "top_k", "rms_norm_eps": "rms_eps",
          "norm_topk_prob": "norm_topk_prob",
          "tie_word_embeddings": "tie_embeddings",
          "sliding_window": "sliding_window"}
YARN = {"factor": "factor",
        "original_max_position_embeddings": "original_max_position",
        "beta_fast": "beta_fast", "beta_slow": "beta_slow",
        "attention_factor": "attention_factor"}
#: the attention kinds the rooflines read (spans ``lm.attn.<kind>``)
ATTN_KINDS = ("window", "full")


def check_model(cfg: dict, model) -> None:
    """Raise unless the program's model config is the file's."""
    bad = [(k, cfg[k], getattr(model, f)) for k, f in FIELDS.items()
           if getattr(model, f) != cfg[k]]
    if tuple(cfg["layer_types"]) != model.layer_types \
            or not cfg["use_sliding_window"]:
        bad.append(("layer_types", cfg["layer_types"], model.layer_types))
    full = cfg["rope_parameters"]["full_attention"]
    sliding = cfg["rope_parameters"]["sliding_attention"]
    yarn = model.yarn
    bad += [(k, full[k], None if yarn is None else getattr(yarn, f))
            for k, f in YARN.items()
            if yarn is None or getattr(yarn, f) != full[k]]
    if (full["rope_type"], sliding["rope_type"]) != ("yarn", "default") \
            or full["rope_theta"] != model.rope_theta \
            or sliding["rope_theta"] != model.rope_theta:
        bad.append(("rope_parameters", cfg["rope_parameters"],
                    (model.rope_theta, yarn)))
    if set(cfg["mlp_layer_types"]) != {"sparse"} \
            or (model.first_dense_layers, model.n_shared_experts) != (0, 0):
        bad.append(("mlp_layer_types", cfg["mlp_layer_types"],
                    (model.first_dense_layers, model.n_shared_experts)))
    if cfg["attention_bias"] or model.qk_norm \
            or cfg["hidden_act"] != "silu":
        bad.append(("attention_bias, qk_norm, hidden_act",
                    (cfg["attention_bias"], False, cfg["hidden_act"]),
                    (False, model.qk_norm, "silu")))
    if model.dtype != cfg["torch_dtype"] or not model.dropless:
        bad.append(("torch_dtype, dropless", (cfg["torch_dtype"], True),
                    (model.dtype, model.dropless)))
    if bad:
        raise ValueError(f"the program's {cfg['arch']} is not the "
                         f"configuration's: {bad}")


def attn_kernels(kernels) -> dict:
    """The traced kernels' names of each attention kind: the flash kernel's
    window instantiation (its last template argument, ``WINDOW``, true),
    which the program launches inside its ``lm.attn.window`` spans alone,
    and its causal one, inside ``lm.attn.full``.  By name, since the
    profiler links a kernel that the ctypes library launches to no range
    around the launch."""
    out = {kind: [] for kind in ATTN_KINDS}
    for name, _, _ in kernels:
        m = re.search(r"flash_fwd(_wgmma)?<([^<>]*)>", name)
        if m is None:
            continue
        args = [a.strip() for a in m.group(2).split(",")]
        if len(args) == (4 if m.group(1) else 3):
            out["window" if args[-1] == "true" else "full"].append(name)
    return out


def phi_numbers(cfg: dict, lm, sample, seed: int, dev, log=None) -> dict:
    """``phi_rel_err``, ``phi_cos_gap``, ``moe_routed_err`` and
    ``attn_window_err`` over ``sample``: (texts, the unit vectors the
    window searched with [B, dim], the vectors the window's φ call
    normalised [B, dim]) of the program's batches."""
    from repro_torch.models import moe

    dim, t = int(cfg["phi"]["dim"]), int(cfg["phi"]["max_tokens"])
    texts = [r for raws, _, _ in sample for r in raws]
    used = np.concatenate([u for _, u, _ in sample]).astype(np.float64)
    prog = np.concatenate([p for _, _, p in sample]).astype(np.float64)
    kinds = cfg["layer_types"]
    probed = {kinds.index("sliding_attention"), kinds.index("full_attention")}
    rope = {kind: mellum2_ref.cos_sin(cfg, kind, t, dev)
            for kind in set(kinds)}
    sums = {}              # (part, layer) -> [||P - R||^2, ||R||^2]

    def tap(part, i, h, w):
        hp = h.to(lm.dtype)
        if part == "moe":
            want = mellum2_ref.moe(cfg, hp.float(), w)
            got, _ = moe.moe_ffn(moe.nest_moe_params(
                {n: p[i] for n, p in lm.moe_layers.items()}), hp, lm.cfg)
        elif i in probed:
            want = mellum2_ref.attention(cfg, i, hp.float(), w,
                                         *rope[kinds[i]])
            got = lm.attention(i, hp)
        else:
            return
        acc = sums.setdefault((part, i), [0.0, 0.0])
        acc[0] += float(torch.sum((got.double() - want.double()) ** 2))
        acc[1] += float(torch.sum(want.double() ** 2))

    def layer(i):
        return mellum2_weights.layer(cfg, seed, i, dev)

    top = mellum2_weights.top(cfg, seed, dev)
    with torch.no_grad():
        ref = torch.cat([mellum2_ref.phi(
            cfg, mellum2_ref.text_tokens([r], cfg["vocab_size"], t).to(dev),
            top, layer, dim, tap) for r in texts])
    del top
    ref = ref.double().cpu().numpy()
    rn = np.linalg.norm(ref, axis=1)
    rel = np.linalg.norm(prog - ref, axis=1) / np.maximum(rn, 1e-30)
    cos = (used * ref).sum(1) / np.maximum(
        np.linalg.norm(used, axis=1) * rn, 1e-30)
    errs = {key: (a / b) ** 0.5 if b > 0 else float("inf")
            for key, (a, b) in sorted(sums.items())}
    routed = [v for (part, _), v in errs.items() if part == "moe"]
    attn = [v for (part, _), v in errs.items() if part == "attn"]
    if log is not None:
        log(f"[phi] {len(rel)} texts: rel err {rel.tolist()}; 1 - cos "
            f"{(1 - cos).tolist()}; experts' rel err by layer "
            f"{[round(v, 6) for v in routed]}; attention's rel err, layers "
            f"{sorted(probed)}: {[round(v, 6) for v in attn]}")
    return {"phi_rel_err": float(rel.max()),
            "phi_cos_gap": float((1.0 - cos).max()),
            "moe_routed_err": max(routed) if routed else float("inf"),
            "attn_window_err": max(attn) if len(attn) == 2
            else float("inf")}


def run(ctx: dict) -> dict:
    from repro_torch.configs import (AIPMConfig, PandaDBConfig,
                                     VectorIndexConfig, get_arch)
    from repro_torch.core.aipm import model_embedding_extractor
    from repro_torch.core.database import PandaDB
    from repro_torch.core.vector_index import IVFIndex
    from repro_torch.models import moe
    from repro_torch.models.transformer import LM

    cfg, tr, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], \
        ctx["device"]
    log = ctx["log"]
    arch = get_arch(cfg["arch"])          # the model's name, first: a
    check_model(cfg, arch.model)          # program without it fails here
    index_spec, phi = cfg["index"], cfg["phi"]
    dim, t = int(phi["dim"]), int(phi["max_tokens"])
    k, nprobe, batch = int(tr["k"]), int(tr["nprobe"]), int(tr["batch"])
    sub_key = phi["sub_key"]
    t_imports = time.perf_counter()
    rows = passages(int(cfg["corpus_reports"]), dim, seed, dev)
    t_data = time.perf_counter()
    index = IVFIndex.build(rows, cfg=VectorIndexConfig(
        dim=dim, metric=index_spec["metric"],
        vectors_per_bucket=int(index_spec["vectors_per_bucket"]),
        min_buckets=int(index_spec["min_buckets"]),
        nprobe=int(index_spec["nprobe"]),
        kmeans_iters=int(index_spec["kmeans_iters"]),
        pq_m=int(index_spec["pq_m"])), seed=seed, device=dev)
    t_build = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    lm = LM(arch.model, device=dev, generator=gen)
    mellum2_weights.load(cfg, seed, lm)
    dropped0 = moe.METRICS.counter("moe.dropped_pairs").value
    db = PandaDB(PandaDBConfig(aipm=AIPMConfig(
        max_batch=int(phi["batch_size"]),
        auto_batch=bool(phi["auto_batch"]))), device=dev)
    fn = model_embedding_extractor(lm, dim=dim, max_tokens=t)
    # the vectors each φ call normalises, kept as it returns them (the
    # extractor calls its ``raw`` through the attribute)
    kept, inner = [], fn.raw

    def keep(raws):
        kept.append(inner(raws))
        return kept[-1]
    fn.raw = keep
    db.register_extractor(sub_key, fn, batch_size=int(phi["batch_size"]))
    t_model = time.perf_counter()
    lo, hi = tr["text_bytes"]
    draws = text_draws(seed, batch, int(lo), int(hi))
    # the first forward builds the model's kernels: on this thread, since
    # the AIPM request's timeout is set for calls, not for builds
    fn(next(draws))
    t_first = time.perf_counter()

    def phi_and_search(raws):
        kept.clear()
        got = db.aipm.extract_sync(sub_key, list(enumerate(raws)))
        q = np.stack([got[i] for i in range(len(raws))]).astype(np.float32)
        return q, np.concatenate(kept), index.search_many(q, k, nprobe)

    # warm up through the service until the rate has settled
    t_warm, n_warm = time.perf_counter(), 0
    while n_warm < 3 or time.perf_counter() - t_warm < float(
            tr["warmup_seconds"]):
        phi_and_search(next(draws))
        n_warm += 1
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx["t_start"]
    log(f"[phi_doc_search] {len(rows)} reports, "
        f"{index.centroids.shape[0]} buckets, {arch.name} "
        f"{arch.model.n_layers} layers; set-up {setup_s:.3f} s: imports "
        f"{t_imports - ctx['t_start']:.3f}, data {t_data - t_imports:.3f}, "
        f"build {t_build - t_data:.3f}, model {t_model - t_build:.3f}, "
        f"first forward {t_first - t_model:.3f}, warm-up "
        f"{time.perf_counter() - t_first:.3f} ({n_warm} batches); device "
        f"peak {torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0:.2f}"
        f" GB")

    trace_s = min(float(tr["trace_seconds"]), ctx["seconds"]) \
        if ctx["trace"] else 0.0
    if trace_s:
        with _profiled(True):            # the profiler's own start-up, once
            pass
    pick = np.random.default_rng([int(seed), 2])
    sample, n_keep = [], int(tr["check_batches"])
    lat, n_batches, failed = [], 0, 0
    rows0 = index.scan_rows
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def one_batch() -> None:
        nonlocal failed, n_batches
        raws = next(draws)
        t1 = time.perf_counter()
        try:
            with record_function(NAME):
                q, raw, (vals, ids) = phi_and_search(raws)
        except Exception:  # a failed batch is counted, the run goes on
            if not failed:
                log(traceback.format_exc())
            failed += len(raws)
            return
        lat.append(time.perf_counter() - t1)
        n_batches += 1
        # reservoir sample of the batches, from the seed
        j = n_batches - 1
        if j < n_keep:
            sample.append((raws, q, raw, vals, ids))
        else:
            r = int(pick.integers(0, j + 1))
            if r < n_keep:
                sample[r] = (raws, q, raw, vals, ids)

    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx["seconds"] - trace_s:
            one_batch()
        untraced = n_batches
        with _profiled(trace_s > 0) as prof:
            with record_function(devtrace.WINDOW):
                while time.perf_counter() - t0 < ctx["seconds"]:
                    one_batch()
            window_s = time.perf_counter() - t0
    finally:
        gc.enable()
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = None
    if prof is not None:
        summary = devtrace.summarize(prof)
        if summary is not None:
            summary["batches"] = n_batches - untraced
            summary["phi_device_s"] = _phi_device_s(prof)
            summary["attn_kernels"] = attn_kernels(summary["kernels"])
        del prof
    scanned = index.scan_rows - rows0
    state = {"centroids": np.array(index.centroids, np.float32),
             "bucket_of": np.array(index.bucket_of),
             "ids": np.array(index.ids)}
    del index
    if cuda:
        torch.cuda.empty_cache()

    # the comparison, after the window and the peak's reading
    t_check = time.perf_counter()
    numbers = phi_numbers(cfg, lm, [s[:3] for s in sample], seed, dev, log)
    numbers["moe_dropped_pairs"] = moe.METRICS.counter(
        "moe.dropped_pairs").value - dropped0
    t_phi = time.perf_counter()
    db.aipm.shutdown()
    del db, fn, lm
    if cuda:
        torch.cuda.empty_cache()
    numbers.update(check.build_numbers(rows, index_spec, seed, state, dev))
    queries = np.concatenate([s[1] for s in sample]) if sample else \
        np.zeros((0, dim), np.float32)
    answers, off = [], 0
    for raws, q, _, vals, ids in sample:
        answers.append((np.arange(off, off + len(q)), vals, ids))
        off += len(q)
    found = check.search_numbers(rows, queries, answers, state,
                                 index_spec["metric"], k, nprobe, dev)
    compared = found.pop("answers")
    numbers.update(found)
    tenth = max(1, len(lat) // 10)
    log(f"[phi_doc_search] {n_batches} batches in {window_s:.3f} s (mean "
        f"ms of the first and last tenth: {1e3 * np.mean(lat[:tenth]):.3f}, "
        f"{1e3 * np.mean(lat[-tenth:]):.3f}); comparison: phi "
        f"{t_phi - t_check:.3f} s, index {time.perf_counter() - t_phi:.3f} s")
    return {"attempted": n_batches * batch + failed, "failed": failed,
            "setup_s": setup_s,
            "window_s": window_s, "batches": n_batches,
            "queries": n_batches * batch, "latencies_s": lat,
            "peak_window_bytes": peak_window,
            "memory_peak_bytes": max(peak_setup, peak_window),
            "scan_rows": scanned,
            "phi_flops": n_batches * mellum2_work.call_flops(cfg, batch, t),
            "attn_least_s": {kind: mellum2_work.attn_least_s(cfg, kind,
                                                             batch, t)
                             for kind in ATTN_KINDS},
            "trace": summary, "numbers": numbers, "compared": compared}
