"""Closed-loop semantic text search, one client: φ, then the kNN.

A PandaDB node registers the configuration's LM (``get_arch(cfg["arch"])``,
built by the port's ``LM`` in bf16 on the run's device, with the weights
``phi_weights.py`` draws there from the seed) as the ``textvec`` φ through
``model_embedding_extractor`` and the AIPM service, as the executor does.
Each batch draws ``batch`` fresh lowercase query texts from the seed,
extracts their vectors through ``db.aipm.extract_sync`` (the AIPM worker
runs the forward and the pooling) and searches the passages' index with
``IVFIndex.search_many``; a batch's latency runs from the request to the
answers on the host.  Set-up builds the index over the configuration's
passages (seeded unit vectors standing in for the passages' φ vectors),
builds the model and warms up on the traffic's own shapes.  A traced run
profiles the window's last ``trace_seconds`` with every thread recorded
(the forward runs on the AIPM worker's thread).

Once the window has closed, a sample of its batches, drawn from the seed,
is judged against the plain float32 reference (``deepseek_v2_ref.py``, run
layer by layer on the run's device with ``phi_weights.py``'s weights drawn
again): ``phi_rel_err``, the largest ||p - r|| / ||r|| of a text, p the
vector the window's φ call normalised (kept as the call returned it) and r
the reference's; ``phi_cos_gap``, the largest 1 - cos between the vector
the window's search was given and r; ``moe_routed_err``, over the MoE
layers the largest ||P - R|| / ||R||, R the reference's routed experts'
weighted sum on that layer's input (every token of the sample), P the
program's (``moe.moe_ffn`` with the shared experts left out) on the same
input in the program's dtype; ``moe_dropped_pairs``, the (token, expert)
pairs the MoE layers dropped from the model's build to the end of the
comparison (the program's counter); and the index's numbers
(``check.py``) over the window's own φ vectors.
"""
from __future__ import annotations

import gc
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, deepseek_v2_ref, devtrace, phi_weights, phi_work

NAME = "portbench.phi_search"
SUB_KEY = "textvec"

#: the port's ``TransformerConfig`` field each published key sets
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "intermediate_size": "d_ff",
          "moe_intermediate_size": "moe_d_ff", "vocab_size": "vocab_size",
          "n_routed_experts": "n_routed_experts",
          "n_shared_experts": "n_shared_experts",
          "num_experts_per_tok": "top_k",
          "first_k_dense_replace": "first_dense_layers",
          "kv_lora_rank": "kv_lora_rank", "q_lora_rank": "q_lora_rank",
          "qk_nope_head_dim": "qk_nope_head_dim",
          "qk_rope_head_dim": "qk_rope_head_dim",
          "v_head_dim": "v_head_dim", "rope_theta": "rope_theta",
          "rms_norm_eps": "rms_eps", "norm_topk_prob": "norm_topk_prob",
          "tie_word_embeddings": "tie_embeddings"}
YARN = {"factor": "factor",
        "original_max_position_embeddings": "original_max_position",
        "beta_fast": "beta_fast", "beta_slow": "beta_slow",
        "mscale": "mscale", "mscale_all_dim": "mscale_all_dim"}


def check_model(cfg: dict, model) -> None:
    """Raise unless the program's model config is the file's."""
    # a null q_lora_rank is the port's 0
    bad = [(k, cfg[k], getattr(model, f)) for k, f in FIELDS.items()
           if getattr(model, f) != (0 if cfg[k] is None else cfg[k])]
    yarn = model.yarn
    bad += [(k, cfg["rope_scaling"][k], None if yarn is None
             else getattr(yarn, f)) for k, f in YARN.items()
            if yarn is None or getattr(yarn, f) != cfg["rope_scaling"][k]]
    if model.dtype != cfg["torch_dtype"] or not model.dropless:
        bad.append(("torch_dtype, dropless", (cfg["torch_dtype"], True),
                    (model.dtype, model.dropless)))
    # the port's gate has no scale: it runs the published factor of 1 only
    if cfg["routed_scaling_factor"] != 1:
        bad.append(("routed_scaling_factor", cfg["routed_scaling_factor"],
                    1))
    if bad:
        raise ValueError(f"the program's {cfg['arch']} is not the "
                         f"configuration's: {bad}")


def text_draws(seed: int, batch: int, lo: int, hi: int):
    """Endless batches of ``batch`` lowercase ASCII texts of ``lo``-``hi``
    bytes (uint8 arrays), drawn from the seed."""
    rng = np.random.default_rng([int(seed), 3])
    while True:
        lens = rng.integers(lo, hi + 1, batch)
        chars = rng.integers(ord("a"), ord("z") + 1, (batch, hi),
                             dtype=np.uint8)
        yield [chars[i, :lens[i]].copy() for i in range(batch)]


def passages(n: int, dim: int, seed: int, device: torch.device
             ) -> np.ndarray:
    """[n, dim] float32 seeded unit vectors (host)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.randn((n, dim), generator=gen, device=device)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-9)
    out = x.cpu().numpy()
    del x
    return out


def _phi_device_s(prof) -> float:
    """Device seconds of the kernels launched inside ``phi.forward``."""
    from torch.autograd import DeviceType
    return sum(e.device_time_total for e in prof.events()
               if e.name == "phi.forward"
               and e.device_type == DeviceType.CPU) / 1e6


def _profiled(enabled: bool):
    """``devtrace.profiled`` with every thread recorded, where this torch
    can (φ runs on the AIPM service's worker thread)."""
    if not enabled:
        return devtrace.profiled(False)
    from torch.profiler import ProfilerActivity, profile
    try:
        from torch._C._profiler import _ExperimentalConfig
        extra = {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        extra = {}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, **extra)


def phi_numbers(cfg: dict, lm, sample, seed: int, dev, log=None) -> dict:
    """``phi_rel_err``, ``phi_cos_gap`` and ``moe_routed_err`` over
    ``sample``: (texts, the unit vectors the window searched with [B, dim],
    the vectors the window's φ call normalised [B, dim]) of the program's
    batches."""
    import dataclasses

    from repro_torch.models import moe

    dim, t = int(cfg["phi"]["dim"]), int(cfg["phi"]["max_tokens"])
    texts = [r for raws, _, _ in sample for r in raws]
    used = np.concatenate([u for _, u, _ in sample]).astype(np.float64)
    prog = np.concatenate([p for _, _, p in sample]).astype(np.float64)
    n_dense = cfg["first_k_dense_replace"]
    routed_ref = dict(cfg, n_shared_experts=0)
    routed_prog = dataclasses.replace(lm.cfg, n_shared_experts=0)
    sums = {}                      # MoE layer -> [||P - R||^2, ||R||^2]

    def tap(i, h, w):
        hp = h.to(lm.dtype)
        want = deepseek_v2_ref.moe(routed_ref, hp.float(), w)
        flat = {n: p[i - n_dense] for n, p in lm.moe_layers.items()
                if not n.startswith("shared_")}
        got, _ = moe.moe_ffn(moe.nest_moe_params(flat), hp, routed_prog)
        acc = sums.setdefault(i, [0.0, 0.0])
        acc[0] += float(torch.sum((got.double() - want.double()) ** 2))
        acc[1] += float(torch.sum(want.double() ** 2))

    def layer(i):
        return phi_weights.layer(cfg, seed, i, dev)

    top = phi_weights.top(cfg, seed, dev)
    tokens = deepseek_v2_ref.text_tokens(texts, cfg["vocab_size"], t)
    with torch.no_grad():
        ref = torch.cat([deepseek_v2_ref.phi(cfg, tokens[i:i + 256].to(dev),
                                             top, layer, dim, tap)
                         for i in range(0, len(texts), 256)])
    del top
    ref = ref.double().cpu().numpy()
    rn = np.linalg.norm(ref, axis=1)
    rel = np.linalg.norm(prog - ref, axis=1) / np.maximum(rn, 1e-30)
    cos = (used * ref).sum(1) / np.maximum(
        np.linalg.norm(used, axis=1) * rn, 1e-30)
    routed = {i: (a / b) ** 0.5 if b > 0 else float("inf")
              for i, (a, b) in sorted(sums.items())}
    if log is not None:
        q = [100, 99, 90, 50]
        log(f"[phi] {len(rel)} texts: rel err max/p99/p90/p50 "
            f"{np.percentile(rel, q).tolist()}, over all "
            f"{np.linalg.norm(prog - ref) / np.linalg.norm(ref)}; 1 - cos "
            f"max/p99/p90/p50 {np.percentile(1 - cos, q).tolist()}, mean "
            f"{float((1 - cos).mean())}; routed experts' rel err by MoE "
            f"layer {[round(v, 6) for v in routed.values()]}")
    return {"phi_rel_err": float(rel.max()),
            "phi_cos_gap": float((1.0 - cos).max()),
            "moe_routed_err": max(routed.values()) if routed
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
    t_imports = time.perf_counter()
    rows = passages(int(cfg["corpus_passages"]), dim, seed, dev)
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
    phi_weights.load(cfg, seed, lm)
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
    db.register_extractor(SUB_KEY, fn, batch_size=int(phi["batch_size"]))
    t_model = time.perf_counter()
    lo, hi = tr["text_bytes"]
    draws = text_draws(seed, batch, int(lo), int(hi))
    # the first forward builds the model's kernels: on this thread, since
    # the AIPM request's timeout is set for calls, not for builds
    fn(next(draws))
    t_first = time.perf_counter()

    def phi_and_search(raws):
        kept.clear()
        got = db.aipm.extract_sync(SUB_KEY, list(enumerate(raws)))
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
    log(f"[phi_search] {len(rows)} passages, "
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
    log(f"[phi_search] {n_batches} batches in {window_s:.3f} s (mean ms "
        f"of the first and last tenth: {1e3 * np.mean(lat[:tenth]):.3f}, "
        f"{1e3 * np.mean(lat[-tenth:]):.3f}); comparison: phi "
        f"{t_phi - t_check:.3f} s, index {time.perf_counter() - t_phi:.3f} s")
    return {"attempted": n_batches * batch + failed, "failed": failed,
            "setup_s": setup_s,
            "window_s": window_s, "batches": n_batches,
            "queries": n_batches * batch, "latencies_s": lat,
            "peak_window_bytes": peak_window,
            "memory_peak_bytes": max(peak_setup, peak_window),
            "scan_rows": scanned,
            "phi_flops": n_batches * phi_work.call_flops(cfg, batch, t),
            "trace": summary, "numbers": numbers, "compared": compared}
