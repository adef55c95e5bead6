#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--persons N] [--pq-rows N] [--profile]
                          [--out results.json]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once), then runs seventeen phases and fails if any
fails:

1. kernels against plain: each kernel's wrapper against its plain PyTorch
   version on the card, at the main paths' shapes (IVF: Q in {256, 930}, N =
   200,000, d = 128, k in {10, 64, 20,001}, and the serving knows request's
   chunk scan, Q = 800, N = 100,000, k = 10,002, each timed whole and split
   into scoring, selection and the sort of the k survivors; the index's
   masked dense scan at the probe8 cell's shape, Q = 256, N = 1,000,000,
   k = 10, each query probing 8 of 10 buckets, 1,000 rows' buckets out of
   order, against the plain version with the same mask, max |delta| 0,
   with its device time split the same way, and in cosine, the phi cell's
   scan, on +-1 vectors of norm 8 (exact normalised sums), max |delta| 0;
   PQ, both forms:
   Q = 256, N = 1,000,000, M = 16, K = 256, k' in {80, 800}, and the adc
   path's probe groups, Q in {1, 6, 20} over 800,000 rows, k' in {80, 800},
   split the same way, the scoring also timed at each query-slot count;
   merge: P in {2, 4, 8} shard windows of K in {10, 100, 10,002} for Q in
   {1, 256, 4096}, the windows past the one-launch path split into
   selection, sort and epilogue), with a ragged ``n_valid``, exact duplicate rows and
   cross-shard ties, (-inf, -1) padding, an all-padding shard, starved probe
   masks and int64 ids past 2**31.  Integer-valued vectors keep the IVF sums
   exact, the PQ sums run in the plain version's order and the merge does no
   arithmetic, so ids must be equal and max |delta| <= 1e-4 (0 for the
   merge).  The attention kernels run at the LM paths' shapes (flash:
   llama3-8b's prefill, B=8, S=4,096, 32/8 heads of 128, bf16, plus the phi
   forward's S=64, a ragged S, head width 160, each with the
   float32-faithful weights and with ``bf16_probs``, and a float32 case;
   deepseek-moe-16b's prefill, 16/16 heads; deepseek-v2's MLA prefill at
   B=8, 128 heads, q and k at 192, v at 128; the phi cell's
   DeepSeek-V2-Lite MLA, B=256, S=64, 16 heads, q and k at 192, v at 128;
   the Mellum2 cell's, B=1, S=32,768, 32 query heads over 4 of 128, with
   the sliding layers' window of 1,024 (SDPA given the band as a boolean
   mask) and in the full layers;
   decode: B=8 over a
   32,768-position cache with positions spread over it, at the LM path's
   positions, head width 160, float32; deepseek-moe-16b's decode, B=4, 16/16
   heads, spread and at its path's positions) and at the other shapes the
   reference serves (flash: 512 queries against 4,096 keys, MLA's prefill at
   B=1, a padded width of 80; decode: MLA's widths, 16 query heads per key
   head, width 96 in float32), within rtol=1e-2, atol=1e-4 in bf16 (one
   bf16 ulp of
   the output; with ``bf16_probs`` plus the slack of the weights that sit
   within 2^-12 of a bf16 midpoint and may round the other way on either
   side) and 1e-4 in float32; in each bf16 case, in both modes, a planted
   fault, the values of 32 keys zeroed, must fail that limit on the longest
   rows.  Prints kernel, plain and library (one PyTorch call of the same
   function) times and the bounds (for flash also the floor of its
   two-product P.V, for PQ the shared-memory floor of its gathers); the
   MoE and MLA paths' attention cases also in device time (torch.profiler,
   kernel and SDPA).  The flash backward (``flash_attention_bwd``) at the
   training path's shape (B=2, S=4,096, 32/8 heads of 128, bf16, causal),
   at MLA's widths, with more queries than keys, unmasked, and in float32:
   dq, dk and dv against the plain version on the forward kernel's o, m and
   l (m and l first held against the plain forward's), within rtol 1e-2
   plus 2^-10 of the tensor's largest value in bf16 (1e-4 and 1e-5 in
   float32); a planted fault must fail each limit (a key tile of v zeroed:
   dq and dk; 32 rows of dO zeroed: dv); SDPA's backward (forward +
   backward minus forward) is its library time.  ``gather_scatter``, the
   GNN's SpMM, at ogb_products' two GraphSAGE layers (2,449,029 nodes,
   61,859,328 power-law edges, d = 100 and 128, float32, sum and mean, the
   backward at d = 128), at E = 1,000,000 with a planted hub row of
   60,000 edges each way (the kernel's long-row path: split by columns),
   forward and backward bit for bit against the plain version on the CPU
   (the backward against its sum over the reversed edges), at the
   minibatch block (169,984 nodes, 168,960
   edges, d = 602 and 128, also bf16) and at Cora (d = 16, 7 and 1,433;
   empty rows, masked edges): within 1e-5 of each element's sum |w x| of
   the plain version on the card (bf16 stores: plus one bf16 rounding), the
   backward likewise; a planted fault, one edge's term dropped (also each
   hub row's largest, forward and backward), must fail that limit; kernel,
   device, plain (where its [E, d] messages fit) and library
   (``torch.sparse.mm``; for the backward over the CSR by source) times,
   the bound and the gather floor.  The recsys path's shapes: AutoInt's
   embedding bag at train_batch (65,536 x 39 x 4 ids over 39 tables of
   1,000,000 x 16 float32, mean; E = 10,223,616 into 2,555,904 bags) with
   uniform and with Zipf ids, forward and the tables' gradient, against
   the plain version on the card within 1e-5 of each element's sum |x| /
   H and bit for bit against the CPU's; planted faults (the most frequent
   id's table row zeroed; one of its bags' cotangent zeroed) must fail the
   limits; timed beside ``F.embedding_bag(mode="mean")``, forward and
   forward + backward, with the gather floor as bound.  ``ivf_scan`` at
   retrieval's shape (Q = 1, N = 1,000,000, d = 1,248, ip, k = 100,
   integer-valued, ties): ids equal to plain, exact values, beside
   ``torch.mv`` + a stable top-k.
2. serving: ``PandaDB(device="cuda")`` over an SNB graph of ``--persons``
   persons (100,000 by default) with 128-d faces and the IVF-Flat face
   index; a ``QueryServer`` answers the semantic and structured requests
   below, the unfiltered ``knows`` var-var query among them.
3. PQ: ``IVFIndex.search_many`` on 1,000,000 SIFT-like vectors (pq_m=16),
   Q = 256, k in {10, 100}, in ``adc``, residual ``adc`` and ``fused`` mode,
   each held against the float ``search_exact`` by recall (>= 0.90; the
   card reads 0.94 at k=10 and 0.98 at k=100 on this data).  Then one adc
   and one fused search at k=100 with every ``pq_adc_topk`` call (each probe
   group's in adc) held against the plain version on the same inputs: ids
   equal, max |delta| <= 1e-4.
4. cluster: ``ShardedPandaDB(n_shards=4, device="cuda")`` over 100,000
   persons written through the coordinator as ``launch/serve.py::
   build_cluster`` does, 128-d faces, four IVF-Flat pieces on the card.  A
   ``QueryServer`` over it answers the cluster requests; ``knn`` at Q = 256, k in {10, 100} is held against
   the merged single index; phase 3's residual 1M-row index, cut in four,
   serves a fused scatter-gather by recall (>= 0.90); a 2 x 2
   ``ReplicatedPandaDB`` at 20,000 persons loses a replica halfway through
   a closed loop and must fail no request.
5. lm: ``LM(llama3-8b, device="cuda")`` at full width and depth (32 layers,
   bf16), initialised on the card from a seeded generator; ``prefill_step``
   on 8 prompts of 4,096 tokens, its cache copied into a 32,768-position
   cache, 32 greedy ``serve_step``s (logits finite; tokens/s and step ms,
   and wall against host-thread CPU time in four windows of 8 steps).
   Then phi: ``PandaDB(device="cuda")`` with 2,000 seeded 64-byte texts,
   20 of them near-duplicates of 20 planted anchors, the LM registered as
   ``textvec`` through ``model_embedding_extractor``, the index built; the
   similarity query from the anchors must return every twin.
6. moe-lm: ``LM(deepseek-moe-16b)`` at full width and depth (28 layers, 64
   routed + 2 shared experts, top-6, bf16, ~32.8 GB), the same prefill,
   then 16 greedy steps at B = 4 (decode_32k's B = 128 cut: its cache would
   take ~960 GB) over a 32,768-position cache holding the prefill's first
   four rows (~30 GB).  Each decode step's floor, every weight read once
   (every expert runs over its capacity), is printed beside it.
7. mla-lm: ``LM(deepseek-v2-236b)`` at full width, cut to 5 layers (the
   dense layer 0 and 4 MoE layers, ~34.6 GB; all 60 take ~472 GB): MLA at
   128 heads, 160 routed + 2 shared experts; the same prefill, 16 greedy
   steps at B = 8 over a 32,768-position latent cache.  Then, a main path
   of its own, the phi cell's (``dsv2lite-msmarco1m.phi-q256-t64-k10``):
   ``LM(deepseek-v2-lite)`` at its published widths and depth (27 layers,
   bf16, dropless) as ``textvec`` phi through the AIPM service, 256 seeded
   lowercase texts of 16-64 bytes at 64 tokens, then ``search_many`` (k =
   10, nprobe 8) over a 1,000,000-row cosine IVF-Flat index of 10
   buckets: unit, finite vectors, no (token, expert) pair dropped, every
   answer a row of the index, the batch on the masked dense scan.  Then
   the Mellum2 cell's (``mellum2-govreport.doc-b1-t32k-k10``), a main path
   of its own: ``LM(mellum2-12b-a2.5b)`` whole (28 layers, 21 of them
   sliding-window ones, bf16, every layer a dropless MoE) as ``docvec`` phi
   through the AIPM service, one seeded report of 16-64 KB at 32,768
   tokens, then ``search_many`` (k = 10, nprobe 8) over 19,466 cosine
   rows: one flash launch of the window instantiation a sliding layer and
   one causal a full layer, a unit vector, no pair dropped.
8. distributed: a world of one NCCL rank (NCCL takes one rank per card):
   ``sharded_topk`` over 200,000 rows (d = 128, Q = 256, k in {10, 100})
   must return ``scan_topk``'s ids over the whole corpus;
   ``partial_softmax_combine`` must agree within 1e-4 with
   ``decode_attention`` on the same q, K, V and with the plain softmax.
9. train: ``LM(llama3-8b)`` at full width cut to 8 layers (2.8 B
   parameters; all 32 with AdamW state would need ~128 GB), weights drawn
   on the card; 4 optimizer steps of ``train_step`` on SyntheticLM batches
   of 8 x 4,096 tokens (train_4k's global batch 256 cut to 8: the config's
   4 micro-batches of 2), remat, AdamW: each step's loss (finite), grad
   norm, ms, tokens/s and MFU ((6 N_matmul + 12 L H D (S + 1) / 2) tokens
   / step time / 989 TFLOP/s), peak memory, and the flash forward and
   backward kernels' launches (every layer and micro-batch: two forwards
   under remat, one backward).
10. gnn: the GNN family trains through ``gnn_train_step`` (AdamW),
   GNN_STEPS steps each, weights drawn on the card: gnn-products,
   graphsage-reddit at full width on ogb_products' full graph (2,449,029
   nodes, 61,859,140 power-law edges padded to 61,859,328, 100 features
   stored in bf16, 41 classes); gnn-reddit-minibatch, graphsage-reddit on
   ``NeighborSampler`` blocks (fanout (15, 10), 1,024 seeds) of a
   Reddit-sized graph (232,965 nodes, 114,615,892 edges, 602 features);
   gnn-small, gcn-cora, gat-bonus and gin-bonus on full_graph_sm and
   schnet and equiformer-v2 (12 layers, 128 channels, l_max 6) on molecule
   (128 graphs of 30 nodes and 64 edges, graph-level MSE).  Loss (finite),
   step ms, edges/s, peak memory; the graphs' making is timed apart.
11. parity: the serving requests at 5,000 persons, and the cluster's
   requests and kNN at 5,000 persons, card against CPU: rows identical,
   kNN ids identical wherever neighbouring scores differ by more than 1e-4.
12. lm parity, for llama3-8b, deepseek-moe-16b and deepseek-v2-236b: a
   2-layer float32 cut (d_model 128) with the same weights on the card and
   the CPU: logits within 1e-4, greedy tokens identical.  Then each arch
   cut to 2 layers at full width in bf16, on the card through the kernels
   and through their plain versions (the plain run replays the kernel
   run's expert choices): logits within two bf16 ulps of the largest
   logit, greedy tokens identical wherever the top two logits are further
   apart than that.  Then training: each 2-layer float32 cut's loss and
   gradients and its parameters after one ``train_step`` (grad_accum 2),
   card against CPU within 1e-4; and llama3-8b's 2-layer full-width bf16
   cut (B = 2, S = 500), one step's loss and gradients through the flash
   forward and backward kernels against the same step through their plain
   versions: loss within 2^-8 and grad norm within 2^-5 of themselves.
13. gnn parity: each GNN architecture cut to 2 layers, float32, the same
   weights on the card and the CPU: logits, loss, gradients and the
   parameters after one ``gnn_train_step`` within 1e-4; Equiformer's
   chunked path (grouped remat) against its flat path on the card.
14. recsys: autoint at full size, no cut (39 tables of 1,000,000 x 16
   float32, weights drawn on the card), its ids Zipf-distributed
   (exponent 1.05 over each field's ranks, a seeded permutation to ids):
   train_batch, 4 ``recsys_train_step``s of 65,536 samples (loss finite,
   step ms, samples/s, peak GB, the bag's two launches a step);
   serve_p99, 50 requests of 512 from the host (median and p99 ms);
   serve_bulk, 262,144 (ms, samples/s); retrieval_cand, one query against
   1,000,000 candidate representations (d = 1,248, 4.99 GB) made by the
   model, through ``ivf_scan``: ms, ids against the plain version on the
   card wherever neighbouring scores differ by more than 1e-5 of the
   largest.
15. recsys parity: autoint at full width, its tables cut to 1,000 rows,
   float32, the same weights on the card and the CPU: logits, loss,
   gradients and the parameters after one ``recsys_train_step`` within
   1e-5.
16. dtensor route: the steps on DTensors over the one-rank NCCL 1 x 1 mesh
   (``make_smoke_mesh("cuda")``), every placement local, so the same
   kernels run on the same shapes: llama3-8b at full width cut to 2 layers
   (the loss and gradients of ``loss_fn`` through flash forward and
   backward, the parameters after one ``train_step``, prefill and 4 decode
   steps' logits through the decode kernel), graphsage-reddit on a
   200,000-node graph and AutoInt's train_batch cut (``gather_scatter``):
   each equal to the plain route's bit for bit, as two plain runs are to
   each other (256 positions: the bf16 backward's dq sums at most two
   terms, in any order the same); one weight element changed in a
   routed parameter's local shard runs to its end and must fail each.
17. dryrun, last: operation counts (``launch/op_analysis.py``).  Three
   training steps of the paths above at their own shapes, train-8b-8L,
   gnn-products and AutoInt's train_batch, each counted on the meta device
   and on the card through its ``StepBundle``'s ``fn`` (the hand kernels'
   work recorded by their wrappers): FLOPs within 1%, bytes within 10%
   (the wrappers' set-up, such as a CSR's sort, runs on the card only),
   the kernels' calls equal; each step's roofline (compute s at the
   config's peak, memory s at 3.35 TB/s) beside its measured ms; the LM's
   FLOPs within 2% of ``train_flops``' executed count, and its MFU = 6 N
   D / step s / 989 TFLOP/s.  Then ``launch/dryrun.py``'s ``run_cell`` at
   mesh ``one`` for all 40 cells of ``all_cells()`` on meta, at full
   size, in worker processes: seconds, FLOPs, argument and peak GB,
   whether the peak fits 80 GB; a failed cell fails the phase.  Then 8
   sharded counts: llama3-8b and deepseek-moe-16b train_4k,
   graphsage-reddit ogb_products and AutoInt train_batch on the 16 x 16
   and 2 x 16 x 16 meshes, each on DTensors over a fake process group in
   worker processes of its mesh: per-device FLOPs, bytes, peak GB,
   collectives by kind, collective s (at 50 GB/s a GPU) and the dominant
   roofline term; a count that fails or has no collective fails the
   phase.

Launch counts are zeroed just before each main path (phases 2-3, the
single node; phase 4, the cluster; phases 5, 6, 7, the phi cell's path,
8, 9, 10, 14 and 17, each alone) and read just after it; every kernel of a path must have launched
on it.  ``--profile`` runs each serving request, each PQ search mode, one
cluster kNN, one fan-out request, one prefill and one decode step of each
LM, one training step, one gnn-products step, one recsys training step,
serve_bulk and retrieval once more, after the main path's run and
uncounted, under
``torch.profiler`` and ``cProfile``: host wall time, device busy time (CUDA
kernels and copies, which run on one stream), the idle share ``1 - busy /
wall``, and the kernels and host functions that took the most time.

The second-to-last line holds the kernels' numbers as JSON, the line before
it the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/repro_torch`` beside this file, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM shared memory: 32 banks x 4 bytes a clock on each of 132 SMs at
# the 1,980 MHz boost clock (the floor of gathers without bank conflicts);
# the card's other peaks are src/repro_torch/launch/mesh.py's HW
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9
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


def device_ms(torch, fn, runs: int = 20) -> float:
    """Device time of one call of ``fn``: each kernel's mean time under
    ``torch.profiler`` over ``runs`` calls after one warm-up, times its
    launches a call (its records over ``runs``, rounded), summed (no host
    time in it).  A record the profiler drops does not pass for a faster
    call; the dropped records are logged.  ``kernel_phase.py`` keeps its
    own copy, since it also drives older checkouts' phase 1."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ms, dropped = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.count:
            per_call = round(ev.count / runs)
            ms += ev.self_device_time_total / 1e3 / ev.count * per_call
            dropped += max(0, per_call * runs - ev.count)
    if dropped:
        log(f"[device_ms] the profiler dropped {dropped} kernel records of "
            f"{runs} calls: each kernel counted at its mean time")
    return ms


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


def hbm_ms(n_bytes: float) -> float:
    """ms to move ``n_bytes`` at the card's memory rate."""
    from repro_torch.launch.mesh import HW
    return n_bytes / HW["hbm_bw"] * 1e3


def bound(work, dtype=None):
    """Least time on the card for ``work`` = (operations, bytes), a
    kernel's ``work()``: bytes over the memory rate vs operations over the
    peak rate of ``dtype``'s products (float32 unless given), both from
    ``launch/mesh.py``'s HW; the larger one bounds."""
    from repro_torch.launch.mesh import peak_flops
    n_ops, n_bytes = work
    t_bytes = hbm_ms(n_bytes)
    t_ops = n_ops / peak_flops(dtype or "float32") * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: kernels against plain
# ---------------------------------------------------------------------------


def ivf_case(torch, q, corpus, k: int, n_valid: int) -> dict:
    """One ivf_scan case: ids and values against plain, the wrapper's time,
    its split into scoring, selection and the final sort of the k
    survivors, plain, library (``matmul`` + ``topk``) and bound."""
    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
    from repro_torch.kernels.topk import sort_survivors

    qn, d = q.shape
    n = corpus.shape[0]
    kv, ki = ivf_ops.ivf_scan_topk(q, corpus, k, n_valid=n_valid)
    pv, pi = ivf_scan_topk_ref(q, corpus, k, n_valid=n_valid)
    torch.cuda.synchronize()
    same = bool(torch.equal(ki, pi))
    err = float((kv - pv).abs().max())
    del kv, ki, pv, pi
    ms = time_ms(torch, lambda: ivf_ops.ivf_scan_topk(q, corpus, k,
                                                      n_valid=n_valid))
    scores = ivf_ops.ivf_scores(q, corpus, True)
    sv, si = ivf_ops.ivf_select(scores, n_valid, k)
    score_ms = time_ms(torch, lambda: ivf_ops.ivf_scores(q, corpus, True))
    select_ms = time_ms(torch, lambda: ivf_ops.ivf_select(scores, n_valid, k))
    sort_ms = time_ms(torch, lambda: sort_survivors(sv, si, k))
    del scores, sv, si
    plain_ms = time_ms(torch, lambda: ivf_scan_topk_ref(q, corpus, k,
                                                        n_valid=n_valid))
    c2 = (corpus * corpus).sum(1)

    def library():
        s = -((q * q).sum(1, keepdim=True) - 2.0 * (q @ corpus.T)
              + c2[None, :])
        return torch.topk(s[:, :n_valid], k)

    lib_ms = time_ms(torch, library)
    b_ms, b_by = bound(ivf_ops.work(q, corpus, k))
    log(f"[kernels] ivf_scan Q={qn} N={n} d={d} k={k} n_valid={n_valid}: "
        f"ids_equal={same} max_abs_err={err} ms={ms:.3f} (score "
        f"{score_ms:.3f} + select {select_ms:.3f} + sort {sort_ms:.3f}) "
        f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    check(same, f"ivf_scan ids differ at Q={qn} N={n} k={k}")
    check(err <= 1e-4, f"ivf_scan max|delta| {err} at Q={qn} N={n} k={k}")
    return dict(ms=ms, score_ms=score_ms, select_ms=select_ms,
                sort_ms=sort_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)


def ivf_masked_case(torch, dev, metric: str = "l2") -> dict:
    """The index's dense probe scan at the probe8 cell's shape (Q = 256,
    N = 1M, d = 128, k = 10, each query probing 8 of 10 buckets): the
    masked ``ivf_scan_topk`` against the plain version given the same mask
    (``where`` + a stable sort of [Q, N]), on integer vectors (exact sums,
    ties); the buckets sorted as the table stores them, then 1,000 pending
    rows in no order.  Its launches a call, device ms whole and split, the
    unmasked scan's at the same shape, and the bound.  In ``cosine`` (the
    phi cell's scan) each vector holds +-1 at 64 of its 128 places, so its
    norm is 8 and the normalised sums stay exact; the split is l2's only."""
    import numpy as np

    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
    from repro_torch.kernels.topk import sort_survivors

    rng = np.random.default_rng(8)
    qn, n, d, k, m, nprobe, pending = 256, 1_000_000, 128, 10, 10, 8, 1_000
    if metric == "cosine":
        gen = torch.Generator(device=dev).manual_seed(8)

        def signs(rows):
            half = torch.rand(rows, d, device=dev, generator=gen).argsort(
                dim=1) < d // 2
            sign = torch.randint(0, 2, (rows, d), device=dev,
                                 generator=gen) * 2 - 1
            return (half * sign).float()
        corpus, q = signs(n), signs(qn)
    else:
        corpus = torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(
            np.float32)).to(dev)
        q = torch.from_numpy(rng.integers(-3, 4, (qn, d)).astype(
            np.float32)).to(dev)
    rb = np.sort(rng.integers(0, m, n))
    rb[-pending:] = rng.integers(0, m, pending)
    rb = torch.from_numpy(rb.astype(np.int32)).to(dev)
    pm = np.zeros((qn, m), np.uint8)
    pm[np.arange(qn)[:, None], rng.random((qn, m)).argsort(1)[:, :nprobe]] \
        = 1
    pm = torch.from_numpy(pm).to(dev)
    mask = dict(metric=metric, row_bucket=rb, probe_mask=pm)
    before = ivf_ops.launches.n
    kv, ki = ivf_ops.ivf_scan_topk(q, corpus, k, **mask)
    n_launch = ivf_ops.launches.n - before
    pv, pi = ivf_scan_topk_ref(q, corpus, k, **mask)
    torch.cuda.synchronize()
    same = bool(torch.equal(ki, pi))
    err = float((kv - pv).abs().max())
    del kv, ki, pv, pi
    dms = device_ms(torch, lambda: ivf_ops.ivf_scan_topk(q, corpus, k,
                                                         **mask))
    ms = time_ms(torch, lambda: ivf_ops.ivf_scan_topk(q, corpus, k, **mask))
    plain_ms = device_ms(torch, lambda: ivf_scan_topk_ref(q, corpus, k,
                                                          **mask), 5)
    b_ms, b_by = bound(ivf_ops.work(q, corpus, k))
    head = (f"[kernels] ivf_scan masked {metric} Q={qn} N={n} d={d} k={k} "
            f"nprobe {nprobe} of {m} ({pending} pending rows): "
            f"ids_equal={same} max_abs_err={err} launches={n_launch} "
            f"device_ms={dms:.3f}")
    check(same, f"masked ivf_scan ({metric}) ids differ at Q={qn} N={n} "
          f"k={k}")
    check(err == 0.0, f"masked ivf_scan ({metric}) max|delta| {err} at "
          f"Q={qn} N={n}")
    check(n_launch == 1, f"masked ivf_scan ({metric}) made {n_launch} "
          f"launches")
    if metric != "l2":
        log(f"{head} ms={ms:.3f} plain_device_ms={plain_ms:.3f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        return dict(ms=ms, device_ms=dms, launches=n_launch,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=err)
    score_ms = device_ms(torch, lambda: ivf_ops.ivf_scores(q, corpus, True,
                                                           rb, pm))
    scores = ivf_ops.ivf_scores(q, corpus, True, rb, pm)
    sv, si = ivf_ops.ivf_select(scores, n, k)
    select_ms = device_ms(torch, lambda: ivf_ops.ivf_select(scores, n, k))
    sort_ms = device_ms(torch, lambda: sort_survivors(sv, si, k))
    del scores, sv, si
    unmasked_ms = device_ms(torch, lambda: ivf_ops.ivf_scan_topk(q, corpus,
                                                                 k))
    unmasked_score_ms = device_ms(torch, lambda: ivf_ops.ivf_scores(
        q, corpus, True))
    log(f"{head} (score {score_ms:.3f} + select {select_ms:.3f} + sort "
        f"{sort_ms:.3f}) ms={ms:.3f} unmasked_device_ms={unmasked_ms:.3f} "
        f"(score {unmasked_score_ms:.3f}) plain_device_ms={plain_ms:.3f} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    return dict(ms=ms, device_ms=dms, score_ms=score_ms,
                select_ms=select_ms, sort_ms=sort_ms, launches=n_launch,
                unmasked_device_ms=unmasked_ms,
                unmasked_score_ms=unmasked_score_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)


def pq_case(torch, name: str, luts, codes, k: int, nv: int, kw: dict
            ) -> dict:
    """One pq_scan case (``kw`` holds the extended form's terms): ids,
    values and padding against plain, the wrapper's time, its split into
    scoring, selection and the sort of the survivors, the scoring's time at
    every query-slot count that fits, plain, library (``embedding_bag`` +
    ``topk``), bound and the shared-memory floor of the gathers."""
    from repro_torch.kernels.pq_scan import ops as pq_ops
    from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref
    from repro_torch.kernels.topk import sort_survivors

    qn, m, ksub = luts.shape
    pm = kw.get("probe_mask")
    reps = 3 if qn >= 256 else 10       # a probe group's scan is short
    kv, ki = pq_ops.pq_adc_topk(luts, codes, k, n_valid=nv, **kw)
    pv, pi = pq_adc_topk_ref(luts, codes, k, n_valid=nv, **kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(ki, pi))
    fin = torch.isfinite(pv)
    same_inf = bool(torch.equal(fin, torch.isfinite(kv)))
    err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
    starved = ""
    if pm is not None:
        check(bool((ki[0] == -1).all()), "starved query not padded")
        starved = " starved_pad_ok=True"
    del kv, ki, pv, pi
    ms = time_ms(torch, lambda: pq_ops.pq_adc_topk(luts, codes, k,
                                                   n_valid=nv, **kw), reps)
    # the wrapper's kernels alone (it passes the mask as uint8)
    split_kw = dict(kw, probe_mask=None if pm is None
                    else pm.view(torch.uint8))
    scores = pq_ops.pq_scores(luts, codes, nv, **split_kw)
    sv, si = pq_ops.pq_select(scores, nv, k)
    score_ms = time_ms(torch, lambda: pq_ops.pq_scores(luts, codes, nv,
                                                       **split_kw), reps)
    select_ms = time_ms(torch, lambda: pq_ops.pq_select(scores, nv, k),
                        reps)
    sort_ms = time_ms(torch, lambda: sort_survivors(sv, si, k), reps)
    del scores, sv, si
    policy = pq_ops.query_slots
    slots = policy(qn, m, ksub)
    slot_ms = {}
    try:
        for s in (4, 1):              # each form, the policy swapped out
            if s * 4 * m * ksub <= pq_ops.SMEM_MAX:
                pq_ops.query_slots = lambda *_, s=s: s
                slot_ms[s] = time_ms(torch, lambda: pq_ops.pq_scores(
                    luts, codes, nv, **split_kw), reps)
    finally:
        pq_ops.query_slots = policy
    plain_ms = time_ms(torch, lambda: pq_adc_topk_ref(luts, codes, k,
                                                      n_valid=nv, **kw))
    table = luts.reshape(qn, m * ksub).T.contiguous()          # [M*K, Q]
    flat_codes = codes[:nv].long() + torch.arange(
        m, device=codes.device) * ksub

    def library():
        # one embedding_bag gathers and sums every row's M entries
        s = torch.nn.functional.embedding_bag(flat_codes, table,
                                              mode="sum").T
        if kw:
            rbl = kw["row_bucket"][:nv].long()
            s = s + kw["bias"][None, :nv] + kw["cscores"][:, rbl]
            if pm is not None:
                s = s.masked_fill(~pm[:, rbl], -torch.inf)
        return torch.topk(s, k)

    lib_ms = time_ms(torch, library, reps)
    del table, flat_codes
    b_ms, b_by = bound(pq_ops.work(luts, codes, k, nv, kw.get("cscores"),
                                   pm))
    smem_ms = 4.0 * qn * nv * m / SMEM_BYTES_PER_S * 1e3
    log(f"[kernels] {name} Q={qn} N={nv} M={m} K={ksub} k'={k}: "
        f"ids_equal={same} max_abs_err={err}{starved} ms={ms:.3f} "
        f"(score {score_ms:.3f} + select {select_ms:.3f} + sort "
        f"{sort_ms:.3f}; segments "
        f"{pq_ops.select_segments(qn, nv, k)}; scoring at "
        + ", ".join(f"{s}{'*' if s == slots else ''} slots {t:.3f}"
                    for s, t in slot_ms.items())
        + f") plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        f"bound_ms={b_ms:.4f} ({b_by}; shared-memory floor of the gathers "
        f"{smem_ms:.4f})")
    check(same and same_inf, f"{name} ids differ at Q={qn} N={nv} k'={k}")
    check(err <= 1e-4, f"{name} max|delta| {err} at Q={qn} N={nv} k'={k}")
    return dict(ms=ms, score_ms=score_ms, select_ms=select_ms,
                sort_ms=sort_ms, slot_score_ms=slot_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                smem_floor_ms=smem_ms, max_abs_err=err)


def phase_kernels(torch, pq_rows: int):
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}

    # -- ivf_scan: integer vectors (exact sums); the second half of the
    # corpus repeats the first (ties); the last 37 rows are padding.  The
    # serving shape (Q = 800, k = 10,002 over 100,000 rows) is the knows
    # request's chunk scan at 100,000 persons
    worst = 0.0
    main = None
    split = {}
    for n, qns, ks in ((200_000, (256, 930), (10, 64, 20_001)),
                       (100_000, (800,), (10_002,))):
        d = 128
        half = rng.integers(-3, 4, (n // 2, d)).astype(np.float32)
        corpus = torch.from_numpy(np.concatenate([half, half])).to(dev)
        n_valid = n - 37
        for qn in qns:
            q = torch.from_numpy(rng.integers(-3, 4, (qn, d)).astype(
                np.float32)).to(dev)
            for k in ks:
                r = ivf_case(torch, q, corpus, k, n_valid)
                worst = max(worst, r["max_abs_err"])
                label = f"Q={qn} N={n} d={d} k={k}"
                split[label] = r
                if (qn, k) == (930, 20_001):
                    main = dict(r, shape=label)
        del corpus, half
        torch.cuda.empty_cache()
    for metric in ("l2", "cosine"):
        r = ivf_masked_case(torch, dev, metric)
        worst = max(worst, r["max_abs_err"])
        tag = "" if metric == "l2" else " cosine"
        split[f"masked{tag} Q=256 N=1M d=128 k=10 nprobe 8 of 10"] = r
        torch.cuda.empty_cache()
    out["ivf_scan"] = dict(main, max_abs_err=worst, cases=split)

    # -- pq_scan / pq_scan_ext: float LUTs, sums in the plain order.  The
    # whole table at Q = 256 (the fused scan; pq_scan's k' = 80 and 800),
    # then the adc path's probe groups: a few queries over the 8 of 10
    # buckets they probe (~800,000 rows), a query alone, and a larger group
    m, ksub, mb = 16, 256, 10
    n = pq_rows
    gen = torch.Generator(device=dev).manual_seed(1)
    codes = torch.randint(0, ksub, (n, m), device=dev, generator=gen,
                          dtype=torch.uint8)
    rb = torch.sort(torch.randint(0, mb, (n,), device=dev, generator=gen,
                                  dtype=torch.int32)).values
    bias = torch.randn(n, device=dev, generator=gen)
    shapes = [(256, n, k) for k in (80, 800)]
    shapes += [(qg, n * 4 // 5, k) for qg, k in ((1, 80), (6, 80), (6, 800),
                                                  (20, 800))]
    for name, ext in (("pq_scan", False), ("pq_scan_ext", True)):
        worst, cases = 0.0, {}
        for qn, nv, k in shapes:
            luts = torch.randn(qn, m, ksub, device=dev, generator=gen)
            kw = {}
            if ext:        # residual terms; the whole-table scan's mask
                kw = dict(bias=bias, row_bucket=rb,
                          cscores=torch.randn(qn, mb, device=dev,
                                              generator=gen))
                if qn == 256:
                    pm = torch.rand(qn, mb, device=dev, generator=gen) < 0.4
                    pm[0] = False              # a query that probes nothing
                    pm[1] = False
                    pm[1, 3] = True            # one that probes one bucket
                    kw["probe_mask"] = pm
            elif qn == 256:
                nv = n - 5                     # ragged n_valid
            r = pq_case(torch, name, luts, codes, k, nv, kw)
            worst = max(worst, r["max_abs_err"])
            label = f"Q={qn} N={nv} M={m} K={ksub} k'={k}"
            cases[label] = r
            if (qn, k) == (256, 800):
                main = dict(r, shape=label)
            del luts, kw
        out[name] = dict(main, max_abs_err=worst, cases=cases)
    del codes, rb, bias
    torch.cuda.empty_cache()
    out["topk_merge"] = kernel_topk_merge(torch, dev)
    out["flash_attention"] = kernel_flash_attention(torch, dev)
    out["decode_attention"] = kernel_decode_attention(torch, dev)
    out["flash_attention_bwd"] = kernel_flash_attention_bwd(torch, dev)
    out["gather_scatter"] = kernel_gather_scatter(torch, dev)
    rec = kernel_recsys(torch, dev)
    gs = out["gather_scatter"]
    gs["cases"].update(rec["bags"])
    gs["max_abs_err"] = max([gs["max_abs_err"]] + [c["max_abs_err"] for c
                                                    in rec["bags"].values()])
    out["ivf_scan"]["cases"]["retrieval Q=1 N=1,000,000 d=1,248 k=100 ip"] \
        = rec["retrieval"]
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
    from repro_torch.kernels.topk_merge import ops as merge_ops
    from repro_torch.kernels.topk_merge.ops import merge_topk_dev
    from repro_torch.kernels.topk_merge.ref import merge_topk_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    worst, main, cases = 0.0, None, {}
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
                b_ms, b_by = bound(merge_ops.work(vals, ids, k))
                r = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
                split = ""
                if c > merge_ops.SMALL_COLS:     # the selection's steps
                    sel_v, sel_c = merge_ops.merge_select(vals, k, nv)
                    sv, pos = torch.sort(sel_v, dim=1, descending=True,
                                         stable=True)
                    out_i = torch.empty_like(kv, dtype=ids.dtype)
                    r["select_ms"] = time_ms(
                        torch, lambda: merge_ops.merge_select(vals, k, nv))
                    r["sort_ms"] = time_ms(torch, lambda: torch.sort(
                        sel_v, dim=1, descending=True, stable=True))
                    r["epilogue_ms"] = time_ms(
                        torch, lambda: merge_ops.merge_epilogue(
                            sv, pos, sel_c, ids, out_i))
                    split = (f" (select {r['select_ms']:.3f} + sort "
                             f"{r['sort_ms']:.3f} + epilogue "
                             f"{r['epilogue_ms']:.3f})")
                    del sel_v, sel_c, sv, pos, out_i
                cases[f"P={p} Q={qn} K={kk}"] = r
                log(f"[kernels] topk_merge P={p} Q={qn} K={kk} k={k} "
                    f"n_valid={nv}: ids_equal={same} max_abs_err={err} "
                    f"ms={ms:.3f}{split} plain_ms={plain_ms:.3f} "
                    f"library_ms={lib_ms:.3f} bound_ms={b_ms:.4f} ({b_by})")
                check(same and same_inf,
                      f"topk_merge ids differ at P={p} Q={qn} K={kk}")
                check(err == 0.0, f"topk_merge max|delta| {err} at P={p} "
                      f"Q={qn} K={kk}")
                if (p, qn, kk) == (4, 256, 10):    # the cluster kNN's merge
                    main = dict(r, shape=f"P={p} Q={qn} K={kk} k={k}")
                del vals, ids, kv, ki, pv, pi
        torch.cuda.empty_cache()
    return dict(main, max_abs_err=worst, cases=cases)


# the attention kernels' tolerances.  bf16: the kernel and the plain version
# both round one float32 value per output to bf16, and those float32 values
# differ by float32 noise only, so they round at most one bf16 ulp apart,
# <= 2^-7 |x| (rtol 1e-2 keeps a margin); atol covers the float32 noise of
# outputs near zero.  float32: sums in another order than the plain version.
ATTN_TOL = {"bfloat16": (1e-2, 1e-4), "float32": (1e-4, 1e-4)}
FAULT_KEYS = 32                 # keys a planted fault zeroes (<= a key tile)
# the attention cases of the MoE and MLA paths, also timed on the device
# alone (torch.profiler), kernel and SDPA
DEVICE_MS_CASES = {"moe_prefill", "mla_prefill_b8", "moe_spread",
                   "moe_lm_path", "phi_dsv2lite", "mellum2_window",
                   "mellum2_full"}


def attn_err(got, want, dtype_name: str, slack=0.0):
    """(max |delta|, every element within atol + rtol * |want| + slack);
    ``slack`` is a number or a tensor like ``want``."""
    rtol, atol = ATTN_TOL[dtype_name]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= atol + rtol * w.abs() + slack)
                                   .all())


def fault_tile(s: int, last: int, window: int = 0) -> slice:
    """A planted fault's keys: the 32-key tile that starts at the middle of
    the keys the row at position ``last`` sees (the first ``last + 1``, the
    last ``window`` of them under a window), rounded down to a tile."""
    first = max(0, last + 1 - window) if window else 0
    start = (first + last + 1) // 2 // FAULT_KEYS * FAULT_KEYS
    return slice(start, min(start + FAULT_KEYS, s))


def sdpa(torch, q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call on [B, S, H, D] tensors
    with fewer key heads (v may be narrower): the library yardstick, never
    used by the port."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **kw).transpose(1, 2)


#: flash_attention's cases: (label, B, Sq, Skv, H, KVH, D, Dv, dtype name,
#: the causal window, 0 for none)
FLASH_CASES = [("prefill", 8, 4096, 4096, 32, 8, 128, 128, "bfloat16", 0),
               ("phi", 8, 64, 64, 32, 8, 128, 128, "bfloat16", 0),
               ("ragged", 2, 1000, 1000, 32, 8, 128, 128, "bfloat16", 0),
               ("head_dim_160", 2, 2048, 2048, 32, 8, 160, 160, "bfloat16",
                0),
               ("parity_f32", 2, 37, 37, 4, 2, 32, 32, "float32", 0),
               ("sq_below_skv", 8, 512, 4096, 32, 8, 128, 128, "bfloat16",
                0),
               ("mla_prefill", 1, 4096, 4096, 128, 128, 192, 128,
                "bfloat16", 0),
               ("padded_d80", 2, 1024, 1024, 32, 8, 80, 80, "bfloat16", 0),
               ("moe_prefill", 8, 4096, 4096, 16, 16, 128, 128, "bfloat16",
                0),
               ("mla_prefill_b8", 8, 4096, 4096, 128, 128, 192, 128,
                "bfloat16", 0),
               ("phi_dsv2lite", 256, 64, 64, 16, 16, 192, 128, "bfloat16",
                0),
               ("mellum2_window", 1, 32768, 32768, 32, 4, 128, 128,
                "bfloat16", 1024),
               ("mellum2_full", 1, 32768, 32768, 32, 4, 128, 128, "bfloat16",
                0)]


def kernel_flash_attention(torch, dev):
    """flash_attention at the LM path's shapes: the llama3-8b prefill (B=8,
    S=4,096, 32 query / 8 key heads of 128, bf16), the phi forward (S=64),
    a ragged S, stablelm's head width 160, and the float32 parity config;
    then the shapes the reference's chunked_attention also serves: 512
    queries against 4,096 keys, MLA's prefill at deepseek-v2's full head
    count (q and k at 192, v at 128, 128 heads), and a width the wrapper
    pads (80); the phi cell's (DeepSeek-V2-Lite's MLA over 256 texts of 64
    tokens: 16 heads, q and k at 192, v at 128, one key tile); the Mellum2
    cell's, one report of 32,768 positions, 32 query heads over 4 key heads
    of 128, in a sliding layer (window 1,024: the kernel's ``WINDOW``
    instantiation) and in a full one; the bf16 cases with the
    float32-faithful weights (the LM's path) and with ``bf16_probs``, held
    against the plain version rounding on the kernel's key tiles."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         key_tile)
    from repro_torch.kernels.flash_attention.ref import (bf16_probs_slack,
                                                         flash_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(3)
    worst, main, table = 0.0, None, {}
    for label, b, sq, skv, h, kvh, d, dv, dt, win in FLASH_CASES:
        dt = getattr(torch, dt)
        # the plain version's key block for its timing: 256 at MLA's B = 8,
        # whose [B, H, Sq, 1,024] float32 blocks would take ~17 GB apiece
        plain_block = 256 if label == "mla_prefill_b8" else 1024
        q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dt)
        k = torch.randn(b, skv, kvh, d, device=dev, generator=gen).to(dt)
        v = torch.randn(b, skv, kvh, dv, device=dev, generator=gen).to(dt)
        name = str(dt).split(".")[1]
        kt = key_tile(d, dt, dv)
        # the bound of the function (flash_attention's work()); the
        # kernel's float32-faithful P.V is two bf16 products (hi + lo), so
        # its own floor counts 4Dv for P.V
        wk = flash_ops.work(q, k, v, causal=True, window=win)
        b_ms, b_by = bound(wk, dt)
        pairs = flash_ops.attention_pairs(b, h, sq, skv, True, win)
        split_ms = bound((pairs * (2 * d + 4 * dv), wk[1]), torch.bfloat16)[0]
        # SDPA's is_causal aligns the rows top-left; the bottom-right mask
        # of unequal lengths, and a window's band, go in as a boolean mask
        pos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
        keys = torch.arange(skv, device=dev)[None, :]
        mask = dict(is_causal=True) if sq == skv and not win else dict(
            attn_mask=(pos >= keys) & (keys > pos - win if win else True))
        del pos, keys
        lib_ms = time_ms(torch, lambda: sdpa(torch, q, k, v, **mask))
        lib_dev = device_ms(torch, lambda: sdpa(torch, q, k, v, **mask)) \
            if label in DEVICE_MS_CASES else None
        modes = (False, True) if dt == torch.bfloat16 else (False,)
        row = {}
        for probs in modes:
            got = flash_attention(q, k, v, bf16_probs=probs, window=win)
            want = flash_attention_ref(q, k, v, bf16_probs=probs,
                                       block_kv=kt, window=win)
            # with bf16_probs each side rounds every weight to bf16 from its
            # own float32 value: the weights on a bf16 midpoint may land one
            # ulp apart, and only they get room beyond one output ulp
            slack = bf16_probs_slack(q, k, v, block_kv=kt, window=win) \
                if probs else 0.0
            torch.cuda.synchronize()
            err, ok = attn_err(got, want, name, slack)
            worst = max(worst, err)
            ms = time_ms(torch, lambda: flash_attention(
                q, k, v, bf16_probs=probs, window=win))
            plain_ms = time_ms(torch, lambda: flash_attention_ref(
                q, k, v, bf16_probs=probs, block_kv=plain_block, window=win))
            dev_ms = device_ms(torch, lambda: flash_attention(
                q, k, v, bf16_probs=probs, window=win)) \
                if label in DEVICE_MS_CASES else None
            tag = "bf16_probs" if probs else "f32_probs"
            extra = f" split_floor_ms={split_ms:.4f}" \
                if dt == torch.bfloat16 and not probs else ""
            if probs:
                # how far past the one-ulp limit the kernel went, and the
                # most room the midpoint weights gave any element
                rtol, atol = ATTN_TOL[name]
                w = want.float()
                over = float(((got.float() - w).abs() - atol
                              - rtol * w.abs()).clamp(min=0).max())
                extra = (f" past_one_ulp={over} slack_max="
                         f"{float(slack.max())} slack_mean="
                         f"{float(slack.mean()):.3g}")
            if dev_ms is not None:
                extra += (f" device_ms={dev_ms:.4f} library_device_ms="
                          f"{lib_dev:.4f}")
            log(f"[kernels] flash_attention {label} B={b} Sq={sq} Skv={skv} "
                f"H={h} KVH={kvh} D={d} Dv={dv} window={win} {name} {tag}: "
                f"max_abs_err={err} "
                f"within_tol={ok} ms={ms:.3f} plain_ms={plain_ms:.3f} "
                f"library_ms={lib_ms:.3f} bound_ms={b_ms:.4f} ({b_by})"
                f"{extra}")
            check(ok, f"flash_attention {label} {tag} off its plain version "
                  f"by {err}")
            row[tag] = dict(window=win, ms=ms, plain_ms=plain_ms,
                            max_abs_err=err, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                            device_ms=dev_ms, library_device_ms=lib_dev)
            del got
            fault = {}
            if dt == torch.bfloat16:
                # the tolerance must fail a kernel that loses one key tile's
                # values on the longest rows (the last query tile, batch
                # row 0), in each mode with that mode's limit
                tile = fault_tile(skv, skv - 1, win)
                rows = slice(max(0, sq - 64), sq)
                vf = v[:1].clone()
                vf[:, tile] = 0
                bad = flash_attention_ref(q[:1], k[:1], vf, bf16_probs=probs,
                                          block_kv=kt, window=win)[:, rows]
                f_err, f_ok = attn_err(bad, want[:1, rows], name,
                                       slack[:1, rows] if probs else 0.0)
                fault = dict(fault_err=f_err, fault_caught=not f_ok,
                             want_mean_abs=float(want[:1, rows].float().abs()
                                                 .mean()))
                room = f", slack_max there {float(slack[:1, rows].max()):.4g}" \
                    if probs else ""
                log(f"[kernels] flash_attention {label} {tag}: planted fault "
                    f"(values of keys {tile.start}-{tile.stop - 1} zeroed), "
                    f"last 64 rows: max_abs_err={f_err} caught={not f_ok} "
                    f"(mean |want| there {fault['want_mean_abs']:.4g}{room})")
                check(not f_ok, f"flash_attention {label} {tag}: the "
                      f"tolerance passes a kernel that drops a key tile")
                row[tag]["fault_err"] = f_err
                del vf, bad
            if label == "prefill" and not probs:
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            split_floor_ms=split_ms, **fault,
                            shape=f"B={b} S={sq} H={h} KVH={kvh} D={d} {name}")
            del want, slack
        table[label] = row
        if label == "prefill":
            main["bf16_probs_ms"] = row["bf16_probs"]["ms"]
            main["bf16_probs_max_abs_err"] = row["bf16_probs"]["max_abs_err"]
            main["bf16_probs_fault_err"] = row["bf16_probs"]["fault_err"]
        del q, k, v, mask
        torch.cuda.empty_cache()
    return dict(main, max_abs_err=worst, cases=table)


def kernel_decode_attention(torch, dev):
    """decode_attention over a 32,768-position cache (the decode_32k shape
    cut to B=8): positions spread over [0, S-1] with one at S-1, the LM
    path's positions (all 4,100), head width 160, and float32; then the
    shapes the reference's decode_attention also serves: v narrower than
    k (MLA's widths, 192 and 128), 16 query heads per key head, and a width
    outside the old kernel's list (96, float32)."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, KVH, D, Dv, dtype, pos: spread if None)
    cases = [("spread", 8, 32768, 32, 8, 128, 128, bf, None),
             ("lm_path", 8, 32768, 32, 8, 128, 128, bf, 4100),
             ("head_dim_160", 4, 8192, 32, 8, 160, 160, bf, None),
             ("parity_f32", 2, 45, 4, 2, 32, 32, f32, None),
             ("mla_widths", 8, 8192, 32, 8, 192, 128, bf, None),
             ("group_16", 8, 32768, 32, 2, 128, 128, bf, None),
             ("odd_f32", 4, 4096, 16, 4, 96, 96, f32, None),
             ("moe_spread", 4, 32768, 16, 16, 128, 128, bf, None),
             ("moe_lm_path", 4, 32768, 16, 16, 128, 128, bf, 4100)]
    worst, main, table = 0.0, None, {}
    for label, b, s, h, kvh, d, dv, dt, at in cases:
        q = torch.randn(b, 1, h, d, device=dev, generator=gen).to(dt)
        kc = torch.randn(b, s, kvh, d, device=dev, generator=gen).to(dt)
        vc = torch.randn(b, s, kvh, dv, device=dev, generator=gen).to(dt)
        if at is None:
            pos = torch.randint(0, s, (b,), device=dev, generator=gen,
                                dtype=torch.int32)
            pos[0] = s - 1
            pos[-1] = 0
        else:
            pos = torch.full((b,), at, device=dev, dtype=torch.int32)
        got = decode_attention(q, kc, vc, pos)
        want = decode_attention_ref(q, kc, vc, pos)
        torch.cuda.synchronize()
        name = str(dt).split(".")[1]
        err, ok = attn_err(got, want, name)
        worst = max(worst, err)
        ms = time_ms(torch, lambda: decode_attention(q, kc, vc, pos))
        plain_ms = time_ms(torch, lambda: decode_attention_ref(q, kc, vc,
                                                               pos))
        mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None].long()
                )[:, None, None, :]
        lib_ms = time_ms(torch, lambda: sdpa(torch, q, kc, vc,
                                             attn_mask=mask))
        dev_t = {}
        if label in DEVICE_MS_CASES:
            dev_t = dict(device_ms=device_ms(
                torch, lambda: decode_attention(q, kc, vc, pos)),
                library_device_ms=device_ms(
                    torch, lambda: sdpa(torch, q, kc, vc, attn_mask=mask)))
        # the function depends on the cache rows at positions <= pos only
        vis = float(torch.clamp(pos.long() + 1, max=s).sum())
        b_ms, b_by = bound(decode_ops.work(q, kc, vc, pos), dt)
        log(f"[kernels] decode_attention {label} B={b} S={s} H={h} "
            f"KVH={kvh} D={d} Dv={dv} {name} visible_keys={int(vis)}: "
            f"max_abs_err={err} within_tol={ok} ms={ms:.3f} "
            f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
            f"bound_ms={b_ms:.4f} ({b_by})"
            + "".join(f" {k}={v:.4f}" for k, v in dev_t.items()))
        check(ok, f"decode_attention {label} off its plain version by {err}")
        fault = {}
        if dt == torch.bfloat16:
            # the tolerance must fail a kernel that loses one key tile's
            # values on the longest row
            r = int(pos.argmax())
            one = slice(r, r + 1)
            tile = fault_tile(s, int(pos[r]))
            vf = vc[one].clone()
            vf[:, tile] = 0
            bad = decode_attention_ref(q[one], kc[one], vf, pos[one])
            f_err, f_ok = attn_err(bad, want[one], name)
            fault = dict(fault_err=f_err, fault_caught=not f_ok,
                         want_mean_abs=float(want[one].float().abs().mean()))
            log(f"[kernels] decode_attention {label}: planted fault (values "
                f"of keys {tile.start}-{tile.stop - 1} zeroed), row with pos "
                f"{int(pos[r])}: max_abs_err={f_err} caught={not f_ok} "
                f"(mean |want| there {fault['want_mean_abs']:.4g})")
            check(not f_ok, f"decode_attention {label}: the tolerance passes "
                  f"a kernel that drops a key tile")
            del vf, bad
        table[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                            visible_keys=int(vis), **fault, **dev_t)
        if label == "spread":
            main = dict(table[label],
                        shape=f"B={b} S={s} H={h} KVH={kvh} D={d} {name}, "
                              f"pos spread")
        del q, kc, vc, got, want, mask
        torch.cuda.empty_cache()
    return dict(main, max_abs_err=worst, cases=table)


# the backward's limit: |delta| <= rtol |want| + atol * max |want| of the
# tensor.  bf16: both sides compute float32 gradients (the kernel's P and
# dS enter its products as bf16 hi + lo) and round them once, so they lie
# one bf16 ulp apart (rtol 1e-2 keeps a margin) plus float32 noise of sums
# over thousands of terms, which cancel in small elements (atol, relative
# to the tensor's largest).  float32: sums in another order.
BWD_TOL = {"bfloat16": (1e-2, 2.0 ** -10), "float32": (1e-4, 1e-5)}


def bwd_err(got, want, dtype_name: str):
    """(max |delta|, max |delta| / max |want|, every element within the
    backward's limit)."""
    rtol, atol = BWD_TOL[dtype_name]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    top = float(w.abs().max())
    return (float(diff.max()), float(diff.max()) / max(top, 1e-30),
            bool((diff <= rtol * w.abs() + atol * top).all()))


def sdpa_bwd_ms(torch, q, k, v, do, causal: bool):
    """SDPA's backward (``is_causal``, ``enable_gqa``), timed as forward +
    backward minus forward: the library yardstick, never used by the
    port."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    def both():
        qt.grad = kt.grad = vt.grad = None
        fwd().backward(dot)

    with torch.no_grad():
        f_ms = time_ms(torch, fwd)
    return time_ms(torch, both) - f_ms


def kernel_flash_attention_bwd(torch, dev):
    """flash_attention_bwd at the training path's shape (llama3-8b, B=2,
    S=4,096, 32 query / 8 key heads of 128, bf16, causal), at MLA's widths
    (q and k 192, v 128), with more queries than keys (rows that see no
    key), without the mask, and in float32: dq, dk, dv against the plain
    version on the same inputs (the forward kernel's o, m and l, whose m
    and l are first held against the plain forward's).  A planted fault
    must fail each limit: the values of one key tile zeroed (dq and dk of
    the rows and keys it meets), and dO zeroed on 32 query rows near the
    end (dv of the keys they weigh most).  The bf16 kernel's layout is
    logged; dq's float32 sums are added by TMA reductions (atomics for the
    widest heads) in no fixed order, so a second launch of the training
    case must agree with the first within the same limit, not bitwise (dk
    and dv are summed in a fixed order)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, Sq, Skv, H, KVH, D, Dv, dtype, causal)
    cases = [("train", 2, 4096, 4096, 32, 8, 128, 128, bf, True),
             ("mla_widths", 1, 2048, 2048, 16, 16, 192, 128, bf, True),
             ("sq_above_skv", 1, 600, 400, 8, 2, 64, 64, bf, True),
             ("full", 1, 512, 512, 8, 8, 128, 128, bf, False),
             ("f32", 2, 300, 300, 4, 2, 32, 32, f32, True)]
    worst, main, table = 0.0, None, {}
    n_fwd = flash_ops.launches.n            # comparisons: not a path's
    for label, b, sq, skv, h, kvh, d, dv, dt, causal in cases:
        q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dt)
        k = torch.randn(b, skv, kvh, d, device=dev, generator=gen).to(dt)
        v = torch.randn(b, skv, kvh, dv, device=dev, generator=gen).to(dt)
        do = torch.randn(b, sq, h, dv, device=dev, generator=gen).to(dt)
        name = str(dt).split(".")[1]
        o, m, l = flash_ops.flash_attention(q, k, v, causal=causal,
                                            return_stats=True)
        _, pm, pl = flash_attention_ref(q, k, v, causal=causal,
                                        return_stats=True)
        m_err = float((m - pm).abs().max())
        l_err = float(((l - pl).abs() / pl.abs().clamp(min=1e-30)).max())
        check(m_err <= 1e-4 and l_err <= 1e-4,
              f"flash_attention {label}: m/l off the plain version's by "
              f"{m_err} / {l_err} (relative)")
        n0 = flash_ops.bwd_launches.n
        got = flash_ops.flash_attention_bwd(q, k, v, o, m, l, do,
                                            causal=causal)
        want = flash_attention_bwd_ref(q, k, v, o, m, l, do, causal=causal)
        torch.cuda.synchronize()
        check(flash_ops.bwd_launches.n == n0 + 1,
              "flash_attention_bwd did not count its launch")
        errs = {}
        for what, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            err, rel, ok = bwd_err(g_, w_, name)
            errs[what] = (err, rel)
            worst = max(worst, err)
            check(ok, f"flash_attention_bwd {label} {what} off its plain "
                  f"version by {err} ({rel} of its largest)")
        # planted faults: a kernel that drops one key tile, and one that
        # drops 32 query rows
        tile = fault_tile(skv, skv - 1)
        vf = v.clone()
        vf[:, tile] = 0
        bad_v = flash_attention_bwd_ref(q, k, vf, o, m, l, do, causal=causal)
        dof = do.clone()
        dof[:, max(0, sq - 64):max(0, sq - 32)] = 0
        bad_do = flash_attention_bwd_ref(q, k, v, o, m, l, dof, causal=causal)
        caught = {"dq": not bwd_err(bad_v[0], want[0], name)[2],
                  "dk": not bwd_err(bad_v[1], want[1], name)[2],
                  "dv": not bwd_err(bad_do[2], want[2], name)[2]}
        check(all(caught.values()), f"flash_attention_bwd {label}: the "
              f"limit passes a planted fault ({caught})")
        del vf, bad_v, dof, bad_do, want
        rerun = {}
        if label == "train":
            # a second launch on the same inputs: dq's sums add in
            # another order, dk and dv come out the same
            again = flash_ops.flash_attention_bwd(q, k, v, o, m, l, do,
                                                  causal=causal)
            torch.cuda.synchronize()
            for what, g_, a_ in zip(("dq", "dk", "dv"), got, again):
                err, _, ok = bwd_err(a_, g_, name)
                rerun[what] = dict(bitwise=bool(torch.equal(a_, g_)),
                                   max_abs_diff=err)
                check(ok, f"flash_attention_bwd {label}: a second launch's "
                      f"{what} off the first by {err}")
            log(f"[kernels] flash_attention_bwd {label}: second launch "
                + " ".join(f"{w}_bitwise={r['bitwise']} "
                           f"{w}_max_abs_diff={r['max_abs_diff']}"
                           for w, r in rerun.items())
                + " (dq's float32 sums added in no fixed order: not "
                  "deterministic)")
            del again
        layout = flash_ops.bwd_layout(d, dv) if dt == torch.bfloat16 \
            else None
        ms = time_ms(torch, lambda: flash_ops.flash_attention_bwd(
            q, k, v, o, m, l, do, causal=causal))
        plain_block = 512 if label == "train" else 1024
        plain_ms = time_ms(torch, lambda: flash_attention_bwd_ref(
            q, k, v, o, m, l, do, causal=causal, block_kv=plain_block))
        dev_ms = device_ms(torch, lambda: flash_ops.flash_attention_bwd(
            q, k, v, o, m, l, do, causal=causal), runs=5)
        lib_ms = sdpa_bwd_ms(torch, q, k, v, do, causal) \
            if sq == skv else None
        # the bound of the function (flash_attention_bwd's bwd_work()).
        # The bf16 kernel feeds P and dS to its tensor cores as hi + lo:
        # eight products' worth (S, dP, and dV, dK, dQ twice), its own
        # floor beside the bound
        wk = flash_ops.bwd_work(q, k, v, causal)
        b_ms, b_by = bound(wk, dt)
        split_ms = None
        if dt == torch.bfloat16:
            pairs = flash_ops.attention_pairs(b, h, sq, skv, causal)
            split_ms = bound((pairs * 2 * (5 * d + 3 * dv), wk[1]),
                             torch.bfloat16)[0]
        log(f"[kernels] flash_attention_bwd {label} B={b} Sq={sq} Skv={skv} "
            f"H={h} KVH={kvh} D={d} Dv={dv} {name} causal={causal}: "
            + " ".join(f"{w}_max_abs_err={e[0]} ({e[1]:.3g} of max)"
                       for w, e in errs.items())
            + f" m_err={m_err} l_rel_err={l_err:.3g} faults_caught={caught} "
            f"ms={ms:.3f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.3f} "
            f"library_ms={'-' if lib_ms is None else f'{lib_ms:.3f}'} "
            f"bound_ms={b_ms:.4f} ({b_by})"
            + ("" if split_ms is None else
               f" hi_lo_bound_ms={split_ms:.4f} (8 products)")
            + ("" if layout is None else
               f" layout={layout} (bwd_delta, bwd_pack_stats, "
               f"flash_bwd_wgmma grid (KVH, B, ceil(Skv / "
               f"{layout['keys_per_block']})), bwd_dq_cast; dq's float32 "
               f"sums added by TMA reductions or atomics, not "
               f"deterministic)"))
        table[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                            hi_lo_bound_ms=split_ms, layout=layout,
                            dq_deterministic=dt != torch.bfloat16,
                            second_launch=rerun or None,
                            errors=errs, m_err=m_err, l_rel_err=l_err)
        if label == "train":
            main = dict(table[label], shape=f"B={b} S={sq} H={h} KVH={kvh} "
                                            f"D={d} {name} causal")
        del q, k, v, do, o, m, l, got
        torch.cuda.empty_cache()
    flash_ops.launches.n = n_fwd
    return dict(main, max_abs_err=worst, cases=table)


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


def compare_knn(label: str, got, want, tol: float = KNN_GAP) -> dict:
    """kNN (vals, ids) against a reference run: the same -inf padding, max
    |delta| <= ``tol`` over finite scores, and the same ids at every
    position whose score differs from both neighbours' by more than
    ``tol`` (a closer pair may swap on one rounding)."""
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
    sep = gap > tol
    id_miss = int((gi != wi)[sep].sum())
    bitwise = int((gv == wv).sum())
    log(f"{label}: max_abs_err={err} ids_differ_where_separated={id_miss} "
        f"of {int(sep.sum())} ids_equal={int((gi == wi).sum())} "
        f"values_bitwise_equal={bitwise} of {wv.size}")
    check(err <= tol, f"{label}: max|delta| {err}")
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
        label = "residual" if residual else "plain"
        calls = check_pq_calls(torch, idx, queries, 100)
        bad = [c for c in calls if not c["ok"]]
        qs = [c["Q"] for c in calls]
        ns = [c["N"] for c in calls]
        log(f"[pq] {label} adc + fused at k=100: {len(calls)} pq_adc_topk "
            f"calls (Q {min(qs)}-{max(qs)}, N {min(ns)}-{max(ns)}, k' "
            f"{sorted({c['k'] for c in calls})}) against plain: "
            f"{len(calls) - len(bad)} equal, max_abs_err "
            f"{max(c['err'] for c in calls)}")
        check(not bad, f"pq {label} scans differ from plain: {bad[:3]}")
        out[f"{label}_calls_checked"] = len(calls)
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


def check_pq_calls(torch, idx, queries, k: int) -> list:
    """One adc and one fused ``search_many`` at k with every
    ``pq_adc_topk`` call of the index (one a probe group in adc) held
    against the plain version on the same inputs: ids and padding equal,
    max |delta| <= 1e-4.  Returns each call's shape and result."""
    from repro_torch.core import vector_index
    from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref

    kernel = vector_index.pq_adc_topk
    calls = []

    def checked(luts, codes, kp, **kw):
        v, i = kernel(luts, codes, kp, **kw)
        pv, pi = pq_adc_topk_ref(luts, codes, kp, **kw)
        fin = torch.isfinite(pv)
        err = float((v[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
        ok = (torch.equal(i, pi) and torch.equal(fin, torch.isfinite(v))
              and err <= 1e-4)
        calls.append(dict(Q=luts.shape[0], N=codes.shape[0], k=kp,
                          ok=bool(ok), err=err))
        return v, i

    vector_index.pq_adc_topk = checked
    try:
        for mode in ("adc", "fused"):
            idx.search_many(queries, k, mode=mode)
    finally:
        vector_index.pq_adc_topk = kernel
    return calls


# ---------------------------------------------------------------------------
# phase 5: the LM (llama3-8b) and the LM as phi
# ---------------------------------------------------------------------------

LM_ARCH = "llama3-8b"
PREFILL_BATCH, PREFILL_LEN = 8, 4096    # prefill_32k cut to B=8, S=4,096
DECODE_LEN, DECODE_STEPS = 32768, 32    # decode_32k's cache, cut to B=8
DECODE_WINDOWS = 4                      # the decode steps' timing windows
PHI_DOCS, PHI_TWINS = 2000, 20
MOE_ARCH, MLA_ARCH = "deepseek-moe-16b", "deepseek-v2-236b"
MOE_DECODE_BATCH = 4        # decode_32k's B = 128 cut to 4: ~30 GB of cache
MLA_DECODE_BATCH = 8
MLA_LAYERS = 5              # 60 -> the dense layer 0 + 4 MoE layers
MOE_DECODE_STEPS = 16


def unlisted_norms(cfg) -> int:
    """Parameters that ``param_count()`` leaves out: the final norm's
    d_model scales, and MLA's latent norm scales (kv_a_norm, q_a_norm)."""
    mla = cfg.n_layers * (cfg.kv_lora_rank + cfg.q_lora_rank) \
        if cfg.is_mla else 0
    return cfg.d_model + mla


def serve_lm(torch, label: str, cfg, decode_batch: int, steps: int,
             prof=None):
    """An LM of the registry at full width on the card, its weights drawn
    there from a seeded generator: ``prefill_step`` on PREFILL_BATCH
    prompts of PREFILL_LEN tokens, the first ``decode_batch`` rows of its
    cache copied into a DECODE_LEN-position cache, ``steps`` greedy
    ``serve_step``s.  Checks the parameter count against ``param_count()``,
    finite logits, and that each decode step wrote its cache rows and
    nothing past them.  Prints tokens/s, step ms (wall against host-thread
    CPU time in DECODE_WINDOWS windows), the decode step's floor (every
    weight read once at the memory rate) and peak memory.  Returns (its
    numbers, the model); the caches are freed."""
    import gc

    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models.transformer import LM

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    out = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    out["init_s"] = time.perf_counter() - t0
    out["params"], out["weight_gb"] = n_params, weight_bytes / 1e9
    moe = (f" moe_layers={model.n_moe} experts={cfg.n_routed_experts}+"
           f"{cfg.n_shared_experts} top_k={cfg.top_k} moe_d_ff="
           f"{cfg.moe_d_ff}" if cfg.is_moe else "")
    mla = (f" mla kv_lora={cfg.kv_lora_rank} q_lora={cfg.q_lora_rank} "
           f"qk={cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim} "
           f"v={cfg.v_head_dim}" if cfg.is_mla else "")
    heads = f"{cfg.n_heads}" if cfg.is_mla else \
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}"
    log(f"[{label}] {cfg.n_layers} layers d_model={cfg.d_model} "
        f"heads={heads} d_ff={cfg.d_ff}"
        f"{moe}{mla} vocab={cfg.vocab_size} {cfg.dtype}: {n_params} "
        f"parameters ({weight_bytes / 1e9:.2f} GB) initialised on the card "
        f"in {out['init_s']:.1f}s")
    check(n_params == cfg.param_count() + unlisted_norms(cfg),
          "parameter count differs from the config's")

    b, s = PREFILL_BATCH, PREFILL_LEN
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, pre = prefill_step(model, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(last.shape == (b, cfg.vocab_size) and
          bool(torch.isfinite(last).all()), "prefill logits not finite")
    out["prefill"] = {"ms": prefill_s * 1e3,
                      "tokens_per_s": b * s / prefill_s}
    log(f"[{label}] prefill_step B={b} S={s}: ms={prefill_s * 1e3:.1f} "
        f"tokens_per_s={b * s / prefill_s:.1f}")

    db = decode_batch
    cache = model.init_cache(db, DECODE_LEN)
    for key in cache:
        for dst, src in zip(cache[key], pre[key]):
            dst[:, :, :s] = src[:, :db]
    del pre
    cache_gb = sum(t.numel() * t.element_size() for pair in cache.values()
                   for t in pair) / 1e9
    nxt = last[:db].argmax(-1)
    steps_ms, cpu_ms, generated = [], [], []
    for t in range(steps):
        pos = torch.full((db,), s + t, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        logits, cache = serve_step(model, cache, nxt[:, None], pos)
        nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        cpu_ms.append((time.thread_time() - c0) * 1e3)
        check(bool(torch.isfinite(logits).all()),
              f"decode step {t} logits not finite")
        generated.append(nxt)
    for key, (first, _) in cache.items():
        # [L, B, steps, ...] -> each step's largest |value|
        written = first[:, :, s:s + steps].transpose(0, 2).reshape(steps, -1)
        check(bool((written.abs().amax(1) > 0).all()),
              f"decode steps left {key} cache rows unwritten")
        check(bool((first[:, :, s + steps:] == 0).all()),
              f"decode wrote past its positions in the {key} cache")
    total = sum(steps_ms) / 1e3
    floor_ms = hbm_ms(weight_bytes)
    out["decode"] = {"steps": steps, "batch": db, "cache_len": DECODE_LEN,
                     "cache_gb": cache_gb,
                     "step_ms_mean": sum(steps_ms) / len(steps_ms),
                     "step_ms_min": min(steps_ms),
                     "step_ms_max": max(steps_ms),
                     "weights_floor_ms": floor_ms,
                     "tokens_per_s": db * steps / total}
    log(f"[{label}] serve_step x{steps} B={db} cache={DECODE_LEN} "
        f"({cache_gb:.2f} GB) from pos {s}: step_ms "
        f"mean={out['decode']['step_ms_mean']:.2f} min={min(steps_ms):.2f} "
        f"max={max(steps_ms):.2f} (floor: the weights once at the memory "
        f"rate {floor_ms:.2f}) tokens_per_s="
        f"{out['decode']['tokens_per_s']:.1f}; first row's tokens "
        f"{[int(x[0]) for x in generated[:8]]}")
    # the step's spread: wall against this thread's CPU time, by window; a
    # step whose CPU time is its wall time is the host issuing work
    win = steps // DECODE_WINDOWS
    out["decode"]["windows"] = [
        {"wall_ms": sum(steps_ms[i:i + win]) / win,
         "thread_cpu_ms": sum(cpu_ms[i:i + win]) / win}
        for i in range(0, win * DECODE_WINDOWS, win)]
    log(f"[{label}] decode windows of {win} steps, wall ms / thread CPU ms "
        "a step: " + ", ".join(f"{w['wall_ms']:.2f} / {w['thread_cpu_ms']:.2f}"
                               for w in out["decode"]["windows"]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label}] peak device memory {out['peak_gb']:.1f} GB")
    if prof is not None:
        prof(f"{label} prefill B={b} S={s}",
             lambda: prefill_step(model, tokens))
        pos = torch.full((db,), s + steps, dtype=torch.int32, device=dev)
        prof(f"{label} decode step B={db} cache={DECODE_LEN} pos={s + steps}",
             lambda: serve_step(model, cache, nxt[:, None], pos))
    del cache, logits, last, written
    gc.collect()
    torch.cuda.empty_cache()
    return out, model


def phase_lm(torch, prof=None):
    """llama3-8b at full width and depth on the card: a prefill of 8
    prompts of 4,096 tokens, 32 greedy decode steps into a 32,768-position
    cache, then the LM as phi in a PandaDB similarity query."""
    import gc

    from repro_torch.configs import get_arch

    out, model = serve_lm(torch, "lm", get_arch(LM_ARCH).model,
                          PREFILL_BATCH, DECODE_STEPS, prof)
    out["phi"] = phase_phi(torch, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_lm(torch, prof=None):
    """deepseek-moe-16b at full width and depth (28 layers, 64 routed + 2
    shared experts, top-6): a prefill of 8 prompts of 4,096 tokens, 16
    greedy decode steps at B = 4 into a 32,768-position cache."""
    from repro_torch.configs import get_arch

    out, _ = serve_lm(torch, "moe-lm", get_arch(MOE_ARCH).model,
                      MOE_DECODE_BATCH, MOE_DECODE_STEPS, prof)
    return out


def phase_mla_lm(torch, prof=None):
    """deepseek-v2-236b at full width, cut to its dense layer 0 and 4 MoE
    layers: MLA (128 heads, kv_lora 512, q_lora 1,536), 160 routed + 2
    shared experts, top-6; a prefill of 8 prompts of 4,096 tokens, 16
    greedy decode steps at B = 8 into a 32,768-position latent cache."""
    from repro_torch.configs import get_arch, reduced

    cfg = reduced(get_arch(MLA_ARCH).model, n_layers=MLA_LAYERS)
    out, _ = serve_lm(torch, "mla-lm", cfg, MLA_DECODE_BATCH,
                      MOE_DECODE_STEPS, prof)
    return out


PHI_CELL_ARCH = "deepseek-v2-lite"
PHI_CELL_ROWS, PHI_CELL_BATCH = 1_000_000, 256


def phase_phi_cell(torch):
    """The phi cell's path once (the module docstring's, after phase 7),
    the model with the port's own init: its vectors, the index's answers,
    the pairs dropped, the batch's ms, the model's build and the index's."""
    import gc

    import numpy as np
    from repro_torch.configs import (AIPMConfig, PandaDBConfig,
                                     VectorIndexConfig, get_arch)
    from repro_torch.core import PandaDB
    from repro_torch.core.aipm import model_embedding_extractor
    from repro_torch.core.vector_index import METRICS, IVFIndex
    from repro_torch.models import moe
    from repro_torch.models.transformer import LM

    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    rows = rng.standard_normal((PHI_CELL_ROWS, FACE_DIM), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    t0 = time.perf_counter()
    index = IVFIndex.build(rows, cfg=VectorIndexConfig(
        dim=FACE_DIM, metric="cosine", vectors_per_bucket=100_000,
        min_buckets=4, nprobe=8, kmeans_iters=8, pq_m=0), seed=29,
        device=dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = LM(get_arch(PHI_CELL_ARCH).model, device=dev)
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    db = PandaDB(PandaDBConfig(aipm=AIPMConfig(
        max_batch=PHI_CELL_BATCH, auto_batch=False)), device=dev)
    fn = model_embedding_extractor(lm, dim=FACE_DIM, max_tokens=64)
    db.register_extractor("textvec", fn, batch_size=PHI_CELL_BATCH)
    texts = [rng.integers(97, 123, int(n), dtype=np.uint8)
             for n in rng.integers(16, 65, PHI_CELL_BATCH)]
    fn(texts)          # the first forward, outside the request's timeout
    dropped0 = moe.METRICS.counter("moe.dropped_pairs").value
    dense0 = METRICS.counter("ivf.path.dense").value
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = db.aipm.extract_sync("textvec", list(enumerate(texts)))
    q = np.stack([got[i] for i in range(PHI_CELL_BATCH)]).astype(np.float32)
    vals, ids = index.search_many(q, 10, 8)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    dropped = moe.METRICS.counter("moe.dropped_pairs").value - dropped0
    dense = METRICS.counter("ivf.path.dense").value - dense0
    ids, vals = np.asarray(ids), np.asarray(vals)
    unit = float(np.abs(np.linalg.norm(q, axis=1) - 1).max())
    log(f"[phi-cell] {PHI_CELL_ARCH} ({lm.cfg.n_layers} layers, built in "
        f"{model_s:.1f}s) as textvec over {PHI_CELL_BATCH} texts, then "
        f"search_many k=10 nprobe=8 over {PHI_CELL_ROWS} cosine rows "
        f"({index.centroids.shape[0]} buckets, built in {build_s:.1f}s): "
        f"{ms:.1f} ms; max | |phi| - 1 | {unit:.3g}, pairs dropped "
        f"{dropped}, dense scans {dense}, best score mean "
        f"{float(vals[:, 0].mean()):.4f}")
    db.aipm.shutdown()
    check(bool(np.isfinite(q).all()) and unit < 1e-5,
          f"phi cell: vectors not unit ({unit})")
    check(dropped == 0, f"phi cell: {dropped} (token, expert) pairs dropped")
    check(bool(((ids >= 0) & (ids < PHI_CELL_ROWS)).all()),
          "phi cell: an answer outside the index")
    check(dense == 1, f"phi cell: {dense} batches on the dense scan")
    del db, fn, lm, index
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "model_build_s": model_s, "index_build_s": build_s,
            "pairs_dropped": dropped, "dense_scans": dense}


MELLUM2_ARCH = "mellum2-12b-a2.5b"
#: GovReport's reports and one report's positions (the Mellum2 cell's)
MELLUM2_ROWS, MELLUM2_TOKENS = 19_466, 32_768


def phase_mellum2_cell(torch):
    """The Mellum2 cell's path once, the model whole with the port's own
    init: one report of 16-64 KB (byte tokens, cut or padded to 32,768) as
    ``docvec`` through the AIPM service, then its top 10 among 19,466
    cosine rows; the flash launches of that one forward by instantiation
    (the window's, one a sliding layer, and the causal one's, one a full
    layer), the pairs dropped, the batch's ms, the model's build."""
    import gc

    import numpy as np
    from repro_torch.configs import (AIPMConfig, PandaDBConfig,
                                     VectorIndexConfig, get_arch)
    from repro_torch.core import PandaDB
    from repro_torch.core.aipm import model_embedding_extractor
    from repro_torch.core.vector_index import IVFIndex
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import LM

    dev = torch.device("cuda")
    rng = np.random.default_rng(33)
    rows = rng.standard_normal((MELLUM2_ROWS, FACE_DIM), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index = IVFIndex.build(rows, cfg=VectorIndexConfig(
        dim=FACE_DIM, metric="cosine", vectors_per_bucket=5_000,
        min_buckets=4, nprobe=8, kmeans_iters=8, pq_m=0), seed=33,
        device=dev)
    t0 = time.perf_counter()
    cfg = get_arch(MELLUM2_ARCH).model
    lm = LM(cfg, device=dev)
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    db = PandaDB(PandaDBConfig(aipm=AIPMConfig(max_batch=1,
                                               auto_batch=False)), device=dev)
    fn = model_embedding_extractor(lm, dim=FACE_DIM,
                                   max_tokens=MELLUM2_TOKENS)
    db.register_extractor("docvec", fn, batch_size=1)
    reports = [rng.integers(97, 123, int(n), dtype=np.uint8)
               for n in rng.integers(16_384, 65_537, 2)]
    fn(reports[:1])    # the first forward, outside the request's timeout
    dropped0 = moe.METRICS.counter("moe.dropped_pairs").value
    n0 = (flash_ops.launches.n, flash_ops.window_launches.n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = db.aipm.extract_sync("docvec", [(0, reports[1])])
    q = got[0][None].astype(np.float32)
    vals, ids = index.search_many(q, 10, 8)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    window = flash_ops.window_launches.n - n0[1]
    full = flash_ops.launches.n - n0[0] - window
    dropped = moe.METRICS.counter("moe.dropped_pairs").value - dropped0
    ids, vals = np.asarray(ids), np.asarray(vals)
    unit = float(np.abs(np.linalg.norm(q, axis=1) - 1).max())
    sliding = cfg.layer_types.count("sliding_attention")
    log(f"[mellum2-cell] {MELLUM2_ARCH} ({cfg.n_layers} layers, {sliding} "
        f"sliding, window {cfg.sliding_window}; built in {model_s:.1f}s) as "
        f"docvec over one report of {MELLUM2_TOKENS} positions, then "
        f"search_many k=10 nprobe=8 over {MELLUM2_ROWS} cosine rows: "
        f"{ms:.1f} ms; flash launches window {window} causal {full}; max "
        f"| |phi| - 1 | {unit:.3g}, pairs dropped {dropped}, best score "
        f"{float(vals[0, 0]):.4f}")
    db.aipm.shutdown()
    check(window == sliding and full == cfg.n_layers - sliding,
          f"mellum2 cell: flash launches window {window} causal {full}")
    check(bool(np.isfinite(q).all()) and unit < 1e-5,
          f"mellum2 cell: vector not unit ({unit})")
    check(dropped == 0, f"mellum2 cell: {dropped} (token, expert) pairs "
          "dropped")
    check(bool(((ids >= 0) & (ids < MELLUM2_ROWS)).all()),
          "mellum2 cell: an answer outside the index")
    del db, fn, lm, index
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "model_build_s": model_s, "window_launches": window,
            "causal_launches": full, "pairs_dropped": dropped}



def phase_phi(torch, model):
    """The LM as phi: 2,000 Doc nodes with seeded 64-byte texts, 20 of them
    near-duplicates (one byte changed) of 20 planted anchors;
    ``model_embedding_extractor(lm, dim=128)`` registered as ``textvec``,
    the index built, and examples/train_lm_e2e.py's query run from the
    planted anchors must return each anchor's twin."""
    import numpy as np
    from repro_torch.core import PandaDB
    from repro_torch.core.aipm import model_embedding_extractor

    rng = np.random.default_rng(7)
    texts = rng.integers(0, 256, (PHI_DOCS, 64), dtype=np.uint8)
    twin_of = {}
    for i in range(PHI_TWINS):
        j = PHI_DOCS - PHI_TWINS + i
        texts[j] = texts[i]
        texts[j, 60] ^= 0x55
        twin_of[f"doc_{i}"] = f"doc_{j}"
    db = PandaDB(device="cuda")
    db.register_extractor("textvec", model_embedding_extractor(model, dim=128),
                          batch_size=8)
    for i, t in enumerate(texts):
        db.graph.create_node("Doc", name=f"doc_{i}", blob=t.tobytes(),
                             planted=int(i < PHI_TWINS))
    t0 = time.perf_counter()
    idx = db.build_index("textvec", "blob")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[phi] {PHI_DOCS} blobs through the LM (batches of 8) and the "
        f"textvec index ({idx.n_total} rows, dim {idx.vectors.shape[1]}, on "
        f"{idx.t_vectors.device}) in {build_s:.1f}s")
    text = ("MATCH (x:Doc), (y:Doc) WHERE x.planted = 1 AND "
            "x.blob->textvec ~: y.blob->textvec RETURN x.name, y.name")
    t0 = time.perf_counter()
    rows = db.query(text)
    torch.cuda.synchronize()
    query_ms = (time.perf_counter() - t0) * 1e3
    found = {}
    for r in rows:
        found.setdefault(r["x.name"], set()).add(r["y.name"])
    hits = sum(twin_of[a] in found.get(a, ()) for a in twin_of)
    others = sum(len(v - {a, twin_of[a]}) for a, v in found.items())
    log(f"[phi] planted twins found {hits} of {PHI_TWINS}; rows={len(rows)} "
        f"(other matches {others}) in {query_ms:.1f} ms")
    db.aipm.shutdown()
    check(hits == PHI_TWINS, f"the phi query found {hits} of {PHI_TWINS} "
          f"planted twins")
    return {"index_build_s": build_s, "query_ms": query_ms, "twins": hits,
            "rows": len(rows), "other_matches": others}


# each arch cut as launch/train.py's smoke config cuts llama3-8b (2 layers,
# d_model 128, float32); the MoE cuts keep their expert count and top-k, a
# dense first layer and the shared experts
PARITY_CUTS = {
    LM_ARCH: dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  head_dim=32, d_ff=256, vocab_size=512),
    MOE_ARCH: dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                   head_dim=32, d_ff=256, moe_d_ff=64, vocab_size=512),
    MLA_ARCH: dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                   d_ff=256, moe_d_ff=64, vocab_size=512, kv_lora_rank=64,
                   q_lora_rank=96, qk_nope_head_dim=32, qk_rope_head_dim=16,
                   v_head_dim=32),
}


def fill_cache(cache, pre, s: int) -> None:
    """Copy a prefill's cache into the first ``s`` positions of a decode
    cache of the same batch, every stack."""
    for key in cache:
        for dst, src in zip(cache[key], pre[key]):
            dst[:, :, :s] = src


def phase_lm_parity(torch, arch: str = LM_ARCH):
    """``arch`` cut to ``PARITY_CUTS[arch]`` in float32, the same weights on
    the card and on the CPU: prefill and 8 greedy decode steps; logits
    within 1e-4, tokens identical."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import LM

    cfg = reduced(get_arch(arch).model, **PARITY_CUTS[arch],
                  dtype="float32", grad_accum=1, fsdp=False)
    card = LM(cfg, device="cuda",
              generator=torch.Generator(device="cuda").manual_seed(1))
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    b, s, steps = 2, 37, 8
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(2))
    runs = []
    for model in (card, cpu):
        full, _ = model.forward(toks)
        last, pre = model.prefill(toks)
        cache = model.init_cache(b, s + steps)
        fill_cache(cache, pre, s)
        logits, tokens = [last.cpu()], [last.argmax(-1).cpu()]
        for t in range(steps):
            lg, cache = model.decode_step(cache, tokens[-1][:, None],
                                          torch.full((b,), s + t))
            logits.append(lg.cpu())
            tokens.append(lg.argmax(-1).cpu())
        runs.append((full.cpu(), torch.stack(logits), torch.stack(tokens)))
    err_full = float((runs[0][0] - runs[1][0]).abs().max())
    err_dec = float((runs[0][1] - runs[1][1]).abs().max())
    same = bool(torch.equal(runs[0][2], runs[1][2]))
    log(f"[lm parity] 2-layer float32 {arch} card vs cpu: forward "
        f"max_abs_err={err_full} prefill+decode max_abs_err={err_dec} "
        f"greedy_tokens_identical={same}")
    check(err_full <= 1e-4 and err_dec <= 1e-4,
          f"lm parity logits differ by {max(err_full, err_dec)}")
    check(same, "lm parity greedy tokens differ")
    return {"forward_max_abs_err": err_full, "decode_max_abs_err": err_dec,
            "tokens_identical": same}


def phase_lm_parity_bf16(torch, arch: str = LM_ARCH):
    """The bf16 attention kernels inside the model: ``arch`` cut to 2
    layers at full width (bf16, its path's kernel shapes; a MoE arch keeps
    its dense layer 0 and one MoE layer), on the card once through the
    kernels and once with ``chunked_attention`` / ``decode_attention``
    swapped for their plain versions: a prefill of 2 prompts of 500 tokens
    and 8 greedy decode steps, the plain run fed the kernel run's tokens
    and, in MoE layers, the kernel run's expert choices (weights from its
    own probabilities; a choice is a step function of the router's input,
    so one ulp of attention could move a token to another expert).  The two
    runs differ only where the attention's one bf16 rounding falls the
    other way, which moves a logit by at most an ulp: logits within two
    bf16 ulps of the largest logit (2^-6 max |logit|), and greedy tokens
    identical wherever the plain run's top two logits are further apart.
    Tokens whose plain run would have chosen other experts are counted."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import moe, transformer
    from repro_torch.models.transformer import LM

    cfg = reduced(get_arch(arch).model, n_layers=2)
    dev = torch.device("cuda")
    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(5))
    b, s, steps = 2, 500, 8
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
    routes, moved = [], []
    router_topk = moe.router_topk

    def recording(probs, k):
        w, idx = router_topk(probs, k)
        routes.append(idx)
        return w, idx

    def replaying(probs, k):
        idx = routes[len(moved)]
        own = router_topk(probs, k)[1]
        moved.append(int((own.sort(-1).values != idx.sort(-1).values)
                         .any(-1).sum()))
        w = probs.gather(-1, idx)
        return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9), idx

    def run(feed=None):
        last, pre = model.prefill(toks)
        cache = model.init_cache(b, s + steps)
        fill_cache(cache, pre, s)
        logits = [last]
        for t in range(steps):
            nxt = logits[-1].argmax(-1) if feed is None else feed[t]
            lg, cache = model.decode_step(cache, nxt[:, None],
                                          torch.full((b,), s + t, device=dev))
            logits.append(lg)
        return torch.stack(logits).float()              # [steps + 1, B, V]

    def launched():
        return (flash_ops.launches.n, decode_ops.launches.n)

    n0 = launched()
    moe.router_topk = recording
    try:
        kern = run()
    finally:
        moe.router_topk = router_topk
    n1 = launched()
    tokens = kern.argmax(-1)
    saved = transformer.chunked_attention, transformer.decode_attention
    transformer.chunked_attention = flash_attention_ref
    transformer.decode_attention = decode_attention_ref
    moe.router_topk = replaying
    try:
        plain = run(feed=tokens)
    finally:
        transformer.chunked_attention, transformer.decode_attention = saved
        moe.router_topk = router_topk
    # MLA's absorbed decode is plain torch: no decode kernel there
    decode_launches = 0 if cfg.is_mla else cfg.n_layers * steps
    check(n1[0] - n0[0] == cfg.n_layers and
          n1[1] - n0[1] == decode_launches and launched() == n1,
          f"bf16 lm parity launches {n0} -> {n1} -> {launched()}")
    check(len(moved) == len(routes), "the plain run routed another number "
          "of times than the kernel run")
    check(bool(torch.isfinite(kern).all()), "bf16 lm logits not finite")
    limit = 2.0 ** -6 * float(plain.abs().max())
    err = float((kern - plain).abs().max())
    equal = float((kern == plain).float().mean())
    top2 = plain.topk(2, dim=-1).values
    apart = top2[..., 0] - top2[..., 1] > limit
    same = tokens == plain.argmax(-1)
    n_routed = sum(r.shape[0] * r.shape[1] for r in routes)
    routed = (f"; routing replayed over {n_routed} tokens, {sum(moved)} of "
              f"which the plain run would have sent to other experts"
              if routes else "")
    log(f"[lm parity] 2-layer bf16 {arch} at full width, kernels vs "
        f"plain on the card: logits max_abs_err={err} limit={limit} "
        f"bitwise_equal={equal:.6f}; greedy tokens identical "
        f"{int(same.sum())} of {same.numel()} (near ties "
        f"{int((~apart).sum())}, differing there {int((~same).sum())})"
        f"{routed}")
    check(err <= limit, f"bf16 lm logits differ by {err} > {limit}")
    check(bool((same | ~apart).all()),
          "bf16 lm greedy tokens differ where the top two logits are apart")
    del model
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "limit": limit, "bitwise_equal": equal,
            "tokens_identical": int(same.sum()), "tokens": same.numel(),
            "near_ties": int((~apart).sum()),
            "routing_would_differ": sum(moved)}


# ---------------------------------------------------------------------------
# training: llama3-8b at full width, and 2-layer parity
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8            # 32 -> 8: weights, grads and AdamW state fit
TRAIN_BATCH, TRAIN_LEN = 8, 4096   # train_4k's global batch 256 cut to 8
TRAIN_STEPS = 4


def train_flops(cfg, tokens: int, seq: int) -> dict:
    """Model FLOPs of a training step (no recompute counted): 6 N_matmul
    per token for the weight products (N_matmul: every matrix a token
    multiplies -- wq, wk, wv, wo, w_gate, w_up, w_down of each layer and
    the head; not the embedding gather), plus attention's 3 x 4 H D
    operations per visible (query, key) pair and layer (forward S and P V,
    backward twice that), (S + 1) / 2 visible keys a query under causal.
    ``executed_flops``: the products a step runs, which an operation count
    (``launch/op_analysis.py``) sees: the same plus, under remat, each
    block's forward again but its last product, and the attention
    backward's five products."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    per_layer = d * h * hd * 2 + d * cfg.n_kv_heads * hd * 2 + 3 * d * cfg.d_ff
    n_matmul = cfg.n_layers * per_layer + d * cfg.vocab_size
    attn = 12 * cfg.n_layers * h * hd * (seq + 1) / 2
    # what a step runs: under remat each block's forward again in the
    # backward, up to its last product (torch's checkpoint stops the
    # recompute once the backward has what it needs: w_down's output is
    # not), so 2 (N_matmul - d V - L d d_ff); and attention's backward as
    # its kernel computes it, five products (10 H D a pair, not 8)
    recompute = 2 * (n_matmul - d * cfg.vocab_size
                     - cfg.n_layers * d * cfg.d_ff) if cfg.remat else 0
    attn_run = attn * ((4 + 4 + 10) if cfg.remat else (4 + 10)) / 12
    return {"n_matmul": n_matmul,
            "flops": (6 * n_matmul + attn) * tokens,
            "formula": "(6 N_matmul + 12 L H D (S + 1) / 2) tokens",
            "executed_flops": (6 * n_matmul + recompute + attn_run) * tokens,
            "executed_formula": "(8 N_matmul - 2 d V - 2 L d d_ff + 18 L H "
                                "D (S + 1) / 2) tokens under remat"}


def phase_train(torch, prof=None):
    """llama3-8b at full width (d_model 4,096, 32 / 8 heads of 128, d_ff
    14,336, vocab 128,256, bf16) cut to TRAIN_LAYERS layers, weights drawn
    on the card from a seeded generator; TRAIN_STEPS optimizer steps of
    ``train_step`` on SyntheticLM batches of 8 x 4,096 tokens, each the
    config's grad_accum = 4 micro-batches of 2, under remat, AdamW: loss
    (finite), grad norm, step ms, tokens/s, MFU, peak memory, and the flash
    forward and backward kernels' launches."""
    import gc

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.mesh import peak_flops
    from repro_torch.launch.steps import train_step
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    cfg = reduced(get_arch(LM_ARCH).model, n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(0))
    opt_cfg = AdamWConfig()
    opt_state = init_opt_state(dict(model.named_parameters()))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] llama3-8b cut to {cfg.n_layers} layers, d_model="
        f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}: {n_params} "
        f"parameters, grad_accum={cfg.grad_accum} remat={cfg.remat}; model "
        f"and AdamW state on the card in {time.perf_counter() - t0:.1f}s")
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, TRAIN_LEN, TRAIN_BATCH))
    tokens = TRAIN_BATCH * TRAIN_LEN
    fl = train_flops(cfg, tokens, TRAIN_LEN)
    n0 = (flash_ops.launches.n, flash_ops.bwd_launches.n)
    steps = []
    for step in range(TRAIN_STEPS):
        batch = data.batch(step)
        toks = torch.from_numpy(batch["tokens"]).to(dev)
        labs = torch.from_numpy(batch["labels"]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_state, met = train_step(model, opt_state, toks, labs, opt_cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        row = {k: float(v) for k, v in met.items()}
        row.update(ms=ms, tokens_per_s=tokens / ms * 1e3,
                   mfu=fl["flops"] / (ms / 1e3) / peak_flops("bfloat16"))
        steps.append(row)
        log(f"[train] step {step}: loss={row['loss']:.6f} ce={row['ce']:.6f} "
            f"grad_norm={row['grad_norm']:.6f} lr={row['lr']:.3g} "
            f"step_ms={ms:.1f} tokens_per_s={row['tokens_per_s']:.1f} "
            f"mfu={row['mfu']:.4f}")
        check(all(math.isfinite(row[k]) for k in ("loss", "grad_norm")),
              f"train step {step}: loss or grad norm not finite")
    n1 = (flash_ops.launches.n, flash_ops.bwd_launches.n)
    launches = {"flash_attention": n1[0] - n0[0],
                "flash_attention_bwd": n1[1] - n0[1]}
    # each of the L layers, per micro-batch: a forward, its recompute under
    # remat, and one backward
    micro = TRAIN_STEPS * cfg.grad_accum
    want = {"flash_attention": micro * cfg.n_layers * (2 if cfg.remat else 1),
            "flash_attention_bwd": micro * cfg.n_layers}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {TRAIN_STEPS} steps of {tokens} tokens: launches {launches} "
        f"(expected {want}); peak device memory {peak:.1f} GB; MFU = "
        f"{fl['formula']} / step time / 989 TFLOP/s, N_matmul="
        f"{fl['n_matmul']}, {fl['flops'] / 1e12:.1f} TFLOP a step")
    check(launches == want, f"train launches {launches}, expected {want}")
    if prof is not None:
        batch = data.batch(TRAIN_STEPS)
        toks = torch.from_numpy(batch["tokens"]).to(dev)
        labs = torch.from_numpy(batch["labels"]).to(dev)
        prof(f"train step llama3-8b {cfg.n_layers}L B={TRAIN_BATCH} "
             f"S={TRAIN_LEN}",
             lambda: train_step(model, opt_state, toks, labs, opt_cfg))
    del model, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "launches": launches, "peak_gb": peak,
            "n_params": n_params, **fl}


def train_cut(arch: str):
    """``arch`` cut to ``PARITY_CUTS[arch]`` in float32, grad_accum 2."""
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch(arch).model, **PARITY_CUTS[arch],
                   dtype="float32", grad_accum=2, fsdp=False)


def grads_of(model, toks, labs):
    """(loss, {name: gradient}) of ``model.loss_fn``."""
    from repro_torch.training.optimizer import gradients
    loss, _ = model.loss_fn(toks, labs)
    return loss.detach(), gradients(loss, dict(model.named_parameters()))


def phase_train_parity(torch, arch: str = LM_ARCH):
    """The 2-layer float32 cut of ``arch``, the same weights on the card
    and on the CPU: the loss and every gradient, then every parameter
    after one ``train_step`` (grad_accum 2), card against CPU within
    1e-4 (float32 sums in another order)."""
    from repro_torch.launch.steps import train_step
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import init_opt_state

    cfg = train_cut(arch)
    card = LM(cfg, device="cuda",
              generator=torch.Generator(device="cuda").manual_seed(7))
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    gen = torch.Generator().manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
    labs = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
    res = []
    for model in (card, cpu):
        loss, grads = grads_of(model, toks, labs)
        opt = init_opt_state(dict(model.named_parameters()))
        _, met = train_step(model, opt, toks, labs)
        res.append((float(loss), {k: g.cpu() for k, g in grads.items()},
                    float(met["loss"]),
                    {k: p.detach().cpu() for k, p in model.named_parameters()}))
    err_loss = max(abs(res[0][0] - res[1][0]), abs(res[0][2] - res[1][2]))
    err_grad = max(float((res[0][1][k] - res[1][1][k]).abs().max())
                   for k in res[0][1])
    err_par = max(float((res[0][3][k] - res[1][3][k]).abs().max())
                  for k in res[0][3])
    log(f"[train parity] 2-layer float32 {arch} card vs cpu: loss "
        f"max_abs_err={err_loss} gradients max_abs_err={err_grad} params "
        f"after one train_step max_abs_err={err_par}")
    check(max(err_loss, err_grad, err_par) <= 1e-4,
          f"train parity {arch} off by {max(err_loss, err_grad, err_par)}")
    return {"loss_err": err_loss, "grad_err": err_grad, "param_err": err_par}


# the bf16 training cut, kernels against plain: the two runs differ only
# where attention's one bf16 rounding (forward output, backward gradients)
# falls the other way, a relative 2^-8 on some elements; the mean loss
# moves far less than that, the gradients' norm by less than 2^-5 of itself
TRAIN_BF16_LOSS_REL, TRAIN_BF16_GNORM_REL = 2.0 ** -8, 2.0 ** -5


def phase_train_parity_bf16(torch):
    """llama3-8b cut to 2 layers at full width, bf16, B = 2, S = 500: the
    loss and gradients of one step through the flash kernels (forward and
    backward) against the same step with both swapped for their plain
    versions, on the card.  Limits: loss within 2^-8 of itself, grad norm
    within 2^-5 of itself; the largest gradient |delta| is reported."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.models import attention
    from repro_torch.models.transformer import LM

    cfg = reduced(get_arch(LM_ARCH).model, n_layers=2)
    dev = torch.device("cuda")
    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(9))
    gen = torch.Generator(device=dev).manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (2, 500), device=dev,
                         generator=gen)
    labs = torch.randint(0, cfg.vocab_size, (2, 500), device=dev,
                         generator=gen)
    n0 = (flash_ops.launches.n, flash_ops.bwd_launches.n)
    k_loss, k_grads = grads_of(model, toks, labs)
    n1 = (flash_ops.launches.n, flash_ops.bwd_launches.n)
    saved = attention.flash_attention, attention.flash_attention_bwd

    def plain_fwd(q, k, v, **kw):
        return flash_attention_ref(q, k, v, **kw)

    def plain_bwd(*a, **kw):
        return flash_attention_bwd_ref(*a, **kw)

    attention.flash_attention = plain_fwd
    attention.flash_attention_bwd = plain_bwd
    try:
        p_loss, p_grads = grads_of(model, toks, labs)
    finally:
        attention.flash_attention, attention.flash_attention_bwd = saved
    per_pass = cfg.n_layers * (2 if cfg.remat else 1)
    check(n1[0] - n0[0] == per_pass and n1[1] - n0[1] == cfg.n_layers and
          (flash_ops.launches.n, flash_ops.bwd_launches.n) == n1,
          f"bf16 train parity launches {n0} -> {n1}")
    k_norm = float(torch.sqrt(sum(g.float().square().sum()
                                  for g in k_grads.values())))
    p_norm = float(torch.sqrt(sum(g.float().square().sum()
                                  for g in p_grads.values())))
    d_loss = abs(float(k_loss) - float(p_loss))
    worst, where = 0.0, ""
    for name, g in k_grads.items():
        e = float((g.float() - p_grads[name].float()).abs().max())
        if e > worst:
            worst, where = e, name
    top = float(p_grads[where].float().abs().max()) if where else 0.0
    log(f"[train parity] 2-layer bf16 llama3-8b at full width, B=2 S=500, "
        f"kernels vs plain on the card: loss {float(k_loss):.6f} vs "
        f"{float(p_loss):.6f} (|delta| {d_loss}, limit "
        f"{TRAIN_BF16_LOSS_REL * abs(float(p_loss)):.3g}); grad norm "
        f"{k_norm:.6f} vs {p_norm:.6f} (limit "
        f"{TRAIN_BF16_GNORM_REL * p_norm:.3g}); largest gradient |delta| "
        f"{worst} in {where} (its largest |grad| {top})")
    check(math.isfinite(float(k_loss)) and math.isfinite(k_norm),
          "bf16 train parity: loss or grad norm not finite")
    check(d_loss <= TRAIN_BF16_LOSS_REL * abs(float(p_loss)),
          f"bf16 train parity: loss differs by {d_loss}")
    check(abs(k_norm - p_norm) <= TRAIN_BF16_GNORM_REL * p_norm,
          f"bf16 train parity: grad norm {k_norm} vs {p_norm}")
    del model, k_grads, p_grads
    torch.cuda.empty_cache()
    return {"loss": float(k_loss), "plain_loss": float(p_loss),
            "grad_norm": k_norm, "plain_grad_norm": p_norm,
            "max_grad_abs_err": worst, "at": where}


# ---------------------------------------------------------------------------
# the collectives on one NCCL rank
# ---------------------------------------------------------------------------

DIST_ROWS, DIST_QUERIES = 200_000, 256


def phase_distributed(torch):
    """A world of one NCCL rank (NCCL takes one rank per card), joined
    through a FileStore under ``build/`` (no network).  ``sharded_topk``
    over 200,000 integer-valued rows (exact sums; the second half repeats
    the first, so ties break across the corpus), d = 128, Q = 256, k in
    {10, 100}, int64 ids past 2**32: ids and values equal ``scan_topk`` over
    the whole corpus.  ``partial_softmax_combine`` of float32 scores
    q . K^T . scale and values V (B = 4, 16 heads of 128, S = 32,768) within
    1e-4 of ``decode_attention`` on the same q, K and V (one query head per
    key head, every position visible), whose chunk combine is the same
    arithmetic, and of the plain softmax."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.vector_index import scan_topk
    from repro_torch.device import resolve_device
    from repro_torch.distributed.collectives import (partial_softmax_combine,
                                                     sharded_topk)
    from repro_torch.kernels.decode_attention import ops as decode_ops

    dev = resolve_device("cuda")              # float32 products stay float32
    store = ROOT / "build" / "nccl_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    out = {}
    try:
        log(f"[distributed] backend {dist.get_backend()} world "
            f"{dist.get_world_size()} on {torch.cuda.get_device_name(0)}")
        rng = np.random.default_rng(8)
        half = rng.integers(-3, 4, (DIST_ROWS // 2, FACE_DIM)).astype(
            np.float32)
        corpus = torch.from_numpy(np.concatenate([half, half])).to(dev)
        ids = torch.arange(DIST_ROWS, device=dev) * 3 + (1 << 33)
        q = torch.from_numpy(rng.integers(-3, 4, (DIST_QUERIES, FACE_DIM))
                             .astype(np.float32)).to(dev)
        for k in (10, 100):
            v, i = sharded_topk(q, corpus, ids, k)
            wv, wi = scan_topk(q, corpus, ids, k)
            torch.cuda.synchronize()
            same, err = bool(torch.equal(i, wi)), float((v - wv).abs().max())
            ms = time_ms(torch, lambda: sharded_topk(q, corpus, ids, k))
            log(f"[distributed] sharded_topk N={DIST_ROWS} d={FACE_DIM} "
                f"Q={DIST_QUERIES} k={k}: ids_equal_whole_corpus={same} "
                f"max_abs_err={err} ids {i.dtype} ms={ms:.3f}")
            check(same and err == 0.0 and i.dtype == torch.int64,
                  f"sharded_topk k={k} differs from the whole-corpus scan")
            out[f"sharded_topk_k{k}"] = {"ms": ms, "max_abs_err": err}
        del corpus, ids, q
        b, s, h, d = 4, 32768, 16, 128
        gen = torch.Generator(device=dev).manual_seed(9)
        qd = torch.randn(b, 1, h, d, device=dev, generator=gen)
        kc = torch.randn(b, s, h, d, device=dev, generator=gen)
        vc = torch.randn(b, s, h, d, device=dev, generator=gen)
        scores = torch.einsum("bhd,bshd->bhs", qd[:, 0], kc) * d ** -0.5
        values = vc.permute(0, 2, 1, 3)
        got = partial_softmax_combine(scores, values)
        plain = torch.einsum("bhs,bhsd->bhd", torch.softmax(scores, -1),
                             values)
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
        n = decode_ops.launches.n        # a comparison: not the path's
        kern = decode_ops.decode_attention(qd, kc, vc, pos)[:, 0]
        decode_ops.launches.n = n
        torch.cuda.synchronize()
        err_k = float((got - kern).abs().max())
        err_p = float((got - plain).abs().max())
        ms = time_ms(torch, lambda: partial_softmax_combine(scores, values))
        log(f"[distributed] partial_softmax_combine B={b} H={h} S={s} "
            f"D={d} float32: max_abs_err vs decode_attention={err_k} vs "
            f"plain softmax={err_p} ms={ms:.3f}")
        check(err_k <= 1e-4 and err_p <= 1e-4,
              f"partial_softmax_combine off by {max(err_k, err_p)}")
        out["partial_softmax_combine"] = {"ms": ms, "vs_decode": err_k,
                                          "vs_plain": err_p}
    finally:
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# the GNN family: gather_scatter (phase 1), the gnn main path, gnn parity
# ---------------------------------------------------------------------------

PRODUCTS_NODES, PRODUCTS_EDGES = 2_449_029, 61_859_140   # ogb_products
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892         # Reddit
GS_REL = 1e-5            # kernel vs plain: |delta| <= GS_REL x sum |w x|
GS_BF16_REL = 2.0 ** -8  # plus one bf16 rounding of the stored value
GNN_STEPS = 4


def power_law_edges_dev(torch, rng, n_nodes: int, n_edges: int, dev):
    """``data.sampler.power_law_edges(rng, n_nodes, n_edges)`` with the
    binary search of ``rng.choice`` run on the card: the same draws from
    ``rng`` in the same order (Pareto weights, the uniforms, then the
    destinations) and the same float64 cdf, so the same endpoints (int64 on
    ``dev``; phase 1 holds the two equal)."""
    w = rng.pareto(2.0, n_nodes) + 1.0
    cdf = (w / w.sum()).cumsum()
    cdf /= cdf[-1]
    u = torch.from_numpy(rng.random(n_edges)).to(dev)
    src = torch.searchsorted(torch.from_numpy(cdf).to(dev), u, right=True)
    del u
    dst = torch.from_numpy(rng.integers(0, n_nodes, n_edges)).to(dev)
    return src, dst


def random_graph_dev(torch, n_nodes: int, n_edges: int, d_feat: int,
                     n_classes: int, seed: int, dev):
    """``data.sampler.random_graph``'s CSRGraph, its endpoints drawn by
    ``power_law_edges_dev`` and its stable sort by destination run on the
    card (``n_edges`` need not be a multiple of the nodes; at n_nodes x
    avg_degree the arrays are random_graph's own)."""
    import numpy as np
    from repro_torch.data.sampler import CSRGraph

    rng = np.random.default_rng(seed)
    src, dst = power_law_edges_dev(torch, rng, n_nodes, n_edges, dev)
    feats = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int64)
    order = torch.sort(dst, stable=True).indices
    ptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(dst, minlength=n_nodes), 0, out=ptr[1:])
    idx = src[order].cpu().numpy()
    return CSRGraph(ptr.cpu().numpy(), idx, feats, labels)


def gs_mag(torch, x, src, dst, n, w, reduce, transposed=False):
    """Each output element's sum |w x| (over its count for the mean; for the
    gradient of x, |w| / count of the edge's destination times |g|), by the
    plain version on the card: the scale of the kernel's limit."""
    aw = None if w is None else w.abs()
    if not transposed:
        return plain_or_pieces(torch, x.abs().float(), src, dst, n, aw,
                               reduce)[0]
    cnt = torch.bincount(dst.long(), minlength=x.shape[0]).clamp(min=1)
    wb = (torch.ones_like(src, dtype=torch.float32) if aw is None else aw)
    if reduce == "mean":
        wb = wb / cnt[dst.long()]
    return plain_or_pieces(torch, x.abs().float(), dst, src, n, wb,
                           "sum")[0]


def plain_or_pieces(torch, x, src, dst, n, w, reduce, pieces: int = 8):
    """(the plain version on the card, True), or, where its [E, d] messages
    do not fit, (the same sums added piece by piece over the edges,
    False)."""
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    try:
        return gather_scatter_ref(x, src, dst, n, w, reduce), True
    except torch.cuda.OutOfMemoryError:
        pass
    torch.cuda.empty_cache()
    e = src.shape[0]
    step = -(-e // pieces)
    acc = None
    for i in range(0, e, step):
        part = gather_scatter_ref(x, src[i:i + step], dst[i:i + step], n,
                                  None if w is None else w[i:i + step], "sum")
        acc = part if acc is None else acc.add_(part)
    if reduce == "mean":
        cnt = torch.bincount(dst.long(), minlength=n).clamp(min=1)
        acc = acc / cnt.reshape((-1,) + (1,) * (acc.dim() - 1)).to(acc.dtype)
    return acc, False


def gs_case(torch, label: str, x, src, dst, n: int, w, reduce: str, *,
            backward: bool = False, cpu_bitwise: bool = False,
            timing: bool = False, hubs=None) -> dict:
    """One gather_scatter case: the kernel against the plain version on the
    card within GS_REL x each element's sum |w x| (bf16 input with no weight
    stores bf16: plus GS_BF16_REL of the value, its one rounding, against
    the plain version in float32); a planted fault, the largest-weight
    edge's term dropped, must fail that limit.  ``backward``: the gradient
    of x against the plain version's autograd (in float32 for bf16 x), or
    where its messages do not fit, against the same sums over the reversed
    edges added piece by piece, the same way.
    ``cpu_bitwise``: the float32 result against the plain version on the
    CPU, bit for bit, and the gradient against the CPU's plain sum over the
    reversed edges with the mean's per-edge weights w / max(count_dst, 1),
    bit for bit.  ``hubs`` (node of a long row by destination, node of one
    by source): the largest term of each hub row dropped must fail the
    limit, forward and backward.  ``timing``: kernel ms (3-run events and
    torch.profiler device time), the CSR's build, the plain version (where
    its messages fit), ``torch.sparse.mm`` on a CSR tensor of the same
    weights (the mean as a row scale after it), the bound and the gather
    floor; with ``backward`` the same for the gradient's launch (the
    library: ``sparse.mm`` over the CSR by source)."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref

    torch.cuda.empty_cache()
    ops = gs_ops.EdgeCSR
    e, d = src.shape[0], x[0].numel()
    csr = ops.build(src, dst, n, x.shape[0])
    got = gs_ops.gather_scatter(x, src, dst, n, w, reduce, csr)
    lowp = x.dtype == torch.bfloat16 and w is None
    xw = x.float() if lowp else x
    plain, fits = plain_or_pieces(torch, xw, src, dst, n, w, reduce)
    mag = gs_mag(torch, x, src, dst, n, w, reduce)
    lim = GS_REL * mag + (GS_BF16_REL * plain.abs() if lowp else 0.0)
    err = (got.float() - plain.float()).abs()
    ok = bool((err <= lim).all())
    out = {"max_abs_err": float(err.max()), "plain_fits": fits,
           "worst_rel_to_mag": float((err / mag.clamp(min=1e-30)).max()),
           "dtype": str(x.dtype).split(".")[1], "out_dtype":
           str(got.dtype).split(".")[1]}
    # planted fault: the term of the edge of largest |w| (first edge if
    # unweighted) dropped
    wf = (torch.ones(e, device=x.device) if w is None else w.clone())
    row_max = x.reshape(x.shape[0], -1).abs().amax(1).float()
    e0 = int(torch.argmax(wf.abs() * row_max[src.long()]))
    wf[e0] = 0.0
    bad = gs_ops.gather_scatter(x, src, dst, n, wf, reduce, csr)
    caught = not bool(((bad.float() - plain.float()).abs() <= lim).all())
    del bad, wf
    out["fault_caught"] = caught
    if hubs is not None:
        # the forward hub row's largest term dropped
        on = (dst == hubs[0]).nonzero().flatten()
        wf = (torch.ones(e, device=x.device) if w is None else w.clone())
        e0 = on[int(torch.argmax(wf[on].abs() * row_max[src[on].long()]))]
        wf[e0] = 0.0
        bad = gs_ops.gather_scatter(x, src, dst, n, wf, reduce, csr)
        out["hub_fault_caught"] = not bool(
            ((bad.float() - plain.float()).abs() <= lim).all())
        caught = caught and out["hub_fault_caught"]
        del bad, wf, on
    if cpu_bitwise:
        ref_cpu = gather_scatter_ref(x.cpu(), src.cpu(), dst.cpu(), n,
                                     None if w is None else w.cpu(), reduce)
        out["bitwise_cpu"] = bool(torch.equal(got.cpu(), ref_cpu))
        out["max_abs_err_cpu"] = float((got.cpu() - ref_cpu).abs().max())
        del ref_cpu
    del plain, mag, lim, err
    if timing:
        out["csr_build_ms"] = time_ms(torch, lambda: ops.build(
            src, dst, n, x.shape[0]))
        out["ms"] = time_ms(torch, lambda: gs_ops.gather_scatter(
            x, src, dst, n, w, reduce, csr))
        out["device_ms"] = device_ms(torch, lambda: gs_ops.gather_scatter(
            x, src, dst, n, w, reduce, csr), runs=5)
        out["plain_ms"] = None
        if fits:
            torch.cuda.empty_cache()
            try:
                out["plain_ms"] = time_ms(torch, lambda: gather_scatter_ref(
                    x, src, dst, n, w, reduce))
            except torch.cuda.OutOfMemoryError:
                out["plain_note"] = "timing the plain version ran out of memory"
            torch.cuda.empty_cache()
        x2 = x.reshape(x.shape[0], -1).float()
        vals = (torch.ones(e, device=x.device) if w is None
                else w.float()[csr.rows.perm])
        a = torch.sparse_csr_tensor(csr.rows.ptr, csr.rows.col.long(), vals,
                                    size=(n, x.shape[0]))
        scale = (1.0 / csr.count.clamp(min=1.0))[:, None]

        def library():
            y = torch.sparse.mm(a, x2)
            return y * scale if reduce == "mean" else y

        out["library_ms"] = time_ms(torch, library)
        del a, vals, x2
        xb = x.element_size()
        wk = gs_ops.work(x.shape[0], n, d, e, xb, got.element_size(),
                         weighted=w is not None, ptr_rows=n,
                         mean=reduce == "mean")
        n_bytes = wk[1]
        out["bound_ms"], out["bound_by"] = bound(wk)
        out["gather_floor_ms"] = hbm_ms(n_bytes + e * d * xb
                                        - x.shape[0] * d * xb)
        out["n_bytes"] = n_bytes
    if backward:
        # against the plain version's autograd (in float32 for bf16 x,
        # whose plain backward rounds at every add), or, where its [E, d]
        # messages do not fit, against the same sums over the reversed
        # edges added piece by piece
        xg = (x.float() if lowp else x).detach().requires_grad_()
        # the cotangent in the output's type, the same values for both
        g = torch.randn(got.shape, device=x.device, dtype=torch.float32,
                        generator=torch.Generator(device=x.device)
                        .manual_seed(e)).to(got.dtype).float()
        xk = x.detach().requires_grad_()
        (dk,) = torch.autograd.grad(
            gs_ops.gather_scatter(xk, src, dst, n, w, reduce, csr), xk,
            g.to(got.dtype))
        try:
            (dp,) = torch.autograd.grad(
                gather_scatter_ref(xg, src, dst, n, w, reduce), xg, g)
            out["bwd_plain"] = "autograd"
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            cnt = torch.bincount(dst.long(), minlength=n).clamp(min=1)
            wb = torch.ones(e, device=x.device) if w is None else w.float()
            if reduce == "mean":
                wb = wb / cnt[dst.long()]
            dp = plain_or_pieces(torch, g, dst, src, x.shape[0], wb,
                                 "sum")[0].reshape(dk.shape)
            out["bwd_plain"] = "reversed edges, in pieces"
        bmag = gs_mag(torch, g, src, dst, x.shape[0], w, reduce,
                      transposed=True).reshape(dk.shape)
        blim = GS_REL * bmag + (GS_BF16_REL * dp.abs() if lowp else 0.0)
        berr = (dk.float() - dp.float()).abs()
        out["bwd_max_abs_err"] = float(berr.max())
        out["bwd_ok"] = bool((berr <= blim).all())
        ok = ok and out["bwd_ok"]
        if cpu_bitwise:
            # the CPU's plain sum over the reversed edges, in edge order
            dc, sc = dst.cpu(), src.cpu()
            wb = (torch.ones(e) if w is None else w.float().cpu())
            if reduce == "mean":
                cnt = torch.bincount(dc.long(), minlength=n).float()
                wb = wb / cnt.clamp(min=1.0)[dc.long()]
            want = gather_scatter_ref(g.to(got.dtype).cpu().reshape(
                g.shape[0], -1), dc, sc, x.shape[0], wb, "sum")
            out["bwd_bitwise_cpu"] = bool(torch.equal(
                dk.cpu().reshape(want.shape), want))
            del want, wb
        if hubs is not None:
            # the backward hub row's largest term dropped
            on = (src == hubs[1]).nonzero().flatten()
            wf = (torch.ones(e, device=x.device) if w is None else w.clone())
            g_max = g.reshape(g.shape[0], -1).abs().amax(1)
            e0 = on[int(torch.argmax(wf[on].abs() * g_max[dst[on].long()]))]
            wf[e0] = 0.0
            (df,) = torch.autograd.grad(
                gs_ops.gather_scatter(xk, src, dst, n, wf, reduce, csr), xk,
                g.to(got.dtype))
            out["bwd_hub_fault_caught"] = not bool(
                ((df.float() - dp.float()).abs() <= blim).all())
            caught = caught and out["bwd_hub_fault_caught"]
            del df, wf, on
        del dp, bmag, berr, blim, xg, xk, dk
        if timing:
            rows_t = csr.transposed()
            gw = None if w is None else w.float()[rows_t.perm]
            scale = csr.count if reduce == "mean" else None
            g2 = g.to(got.dtype).reshape(g.shape[0], -1).contiguous()
            out["bwd_ms"] = time_ms(torch, lambda: gs_ops.launch(
                g2, rows_t, gw, False, x.dtype, scale=scale))
            # the library: sparse.mm over the CSR by source, the weights
            # already divided
            vals = torch.ones(e, device=x.device) if gw is None else gw
            if reduce == "mean":
                vals = vals / csr.count.clamp(min=1.0)[rows_t.col.long()]
            at = torch.sparse_csr_tensor(rows_t.ptr, rows_t.col.long(), vals,
                                         size=(x.shape[0], n))
            g32 = g2.float()
            out["bwd_library_ms"] = time_ms(torch, lambda: torch.sparse.mm(
                at, g32))
            out["bwd_bound_ms"] = out["bound_ms"]
            out["bwd_gather_floor_ms"] = out["gather_floor_ms"]
            del g2, gw, at, vals, g32
        del g
    del got, csr
    log(f"[kernels] gather_scatter {label} N={n} E={e} d={d} {reduce} "
        f"{out['dtype']}->{out['out_dtype']}"
        f"{' weighted' if w is not None else ''}: "
        + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in out.items() if k not in ("dtype",
                                                        "out_dtype")))
    check(ok, f"gather_scatter {label} {reduce} past its limit")
    check(caught, f"gather_scatter {label}: a planted fault was not caught")
    if cpu_bitwise:
        check(out["bitwise_cpu"],
              f"gather_scatter {label} differs from the CPU's plain version")
        if backward:
            check(out["bwd_bitwise_cpu"],
                  f"gather_scatter {label}: the gradient differs from the "
                  f"CPU's plain sum over the reversed edges")
    torch.cuda.empty_cache()
    return out


def kernel_gather_scatter(torch, dev):
    """gather_scatter at the GNN paths' shapes: ogb_products' two GraphSAGE
    layers (2,449,029 nodes, 61,859,328 edges: the 61,859,140 of
    ``power_law_edges`` plus 188 padding edges of weight 0; d = 100 and
    128, float32, sum with random weights and mean with the mask), the
    backward at d = 128; E = 1,000,000 at d = 128 with a hub row of 60,000
    edges each way, forward and backward bit for bit against the CPU; the
    minibatch block (169,984 nodes, 168,960 edges, d = 602 and
    128, mean, backward) also in bf16; Cora (2,708 nodes, 10,752 edges of
    which 196 masked, eight rows without an edge, d = 16, 7 and 1,433)."""
    import numpy as np
    from repro_torch.data.sampler import power_law_edges
    from repro_torch.models.gnn.common import sym_norm_coeff

    rng = np.random.default_rng(31)
    # the card's search gives the sampler's own endpoints
    a = power_law_edges(np.random.default_rng(5), 5000, 200_000)
    b = power_law_edges_dev(torch, np.random.default_rng(5), 5000, 200_000,
                            dev)
    check(all(np.array_equal(x, y.cpu().numpy()) for x, y in zip(a, b)),
          "power_law_edges_dev differs from data.sampler.power_law_edges")
    cases = {}
    gen = torch.Generator(device=dev).manual_seed(32)

    def edges(n, e_real, e_pad, empty=0, power=True):
        if power:
            s, t = power_law_edges_dev(torch, rng, n, e_real, dev)
        else:
            s = torch.from_numpy(rng.integers(0, n, e_real)).to(dev)
            t = torch.from_numpy(rng.integers(0, n - empty, e_real)).to(dev)
        pad = torch.zeros(e_pad, dtype=torch.int64, device=dev)
        mask = torch.cat([torch.ones(e_real, device=dev),
                          torch.zeros(e_pad, device=dev)])
        return (torch.cat([s, pad]).to(torch.int32),
                torch.cat([t, pad]).to(torch.int32), mask)

    # ogb_products' layers
    n = PRODUCTS_NODES
    src, dst, mask = edges(n, PRODUCTS_EDGES, 188)
    wts = torch.randn(src.shape[0], device=dev, generator=gen) * mask
    for d in (100, 128):
        x = torch.randn(n, d, device=dev, generator=gen)
        cases[f"products d={d} sum"] = gs_case(
            torch, "ogb_products", x, src, dst, n, wts, "sum", timing=True)
        cases[f"products d={d} mean"] = gs_case(
            torch, "ogb_products", x, src, dst, n, mask, "mean",
            timing=True, backward=(d == 128))
        del x
    del src, dst, mask, wts
    torch.cuda.empty_cache()
    # bit for bit against the CPU, forward and backward, with a planted hub
    # row of 60,000 edges each way (node 7's in-edges, node 11's out-edges),
    # past LONG_ROW: split by columns
    n = 100_000
    src, dst, mask = edges(n, 1_000_000, 0)
    hub = torch.randperm(src.shape[0], device=dev, generator=gen)[:120_000]
    dst[hub[:60_000]], src[hub[60_000:]] = 7, 11
    x = torch.randn(n, 128, device=dev, generator=gen)
    wts = torch.randn(src.shape[0], device=dev, generator=gen)
    cases["E=1M d=128 sum"] = gs_case(torch, "E=1M", x, src, dst, n, wts,
                                      "sum", cpu_bitwise=True, backward=True,
                                      hubs=(7, 11))
    cases["E=1M d=128 mean"] = gs_case(torch, "E=1M", x, src, dst, n, mask,
                                       "mean", cpu_bitwise=True,
                                       backward=True, hubs=(7, 11))
    # the minibatch block
    n = 169_984
    src, dst, mask = edges(n, 168_960, 0, power=False)
    for d in (602, 128):
        x = torch.randn(n, d, device=dev, generator=gen)
        cases[f"block d={d} mean"] = gs_case(
            torch, "block", x, src, dst, n, mask, "mean", backward=True,
            timing=True)
        if d == 128:
            xb = x.to(torch.bfloat16)
            cases["block d=128 bf16 sum"] = gs_case(
                torch, "block", xb, src, dst, n, None, "sum", backward=True)
            cases["block d=128 bf16 mean"] = gs_case(
                torch, "block", xb, src, dst, n, mask, "mean")
    # Cora, eight rows with no edge, the padding masked
    n = 2708
    src, dst, mask = edges(n, 10_556, 196, empty=8, power=False)
    coeff = sym_norm_coeff(src, dst, n, mask) * mask
    for d, w, reduce in ((16, coeff, "sum"), (7, coeff, "sum"),
                         (1433, mask, "mean")):
        x = torch.randn(n, d, device=dev, generator=gen)
        cases[f"cora d={d} {reduce}"] = gs_case(
            torch, "cora", x, src, dst, n, w, reduce, backward=True,
            timing=(d == 1433))
    main = cases["products d=128 mean"]
    worst = max(c["max_abs_err"] for k, c in cases.items()
                if c["dtype"] == "float32")
    return dict(main, max_abs_err=worst,
                shape="N=2,449,029 E=61,859,328 d=128 mean float32",
                cases=cases)


def gnn_run(torch, label: str, spec, cell, batches, prof=None,
            chunk_note: str = "") -> dict:
    """GNN_STEPS ``gnn_train_step``s of ``spec``'s model, sized for
    ``cell``, its weights drawn on the card from a seeded generator, on
    ``batches`` (one a step, each a callable giving a ``gnn_batch`` and
    the seconds it took to make): loss (finite), grad norm, step ms,
    edges/s (the batch's real edges a step), peak memory."""
    import gc

    from repro_torch.launch.gnn_steps import gnn_model, gnn_train_step
    from repro_torch.training.optimizer import init_opt_state

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    model = gnn_model(spec, cell, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    opt = init_opt_state(dict(model.named_parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    steps = []
    batch = None
    for step in range(GNN_STEPS):
        batch, make_s = batches(step)
        real = int(batch["edge_mask"].sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, met = gnn_train_step(model, opt, batch, cell)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        row = {k: float(v) for k, v in met.items()}
        row.update(ms=ms, edges_per_s=real / ms * 1e3, batch_s=make_s)
        steps.append(row)
        log(f"[gnn] {label} step {step}: loss={row['loss']:.6f} grad_norm="
            f"{row['grad_norm']:.6f} step_ms={ms:.1f} edges_per_s="
            f"{row['edges_per_s']:.4g} (batch made in {make_s:.2f}s)")
        check(all(math.isfinite(row[k]) for k in ("loss", "grad_norm")),
              f"{label} step {step}: loss or grad norm not finite")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[gnn] {label}: {spec.name} {cell.n_nodes} nodes {cell.n_edges} "
        f"edges d_feat={cell.d_feat} feats {batch['feats'].dtype} "
        f"n_out={cell.n_out}{chunk_note}: {n_params} parameters; peak "
        f"device memory {peak:.2f} GB")
    if prof is not None:
        prof(f"gnn step {label}",
             lambda: gnn_train_step(model, opt, batch, cell))
    del model, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "peak_gb": peak, "n_params": n_params,
            "nodes": cell.n_nodes, "edges": cell.n_edges}


def molecule_arrays(cell, seed: int):
    """A molecule batch: cell.n_graphs graphs of equal size, each's edges
    drawn within it, positions 1.5-scaled normals, 100 random features and
    one target a graph."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = cell.n_graphs
    per_n, per_e = cell.n_nodes // g, cell.n_edges // g
    off = np.repeat(np.arange(g) * per_n, per_e)
    return {"feats": rng.standard_normal((cell.n_nodes, cell.d_feat)
                                         ).astype(np.float32),
            "pos": (1.5 * rng.standard_normal((cell.n_nodes, 3))
                    ).astype(np.float32),
            "src": (off + rng.integers(0, per_n, g * per_e)).astype(np.int32),
            "dst": (off + rng.integers(0, per_n, g * per_e)).astype(np.int32),
            "graph_ids": np.repeat(np.arange(g), per_n).astype(np.int32),
            "target": rng.standard_normal(g).astype(np.float32)}


def products_batch(torch, cell, dev):
    """ogb_products' full graph as a ``gnn_batch`` on ``dev``: power-law
    edges made on the card, seeded normal features, seeded labels ->
    (batch, seconds to make it)."""
    import numpy as np
    from repro_torch.launch.gnn_steps import gnn_batch

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    src, dst = power_law_edges_dev(torch, rng, PRODUCTS_NODES,
                                   PRODUCTS_EDGES, dev)
    feats = rng.standard_normal((PRODUCTS_NODES, cell.d_feat),
                                dtype=np.float32)
    labels = rng.integers(0, cell.n_out, PRODUCTS_NODES).astype(np.int32)
    batch = gnn_batch(cell, {"feats": feats, "src": src, "dst": dst,
                             "labels": labels}, dev)
    del src, dst, feats, labels
    torch.cuda.synchronize()
    return batch, time.perf_counter() - t0


def phase_gnn(torch, prof=None):
    """The GNN family trains on the card through ``gnn_train_step``:
    gnn-products (graphsage-reddit at full width on ogb_products' full
    graph, features in bf16), gnn-reddit-minibatch (graphsage-reddit on
    NeighborSampler blocks of a Reddit-sized power-law graph, fanout
    (15, 10), 1,024 seeds) and gnn-small (gcn-cora, gat-bonus, gin-bonus
    on full_graph_sm; schnet and equiformer-v2 on molecule), each
    GNN_STEPS steps."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.launch.gnn_steps import cell_of, gnn_batch

    dev = torch.device("cuda")
    out = {}
    spec = get_arch("graphsage-reddit")

    # gnn-products: the full graph, made once
    cell = cell_of(spec, spec.shapes["ogb_products"])
    batch, made = products_batch(torch, cell, dev)
    log(f"[gnn] gnn-products graph ({PRODUCTS_NODES} nodes, "
        f"{PRODUCTS_EDGES} edges, {cell.d_feat} features) made in "
        f"{made:.1f}s")
    out["gnn-products"] = gnn_run(torch, "gnn-products", spec, cell,
                                  lambda step: (batch, 0.0), prof)
    out["gnn-products"]["graph_s"] = made
    del batch

    # gnn-reddit-minibatch: a Reddit-sized graph, sampled blocks a step
    cell = cell_of(spec, spec.shapes["minibatch_lg"])
    t0 = time.perf_counter()
    graph = random_graph_dev(torch, REDDIT_NODES, REDDIT_EDGES, cell.d_feat,
                             cell.n_out, 0, dev)
    made = time.perf_counter() - t0
    log(f"[gnn] gnn-reddit-minibatch graph ({REDDIT_NODES} nodes, "
        f"{len(graph.idx)} edges, {cell.d_feat} features) made in "
        f"{made:.1f}s")
    sampler = NeighborSampler(graph, fanout=(15, 10), seed=0)
    blocks = sampler.batches(cell.seeds, GNN_STEPS)

    def block(step):
        t = time.perf_counter()
        b = gnn_batch(cell, next(blocks), dev)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t

    out["gnn-reddit-minibatch"] = gnn_run(torch, "gnn-reddit-minibatch",
                                          spec, cell, block)
    out["gnn-reddit-minibatch"]["graph_s"] = made
    del graph, sampler

    # gnn-small
    for name in ("gcn-cora", "gat-bonus", "gin-bonus"):
        sp = get_arch(name)
        cell = cell_of(sp, sp.shapes["full_graph_sm"])
        rng = np.random.default_rng(1)
        shape = sp.shapes["full_graph_sm"]
        s, t = power_law_edges_dev(torch, rng, shape.n_nodes, shape.n_edges,
                                   dev)
        b = gnn_batch(cell, {
            "feats": rng.standard_normal((shape.n_nodes, shape.d_feat),
                                         dtype=np.float32),
            "src": s, "dst": t,
            "labels": rng.integers(0, cell.n_out, shape.n_nodes)}, dev)
        out[name] = gnn_run(torch, f"gnn-small {name}", sp, cell,
                            lambda step: (b, 0.0))
    for name in ("schnet", "equiformer-v2"):
        sp = get_arch(name)
        cell = cell_of(sp, sp.shapes["molecule"])
        b = gnn_batch(cell, molecule_arrays(cell, 2), dev)
        out[name] = gnn_run(torch, f"gnn-small {name}", sp, cell,
                            lambda step: (b, 0.0))
    return out


GNN_PARITY = {
    "gcn-cora": {}, "graphsage-reddit": {}, "gin-bonus": {},
    "gat-bonus": dict(n_heads=2, d_hidden=8),
    "schnet": dict(n_rbf=32),
    "equiformer-v2": dict(l_max=2, m_max=1, n_heads=2, n_rbf=8),
}


def phase_gnn_parity(torch):
    """Each GNN architecture cut to 2 layers (d_hidden 16 unless set in
    GNN_PARITY), float32, the same weights on the card and the CPU, on a
    300-node graph of 1,536 edges (some masked, some nodes with none):
    logits, loss and every gradient, and every parameter after one
    ``gnn_train_step``, card against CPU within 1e-4 (sums in another
    order; GAT, SchNet and Equiformer add with atomics on the card).  Then
    Equiformer's chunked path against its flat path on the card, values
    and gradients within 1e-4."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch.gnn_steps import (GNNCell, gnn_batch, gnn_loss,
                                              gnn_model, gnn_train_step)
    from repro_torch.training.optimizer import gradients, init_opt_state

    dev = torch.device("cuda")
    rng = np.random.default_rng(40)
    n, e, d = 300, 1536, 24
    arrays = {"feats": rng.standard_normal((n, d)).astype(np.float32),
              "pos": (1.5 * rng.standard_normal((n, 3))).astype(np.float32),
              "src": rng.integers(0, n, e).astype(np.int32),
              "dst": rng.integers(0, n - 5, e).astype(np.int32),
              "edge_mask": rng.random(e) > 0.1,
              "labels": rng.integers(-1, 7, n).astype(np.int32)}
    cell = GNNCell(n_nodes=n, n_edges=e, d_feat=d, n_out=7, needs_pos=True,
                   shard_nodes=False, channel_shard=False, chunk=None)
    out = {}
    for name, over in GNN_PARITY.items():
        spec = get_arch(name)
        spec = dataclasses.replace(spec, model=dataclasses.replace(
            spec.model, **dict(dict(n_layers=2, d_hidden=16), **over)))
        card = gnn_model(spec, cell, device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(41))
        cpu = gnn_model(spec, cell, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        res = []
        for model, where in ((card, dev), (cpu, "cpu")):
            batch = gnn_batch(cell, arrays, where)
            loss, _ = gnn_loss(model, batch, cell)
            params = dict(model.named_parameters())
            grads = gradients(loss, params)
            logits = model(batch["feats"], batch["pos"], batch["src"],
                           batch["dst"], batch["edge_mask"].float(), n)
            opt = init_opt_state(params)
            _, met = gnn_train_step(model, opt, batch, cell)
            res.append((logits.detach().cpu(), float(loss.detach()),
                        {k: g.cpu() for k, g in grads.items()},
                        float(met["loss"]),
                        {k: p.detach().cpu() for k, p in params.items()}))
        errs = {"logits": float((res[0][0] - res[1][0]).abs().max()),
                "loss": max(abs(res[0][1] - res[1][1]),
                            abs(res[0][3] - res[1][3])),
                "grads": max(float((res[0][2][k] - res[1][2][k]).abs().max())
                             for k in res[0][2]),
                "params": max(float((res[0][4][k] - res[1][4][k]).abs().max())
                              for k in res[0][4])}
        log(f"[gnn parity] 2-layer float32 {name} card vs cpu: "
            + " ".join(f"{k} max_abs_err={v:.3g}" for k, v in errs.items()))
        check(max(errs.values()) <= 1e-4,
              f"gnn parity {name} off by {max(errs.values())}")
        out[name] = errs
    # Equiformer: the chunked autograd.Function against the flat path
    spec = get_arch("equiformer-v2")
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, n_layers=4, d_hidden=16, **GNN_PARITY["equiformer-v2"]))
    model = gnn_model(spec, cell, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(42))
    batch = gnn_batch(cell, arrays, dev)
    res = []
    for chunk in (None, 256):
        model.zero_grad()
        lg = model(batch["feats"], batch["pos"], batch["src"], batch["dst"],
                   batch["edge_mask"].float(), n, chunk=chunk)
        lg.square().mean().backward()
        res.append((lg.detach(), {k: p.grad.clone()
                                  for k, p in model.named_parameters()}))
    err_v = float((res[0][0] - res[1][0]).abs().max())
    err_g = max(float((res[0][1][k] - res[1][1][k]).abs().max())
                for k in res[0][1])
    log(f"[gnn parity] equiformer 4 layers, chunks of 256 (grouped remat) "
        f"vs flat on the card: values max_abs_err={err_v:.3g} gradients "
        f"max_abs_err={err_g:.3g}")
    check(max(err_v, err_g) <= 1e-4,
          f"equiformer chunked vs flat off by {max(err_v, err_g)}")
    out["equiformer_chunked"] = {"values": err_v, "grads": err_g}
    return out


# ---------------------------------------------------------------------------
# the recsys family: the embedding bag and retrieval (phase 1), the recsys
# main path, recsys parity
# ---------------------------------------------------------------------------

RECSYS_ARCH = "autoint"
RECSYS_STEPS = 4
# each field's ids: a Zipf law over its ranks.  A stand-in with no public
# measurement behind its exponent (the reference has no recsys data
# generator): what its skew shows (hub rows, rows touched) is provisional
ZIPF_S = 1.05
# the p99 of this many requests rests on the slowest 10
SERVE_P99_REQUESTS = 1000
RETRIEVAL_K = 100
RETRIEVAL_REL = 1e-5     # retrieval vs plain: |delta| <= this x max score


def zipf_law(torch, rng, f: int, v: int, dev):
    """(cdf [V] float64, perm [F, V] int64), both on ``dev``: a Zipf law
    with exponent ZIPF_S over ranks 1..V, and each field's seeded map from
    rank to id (``rng``'s permutations, one a field)."""
    import numpy as np
    w = np.arange(1, v + 1, dtype=np.float64) ** -ZIPF_S
    cdf = np.cumsum(w / w.sum())
    cdf /= cdf[-1]
    perm = np.stack([rng.permutation(v) for _ in range(f)])
    return torch.from_numpy(cdf).to(dev), torch.from_numpy(perm).to(dev)


def recsys_ids(torch, rng, b: int, f: int, h: int, v: int, dev, zipf=None):
    """[b, f, h] int32 ids on ``dev``: uniform over each field's V rows, or,
    with ``zipf`` (``zipf_law``'s), ``rng``'s float64 uniforms turned into
    ranks by inverse CDF on the card (as ``power_law_edges_dev`` draws)
    and mapped to ids through each field's permutation."""
    import numpy as np
    if zipf is None:
        return torch.from_numpy(rng.integers(0, v, (b, f, h),
                                             dtype=np.int32)).to(dev)
    cdf, perm = zipf
    u = torch.from_numpy(rng.random((b, f, h))).to(dev)
    rank = torch.searchsorted(cdf, u, right=True).clamp_(max=v - 1)
    del u
    fld = torch.arange(f, device=dev)[None, :, None]
    return perm[fld, rank].to(torch.int32)


def bag_case(torch, label: str, table, ids, timing: bool = False) -> dict:
    """One embedding bag at train_batch's shape, the mean of ``table`` [F,
    V, D] float32 over ids [B, F, H], through ``embedding_bag_dense`` (the
    ``gather_scatter`` kernel over ``EdgeCSR.regular``), forward and the
    tables' gradient: against the plain version on the card within GS_REL
    x each element's sum |x| / H (the gradient: x each row's sum |g| / H),
    and bit for bit against the CPU's plain version (the gradient against
    the CPU's plain sum over the reversed edges).  Planted faults must fail
    the limits: the table row of the most frequent id zeroed (forward),
    the cotangent of one of its bags zeroed (gradient).  ``timing``: the
    wrapper (its CSR included) and the kernel, forward and gradient (the
    kernel's device time three times: the spread within a call), the CSR
    built with no sort (``EdgeCSR.regular``) and by the stable sort
    (``EdgeCSR.build``, its dst made as a bag's would be) alternately, the
    CSR by source's build, the plain version, ``F.embedding_bag(mode=
    "mean")`` forward (events and device) and forward + backward, and the
    bounds, bytes the function must move: forward, each table row these
    ids touch read once (U d 4), the ids (4 E) and the bags written (n d
    4); gradient, the cotangent read (n d 4), the ids, and the dense
    gradient of the tables written (F V d 4).  The gather floor, every id's
    row read (E d 4 + n d 4 + 8 E; the gradient's + F V d 4), is kept
    beside it as ``gather_floor_ms``."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    from repro_torch.models.recsys.embedding_bag import embedding_bag_dense

    torch.cuda.empty_cache()
    f, v, d = table.shape
    b, _, h = ids.shape
    dev = table.device
    n, e, n_x = b * f, ids.numel(), f * v
    x = table.reshape(n_x, d)
    src = (ids.long() + torch.arange(f, device=dev)[None, :, None] * v
           ).reshape(-1)
    dst = torch.arange(n, device=dev).repeat_interleave(h)
    counts = torch.bincount(src, minlength=n_x)
    hub = int(torch.argmax(counts))
    out = {"hub_edges": int(counts[hub]),
           "rows_past_64": int((counts >= 64).sum()),
           "rows_touched": int((counts > 0).sum())}
    del counts
    got = embedding_bag_dense(table, ids, "mean").reshape(n, d)
    plain = gather_scatter_ref(x, src, dst, n, None, "mean")
    lim = GS_REL * gather_scatter_ref(x.abs(), src, dst, n, None, "mean")
    err = (got - plain).abs()
    ok = bool((err <= lim).all())
    out["max_abs_err"] = float(err.max())
    cpu = gather_scatter_ref(x.cpu(), src.cpu(), dst.cpu(), n, None, "mean")
    out["bitwise_cpu"] = bool(torch.equal(got.cpu(), cpu))
    del cpu, err
    # planted fault: the most frequent id's table row zeroed
    saved = x[hub].clone()
    x[hub] = 0.0
    bad = embedding_bag_dense(table, ids, "mean").reshape(n, d)
    x[hub] = saved
    out["fault_caught"] = not bool(((bad - plain).abs() <= lim).all())
    del bad, plain, lim
    # the gradient: the kernel over the CSR by source, the mean's 1 / H in
    # the kernel, against the plain version's autograd on the card
    g = torch.randn((b, f, d), device=dev, generator=torch.Generator(
        device=dev).manual_seed(e))
    tg = table.detach().requires_grad_()
    (dk,) = torch.autograd.grad(embedding_bag_dense(tg, ids, "mean"), tg, g)
    dk = dk.reshape(n_x, d)
    xg = x.detach().requires_grad_()
    g2 = g.reshape(n, d)
    (dp,) = torch.autograd.grad(gather_scatter_ref(xg, src, dst, n, None,
                                                   "mean"), xg, g2)
    wq = torch.full((e,), 1.0 / h, device=dev)
    blim = GS_REL * gather_scatter_ref(g2.abs(), dst, src, n_x, wq, "sum")
    berr = (dk - dp).abs()
    bwd_ok = bool((berr <= blim).all())
    out["bwd_max_abs_err"] = float(berr.max())
    del berr
    want = gather_scatter_ref(g2.cpu(), dst.cpu(), src.cpu(), n_x, wq.cpu(),
                              "sum")
    out["bwd_bitwise_cpu"] = bool(torch.equal(dk.cpu(), want))
    del want, dk
    # planted fault: the cotangent of the hub's first bag zeroed
    gf = g2.clone()
    gf[int(dst[int((src == hub).nonzero()[0])])] = 0.0
    (df,) = torch.autograd.grad(embedding_bag_dense(tg, ids, "mean"), tg,
                                gf.reshape(b, f, d))
    out["bwd_fault_caught"] = not bool(
        ((df.reshape(n_x, d) - dp).abs() <= blim).all())
    del df, gf, dp, blim, xg
    if timing:
        csr = gs_ops.EdgeCSR.regular(src.to(torch.int32), h, n_x)
        rows_t = csr.transposed()
        out["n_long_by_source"] = int(rows_t.n_long)
        out["long_min_by_source"] = rows_t.long_min
        src32 = src.to(torch.int32)

        def sorted_csr():
            dst32 = torch.arange(n, dtype=torch.int32,
                                 device=dev).repeat_interleave(h)
            return gs_ops.EdgeCSR.build(src32, dst32, n, n_x)

        out["csr_regular_ms"], out["csr_sorted_ms"] = [], []
        for _ in range(3):
            out["csr_regular_ms"].append(time_ms(
                torch, lambda: gs_ops.EdgeCSR.regular(src32, h, n_x)))
            out["csr_sorted_ms"].append(time_ms(torch, sorted_csr))
        del src32
        out["ms"] = time_ms(torch, lambda: embedding_bag_dense(table, ids,
                                                               "mean"))
        out["kernel_device_ms"] = [device_ms(torch, lambda: gs_ops.launch(
            x, csr.rows, None, True, torch.float32)) for _ in range(3)]
        out["fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            embedding_bag_dense(tg, ids, "mean"), tg, g))
        out["csr_by_source_ms"] = time_ms(torch, lambda: gs_ops.RowCSR.build(
            csr.src, csr.dst, n_x))
        out["bwd_kernel_device_ms"] = [device_ms(
            torch, lambda: gs_ops.launch(g2, rows_t, None, False,
                                         torch.float32, scale=csr.count),
            runs=5) for _ in range(3)]
        out["plain_ms"] = time_ms(torch, lambda: gather_scatter_ref(
            x, src, dst, n, None, "mean"))
        bags = src.reshape(n, h)
        w = table.detach().reshape(n_x, d).requires_grad_()
        out["library_ms"] = time_ms(torch, lambda: torch.nn.functional
                                    .embedding_bag(bags, x, mode="mean"))
        out["library_device_ms"] = device_ms(
            torch, lambda: torch.nn.functional.embedding_bag(bags, x,
                                                             mode="mean"))
        out["library_fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            torch.nn.functional.embedding_bag(bags, w, mode="mean"), w, g2))
        # the rows the ids touch read once; the gradient writes every row
        # of the dense dx
        out["bound_ms"], out["bound_by"] = bound(gs_ops.work(
            out["rows_touched"], n, d, e, 4, 4, weighted=False, ptr_rows=0,
            mean=True))
        out["bwd_bound_ms"], out["bwd_bound_by"] = bound(gs_ops.work(
            n, n_x, d, e, 4, 4, weighted=False, ptr_rows=0))
        floor = e * d * 4 + n * d * 4 + 8 * e
        out["gather_floor_ms"] = hbm_ms(floor)
        out["bwd_gather_floor_ms"] = hbm_ms(floor + n_x * d * 4)
        del csr, rows_t, bags, w
    del g, g2, tg, wq
    log(f"[kernels] gather_scatter bag {label} B={b} F={f} H={h} V={v} "
        f"d={d} mean float32: " + " ".join(
            f"{k}={val:.4f}" if isinstance(val, float) else f"{k}={val}"
            for k, val in out.items()))
    check(ok, f"embedding bag {label} past its limit")
    check(bwd_ok, f"embedding bag {label}: the gradient past its limit")
    check(out["bitwise_cpu"] and out["bwd_bitwise_cpu"],
          f"embedding bag {label} differs from the CPU's plain version")
    check(out["fault_caught"] and out["bwd_fault_caught"],
          f"embedding bag {label}: a planted fault was not caught")
    torch.cuda.empty_cache()
    return out


def retrieval_case(torch, dev) -> dict:
    """ivf_scan at the retrieval shape: one query of d = 1,248 (39 fields x
    32) against 1,000,000 candidates, ip, k = 100, integer-valued (exact
    sums; the second half repeats the first: ties to the lower row): ids
    equal to plain, values exact.  Times the wrapper, its scoring,
    selection and sort, plain, the library yardstick (``torch.mv`` + a
    stable top-k) and ``torch.mv`` + ``ivf_select`` + ``sort_survivors``;
    the bound is bytes (the candidates read once)."""
    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
    from repro_torch.kernels.topk import sort_survivors, stable_topk

    spec = recsys_spec()
    n = spec.shapes["retrieval_cand"].n_candidates
    d = spec.model.n_sparse * spec.model.d_attn
    k = RETRIEVAL_K
    gen = torch.Generator(device=dev).manual_seed(55)
    cands = torch.empty((n, d), device=dev)
    cands[:n // 2] = torch.randint(-3, 4, (n // 2, d), device=dev,
                                   generator=gen, dtype=torch.int8).float()
    cands[n // 2:] = cands[:n - n // 2]
    q = torch.randint(-3, 4, (1, d), device=dev, generator=gen).float()
    kv, ki = ivf_ops.ivf_scan_topk(q, cands, k, "ip")
    pv, pi = ivf_scan_topk_ref(q, cands, k, "ip")
    same = bool(torch.equal(ki, pi))
    err = float((kv - pv).abs().max())
    out = {"ids_equal": same, "max_abs_err": err,
           "ms": time_ms(torch, lambda: ivf_ops.ivf_scan_topk(q, cands, k,
                                                              "ip")),
           "device_ms": device_ms(torch, lambda: ivf_ops.ivf_scan_topk(
               q, cands, k, "ip"), runs=5)}
    scores = ivf_ops.ivf_scores(q, cands, False)
    sv, si = ivf_ops.ivf_select(scores, n, k)
    out["score_ms"] = time_ms(torch, lambda: ivf_ops.ivf_scores(q, cands,
                                                                False))
    out["select_ms"] = time_ms(torch, lambda: ivf_ops.ivf_select(scores, n,
                                                                 k))
    out["sort_ms"] = time_ms(torch, lambda: sort_survivors(sv, si, k))
    del scores, sv, si
    out["plain_ms"] = time_ms(torch, lambda: ivf_scan_topk_ref(q, cands, k,
                                                               "ip"))
    out["library_ms"] = time_ms(torch, lambda: stable_topk(
        torch.mv(cands, q[0])[None], k))

    def mv_select():
        s = torch.mv(cands, q[0])[None]
        return sort_survivors(*ivf_ops.ivf_select(s, n, k), k)

    out["mv_select_sort_ms"] = time_ms(torch, mv_select)
    out["bound_ms"], out["bound_by"] = bound(ivf_ops.work(q, cands, k))
    del cands
    torch.cuda.empty_cache()
    log(f"[kernels] ivf_scan retrieval Q=1 N={n} d={d} k={k} ip: " + " ".join(
        f"{key}={val:.4f}" if isinstance(val, float) else f"{key}={val}"
        for key, val in out.items()))
    check(same, "ivf_scan ids differ at the retrieval shape")
    check(err == 0.0, f"ivf_scan max|delta| {err} at the retrieval shape")
    return out


def recsys_spec():
    from repro_torch.configs import get_arch
    return get_arch(RECSYS_ARCH)


def kernel_recsys(torch, dev) -> dict:
    """The recsys path's kernel shapes: the embedding bag at train_batch
    (65,536 x 39 x 4 ids over 39 tables of 1,000,000 x 16 float32; E =
    10,223,616 into 2,555,904 bags) with uniform and with Zipf ids, forward
    and gradient (``bag_case``); ivf_scan at retrieval (``retrieval_case``)."""
    import numpy as np
    cfg = recsys_spec().model
    f, v, d, h = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim, \
        cfg.multi_hot
    b = recsys_spec().shapes["train_batch"].batch
    rng = np.random.default_rng(51)
    table = torch.randn((f, v, d), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(50))
    zipf = zipf_law(torch, rng, f, v, dev)
    bags = {}
    for label, law in (("uniform", None), ("zipf", zipf)):
        ids = recsys_ids(torch, rng, b, f, h, v, dev, law)
        bags[f"bag {label} B={b} F={f} H={h} d={d} mean"] = bag_case(
            torch, label, table, ids, timing=True)
        del ids
    del table, zipf
    torch.cuda.empty_cache()
    return {"bags": bags, "retrieval": retrieval_case(torch, dev)}


def phase_recsys(torch, prof=None):
    """autoint at full size, no cut: the model (39 tables of 1,000,000 x 16
    float32, 3 attention layers of 2 heads, d_attn 32) drawn on the card
    from a seeded generator; train_batch, RECSYS_STEPS ``recsys_train_step``s
    of 65,536 x 39 x 4 Zipf ids (loss finite, step ms, samples/s, peak GB,
    the bag's two launches a step); serve_p99, SERVE_P99_REQUESTS requests
    of 512 (ids from the host, logits back to it: median and p99 ms);
    serve_bulk, 262,144 (ms, samples/s); retrieval_cand, one query against
    1,000,000 candidate representations made by ``representation`` over
    seeded Zipf id sets in batches of 65,536 (4.99 GB), through
    ``recsys_retrieval_step``: ms, and ids against the plain version on the
    card wherever neighbouring scores differ by more than RETRIEVAL_REL of
    the largest."""
    import gc

    import numpy as np
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
    from repro_torch.launch.recsys_steps import (field_mask, recsys_model,
                                                 recsys_retrieval_step,
                                                 recsys_serve_step,
                                                 recsys_train_step)
    from repro_torch.training.optimizer import init_opt_state

    dev = torch.device("cuda")
    spec = recsys_spec()
    cfg = spec.model
    v, h = cfg.vocab_per_field, cfg.multi_hot
    rng = np.random.default_rng(60)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = recsys_model(spec, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    f = model.f
    zipf = zipf_law(torch, rng, f, v, dev)
    torch.cuda.synchronize()
    out = {"n_params": sum(p.numel() for p in model.parameters()),
           "init_s": time.perf_counter() - t0}
    log(f"[recsys] {spec.name}: {out['n_params']} parameters ({f} fields "
        f"of {v} x {cfg.embed_dim}) drawn in {out['init_s']:.1f}s")

    def ids_of(b):
        return recsys_ids(torch, rng, b, f, h, v, dev, zipf)

    # train_batch
    b = spec.shapes["train_batch"].batch
    opt = init_opt_state(dict(model.named_parameters()))
    steps = []
    for step in range(RECSYS_STEPS):
        ids = ids_of(b)
        labels = torch.from_numpy(rng.integers(0, 2, b).astype(
            np.float32)).to(dev)
        torch.cuda.synchronize()
        n0 = gs_ops.launches.n
        t = time.perf_counter()
        opt, met = recsys_train_step(model, opt, ids, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        row = {k: float(val) for k, val in met.items()}
        row.update(ms=ms, samples_per_s=b / ms * 1e3,
                   bag_launches=gs_ops.launches.n - n0)
        steps.append(row)
        log(f"[recsys] train_batch step {step}: loss={row['loss']:.6f} "
            f"grad_norm={row['grad_norm']:.6f} step_ms={ms:.1f} samples_per_s"
            f"={row['samples_per_s']:.4g} bag launches={row['bag_launches']}")
        check(all(math.isfinite(row[k]) for k in ("loss", "grad_norm")),
              f"recsys step {step}: loss or grad norm not finite")
        check(row["bag_launches"] == 2, f"recsys step {step}: the bag ran "
              f"{row['bag_launches']} launches, not forward and gradient")
    out["train_batch"] = {"steps": steps, "batch": b,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[recsys] train_batch: peak device memory "
        f"{out['train_batch']['peak_gb']:.2f} GB")
    if prof is not None:
        prof("recsys train_batch step",
             lambda: recsys_train_step(model, opt, ids, labels))
    del opt, ids, labels
    gc.collect()
    torch.cuda.empty_cache()

    # serve_p99: requests from the host, logits back to it
    b = spec.shapes["serve_p99"].batch
    reqs = [ids_of(b).cpu() for _ in range(SERVE_P99_REQUESTS + 1)]
    lat = []
    for i, r in enumerate(reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg = recsys_serve_step(model, r.to(dev)).cpu()
        if i:                                    # the first warms up
            lat.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(lg).all()) and lg.shape == (b,),
              "serve_p99 logits not finite or misshapen")
    out["serve_p99"] = {"batch": b, "requests": len(lat),
                        "median_ms": float(np.median(lat)),
                        "p99_ms": float(np.percentile(lat, 99)),
                        "max_ms": max(lat)}
    log(f"[recsys] serve_p99 B={b}: {len(lat)} requests median_ms="
        f"{out['serve_p99']['median_ms']:.3f} p99_ms="
        f"{out['serve_p99']['p99_ms']:.3f} max_ms="
        f"{out['serve_p99']['max_ms']:.3f}")

    # serve_bulk
    b = spec.shapes["serve_bulk"].batch
    bulk = ids_of(b).cpu()
    runs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg = recsys_serve_step(model, bulk.to(dev)).cpu()
        runs.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(lg).all()) and lg.shape == (b,),
              "serve_bulk logits not finite or misshapen")
    ms = float(np.median(runs[1:]))
    out["serve_bulk"] = {"batch": b, "ms": ms, "runs_ms": runs,
                         "samples_per_s": b / ms * 1e3}
    log(f"[recsys] serve_bulk B={b}: ms={ms:.2f} (runs {runs}) "
        f"samples_per_s={b / ms * 1e3:.4g}")
    if prof is not None:
        prof("recsys serve_bulk", lambda: recsys_serve_step(
            model, bulk.to(dev)).cpu())
    del reqs, bulk, lg

    # retrieval_cand: the candidates' representations, then one query
    shape = spec.shapes["retrieval_cand"]
    n = shape.n_candidates
    mask = field_mask(model)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cands = torch.empty((n, model.d_repr), device=dev)
    with torch.no_grad():
        for i in range(0, n, 65_536):
            rows = min(65_536, n - i)
            cands[i:i + rows] = model.representation(ids_of(rows), mask)
    torch.cuda.synchronize()
    made = time.perf_counter() - t
    qids = ids_of(shape.batch)
    vals, rows = recsys_retrieval_step(model, qids, cands, RETRIEVAL_K)
    with torch.no_grad():
        q = model.representation(qids, mask)
    pv, pi = ivf_scan_topk_ref(q, cands, RETRIEVAL_K, "ip")
    tol = RETRIEVAL_REL * float(pv.abs().max())
    cmp = compare_knn(f"[recsys] retrieval Q=1 N={n} d={model.d_repr} "
                      f"k={RETRIEVAL_K} vs plain", (vals[None].cpu().numpy(),
                                                    rows[None].cpu().numpy()),
                      (pv.cpu().numpy(), pi.cpu().numpy()), tol)
    ms = time_ms(torch, lambda: recsys_retrieval_step(model, qids, cands,
                                                      RETRIEVAL_K))
    out["retrieval_cand"] = dict(cmp, n_candidates=n, d_repr=model.d_repr,
                                 candidates_gb=cands.numel() * 4 / 1e9,
                                 candidates_s=made, ms=ms, tol=tol)
    log(f"[recsys] retrieval_cand: {n} candidates of {model.d_repr} "
        f"({cands.numel() * 4 / 1e9:.2f} GB) made in {made:.1f}s; "
        f"retrieval ms={ms:.3f}")
    if prof is not None:
        prof("recsys retrieval_cand", lambda: recsys_retrieval_step(
            model, qids, cands, RETRIEVAL_K))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, cands, zipf, q, pv, pi
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_recsys_parity(torch):
    """autoint at its full widths, its tables cut to 1,000 rows a field,
    float32, the same weights on the card and the CPU, 256 samples of
    uniform ids: logits, loss, every gradient, and the loss, grad norm and
    every parameter after one ``recsys_train_step``, card against CPU
    within 1e-5 (the bag bit for bit; the einsums sum in another order)."""
    import dataclasses

    import numpy as np
    from repro_torch.launch.recsys_steps import (field_mask, recsys_model,
                                                 recsys_train_step)
    from repro_torch.training.optimizer import gradients, init_opt_state

    dev = torch.device("cuda")
    spec = recsys_spec()
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, vocab_per_field=1000))
    cfg = spec.model
    rng = np.random.default_rng(61)
    ids = rng.integers(0, 1000, (256, cfg.n_sparse, cfg.multi_hot),
                       dtype=np.int32)
    labels = rng.integers(0, 2, 256).astype(np.float32)
    card = recsys_model(spec, device=dev, generator=torch.Generator(
        device=dev).manual_seed(62))
    cpu = recsys_model(spec, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    res = []
    for model, where in ((card, dev), (cpu, "cpu")):
        i = torch.from_numpy(ids).to(where)
        lab = torch.from_numpy(labels).to(where)
        params = dict(model.named_parameters())
        loss = model.loss_fn(i, lab, field_mask(model))
        grads = gradients(loss, params)
        with torch.no_grad():
            lg = model.logits(i, field_mask(model))
        _, met = recsys_train_step(model, init_opt_state(params), i, lab)
        res.append((lg.cpu(), float(loss.detach()),
                    {k: g.cpu() for k, g in grads.items()},
                    {k: float(val) for k, val in met.items()},
                    {k: p.detach().cpu() for k, p in params.items()}))
    errs = {"logits": float((res[0][0] - res[1][0]).abs().max()),
            "loss": abs(res[0][1] - res[1][1]),
            "grads": max(float((res[0][2][k] - res[1][2][k]).abs().max())
                         for k in res[0][2]),
            "step": max(abs(res[0][3][k] - res[1][3][k]) for k in res[0][3]),
            "params": max(float((res[0][4][k] - res[1][4][k]).abs().max())
                          for k in res[0][4])}
    log("[recsys parity] autoint, 1,000 rows a field, float32, card vs cpu: "
        + " ".join(f"{k} max_abs_err={val:.3g}" for k, val in errs.items()))
    check(max(errs.values()) <= 1e-5,
          f"recsys parity off by {max(errs.values())}")
    return errs


# ---------------------------------------------------------------------------
# the DTensor route on a one-rank mesh: the same kernels on the same shapes
# ---------------------------------------------------------------------------

ROUTE_LM = (8, 256)            # the LM check's tokens: 2 rows a micro-batch
# At 256 positions each query row sees at most two key tiles of 128, so the
# bf16 backward adds at most two float32 terms onto each zeroed dq sum, and
# a sum of two terms is the same in either order: dq, and with it every
# tensor of the check, is deterministic by construction.  (From three key
# tiles on, the order in which the tiles' blocks add to dq changes its last
# bits from run to run.)
ROUTE_GRAPH = (200_000, 2_000_000)   # the GNN check's nodes and edges
ROUTE_RECSYS_ROWS, ROUTE_RECSYS_BATCH = 1000, 4096
#: plain runs of each route check, which must agree bit for bit (the
#: check's determinism)
ROUTE_PLAIN_RUNS = 2


def route_diff(want: dict, got: dict) -> list:
    """The names of the tensors of ``got`` that are not ``want``'s bit for
    bit (dtype, shape and every bit)."""
    return [name for name, a in want.items()
            if not (got[name].dtype == a.dtype and got[name].equal(a))]


def route_equal(label: str, plain: list, routed: dict) -> dict:
    """The plain runs equal each other bit for bit (the check is
    deterministic), and each tensor of the DTensor route equals theirs."""
    for other in plain[1:]:
        diff = route_diff(plain[0], other)
        check(not diff, f"{label}: the plain runs differ in {diff}")
    diff = route_diff(plain[0], routed)
    errs = {n: float((routed[n].float() - plain[0][n].float()).abs().max())
            for n in diff}
    check(not diff, f"{label}: off the plain route in {errs}")
    return {"exact": len(plain[0]), "of": len(plain[0]),
            "plain_runs": len(plain)}


def plant_fault(torch, model, plain: dict) -> str:
    """A planted fault that runs to its end: in the first parameter of two
    or more dims of the routed ``model``, the element whose gradient is the
    largest in the plain run (``plain``'s ``g/<name>``) is raised by the
    parameter's largest magnitude, in its local shard.  -> the name."""
    name, p = next((n, p) for n, p in model.named_parameters()
                   if p.ndim >= 2)
    i = int(plain[f"g/{name}"].abs().argmax())
    with torch.no_grad():
        flat = p.to_local().view(-1)
        flat[i] += flat.abs().max()
    return name


def planted_caught(label: str, run, plain: dict) -> dict:
    """The route check with a planted fault (``run()``, which must run to
    its end) must fail: a metric or a gradient differs from the plain
    run's."""
    got = run()
    diff = route_diff(plain, got)
    caught = [n for n in diff if n.startswith(("m/", "g/"))]
    check(bool(caught), f"{label}: a planted changed weight went unnoticed")
    return {"differ": len(diff), "metrics_or_grads": len(caught)}


def phase_dtensor_route(torch):
    """The DTensor route (``kernels/sharded.py``, the models' constraints,
    ``distributed/sharding.py::place_tree``) on the one-rank NCCL 1 x 1
    mesh (``make_smoke_mesh("cuda")``), where every placement is local:
    the same kernels run on the same shapes as on plain tensors.  (a)
    llama3-8b at full width cut to 2 layers (bf16, remat, FSDP rules):
    the loss and every gradient of ``loss_fn`` (flash forward and
    backward), every parameter after one ``train_step`` (4 micro-batches),
    the prefill's logits and 4 decode steps' logits (decode kernel);
    (b) graphsage-reddit on a 200,000-node power-law graph of 2,000,000
    edges (``gather_scatter``): the loss, every gradient and the
    parameters after one ``gnn_train_step``; (c) AutoInt at full width,
    1,000 rows a table, train_batch's 4,096-row cut (the bag through
    ``gather_scatter``): the same.  Each against the plain route, bit for
    bit (``route_equal``; ROUTE_LM says why the check is deterministic);
    each also with one weight element changed in its local shard
    (``plant_fault``), which runs to its end and must fail the check.  (On
    a one-rank mesh a wrong placement either changes nothing or raises on
    its global shape.)"""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import LMShape
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch.gnn_steps import (GNNCell, gnn_batch, gnn_bundle,
                                              gnn_loss, gnn_model,
                                              gnn_train_step)
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.recsys_steps import (field_mask, recsys_bundle,
                                                 recsys_model,
                                                 recsys_train_step)
    from repro_torch.launch.steps import _lm_bundle, train_step
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import gradients, init_opt_state

    dev = torch.device("cuda")
    mesh = make_smoke_mesh("cuda")
    out = {}

    def placed(args, specs):
        return tuple(place_tree(a, s, mesh, values=True)
                     for a, s in zip(args, specs))

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def flat(metrics, model=None, grads=None):
        res = {f"m/{k}": whole(v).detach() for k, v in metrics.items()}
        if model is not None:
            res.update({f"p/{k}": whole(p).detach()
                        for k, p in model.named_parameters()})
        if grads is not None:
            res.update({f"g/{k}": whole(g).detach()
                        for k, g in grads.items()})
        return res

    # (a) llama3-8b, 2 layers at full width
    spec = get_arch(LM_ARCH)
    cfg = reduced(spec.model, n_layers=2)
    b, s_len = ROUTE_LM
    lm_spec = dataclasses.replace(spec, model=cfg)
    train_b = _lm_bundle(lm_spec, LMShape("route", s_len, b, "train"), mesh)
    pre_b = _lm_bundle(lm_spec, LMShape("route", s_len, b, "prefill"),
                       mesh)
    dec_b = _lm_bundle(lm_spec, LMShape("route", s_len, b, "decode"), mesh)
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (b, s_len), generator=gen).to(dev)
    labs = torch.randint(0, cfg.vocab_size, (b, s_len), generator=gen).to(dev)

    def lm_run(route: bool, fault: dict = None) -> dict:
        model = LM(cfg, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(11))
        opt = init_opt_state(dict(model.named_parameters()))
        t, lab = toks, labs
        if route:
            model.rules = train_b.rules
            model, opt, t, lab = placed((model, opt, t, lab),
                                        train_b.in_specs)
            if fault is not None:
                plant_fault(torch, model, fault)
        with implicit_replication():
            loss, _ = model.loss_fn(t, lab)
            grads = gradients(loss, dict(model.named_parameters()))
            res = flat({"loss": loss}, grads=grads)
            del grads
            _, met = train_step(model, opt, t, lab)
            res.update(flat(met, model))
            del opt
            if route:
                model.rules = pre_b.rules
            logits, cache = model.prefill(
                place_tree(toks[:, :64], pre_b.in_specs[1], mesh,
                           values=True) if route else toks[:, :64])
            res["prefill"] = whole(logits)
            full = model.init_cache(b, s_len)
            if route:
                model.rules = dec_b.rules
                full = place_tree(full, dec_b.in_specs[1], mesh, values=True)
            for key, pair in cache.items():
                for dst, src in zip(full[key], pair):
                    (dst.to_local() if route else dst)[:, :, :64].copy_(
                        whole(src))
            nxt = toks[:, 64:65]
            for step in range(4):
                pos = torch.full((b,), 64 + step, dtype=torch.int32,
                                 device=dev)
                tk, ps = nxt, pos
                if route:
                    tk = place_tree(nxt, dec_b.in_specs[2], mesh, values=True)
                    ps = place_tree(pos, dec_b.in_specs[3], mesh, values=True)
                logits, full = model.decode_step(full, tk, ps)
                res[f"decode{step}"] = whole(logits)
                nxt = whole(logits).argmax(-1, keepdim=True).to(torch.int32)
        del model, full, cache
        torch.cuda.empty_cache()
        return res

    plain = [lm_run(False) for _ in range(ROUTE_PLAIN_RUNS)]
    routed = lm_run(True)
    out["lm"] = route_equal("llama3-8b 2L route", plain, routed)
    out["lm"]["planted"] = planted_caught(
        "llama3-8b 2L route", lambda: lm_run(True, fault=plain[0]),
        plain[0])
    log(f"[dtensor route] llama3-8b 2 layers full width: {out['lm']}")
    del plain, routed
    torch.cuda.empty_cache()

    # (b) graphsage-reddit
    gspec = get_arch("graphsage-reddit")
    n, e = ROUTE_GRAPH
    rng = np.random.default_rng(13)
    src, dst = power_law_edges_dev(torch, rng, n, e, dev)
    cell = GNNCell(n_nodes=n, n_edges=e, d_feat=100, n_out=47,
                   needs_pos=False, shard_nodes=False, channel_shard=False,
                   chunk=None)
    batch = gnn_batch(cell, {
        "feats": rng.standard_normal((n, 100), dtype=np.float32),
        "src": src, "dst": dst,
        "labels": rng.integers(0, 47, n).astype(np.int32)}, dev)
    g_specs = gnn_bundle(gspec, gspec.shapes["ogb_products"], mesh).in_specs

    def gnn_run(route: bool, fault: dict = None) -> dict:
        model = gnn_model(gspec, cell, device=dev, generator=torch.Generator(
            device=dev).manual_seed(14))
        opt = init_opt_state(dict(model.named_parameters()))
        bt = batch
        if route:
            model, opt, bt = placed((model, opt, batch), g_specs)
            if fault is not None:
                plant_fault(torch, model, fault)
        with implicit_replication():
            loss, _ = gnn_loss(model, bt, cell)
            grads = gradients(loss, dict(model.named_parameters()))
            res = flat({"loss": loss}, grads=grads)
            _, met = gnn_train_step(model, opt, bt, cell)
        res.update(flat(met, model))
        return res

    plain = [gnn_run(False) for _ in range(ROUTE_PLAIN_RUNS)]
    routed = gnn_run(True)
    out["gnn"] = route_equal("graphsage route", plain, routed)
    out["gnn"]["planted"] = planted_caught(
        "graphsage route", lambda: gnn_run(True, fault=plain[0]), plain[0])
    log(f"[dtensor route] graphsage-reddit {n} nodes {e} edges: "
        f"{out['gnn']}")
    del batch, src, dst, plain, routed
    torch.cuda.empty_cache()

    # (c) AutoInt train_batch, cut
    rspec = recsys_spec()
    rspec = dataclasses.replace(rspec, model=dataclasses.replace(
        rspec.model, vocab_per_field=ROUTE_RECSYS_ROWS))
    rcfg = rspec.model
    r_specs = recsys_bundle(rspec, rspec.shapes["train_batch"],
                            mesh).in_specs
    rb = ROUTE_RECSYS_BATCH
    ids = torch.from_numpy(rng.integers(
        0, ROUTE_RECSYS_ROWS, (rb, recsys_model(rspec, device="meta").f,
                               rcfg.multi_hot), dtype=np.int32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 2, rb).astype(
        np.float32)).to(dev)

    def recsys_run(route: bool, fault: dict = None) -> dict:
        model = recsys_model(rspec, device=dev, generator=torch.Generator(
            device=dev).manual_seed(15))
        mask = field_mask(model)
        opt = init_opt_state(dict(model.named_parameters()))
        i, lab = ids, labels
        if route:
            model, opt, i, lab = placed((model, opt, ids, labels), r_specs)
            if fault is not None:
                plant_fault(torch, model, fault)
        with implicit_replication():
            loss = model.loss_fn(i, lab, mask)
            grads = gradients(loss, dict(model.named_parameters()))
            res = flat({"loss": loss}, grads=grads)
            _, met = recsys_train_step(model, opt, i, lab)
        res.update(flat(met, model))
        return res

    plain = [recsys_run(False) for _ in range(ROUTE_PLAIN_RUNS)]
    routed = recsys_run(True)
    out["recsys"] = route_equal("autoint route", plain, routed)
    out["recsys"]["planted"] = planted_caught(
        "autoint route", lambda: recsys_run(True, fault=plain[0]), plain[0])
    log(f"[dtensor route] autoint {ROUTE_RECSYS_ROWS} rows a table, "
        f"{rb} samples: {out['recsys']}")
    return out


# ---------------------------------------------------------------------------
# the dry run: operation counts on meta and on the card
# ---------------------------------------------------------------------------

DRY_FLOPS_REL = 0.01     # meta vs card FLOPs of one step
DRY_BYTES_REL = 0.10     # meta vs card bytes (the wrappers' own set-up,
                         # such as the CSR's sort, runs on the card only)
DRY_LM_FLOPS_REL = 0.02  # the LM step's FLOPs vs train_flops' executed count
DRY_TIMED_STEPS = 3
DRYRUN_JOBS = 6          # worker processes of the 40-cell dry run
#: the cells counted per device on the production meshes, each mesh's in
#: worker processes of their own (a process holds one process group, and
#: this one holds the distributed phase's NCCL rank)
SHARDED_CELLS = (("llama3-8b", "train_4k"), ("deepseek-moe-16b", "train_4k"),
                 ("graphsage-reddit", "ogb_products"),
                 ("autoint", "train_batch"))


def meta_card_case(torch, label: str, bundle, card_args, peak: float
                   ) -> dict:
    """One step counted on meta (``bundle``'s abstract arguments) and on
    the card (``card_args`` through the same ``bundle.fn``, the hand
    kernels running): FLOPs within DRY_FLOPS_REL, bytes within
    DRY_BYTES_REL, the hand kernels' calls equal; the meta count's
    roofline (``compute_s`` at ``peak``, ``memory_s``) beside the step's
    measured ms (median of DRY_TIMED_STEPS after the counted one)."""
    from repro_torch.launch.op_analysis import analyze, roofline

    counts = {}
    meta = analyze(bundle.fn, *bundle.abstract_args)
    card = analyze(bundle.fn, *card_args)
    torch.cuda.synchronize()
    times = []
    for _ in range(DRY_TIMED_STEPS):
        t0 = time.perf_counter()
        bundle.fn(*card_args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(times)[len(times) // 2]
    r = roofline(meta, peak)
    counts.update(
        flops_meta=meta.flops, flops_card=card.flops,
        bytes_meta=meta.bytes_accessed, bytes_card=card.bytes_accessed,
        flops_rel=card.flops / meta.flops - 1,
        bytes_rel=card.bytes_accessed / meta.bytes_accessed - 1,
        kernels_meta=meta.kernels, kernels_card=card.kernels,
        peak_gb_meta=meta.peak_bytes / 1e9, meta_s=meta.seconds,
        compute_s=r["compute_s"], memory_s=r["memory_s"],
        dominant=r["dominant"], step_ms=ms, step_ms_all=times,
        step_over_roofline=ms / 1e3 / max(r["compute_s"], r["memory_s"]))
    log(f"[dryrun] {label}: flops meta={meta.flops:.6g} card="
        f"{card.flops:.6g} ({counts['flops_rel']:+.5f}); bytes meta="
        f"{meta.bytes_accessed:.6g} card={card.bytes_accessed:.6g} "
        f"({counts['bytes_rel']:+.5f}); compute_s={r['compute_s']:.6g} "
        f"memory_s={r['memory_s']:.6g} ({r['dominant']}); measured "
        f"step_ms={ms:.3f} = {counts['step_over_roofline']:.3f}x the "
        f"roofline; meta peak {counts['peak_gb_meta']:.2f} GB, counted in "
        f"{meta.seconds:.1f}s")
    for name, k in meta.kernels.items():
        log(f"[dryrun]   kernel {name}: calls {k['calls']:g} flops "
            f"{k['flops']:.6g} bytes {k['bytes']:.6g} (card: "
            f"{card.kernels.get(name, {})})")
    check(abs(counts["flops_rel"]) <= DRY_FLOPS_REL,
          f"{label}: card FLOPs {card.flops} vs meta {meta.flops}")
    check(abs(counts["bytes_rel"]) <= DRY_BYTES_REL,
          f"{label}: card bytes {card.bytes_accessed} vs meta "
          f"{meta.bytes_accessed}")
    check({n: k["calls"] for n, k in meta.kernels.items()}
          == {n: k["calls"] for n, k in card.kernels.items()},
          f"{label}: the hand kernels' calls differ, meta "
          f"{meta.kernels} card {card.kernels}")
    return counts


def phase_dryrun(torch):
    """The dry run (``launch/dryrun.py``, ``launch/op_analysis.py``).
    (a) Three training steps the other paths run, at their shapes, counted
    on the meta device and on the card through the same bundle ``fn``:
    train-8b-8L (llama3-8b at full width cut to TRAIN_LAYERS layers, 8 x
    4,096 tokens in 4 micro-batches, remat), gnn-products (graphsage-reddit
    on ogb_products' full graph) and AutoInt's train_batch step: FLOPs
    within 1%, bytes within 10%; each step's roofline beside its measured
    ms; for the LM its FLOPs against ``train_flops``' executed count
    (within 2%) and MFU = model_flops / step s / 989 TFLOP/s.  (b) All 40
    cells of ``all_cells()`` at mesh ``one`` on meta, at full size, in
    DRYRUN_JOBS worker processes: each cell's seconds, FLOPs, argument GB
    and whether its peak fits 80 GB; a cell that fails fails the phase.
    (c) SHARDED_CELLS on the 16 x 16 and 2 x 16 x 16 meshes: each step on
    DTensors over a fake process group, counted per device (FLOPs, bytes,
    peak, collectives by kind, the roofline's three terms), each mesh's
    counts in worker processes of their own; a count that fails or finds
    no collective fails the phase."""
    import gc

    import numpy as np
    from repro_torch.configs import all_cells, get_arch, reduced
    from repro_torch.configs.base import LMShape
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.launch.dryrun import model_flops_of, run_cells
    from repro_torch.launch.gnn_steps import GNNCell, gnn_bundle, gnn_model
    from repro_torch.launch.mesh import ONE, peak_flops
    from repro_torch.launch.recsys_steps import recsys_bundle, recsys_model
    from repro_torch.launch.steps import _lm_bundle
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import init_opt_state

    dev = torch.device("cuda")
    out = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) train-8b-8L
    spec = get_arch(LM_ARCH)
    cfg = reduced(spec.model, n_layers=TRAIN_LAYERS)
    shape = LMShape("train-8b-8L", TRAIN_LEN, TRAIN_BATCH, "train")
    bundle = _lm_bundle(dataclasses.replace(spec, model=cfg), shape, ONE)
    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(0))
    opt = init_opt_state(dict(model.named_parameters()))
    batch = SyntheticLM(LMDataConfig(cfg.vocab_size, TRAIN_LEN,
                                     TRAIN_BATCH)).batch(0)
    toks = torch.from_numpy(batch["tokens"]).to(dev)
    labs = torch.from_numpy(batch["labels"]).to(dev)
    res = meta_card_case(torch, "train-8b-8L", bundle,
                         (model, opt, toks, labs), peak_flops(cfg.dtype))
    fl = train_flops(cfg, TRAIN_BATCH * TRAIN_LEN, TRAIN_LEN)
    mflops = model_flops_of(cfg, shape)
    res.update(train_flops=fl["flops"], executed_flops=fl["executed_flops"],
               model_flops=mflops,
               flops_over_executed=res["flops_card"] / fl["executed_flops"],
               mfu=mflops / (res["step_ms"] / 1e3) / peak_flops("bfloat16"),
               mfu_train_flops=fl["flops"] / (res["step_ms"] / 1e3)
               / peak_flops("bfloat16"))
    log(f"[dryrun] train-8b-8L: counted {res['flops_card']:.6g} FLOPs "
        f"against train_flops' executed {fl['executed_flops']:.6g} "
        f"({fl['executed_formula']}; x{res['flops_over_executed']:.5f}) "
        f"and its model {fl['flops']:.6g}; MFU = 6 N D "
        f"({mflops:.6g}) / step / 989 TFLOP/s = {res['mfu']:.4f} "
        f"(train_flops' {res['mfu_train_flops']:.4f})")
    check(abs(res["flops_over_executed"] - 1) <= DRY_LM_FLOPS_REL,
          f"train-8b-8L: counted FLOPs off train_flops' executed count by "
          f"{res['flops_over_executed'] - 1:+.4f}")
    out["train-8b-8L"] = res
    del model, opt, toks, labs, bundle
    free()

    # (a) gnn-products
    spec = get_arch("graphsage-reddit")
    bundle = gnn_bundle(spec, spec.shapes["ogb_products"], ONE)
    cell = GNNCell(**bundle.meta["cell"])
    batch, _ = products_batch(torch, cell, dev)
    model = gnn_model(spec, cell, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    opt = init_opt_state(dict(model.named_parameters()))
    out["gnn-products"] = meta_card_case(
        torch, "gnn-products", bundle, (model, opt, batch),
        peak_flops(spec.model.dtype))
    del model, opt, batch, bundle
    free()

    # (a) AutoInt train_batch
    spec = recsys_spec()
    shape = spec.shapes["train_batch"]
    bundle = recsys_bundle(spec, shape, ONE)
    model = recsys_model(spec, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    rng = np.random.default_rng(61)
    cfg = spec.model
    ids = recsys_ids(torch, rng, shape.batch, model.f, cfg.multi_hot,
                     cfg.vocab_per_field, dev,
                     zipf_law(torch, rng, model.f, cfg.vocab_per_field, dev))
    labels = torch.from_numpy(rng.integers(0, 2, shape.batch).astype(
        np.float32)).to(dev)
    opt = init_opt_state(dict(model.named_parameters()))
    out["recsys-train_batch"] = meta_card_case(
        torch, "recsys-autoint train_batch", bundle,
        (model, opt, ids, labels), peak_flops(cfg.dtype))
    del model, opt, ids, labels, bundle
    free()

    # (b) the 40 cells at mesh one, on meta
    import os
    jobs = [(a, s, "one") for a, s in all_cells()]
    n_proc = max(1, min(DRYRUN_JOBS, os.cpu_count() or 1))
    t0 = time.perf_counter()
    cells, failed = {}, []
    for res in run_cells(jobs, n_proc):
        tag = f"{res['arch']} {res['shape']}"
        if "error" in res:
            failed.append(tag)
            log(f"[dryrun] cell {tag} FAILED: {res['error']}\n"
                f"{res['traceback']}")
            continue
        an, r = res["analysis"], res["roofline"]
        cells[tag] = {k: res[k] for k in (
            "seconds", "arg_bytes_per_device", "peak_bytes", "fits_80GB",
            "model_flops_total", "useful_flops_ratio")}
        cells[tag].update(flops=an["flops"], bytes=an["bytes_accessed"],
                          compute_s=r["compute_s"], memory_s=r["memory_s"],
                          kernels=an["kernels"], repeats=an["repeats"])
        log(f"[dryrun] cell {tag}: {res['seconds']:.1f}s flops="
            f"{an['flops']:.6g} bytes={an['bytes_accessed']:.6g} args="
            f"{res['arg_bytes_per_device'] / 1e9:.3f} GB peak="
            f"{res['peak_bytes'] / 1e9:.3f} GB fits_80GB={res['fits_80GB']}"
            f" compute_s={r['compute_s']:.6g} memory_s={r['memory_s']:.6g}")
    out["cells"] = cells
    out["cells_wall_s"] = time.perf_counter() - t0
    log(f"[dryrun] {len(cells)} of {len(jobs)} cells counted in "
        f"{out['cells_wall_s']:.1f}s on {n_proc} processes")
    check(not failed, f"dry-run cells failed: {failed}")
    check(len(cells) == 40, f"{len(cells)} dry-run cells, not 40")

    # (c) sharded counts: per device on the 16 x 16 and 2 x 16 x 16 meshes
    jobs = [(a, s, m) for m in ("single", "multi") for a, s in SHARDED_CELLS]
    t0 = time.perf_counter()
    sharded, failed = {}, []
    for res in run_cells(jobs, min(len(SHARDED_CELLS), n_proc)):
        tag = f"{res['arch']} {res['shape']} {res['mesh']}"
        if "error" in res:
            failed.append(tag)
            log(f"[dryrun] sharded {tag} FAILED: {res['error']}\n"
                f"{res['traceback']}")
            continue
        r = res["roofline"]
        sharded[tag] = {k: res[k] for k in (
            "n_chips", "seconds", "flops", "bytes", "peak_bytes",
            "collectives", "collective_bytes", "fits_80GB",
            "useful_flops_ratio")}
        sharded[tag].update(compute_s=r["compute_s"], memory_s=r["memory_s"],
                            collective_s=r["collective_s"],
                            dominant=r["dominant"])
        kinds = " ".join(f"{k}={e['count']:g}x/{e['bytes'] / 1e9:.4g}GB"
                         for k, e in sorted(res["collectives"].items()))
        log(f"[dryrun] sharded {tag} ({res['n_chips']} chips, "
            f"{res['seconds']:.1f}s): per device flops={res['flops']:.6g} "
            f"bytes={res['bytes']:.6g} peak={res['peak_bytes'] / 1e9:.3f} "
            f"GB collectives {kinds} collective_s={r['collective_s']:.6g} "
            f"compute_s={r['compute_s']:.6g} memory_s={r['memory_s']:.6g} "
            f"dominant={r['dominant']} fits_80GB={res['fits_80GB']}")
        check(res["collectives"], f"sharded {tag}: no collective counted")
    out["sharded"] = sharded
    out["sharded_wall_s"] = time.perf_counter() - t0
    log(f"[dryrun] {len(sharded)} of {len(jobs)} sharded counts in "
        f"{out['sharded_wall_s']:.1f}s")
    check(not failed, f"sharded dry-run counts failed: {failed}")
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
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.topk_merge import ops as merge_ops
    from repro_torch.core.vector_index import METRICS

    dense_scans = METRICS.counter("ivf.path.dense")
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
                "topk_merge": merge_ops.launches,
                "flash_attention": flash_ops.launches,
                "flash_attention_window": flash_ops.window_launches,
                "decode_attention": decode_ops.launches,
                "flash_attention_bwd": flash_ops.bwd_launches,
                "gather_scatter": gs_ops.launches}
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
        and read just after; each kernel in ``needs`` must have launched.
        Beside the counts: the index's batches on the masked dense scan
        (``ivf_score<true>``), which the ivf_scan count includes."""
        for c in counters.values():
            c.reset()
        dense0 = dense_scans.value
        for phase in phases:
            run(*phase)
        got = {name: c.n for name, c in counters.items()}
        log(f"[main path] {label} launches {got}, dense scans "
            f"{dense_scans.value - dense0}")
        got["ivf_scan_dense"] = dense_scans.value - dense0
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
    paths = {"single_node": single, "cluster": cluster}
    paths["lm"] = main_path(
        "lm", ("flash_attention", "decode_attention", "ivf_scan"),
        ("lm", phase_lm, torch, maybe_prof))
    paths["moe_lm"] = main_path(
        "moe-lm", ("flash_attention", "decode_attention"),
        ("moe-lm", phase_moe_lm, torch, maybe_prof))
    paths["mla_lm"] = main_path(
        "mla-lm", ("flash_attention",),
        ("mla-lm", phase_mla_lm, torch, maybe_prof))
    paths["phi_cell"] = main_path(
        "phi-cell", ("flash_attention", "ivf_scan"),
        ("phi-cell", phase_phi_cell, torch))
    paths["mellum2_cell"] = main_path(
        "mellum2-cell", ("flash_attention", "flash_attention_window"),
        ("mellum2-cell", phase_mellum2_cell, torch))
    paths["distributed"] = main_path(
        "distributed", ("topk_merge",),
        ("distributed", phase_distributed, torch))
    paths["train"] = main_path(
        "train", ("flash_attention", "flash_attention_bwd"),
        ("train", phase_train, torch, maybe_prof))
    paths["gnn"] = main_path(
        "gnn", ("gather_scatter",), ("gnn", phase_gnn, torch, maybe_prof))
    paths["recsys"] = main_path(
        "recsys", ("gather_scatter", "ivf_scan"),
        ("recsys", phase_recsys, torch, maybe_prof))
    run("parity", phase_parity)
    for arch, tag in ((LM_ARCH, "lm"), (MOE_ARCH, "moe"), (MLA_ARCH, "mla")):
        run(f"{tag}_parity", phase_lm_parity, torch, arch)
        run(f"{tag}_parity_bf16", phase_lm_parity_bf16, torch, arch)
        run(f"{tag}_train_parity", phase_train_parity, torch, arch)
    run("train_parity_bf16", phase_train_parity_bf16, torch)
    run("gnn_parity", phase_gnn_parity, torch)
    run("recsys_parity", phase_recsys_parity, torch)
    run("dtensor_route", phase_dtensor_route, torch)
    paths["dryrun"] = main_path(
        "dryrun", ("flash_attention", "flash_attention_bwd",
                   "gather_scatter"), ("dryrun", phase_dryrun, torch))
    launches = {name: sum(p[name] for p in paths.values())
                for name in counters}

    meta = {
        "ivf_scan": ("src/repro_torch/csrc/ivf_scan.cu",
                     "src/repro/kernels/ivf_scan/ivf_scan.py:53"),
        "pq_scan": ("src/repro_torch/csrc/pq_scan.cu",
                    "src/repro/kernels/pq_scan/pq_scan.py:106"),
        "pq_scan_ext": ("src/repro_torch/csrc/pq_scan.cu",
                        "src/repro/kernels/pq_scan/pq_scan.py:153"),
        "topk_merge": ("src/repro_torch/csrc/topk_merge.cu",
                       "src/repro/kernels/topk_merge/topk_merge.py:57"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:73"),
        "decode_attention": (
            "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:65"),
        # no Pallas kernel: XLA differentiates the reference's
        # chunked_attention, whose gradient this kernel computes
        "flash_attention_bwd": (
            "src/repro_torch/csrc/flash_attention_bwd.cu",
            "src/repro/models/attention.py:35"),
        # no Pallas kernel: XLA's gather and segment_sum in the reference's
        # gather_scatter, the GNN family's SpMM
        "gather_scatter": (
            "src/repro_torch/csrc/gather_scatter.cu",
            "src/repro/models/gnn/common.py:37"),
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
    results["launches"] = paths
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
