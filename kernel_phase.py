#!/usr/bin/env python3
"""Phase 1 of ``chip_smoke.py`` (every kernel against its plain version,
timed) for one checkout of the repository, to compare two trees on one
card in one run:

    python3 kernel_phase.py <tree root> <label> <out.json> \
        [--attention-only | --gnn-only]

Builds the tree's kernels, prints ptxas' register and spill lines and each
kernel case's line, and writes the phase's numbers to ``out.json``.  Run
it for parent, change, change, parent in one run on the card.  With
``--attention-only`` it skips phase 1 and takes only the attention
kernels' device times below.

Phase 1 times each call with CUDA events around three back-to-back runs,
so a kernel of a few tens of microseconds also carries the host's time to
enqueue it.  The attention kernels at the LM's shapes are timed a second
way as well (``device_ms``, under ``device_ms`` in ``out.json``): the sum
of the kernels' own device time under ``torch.profiler``, with no host
time in it, the tree's wrapper against ``scaled_dot_product_attention``.
Where the tree has them, the flash forward is also timed with its row
statistics written (``return_stats``), and the flash backward at the
training shape (B=2, S=4,096) beside SDPA's forward + backward, and
split into its launches kernel by kernel.  Where the tree has
``gather_scatter``, it is timed the same way at ogb_products' GraphSAGE
layers (2,449,029 nodes, 61,859,328 power-law edges, d = 100 and 128,
float32, mean; forward, and at d = 128 the backward through
``torch.autograd.grad``, as the training step runs it) beside
``torch.sparse.mm`` on a CSR tensor of the same weights (for the backward
the CSR by source), with the CSR's build (one stable sort, and both ways)
apart.  With ``--gnn-only`` it runs, in place of phase 1 and the attention
times, phase 1's ``gather_scatter`` cases, the times above, and
gnn-small's steps (gcn-cora, gat-bonus, gin-bonus as ``chip_smoke.py``'s
gnn phase trains them) on the host's clock and in device time, with the
forward on Cora-sized graphs with and without a long row.
"""
import inspect
import json
import os
import sys
import time


RUNS = 20


def device_ms_by_kernel(torch, fn, runs: int = RUNS) -> dict:
    """Device time of one call of ``fn`` by kernel (name: ms): each
    kernel's mean time on the card under ``torch.profiler`` over ``runs``
    calls after one warm-up, times its launches a call (its records over
    ``runs``, rounded), so that a record the profiler drops does not pass
    for a faster call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total / 1e3 / ev.count
            * round(ev.count / runs) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.count}


def device_ms(torch, fn, runs: int = RUNS) -> float:
    """Device time of one call of ``fn``: the time its kernels ran on the
    card under ``torch.profiler`` over ``runs`` calls after one warm-up,
    divided by ``runs``."""
    return sum(device_ms_by_kernel(torch, fn, runs).values())


def attention_device_times(torch, label: str) -> dict:
    """flash_attention at the llama3-8b prefill (B=8, S=4,096) and phi's
    S=64 in both probability modes, decode_attention at positions spread
    over a 32,768-position cache and at the LM path's 4,100, each beside
    SDPA on the same inputs, in device time (32 query, 8 key heads of 128,
    bf16; inputs as phase 1 makes them)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from chip_smoke import sdpa
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    stats = "return_stats" in inspect.signature(flash_attention).parameters
    for case, b, s in (("prefill", 8, 4096), ("phi", 8, 64)):
        q = torch.randn(b, s, 32, 128, device=dev, generator=gen).to(bf)
        k = torch.randn(b, s, 8, 128, device=dev, generator=gen).to(bf)
        v = torch.randn(b, s, 8, 128, device=dev, generator=gen).to(bf)
        for probs in (False, True):
            out[f"flash {case} bf16_probs={probs}"] = device_ms(
                torch, lambda: flash_attention(q, k, v, bf16_probs=probs))
        if stats:
            out[f"flash {case} return_stats"] = device_ms(
                torch, lambda: flash_attention(q, k, v, return_stats=True))
        out[f"flash {case} sdpa"] = device_ms(
            torch, lambda: sdpa(torch, q, k, v, is_causal=True))
        del q, k, v
    if stats:
        from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
        q, do = (torch.randn(2, 4096, 32, 128, device=dev, generator=gen)
                 .to(bf) for _ in range(2))
        k, v = (torch.randn(2, 4096, 8, 128, device=dev, generator=gen)
                .to(bf) for _ in range(2))
        o, m, l = flash_attention(q, k, v, return_stats=True)
        parts = device_ms_by_kernel(
            torch, lambda: flash_attention_bwd(q, k, v, o, m, l, do))
        out["flash_bwd train"] = sum(parts.values())
        for name, ms in parts.items():     # its launches, kernel by kernel
            short = name.replace("(anonymous namespace)::", "")
            out[f"flash_bwd train: {short.split('(')[0][:60]}"] = ms
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))

        def sdpa_fwd_bwd():
            torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True).backward(
                    do.transpose(1, 2))

        out["flash_bwd train sdpa fwd+bwd"] = device_ms(torch, sdpa_fwd_bwd)
        with torch.no_grad():
            out["flash_bwd train sdpa fwd"] = device_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        del q, k, v, o, m, l, do, qt, kt, vt
    gen = torch.Generator(device=dev).manual_seed(4)
    b, s = 8, 32768
    q = torch.randn(b, 1, 32, 128, device=dev, generator=gen).to(bf)
    kc = torch.randn(b, s, 8, 128, device=dev, generator=gen).to(bf)
    vc = torch.randn(b, s, 8, 128, device=dev, generator=gen).to(bf)
    spread = torch.randint(0, s, (b,), device=dev, generator=gen,
                           dtype=torch.int32)
    spread[0], spread[-1] = s - 1, 0
    lm = torch.full((b,), 4100, device=dev, dtype=torch.int32)
    for case, pos in (("spread", spread), ("lm_path", lm)):
        mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None].long()
                )[:, None, None, :]
        out[f"decode {case}"] = device_ms(
            torch, lambda: decode_attention(q, kc, vc, pos))
        out[f"decode {case} sdpa"] = device_ms(
            torch, lambda: sdpa(torch, q, kc, vc, attn_mask=mask))
    for key, ms in out.items():
        print(f"[{label}] device_ms {key}: {ms:.4f}", flush=True)
    return out


def gather_scatter_device_times(torch, label: str) -> dict:
    """gather_scatter at ogb_products' two GraphSAGE layers in device time,
    beside torch.sparse.mm on the same CSR (the mean as a row scale after
    it), and the CSR's build; the backward at d = 128 as the step runs it,
    ``torch.autograd.grad`` of the mean (the wrapper's work and the
    kernel), beside ``sparse.mm`` over the CSR by source with the same
    per-edge weights; the forward and the backward also as the kernel's
    own time (``... kernel``), the rest being the wrapper's.  Inputs
    as phase 1 makes them.  The CSRs for ``sparse.mm`` are built here, the
    same for every tree."""
    import numpy as np
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from chip_smoke import PRODUCTS_EDGES, PRODUCTS_NODES, power_law_edges_dev
    dev = torch.device("cuda")
    n = PRODUCTS_NODES
    src, dst = power_law_edges_dev(torch, np.random.default_rng(31), n,
                                   PRODUCTS_EDGES, dev)
    pad = torch.zeros(188, dtype=torch.int64, device=dev)
    src = torch.cat([src, pad]).to(torch.int32)
    dst = torch.cat([dst, pad]).to(torch.int32)
    mask = (torch.arange(src.shape[0], device=dev) < PRODUCTS_EDGES).float()
    out = {"gather_scatter csr build": device_ms(
        torch, lambda: gs_ops.EdgeCSR.build(src, dst, n)),
        "gather_scatter csr build both ways": device_ms(
        torch, lambda: gs_ops.EdgeCSR.build(src, dst, n).transposed(), 5)}
    csr = gs_ops.EdgeCSR.build(src, dst, n)

    def sparse_csr(key, other, vals):
        keys, perm = torch.sort(key, stable=True)
        ptr = torch.searchsorted(keys, torch.arange(n + 1, dtype=keys.dtype,
                                                    device=dev))
        col = other[perm].long()
        return torch.sparse_csr_tensor(ptr, col, vals(perm, col),
                                       size=(n, n))

    cnt = torch.bincount(dst.long(), minlength=n).float().clamp(min=1.0)
    a = sparse_csr(dst, src, lambda perm, col: mask[perm])
    scale = (1.0 / cnt)[:, None]
    gen = torch.Generator(device=dev).manual_seed(5)

    def timed(key, fn):
        parts = device_ms_by_kernel(torch, fn, 5)
        out[key] = sum(parts.values())
        out[f"{key} kernel"] = sum(ms for name, ms in parts.items()
                                   if "gather_scatter" in name)

    for d in (100, 128):
        x = torch.randn(n, d, device=dev, generator=gen)
        timed(f"gather_scatter products d={d} mean",
              lambda: gs_ops.gather_scatter(x, src, dst, n, mask, "mean",
                                            csr))
        out[f"gather_scatter products d={d} sparse.mm"] = device_ms(
            torch, lambda: torch.sparse.mm(a, x) * scale, 5)
        if d == 100:
            del x
    del a
    xg = x.detach().requires_grad_()
    y = gs_ops.gather_scatter(xg, src, dst, n, mask, "mean", csr)
    g = torch.randn(n, 128, device=dev, generator=gen)
    timed("gather_scatter products d=128 backward",
          lambda: torch.autograd.grad(y, xg, g, retain_graph=True))
    del y, xg, x
    at = sparse_csr(src, dst, lambda perm, col: mask[perm] / cnt[col])
    out["gather_scatter products d=128 backward sparse.mm"] = device_ms(
        torch, lambda: torch.sparse.mm(at, g), 5)
    for key, ms in out.items():
        print(f"[{label}] device_ms {key}: {ms:.4f}", flush=True)
    return out


def cora_rows_times(torch, label: str) -> dict:
    """The forward's device ms (mean, no weights) on Cora-sized graphs of
    2,708 nodes: Cora as phase 1 makes it (10,556 random edges and 196
    padding edges 0 -> 0, which make row 0 a long row), the same without
    the padding edges (no long row), and the padding edges alone (only the
    long row), at d = 128 and 1,433."""
    import numpy as np
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    dev = torch.device("cuda")
    n = 2708
    rng = np.random.default_rng(3)
    s, t = rng.integers(0, n, 10_556), rng.integers(0, n - 8, 10_556)
    pad = np.zeros(196, np.int64)
    graphs = {"cora": (np.concatenate([s, pad]), np.concatenate([t, pad])),
              "cora without padding": (s, t), "padding row alone": (pad, pad)}
    out = {}
    for name, (src, dst) in graphs.items():
        src = torch.from_numpy(src).to(dev).to(torch.int32)
        dst = torch.from_numpy(dst).to(dev).to(torch.int32)
        csr = gs_ops.EdgeCSR.build(src, dst, n)
        for d in (128, 1433):
            x = torch.randn(n, d, device=dev)
            parts = device_ms_by_kernel(torch, lambda: gs_ops.gather_scatter(
                x, src, dst, n, None, "mean", csr))
            key = f"{name} d={d}"
            out[key] = sum(ms for k, ms in parts.items()
                           if "gather_scatter" in k)
            print(f"[{label}] device_ms gather_scatter {key}: "
                  f"{out[key]:.4f}", flush=True)
    return out


def gnn_small_times(torch, label: str, steps: int = 30) -> dict:
    """gnn-small's models on full_graph_sm, made as ``chip_smoke.py``'s gnn
    phase makes them: a ``gnn_train_step``'s wall ms (median, least and
    most of ``steps`` after 3 warm-ups, the card synchronised around each),
    its kernels' device ms and launches under ``torch.profiler`` (5 steps),
    and, on gcn-cora's graph, the host's ms to enqueue one forward
    ``gather_scatter`` at d = 1,433 (mean of 100, no sync between) and to
    build the CSR both ways (median of 20, synchronised)."""
    import statistics

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import power_law_edges_dev
    from repro_torch.configs import get_arch
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.launch.gnn_steps import (cell_of, gnn_batch, gnn_model,
                                              gnn_train_step)
    from repro_torch.training.optimizer import init_opt_state
    dev = torch.device("cuda")
    out = {}
    for name in ("gcn-cora", "gat-bonus", "gin-bonus"):
        sp = get_arch(name)
        shape = sp.shapes["full_graph_sm"]
        cell = cell_of(sp, shape)
        rng = np.random.default_rng(1)
        s, t = power_law_edges_dev(torch, rng, shape.n_nodes, shape.n_edges,
                                   dev)
        b = gnn_batch(cell, {
            "feats": rng.standard_normal((shape.n_nodes, shape.d_feat),
                                         dtype=np.float32),
            "src": s, "dst": t,
            "labels": rng.integers(0, cell.n_out, shape.n_nodes)}, dev)
        model = gnn_model(sp, cell, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        state = [init_opt_state(dict(model.named_parameters()))]

        def step():
            state[0], _ = gnn_train_step(model, state[0], b, cell)

        ms = []
        for i in range(3 + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i >= 3:
                ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        row = {"step_ms_median": statistics.median(ms),
               "step_ms_min": min(ms), "step_ms_max": max(ms),
               "device_ms": sum(ev.self_device_time_total for ev in evs)
               / 1e3 / 5,
               "device_launches": sum(ev.count for ev in evs) / 5,
               "gather_scatter_device_ms": sum(
                   ev.self_device_time_total for ev in evs
                   if "gather_scatter" in ev.key) / 1e3 / 5}
        if name == "gcn-cora":
            src, dst = b["src"], b["dst"]
            n = shape.n_nodes
            x = b["feats"]
            csr = gs_ops.EdgeCSR.build(src, dst, n)
            gs_ops.gather_scatter(x, src, dst, n, None, "mean", csr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                gs_ops.gather_scatter(x, src, dst, n, None, "mean", csr)
            row["forward_enqueue_ms"] = (time.perf_counter() - t0) * 10
            torch.cuda.synchronize()
            builds = []
            for _ in range(20):
                t0 = time.perf_counter()
                gs_ops.EdgeCSR.build(src, dst, n).transposed()
                torch.cuda.synchronize()
                builds.append((time.perf_counter() - t0) * 1e3)
            row["csr_build_both_ms_median"] = statistics.median(builds)
        out[name] = row
        print(f"[{label}] gnn-small {name}: " + " ".join(
            f"{k}={v:.4f}" for k, v in row.items()), flush=True)
        del model, state, b
    return out


def main() -> int:
    root, label, out = (os.path.abspath(sys.argv[1]), sys.argv[2],
                        os.path.abspath(sys.argv[3]))
    attention_only = "--attention-only" in sys.argv[4:]
    gnn_only = "--gnn-only" in sys.argv[4:]
    os.chdir(root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    t = time.time()
    build.build_all()
    print(f"[{label}] build s {time.time() - t:.1f}", flush=True)
    for name, text in build.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{label}] {name}: {line.strip()}", flush=True)
    t = time.time()
    if gnn_only:
        res = {"gather_scatter": chip_smoke.kernel_gather_scatter(
            torch, torch.device("cuda"))}
        for case, row in res["gather_scatter"]["cases"].items():
            print(f"[{label}] {case}: " + " ".join(
                f"{k}={v:.4f}" for k, v in row.items()
                if k.endswith("ms") and isinstance(v, float)), flush=True)
    else:
        res = {} if attention_only else chip_smoke.phase_kernels(torch,
                                                                 1_000_000)
    print(f"[{label}] phase_kernels s {time.time() - t:.1f}", flush=True)
    gs = os.path.isdir(os.path.join(root, "src", "repro_torch", "kernels",
                                    "gather_scatter"))
    for extra in (None, "device_ms"):
        if extra:
            res[extra] = {} if gnn_only else attention_device_times(torch,
                                                                    label)
            if gs:
                res[extra].update(gather_scatter_device_times(torch, label))
            if gnn_only:
                res["cora_rows"] = cora_rows_times(torch, label)
                res["gnn_small"] = gnn_small_times(torch, label)
        with open(out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
