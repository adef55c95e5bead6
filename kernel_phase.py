#!/usr/bin/env python3
"""Phase 1 of ``chip_smoke.py`` (every kernel against its plain version,
timed) for one checkout of the repository, to compare two trees on one
card in one run:

    python3 kernel_phase.py <tree root> <label> <out.json> [--attention-only]

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
float32, mean; forward, and the backward's launch at d = 128) beside
``torch.sparse.mm`` on a CSR tensor of the same weights, with the CSR's
build (one stable sort) apart.
"""
import inspect
import json
import os
import sys
import time


RUNS = 20


def device_ms_by_kernel(torch, fn, runs: int = RUNS) -> dict:
    """Device time of one call of ``fn`` by kernel (name: ms): the time
    each ran on the card under ``torch.profiler`` over ``runs`` calls
    after one warm-up, divided by ``runs``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total / 1e3 / runs
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


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
    it), and the CSR's build; inputs as phase 1 makes them."""
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
        torch, lambda: gs_ops.EdgeCSR.build(src, dst, n))}
    csr = gs_ops.EdgeCSR.build(src, dst, n)
    ws = mask[csr.perm]
    a = torch.sparse_csr_tensor(csr.ptr, csr.col.long(), ws, size=(n, n))
    scale = (1.0 / csr.count.clamp(min=1.0))[:, None]
    gen = torch.Generator(device=dev).manual_seed(5)
    for d in (100, 128):
        x = torch.randn(n, d, device=dev, generator=gen)
        out[f"gather_scatter products d={d} mean"] = device_ms(
            torch, lambda: gs_ops.gather_scatter(x, src, dst, n, mask,
                                                 "mean", csr), 5)
        out[f"gather_scatter products d={d} sparse.mm"] = device_ms(
            torch, lambda: torch.sparse.mm(a, x) * scale, 5)
        del x
    ptr_t, perm_t, col_t = csr.transposed()
    wb = mask[perm_t] / csr.count.clamp(min=1.0)[col_t.long()]
    g = torch.randn(n, 128, device=dev, generator=gen)
    out["gather_scatter products d=128 backward launch"] = device_ms(
        torch, lambda: gs_ops.launch(g, ptr_t, col_t, wb, False,
                                     torch.float32), 5)
    for key, ms in out.items():
        print(f"[{label}] device_ms {key}: {ms:.4f}", flush=True)
    return out


def main() -> int:
    root, label, out = (os.path.abspath(sys.argv[1]), sys.argv[2],
                        os.path.abspath(sys.argv[3]))
    attention_only = "--attention-only" in sys.argv[4:]
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
    res = {} if attention_only else chip_smoke.phase_kernels(torch, 1_000_000)
    print(f"[{label}] phase_kernels s {time.time() - t:.1f}", flush=True)
    gs = os.path.isdir(os.path.join(root, "src", "repro_torch", "kernels",
                                    "gather_scatter"))
    for extra in (None, "device_ms"):
        if extra:
            res[extra] = attention_device_times(torch, label)
            if gs:
                res[extra].update(gather_scatter_device_times(torch, label))
        with open(out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
