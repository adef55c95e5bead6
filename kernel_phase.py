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
training shape (B=2, S=4,096) beside SDPA's forward + backward.
"""
import inspect
import json
import os
import sys
import time


RUNS = 20


def device_ms(torch, fn, runs: int = RUNS) -> float:
    """Device time of one call of ``fn``: the time its kernels ran on the
    card under ``torch.profiler`` over ``runs`` calls after one warm-up,
    divided by ``runs``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA)
    return us / 1e3 / runs


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
        out["flash_bwd train"] = device_ms(
            torch, lambda: flash_attention_bwd(q, k, v, o, m, l, do))
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
    for extra in (None, "device_ms"):
        if extra:
            res[extra] = attention_device_times(torch, label)
        with open(out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
