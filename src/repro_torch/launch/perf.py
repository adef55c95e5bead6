"""Perf-iteration runner, the reference's ``launch/perf.py``: count one
cell VARIANT's step on the ``meta`` device (``launch/op_analysis.py``),
for one device of a mesh, print its roofline terms against the H100's
peaks (``collective_s`` among them) and its top contributors (the top
collectives among them), and keep the result in ``results/perf_torch/``.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3-8b \\
      --shape train_4k --variant fsdp_only --mesh single
  PYTHONPATH=src python -m repro_torch.launch.perf --list

A variant is a (rule_overrides, cfg_overrides) pair registered per cell
below (the reference's registry as it is).  On mesh ``one`` rules change
only the specs, so a variant's count moves with its ``cfg`` overrides
alone; on ``single`` and ``multi`` (the reference's meshes) the step runs
on DTensors over this process's fake group (``launch/dryrun.py``), and the
rules move the count too.  ``flags`` have no reader in either package.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.configs import get_arch
from repro_torch.launch.mesh import ONE, peak_flops
from repro_torch.launch.op_analysis import analyze, roofline
from repro_torch.launch.steps import build_step

# ---------------------------------------------------------------------------
# variant registry: cell -> name -> dict(rules=..., cfg=...)
# ---------------------------------------------------------------------------

VARIANTS = {
    ("llama3-8b", "train_4k"): {
        "baseline": {},
        # H1: pure FSDP -- fold the model axis into data-parallel batch,
        # shard params over BOTH axes; kills the Megatron activation
        # all-reduces entirely.
        "fsdp_only": {"rules": {
            "batch": ("data", "model"),
            "heads": None, "mlp": None, "vocab": None, "kv_heads": None,
            "p_heads": "model", "p_mlp": "model", "p_vocab": "model",
            "p_kv_heads": None,      # kv=8 < model axis: data-shard via d only
        }},
        # H2: fewer microbatches (fewer FSDP regathers, more activation mem)
        "accum2": {"cfg": {"grad_accum": 2}},
        # H3: larger attention KV blocks (fewer score-chain materializations)
        "blk4096": {"cfg": {"attn_block_kv": 4096}},
        # H4: fused rmsnorm (no fp32 materialization)
        "fused_norm": {"cfg": {"fused_norm": True}},
        # H5: bf16 softmax weights
        "bf16_probs": {"cfg": {"bf16_probs": True}},
        # H6b: fsdp with accum=1 (microbatch must cover the full mesh)
        "fsdp_accum1": {"rules": {
            "batch": ("data", "model"),
            "heads": None, "mlp": None, "vocab": None, "kv_heads": None,
            "p_heads": "model", "p_mlp": "model", "p_vocab": "model",
            "p_kv_heads": None},
            "cfg": {"grad_accum": 1, "attn_block_kv": 4096,
                    "fused_norm": True}},
        # H7: fsdp_accum1 + bf16 softmax weights (single-block: no rescale)
        "combo": {"rules": {
            "batch": ("data", "model"),
            "heads": None, "mlp": None, "vocab": None, "kv_heads": None,
            "p_heads": "model", "p_mlp": "model", "p_vocab": "model",
            "p_kv_heads": None},
            "cfg": {"grad_accum": 1, "attn_block_kv": 4096,
                    "fused_norm": True, "bf16_probs": True}},
    },
    ("deepseek-v2-236b", "train_4k"): {
        "baseline": {},
        "accum8": {"cfg": {"grad_accum": 8}},
        "accum32": {"cfg": {"grad_accum": 32}},
        # EP-heavy: keep experts on model axis but stop sharding attn heads
        # (MLA latent is small; replicating attention kills its all-reduces)
        "ep_only_attn_replicated": {"rules": {
            "heads": None, "p_heads": None, "mlp": None, "vocab": None}},
        # capacity factor reduction (less dispatch padding)
        "cap1": {"cfg": {"capacity_factor": 1.0}},
        "fused_norm": {"cfg": {"fused_norm": True}},
        "blk4096": {"cfg": {"attn_block_kv": 4096}},
        "combo": {"cfg": {"fused_norm": True, "grad_accum": 8,
                          "attn_block_kv": 4096}},
        # H8: vmapped combine scatter (batch-local; code change) + winners
        "vmap_combine": {"cfg": {"attn_block_kv": 4096,
                                 "capacity_factor": 1.0}},
    },
    ("equiformer-v2", "ogb_products"): {
        # NOTE: "baseline" now includes the SH-row fast-logits pass-1 (code
        # change); the pre-change baseline is the dry-run JSON.  Name it
        # explicitly for the §Perf log.
        "baseline": {},
        "fast_logits": {},
        "fast_logits_remat": {},
        "rowln_stopgrad": {},
        "custom_vjp": {},
        "custom_vjp_rows": {},
        "pin_channel": {},
        "custom_vjp_bf16": {"cfg": {"dtype": "bfloat16"}},
        # bf16 irrep features end-to-end + remat
        "bf16_remat": {"cfg": {"dtype": "bfloat16"}},
    },
    ("autoint", "retrieval_cand"): {
        "baseline": {},
        # score in bf16 (candidates are the dominant read)
        "bf16_cands": {"flags": {"bf16_cands": True}},
    },
}


def run_variant(arch: str, shape: str, variant: str,
                out_dir: str = "results/perf_torch", mesh: str = "one"
                ) -> Dict[str, Any]:
    """Count one variant's step on meta for one device of ``mesh``
    (``one``, ``single`` or ``multi``; the last two start this process's
    fake group) and write ``<arch>__<shape>__<variant>.json`` (with
    ``__<mesh>`` past mesh ``one``) under ``out_dir``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch.dryrun import fake_mesh

    spec = VARIANTS.get((arch, shape), {"baseline": {}})
    v = spec[variant]
    t0 = time.perf_counter()
    m = ONE if mesh == "one" else fake_mesh(mesh)
    bundle = build_step(arch, shape, m, rule_overrides=v.get("rules"),
                        cfg_overrides=v.get("cfg"))
    args = bundle.abstract_args
    if mesh != "one":
        args = tuple(place_tree(a, s, m) for a, s in zip(args,
                                                         bundle.in_specs))
    with implicit_replication():
        an = analyze(bundle.fn, *args)
    model = get_arch(arch).model
    dtype = (v.get("cfg") or {}).get("dtype", getattr(model, "dtype",
                                                      "float32"))
    d = an.as_dict()
    res = {"arch": arch, "shape": shape, "variant": variant, "mesh": mesh,
           "seconds": time.perf_counter() - t0,
           **roofline(an, peak_flops(dtype)),
           "peak_gb": an.peak_bytes / 1e9, "kernels": d["kernels"],
           "collectives": d["collectives"],
           "top_bytes": d["top_bytes"], "top_flops": d["top_flops"][:6],
           "top_collectives": d["top_collectives"],
           "repeats": d["repeats"]}
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tail = "" if mesh == "one" else f"__{mesh}"
    (out / f"{arch}__{shape}__{variant}{tail}.json").write_text(
        json.dumps(res, indent=1))
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="results/perf_torch")
    ap.add_argument("--mesh", choices=["one", "single", "multi"],
                    default="one")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for (a, s), vs in VARIANTS.items():
            print(f"{a} x {s}: {sorted(vs)}")
        return 0
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --list")
    res = run_variant(args.arch, args.shape, args.variant, args.out,
                      args.mesh)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("top_bytes", "top_flops",
                                   "top_collectives")}, indent=1))
    print("--- top bytes ---")
    for k, v in res["top_bytes"]:
        print(f"  {v / 1e9:10.1f} GB  {k}")
    print("--- top collectives ---")
    for k, v in res["top_collectives"]:
        print(f"  {v / 1e9:10.1f} GB  {k}")
    print("--- top flops ---")
    for k, v in res["top_flops"]:
        print(f"  {v / 1e12:10.1f} TFLOP  {k}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
