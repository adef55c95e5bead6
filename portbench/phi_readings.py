"""The readings the φ limits are set from, for the φ cell, in one process
(the benchmark's own runs never run this).

    python3 portbench/phi_readings.py --workload <cell> \\
        --controls fp8_routed,capacity_1.25 --seeds 1,2 --seconds 2 \\
        [--out file.jsonl]

For each control and each seed: a run of the cell (``run.run_cell``, a
short window) with the program changed underneath, its numbers; ``program``
runs it unchanged:

* ``fp8_routed``: the routed experts' products with operands rounded to
  fp8 e4m3, the precision below the configuration's bf16 (scaled a row of
  the activations and a column of each expert's weights, as fp8 inference
  scales them);
* ``fp8_experts``: the same for the routed and the shared experts;
* ``capacity_1.25``: capacity routing (the port's default: 1.25 times a
  row's fair share an expert, the rest dropped) in place of dropless;
* ``expert_dropped``: expert 0's output left out (a planted fault).

Each line printed is one JSON object: the seed, who, the numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from portbench import run  # noqa: E402

FP8_MAX = 448.0


def to_fp8(t: torch.Tensor, dim) -> torch.Tensor:
    """t with each slice along ``dim`` scaled to fp8 e4m3's range, rounded
    to e4m3 and scaled back, in t's dtype."""
    scale = t.float().abs().amax(dim=dim, keepdim=True).clamp_min(
        1e-12) / FP8_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float()
    return (q * scale).to(t.dtype)


@contextlib.contextmanager
def fp8_routed():
    from repro_torch.models import moe
    real = moe.grouped_mm
    moe.grouped_mm = lambda x, w, ends: real(to_fp8(x, -1), to_fp8(w, -2),
                                             ends)
    try:
        yield
    finally:
        moe.grouped_mm = real


@contextlib.contextmanager
def fp8_experts():
    import torch.nn.functional as F
    from repro_torch.models import moe
    real = moe.shared_experts

    def shared(x, w_gate, w_up, w_down):
        xq = to_fp8(x, -1)
        h = F.silu(xq @ to_fp8(w_gate, -2)) * (xq @ to_fp8(w_up, -2))
        return to_fp8(h, -1) @ to_fp8(w_down, -2)
    moe.shared_experts = shared
    try:
        with fp8_routed():
            yield
    finally:
        moe.shared_experts = real


@contextlib.contextmanager
def capacity_routing(factor: float = 1.25):
    from repro_torch.models import transformer
    real = transformer.moe_ffn

    def capped(params, x, cfg, rules=None):
        return real(params, x, dataclasses.replace(
            cfg, dropless=False, capacity_factor=factor), rules)
    transformer.moe_ffn = capped
    try:
        yield
    finally:
        transformer.moe_ffn = real


@contextlib.contextmanager
def expert_dropped():
    from repro_torch.models import moe
    real = moe.grouped_mm

    def dropped(x, w, ends):
        out = real(x, w, ends)
        out[:int(ends[0])] = 0
        return out
    moe.grouped_mm = dropped
    try:
        yield
    finally:
        moe.grouped_mm = real


CONTROLS = {"fp8_routed": fp8_routed, "fp8_experts": fp8_experts,
            "capacity_1.25": capacity_routing,
            "expert_dropped": expert_dropped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--controls", default=",".join(CONTROLS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    try:
        for who in filter(None, args.controls.split(",")):
            for s in filter(None, args.seeds.split(",")):
                t0 = time.perf_counter()
                with (contextlib.nullcontext() if who == "program"
                      else CONTROLS[who]()):
                    res = run.run_cell(args.workload, int(s), args.seconds,
                                       False, "cuda", t_start=t0)
                line = json.dumps({
                    "workload": args.workload, "seed": int(s), "who": who,
                    "correct": res["correct"],
                    "numbers": {n: r["value"]
                                for n, r in res["check"].items()},
                    "metrics": {n: r["value"]
                                for n, r in res["metrics"].items()},
                    "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
