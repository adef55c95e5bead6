#!/usr/bin/env python3
"""Phase 1 of ``chip_smoke.py`` (every kernel against its plain version,
timed) for one checkout of the repository, to compare two trees on one
card in one run:

    python3 kernel_phase.py <tree root> <label> <out.json>

Builds the tree's kernels, prints ptxas' register and spill lines and each
kernel case's line, and writes the phase's numbers to ``out.json``.  Run
it for parent, change, change, parent in one run on the card.
"""
import json
import os
import sys
import time


def main() -> int:
    root, label, out = (os.path.abspath(sys.argv[1]), sys.argv[2],
                        os.path.abspath(sys.argv[3]))
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
    res = chip_smoke.phase_kernels(torch, 1_000_000)
    print(f"[{label}] phase_kernels s {time.time() - t:.1f}", flush=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
