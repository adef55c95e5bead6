"""The readings the Mellum2 cell's limits are set from, in one process (the
benchmark's own runs never run this).

    python3 portbench/mellum2_readings.py --workload <cell> \\
        --controls program,fp8_attention,window_960 --seeds 1,2 \\
        --seconds 2 [--out file.jsonl]

``phi_readings.py``'s loop (a run of the cell a control and a seed, its
numbers, one JSON line each) with these controls beside its own, each a
change to the program underneath:

* ``fp8_attention``: every attention call's q, k and v rounded to fp8
  e4m3 (a row of 128 a scale), the precision below the configuration's
  bf16 for what ``attn_window_err`` judges;
* ``sliding_full``: the sliding layers' attention with no window (full
  causal);
* ``window_960``: their window 960 keys in place of 1,024 (15/16 of it);
* ``plain_rope``: the full layers rotated by plain RoPE in place of YaRN.

``fp8_routed`` (the experts' products with fp8 e4m3 operands, the
precision below the configuration's bf16) is ``phi_readings``' own.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import phi_readings  # noqa: E402


@contextlib.contextmanager
def _windows(change):
    """Every attention call's window w made ``change(w)``."""
    from repro_torch.models import transformer
    real = transformer.chunked_attention

    def changed(q, k, v, window=0, **kw):
        return real(q, k, v, window=change(window), **kw)
    transformer.chunked_attention = changed
    try:
        yield
    finally:
        transformer.chunked_attention = real


@contextlib.contextmanager
def fp8_attention():
    from repro_torch.models import transformer
    real = transformer.chunked_attention

    def rounded(q, k, v, **kw):
        return real(*(phi_readings.to_fp8(t, -1) for t in (q, k, v)), **kw)
    transformer.chunked_attention = rounded
    try:
        yield
    finally:
        transformer.chunked_attention = real


@contextlib.contextmanager
def plain_rope():
    from repro_torch.models import transformer
    real = transformer.rotary_cos_sin

    def plain(positions, head_dim, theta, dtype=None, yarn=None):
        return real(positions, head_dim, theta)
    transformer.rotary_cos_sin = plain
    try:
        yield
    finally:
        transformer.rotary_cos_sin = real


CONTROLS = {"fp8_attention": fp8_attention,
            "sliding_full": lambda: _windows(lambda w: 0),
            "window_960": lambda: _windows(lambda w: w * 15 // 16),
            "plain_rope": plain_rope}


def main(argv=None) -> int:
    phi_readings.CONTROLS.update(CONTROLS)
    return phi_readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
