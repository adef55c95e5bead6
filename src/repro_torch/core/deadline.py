"""End-to-end query deadlines: one budget, every layer clamps to it.

A :class:`Deadline` is created once per query (``session.run(...,
deadline_ms=)``, ``ClusterConfig.default_deadline_ms``, or the serving
engine's admission path) and the *same object* rides in every
``ExecutionContext`` the query spawns -- scatter-gather shard legs, hedge
races, retry loops, AIPM waits.  Each layer asks ``remaining()`` and either
finishes inside it, degrades inside it (see the degradation ladder in the
cost model / executor), or raises :class:`DeadlineExceeded` fast instead of
blocking on its own fixed timeout knob.

Because the object is shared, it is also the natural per-query scoreboard
for *how* the budget was met: ``degradations`` records each ladder step the
planner took (``skip_rerank``, ``cap_nprobe``, ``relax_accuracy``,
``partial_topk``) and ``approximate`` flags results whose scores are ADC
approximations rather than exact re-ranked values.  Cursors surface both so
callers can distinguish exact from best-effort answers.

No deadline (``None`` everywhere) means every check is a no-op -- the
ladder is provably inert and behavior is byte-identical to a build without
this module.
"""
from __future__ import annotations

import time
from typing import List, Optional, Union


class DeadlineExceeded(RuntimeError):
    """A query ran out of its per-request time budget.

    Raised at chunk boundaries, AIPM waits, retry loops, and hedge races --
    always *before* starting work that cannot finish in time, so the caller
    observes failure within about one chunk interval of the stated budget.
    """

    def __init__(self, where: str, budget_ms: float, elapsed_ms: float) -> None:
        super().__init__(
            f"deadline exceeded at {where}: "
            f"budget {budget_ms:.1f}ms, elapsed {elapsed_ms:.1f}ms")
        self.where = where
        self.budget_ms = budget_ms
        self.elapsed_ms = elapsed_ms


class OverloadedError(RuntimeError):
    """The serving engine declined to run a query (queue full, or the cost
    model's service estimate exceeds the request's remaining budget).

    ``retry_after_s`` is the engine's estimate of when capacity frees up --
    clients that honor it spread retries instead of thundering back.
    """

    def __init__(self, msg: str, retry_after_s: float = 0.0) -> None:
        super().__init__(f"{msg} (retry after {retry_after_s * 1000:.0f}ms)")
        self.retry_after_s = retry_after_s


class Deadline:
    """Wall-clock budget shared by every leg of one query."""

    __slots__ = ("t0", "budget_s", "degradations", "approximate")

    def __init__(self, budget_s: float, t0: Optional[float] = None) -> None:
        self.t0 = time.perf_counter() if t0 is None else t0
        self.budget_s = float(budget_s)
        #: ordered, de-duplicated ladder steps taken for this query
        self.degradations: List[str] = []
        #: True once any step returned approximate (non-re-ranked) scores
        self.approximate = False

    @classmethod
    def start(cls, budget_ms: float) -> "Deadline":
        return cls(budget_ms / 1000.0)

    @staticmethod
    def resolve(*candidates: Union["Deadline", float, int, None]
                ) -> Optional["Deadline"]:
        """First candidate that names a budget wins: a Deadline passes
        through unchanged (so a server-admitted budget keeps ticking from
        admission, not from dequeue), a positive number starts a fresh
        budget of that many milliseconds, ``None``/``0`` falls through."""
        for cand in candidates:
            if isinstance(cand, Deadline):
                return cand
            if cand:
                return Deadline.start(float(cand))
        return None

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def remaining(self) -> float:
        return self.budget_s - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, where: str) -> None:
        """Raise :class:`DeadlineExceeded` if the budget is gone."""
        elapsed = self.elapsed()
        if elapsed >= self.budget_s:
            raise DeadlineExceeded(where, self.budget_s * 1000, elapsed * 1000)

    def clamp(self, timeout_s: float) -> float:
        """A wait no longer than both ``timeout_s`` and the remaining
        budget (floored at 0 so expired deadlines poll, not block)."""
        return max(0.0, min(timeout_s, self.remaining()))

    def note_degradation(self, step: str, approximate: bool = False) -> None:
        if step not in self.degradations:
            self.degradations.append(step)
        if approximate:
            self.approximate = True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Deadline(budget={self.budget_s * 1000:.1f}ms, "
                f"remaining={self.remaining() * 1000:.1f}ms, "
                f"degradations={self.degradations})")
