"""Cost model + operator-speed statistics service (paper §V-B).

|σ_p| = Σcost / |T| : observed average per-row time of an operator, kept as
an EWMA in the statistics service and updated after every execution.

Est(o) = E[speed(o)|S] * Σ(row, T) : expected cost of running operator ``o``
over input table T (Definition 5.1).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.pandadb import CostModelConfig
from repro_torch.core import logical_plan as lp
from repro_torch.core.cypherplus import Compare, is_semantic


class StatisticsService:
    """Metadata service holding per-operator average speeds (s/row)."""

    def __init__(self, cfg: Optional[CostModelConfig] = None) -> None:
        self.cfg = cfg or CostModelConfig()
        self.speeds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # cardinality statistics
        self.n_nodes = 1
        self.label_counts: Dict[str, int] = {}
        self.avg_degree: float = 4.0
        self.structured_selectivity: float = 0.1
        self.semantic_selectivity: float = 0.5
        # epoch bumps whenever a refresh observes changed cardinalities or a
        # changed extractor serial; the plan cache keys on it so stale plans
        # are re-optimized, not reused
        self.epoch = 0
        self._graph_sig: Optional[tuple] = None
        self._extractor_serials: Dict[str, int] = {}
        # observed escalation fraction per φ family (proxy cascades): what
        # share of proxy-scored rows actually fell inside [lo, hi]
        self._escalation: Dict[str, float] = {}
        # per-shard recent read latencies (replica sets): the hedge deadline
        # is a quantile over this window
        self._replica_lat: Dict[int, "deque[float]"] = {}

    # -- speed statistics ------------------------------------------------------

    def op_key(self, op: lp.PlanOp) -> str:
        if isinstance(op, lp.SemanticFilter):
            # one speed entry per sub-property extractor family; the cascade
            # tier gets its own entry so proxy-routed chunks never pollute
            # the direct-φ EWMA (their per-row times differ by ~1/esc_frac)
            base = f"semantic_filter:{_sem_key(op.predicate)}"
            acc = getattr(op, "accuracy", None)
            return f"{base}:cascade" if acc is not None and acc < 1.0 else base
        return type(op).__name__.lower()

    def record(self, key: str, total_time: float, n_rows: int) -> None:
        """|σ_p| = Σ(cost) / |T| folded into an EWMA."""
        if n_rows <= 0:
            return
        speed = total_time / n_rows
        a = self.cfg.ewma_alpha
        old = self.speeds.get(key)
        if old is None and key.startswith("semantic_filter:"):
            # first real measurement of a φ family replaces the prior
            # (paper-calibrated default, often off by orders of magnitude);
            # bump the epoch so cached plans re-optimize with the truth
            self.epoch += 1
        self.speeds[key] = speed if old is None else a * speed + (1 - a) * old
        self.counts[key] = self.counts.get(key, 0) + n_rows

    def expected_speed(self, op: lp.PlanOp) -> float:
        """E[speed(o)|S] with paper-calibrated priors."""
        key = self.op_key(op)
        if key in self.speeds:
            return self.speeds[key]
        if isinstance(op, lp.SemanticFilter):
            if key.endswith(":cascade"):
                # unmeasured cascade tier: derive from the direct tier --
                # every row pays the proxy, escalated rows also pay φ
                sub = _sem_key(op.predicate)
                return (self.proxy_scan_speed()
                        + self.escalation_fraction(sub) * self.phi_speed(sub))
            return self.cfg.default_semantic_speed      # 0.3 s/row (paper §VI-B)
        if isinstance(op, (lp.Filter, lp.AllNodeScan, lp.NodeByLabelScan,
                           lp.Projection)):
            return self.cfg.default_structured_speed
        if isinstance(op, lp.Expand):
            return 2 * self.cfg.default_structured_speed
        if isinstance(op, lp.Join):
            return 3 * self.cfg.default_structured_speed
        return self.cfg.default_structured_speed

    # -- kNN scan throughput (index pushdown) ----------------------------------

    _KNN_KEY = "knn_scan"
    _PQ_KEY = "pq_scan"
    _FUSED_KEY = "fused_scan"

    def _record_scan(self, key: str, total_time: float,
                     rows_scanned: int) -> None:
        """Observed index-scan throughput (s per corpus row x query), EWMA'd
        like any operator speed.  The first real measurement replaces the
        config prior and bumps the epoch so cached plans re-optimize with
        the truth -- same contract as the semantic-filter speeds."""
        if rows_scanned <= 0:
            return
        speed = total_time / rows_scanned
        a = self.cfg.ewma_alpha
        old = self.speeds.get(key)
        if old is None:
            self.epoch += 1
        self.speeds[key] = (speed if old is None
                            else a * speed + (1 - a) * old)
        self.counts[key] = self.counts.get(key, 0) + rows_scanned

    def record_knn_scan(self, total_time: float, rows_scanned: int) -> None:
        """Float-scan throughput feedback (see :meth:`_record_scan`)."""
        self._record_scan(self._KNN_KEY, total_time, rows_scanned)

    def record_pq_scan(self, total_time: float, rows_scanned: int) -> None:
        """ADC-scan throughput feedback (uint8 code rows; includes the
        LUT build and the exact re-rank of k' candidates, so the EWMA
        prices the *whole* two-stage path per scanned row)."""
        self._record_scan(self._PQ_KEY, total_time, rows_scanned)

    def record_fused_scan(self, total_time: float, rows_scanned: int) -> None:
        """Fused probe->ADC->top-k throughput feedback: ``rows_scanned`` is
        q x the *whole* code table (the fused scan touches every row and
        masks in-kernel), so the EWMA prices its single-dispatch batch cost
        against the staged path's per-signature-group dispatches."""
        self._record_scan(self._FUSED_KEY, total_time, rows_scanned)

    def knn_scan_speed(self) -> float:
        return self.speeds.get(self._KNN_KEY, self.cfg.default_knn_scan_speed)

    def pq_scan_speed(self) -> float:
        return self.speeds.get(self._PQ_KEY, self.cfg.default_pq_scan_speed)

    def fused_scan_speed(self) -> float:
        return self.speeds.get(self._FUSED_KEY,
                               self.cfg.default_fused_scan_speed)

    def has_fused_truth(self) -> bool:
        """Whether a fused scan has actually been observed (the prior is
        not evidence: ``choose_knn_scan`` only picks "fused" on truth, so
        a cold service never routes a batch through an unmeasured path)."""
        return self._FUSED_KEY in self.speeds

    def knn_cost(self, n_total: int, m: int, nprobe: int, q: int = 1) -> float:
        """Estimated cost of a kNN over ``q`` queries: centroid probe
        (m rows) + exact scan of the probed fraction (nprobe/m of the
        corpus), both priced at the observed scan throughput."""
        nprobe = min(max(1, nprobe), max(1, m))
        probed = n_total * nprobe / max(1, m)
        return self.knn_scan_speed() * q * (m + probed)

    def choose_knn_nprobe(self, index, q: int = 1) -> int:
        """Pick exact scan vs IVF probe for this query batch: when probing
        ``cfg.nprobe`` buckets is estimated no cheaper than scanning the
        whole corpus (small index, nprobe ~ m), probe every bucket -- the
        batched path then degenerates to one exact fused scan and recall is
        free.  Otherwise keep the configured probe width."""
        m = index.centroids.shape[0]
        nprobe = min(index.cfg.nprobe, m)
        cost_ivf = self.knn_cost(index.n_total, m, nprobe, q)
        cost_exact = self.knn_cost(index.n_total, m, m, q)
        return m if cost_exact <= cost_ivf else nprobe

    def pq_cost(self, n_total: int, m: int, nprobe: int, q: int = 1,
                k_prime: int = 0) -> float:
        """Estimated cost of the two-stage ADC path: the centroid probe
        (m *float* rows -- identical work to the float path, priced the
        same), the uint8 ADC scan of the probed fraction at the observed
        code-row throughput, and an exact re-rank of ``k_prime`` candidate
        rows per query priced at the float scan throughput."""
        nprobe = min(max(1, nprobe), max(1, m))
        probed = n_total * nprobe / max(1, m)
        probe = self.knn_scan_speed() * q * m
        scan = self.pq_scan_speed() * q * probed
        rerank = self.knn_scan_speed() * q * k_prime
        return probe + scan + rerank

    def fused_cost(self, n_total: int, m: int, q: int = 1,
                   k_prime: int = 0) -> float:
        """Estimated cost of the fused probe->ADC->top-k path: the centroid
        probe (shared with the staged paths), one whole-table masked ADC
        scan at the observed fused throughput (no per-signature gathers or
        dispatches -- the mask is in-kernel), and the exact re-rank of
        ``k_prime`` candidates per query."""
        probe = self.knn_scan_speed() * q * m
        scan = self.fused_scan_speed() * q * n_total
        rerank = self.knn_scan_speed() * q * k_prime
        return probe + scan + rerank

    def negotiate_knn_budget(self, index, q: int, nprobe: int, k: int,
                             remaining_s: float
                             ) -> Tuple[int, bool, List[str]]:
        """Degradation ladder for one index kNN under a deadline: given the
        planned probe width and the budget still left, walk the ladder until
        the estimated cost fits (or the cheapest shape is reached).

        Step 1 -- ``skip_rerank``: drop the exact PQ re-rank and return raw
        ADC scores (callers flag the result ``approximate``).  Step 2 --
        ``cap_nprobe``: halve the probe width down to 1 bucket.  Returns
        ``(nprobe, rerank, steps)``; with a comfortable budget (or a plain
        float index where no step applies) everything is unchanged and
        ``steps`` is empty, so no-deadline behavior is untouched."""
        steps: List[str] = []
        rerank = True
        m = index.centroids.shape[0]
        has_pq = index.pq is not None and index.codes is not None
        k_prime = index.cfg.rerank_mult * k if has_pq else 0

        def est(npb: int, kp: int) -> float:
            if has_pq:
                return self.pq_cost(index.n_total, m, npb, q, kp)
            return self.knn_cost(index.n_total, m, npb, q)

        if remaining_s <= 0 or est(nprobe, k_prime) <= remaining_s:
            return nprobe, rerank, steps
        if k_prime:
            steps.append("skip_rerank")
            rerank, k_prime = False, 0
            if est(nprobe, 0) <= remaining_s:
                return nprobe, rerank, steps
        if nprobe > 1:
            steps.append("cap_nprobe")
            while nprobe > 1 and est(nprobe, k_prime) > remaining_s:
                nprobe = max(1, nprobe // 2)
        return nprobe, rerank, steps

    def choose_knn_scan(self, index, q: int = 1, k: int = 10) -> str:
        """Scan layout for this query batch, from the observed throughputs:
        ``"adc"`` (staged per-signature ADC + re-rank), ``"float"`` (plain
        float scan) or ``"fused"`` (one masked whole-table ADC dispatch).

        The ADC scan saves bandwidth proportionally to the corpus size and
        the re-rank adds a fixed per-query k' cost -- so big corpora go
        ``"adc"`` and tiny ones stay ``"float"``.  The fused path trades
        scanning *every* code row for dispatching exactly once per batch;
        it is only chosen once its throughput has actually been observed
        (``record_fused_scan``), for multi-query batches on a compacted
        index (pending appends fall back to staged gathers)."""
        if index.pq is None or index.codes is None:
            return "float"
        m = index.centroids.shape[0]
        nprobe = self.choose_knn_nprobe(index, q)
        k_prime = index.cfg.rerank_mult * k
        cost_adc = self.pq_cost(index.n_total, m, nprobe, q, k_prime)
        cost_float = self.knn_cost(index.n_total, m, nprobe, q)
        if (q > 1 and index.pending_count == 0 and self.has_fused_truth()):
            cost_fused = self.fused_cost(index.n_total, m, q, k_prime)
            if cost_fused <= min(cost_adc, cost_float):
                return "fused"
        return "adc" if cost_adc <= cost_float else "float"

    # -- proxy-first cascades (accuracy-targeted semantic predicates) ----------

    _PROXY_KEY = "proxy_scan"

    def record_proxy_scan(self, total_time: float, rows_scored: int) -> None:
        """Observed proxy-scoring throughput (s per row scored, including the
        proxy φ call and the similarity/routing arithmetic).  First truth
        replaces the config prior and bumps the epoch -- same contract as the
        index-scan speeds."""
        self._record_scan(self._PROXY_KEY, total_time, rows_scored)

    def proxy_scan_speed(self) -> float:
        return self.speeds.get(self._PROXY_KEY,
                               self.cfg.default_proxy_scan_speed)

    def has_proxy_truth(self) -> bool:
        return self._PROXY_KEY in self.speeds

    def record_escalation(self, sub_key: str, escalated: int,
                          scored: int) -> None:
        """Observed escalation fraction for one cascade chunk, EWMA'd per φ
        family.  The first real observation replaces the config prior and
        bumps the epoch: the fraction scales the φ term of ``cascade_cost``,
        so plans chosen under the prior deserve a re-optimize."""
        if scored <= 0:
            return
        frac = escalated / scored
        a = self.cfg.ewma_alpha
        old = self._escalation.get(sub_key)
        if old is None:
            self.epoch += 1
        self._escalation[sub_key] = (frac if old is None
                                     else a * frac + (1 - a) * old)

    def escalation_fraction(self, sub_key: str) -> float:
        return self._escalation.get(sub_key, self.cfg.default_escalation_frac)

    def phi_speed(self, sub_key: str) -> float:
        """Direct-φ per-row speed for one family (observed or prior)."""
        return self.speeds.get(f"semantic_filter:{sub_key}",
                               self.cfg.default_semantic_speed)

    def cascade_cost(self, n_rows: float, sub_key: str,
                     escalation: Optional[float] = None) -> float:
        """Estimated cost of cascading one semantic predicate over
        ``n_rows``: every row is proxy-scored, the escalated fraction also
        pays the exact φ.  ``escalation`` overrides the observed EWMA (the
        calibrator's expected fraction for the query's specific target)."""
        frac = (self.escalation_fraction(sub_key)
                if escalation is None else float(escalation))
        return n_rows * (self.proxy_scan_speed()
                         + frac * self.phi_speed(sub_key))

    def choose_semantic_path(self, sub_key: str, n_rows: float,
                             calibrated: bool,
                             escalation: Optional[float] = None) -> str:
        """``"cascade"`` vs ``"direct"`` for one semantic predicate.  Only a
        calibrated cascade is eligible (no thresholds -> everything would
        escalate and the proxy pass is pure overhead); index pushdown is
        decided upstream and already bypasses both paths."""
        if not calibrated:
            return "direct"
        direct = n_rows * self.phi_speed(sub_key)
        return ("cascade"
                if self.cascade_cost(n_rows, sub_key, escalation) <= direct
                else "direct")

    def cascade_stats(self) -> Dict[str, float]:
        """Observed escalation fractions per φ family (for ``explain()``)."""
        return dict(self._escalation)

    # -- sharded serving (cluster scatter-gather vs routed plans) --------------

    def record_shard_scan(self, shard: int, total_time: float,
                          rows_scanned: int) -> None:
        """Per-shard kNN scan throughput EWMA (coordinator feedback: a slow
        or overloaded shard raises the fan-out estimate, since scatter wall
        time is the *slowest* shard's scan)."""
        self._record_scan(f"shard{shard}:knn_scan", total_time, rows_scanned)

    def shard_scan_speed(self, shard: int) -> float:
        """Observed s/row of one shard's index scans; falls back to the
        global kNN throughput until that shard has been measured."""
        return self.speeds.get(f"shard{shard}:knn_scan",
                               self.knn_scan_speed())

    def shard_knn_fanout_cost(self, shard_rows: "list[int]", m: int,
                              nprobe: int, q: int = 1, k: int = 10) -> float:
        """Estimated wall cost of a scatter-gather kNN: the slowest shard's
        scan (shards run in parallel; each repeats the centroid probe over
        the replicated centroids) + per-shard dispatch + the merge of
        P x k candidates per query."""
        if not shard_rows:
            return 0.0
        per = [self.shard_scan_speed(s) * q
               * (m + rows * min(max(1, nprobe), max(1, m)) / max(1, m))
               for s, rows in enumerate(shard_rows)]
        p = len(shard_rows)
        merge = self.knn_scan_speed() * q * p * k
        return max(per) + p * self.cfg.shard_dispatch_s + merge

    def shard_fanout_cost(self, plan_cost: float, n_shards: int) -> float:
        """Cost of scattering one statement to every shard: each shard runs
        the plan over ~1/P of the rows in parallel (wall time = slowest
        shard ~= plan_cost / P on a balanced partition) plus one dispatch
        per shard -- the term routed plans avoid."""
        p = max(1, n_shards)
        return plan_cost / p + p * self.cfg.shard_dispatch_s

    def shard_routed_cost(self, plan_cost: float, n_shards: int) -> float:
        """Cost of routing the statement to the single owner shard: that
        shard's ~1/P of the rows, one dispatch, no merge."""
        return plan_cost / max(1, n_shards) + self.cfg.shard_dispatch_s

    def choose_shard_route(self, plan_cost: float, n_shards: int,
                           routable: bool) -> str:
        """``"routed"`` vs ``"fanout"`` for an id-bound statement (both are
        correct: non-owner shards scan their slice and match nothing -- the
        fan-out just pays P-1 useless dispatches, so the optimizer prefers
        the routed plan whenever the predicate pins an owner)."""
        if not routable or n_shards <= 1:
            return "fanout" if not routable else "routed"
        routed = self.shard_routed_cost(plan_cost, n_shards)
        return ("routed" if routed
                <= self.shard_fanout_cost(plan_cost, n_shards) else "fanout")

    # -- replica sets (per-replica latency EWMAs + hedge pricing) --------------

    def record_replica_read(self, shard: int, replica: int,
                            latency_s: float) -> None:
        """One read leg's observed wall latency on (shard, replica).  Keyed
        per replica (NOT per row: replica choice compares whole-leg
        latencies, however many rows the leg scanned) and folded into the
        shared EWMA table; the shard's recent-latency window additionally
        feeds :meth:`hedge_deadline`."""
        key = f"shard{shard}r{replica}:read"
        a = self.cfg.ewma_alpha
        old = self.speeds.get(key)
        self.speeds[key] = (latency_s if old is None
                            else a * latency_s + (1 - a) * old)
        self.counts[key] = self.counts.get(key, 0) + 1
        self._replica_lat.setdefault(
            shard, deque(maxlen=64)).append(float(latency_s))

    def replica_read_latency(self, shard: int, replica: int) -> float:
        """EWMA read latency of one replica; config prior until measured."""
        return self.speeds.get(f"shard{shard}r{replica}:read",
                               self.cfg.default_replica_read_s)

    def choose_replica(self, shard: int, live: Sequence[int]) -> int:
        """The live replica with the lowest observed read latency (ties to
        the lowest replica index, so cold-start choice is deterministic)."""
        if not live:
            raise ValueError(f"shard {shard}: no live replicas to choose")
        return min(live,
                   key=lambda r: (self.replica_read_latency(shard, r), r))

    def hedge_deadline(self, shard: int) -> float:
        """How long a read leg may run on its chosen replica before a
        hedge fires on a second one: ``hedge_quantile`` of the shard's
        recent read latencies x ``hedge_deadline_mult``, floored at
        ``hedge_floor_s`` -- priced from observations, so a shard whose
        reads are genuinely slow is not hedged into double work while a
        stalled replica on a fast shard is raced almost immediately."""
        lat = self._replica_lat.get(shard)
        if not lat or len(lat) < 4:
            return self.cfg.hedge_floor_s
        q = float(np.quantile(np.asarray(lat), self.cfg.hedge_quantile))
        return max(self.cfg.hedge_floor_s,
                   q * self.cfg.hedge_deadline_mult)

    def note_topology_change(self) -> None:
        """The shard map changed (rebalance move / shard retirement): every
        cached plan and shard-positional cost term may be stale."""
        self.epoch += 1

    def suggest_prefetch_depth(self, sem_op: lp.PlanOp,
                               cap: int) -> Optional[int]:
        """Adaptive φ prefetch window for one SemanticFilter: how many
        chunks of structured production fit inside one chunk of φ wait,
        from the observed per-row speeds already in this service -- a slow
        extractor over a fast scan wants the whole window in flight, a
        cheap (cached / pushed-down) one shouldn't queue anything it may
        never need.  Clamped to ``cap`` (the AIPM bounded-queue capacity:
        deeper would just block on backpressure).  Returns None until the
        executor has observed a real speed for this φ family -- cold start
        keeps the configured default."""
        phi = self.speeds.get(self.op_key(sem_op))
        if phi is None:
            return None
        produce = 0.0
        stack = list(sem_op.children())
        while stack:
            op = stack.pop()
            produce += self.expected_speed(op)
            stack.extend(op.children())
        depth = int(np.ceil(phi / max(produce, 1e-12)))
        return max(1, min(cap, depth))

    def note_index_rebuild(self, sub_key: str) -> None:
        """A (re)built index changes which plans are optimal (pushdown
        becomes available / index stats change): invalidate cached plans."""
        self.epoch += 1

    def refresh_extractor_stats(self, registry) -> None:
        """Fold the AIPM registry's observed per-extractor ``avg_speed`` into
        the semantic-filter speed table and track model serials.

        * A changed (or first-seen) serial bumps the epoch, so every cached
          plan keyed on the old epoch is re-optimized -- a model update can
          change φ cost by orders of magnitude (paper Fig 6 invalidation,
          extended to plans).
        * The observed extraction speed seeds the speed table only when the
          executor has no measurement of its own yet: it is a far better
          prior than the paper-calibrated 0.3 s/row default, but the
          executor's EWMA (which sees cache hits and index pushdown) stays
          authoritative once it exists.
        """
        for sub_key in registry.known():
            spec = registry.get(sub_key)
            if self._extractor_serials.get(sub_key) != spec.serial:
                self._extractor_serials[sub_key] = spec.serial
                self.epoch += 1
            key = f"semantic_filter:{sub_key}"
            if spec.rows and key not in self.speeds:
                self.speeds[key] = spec.avg_speed
                self.epoch += 1

    # -- cardinality -----------------------------------------------------------

    def refresh_from_graph(self, graph) -> None:
        sig = (graph.n_nodes, graph.n_relationships)
        if sig == self._graph_sig:
            return          # unchanged cardinalities: keep epoch stable
        self._graph_sig = sig
        self.epoch += 1
        self.n_nodes = max(1, graph.n_nodes)
        self.avg_degree = graph.n_relationships / self.n_nodes if self.n_nodes else 0
        labels = np.asarray(graph.store.node_labels)
        for lid in range(len(graph.store.labels)):
            name = graph.store.labels.name_of(lid)
            self.label_counts[name] = int((labels == lid).sum())

    def estimate_rows(self, op: lp.PlanOp) -> float:
        if isinstance(op, lp.AllNodeScan):
            return float(self.n_nodes)
        if isinstance(op, lp.NodeByLabelScan):
            return float(self.label_counts.get(op.label, self.n_nodes / 10))
        if isinstance(op, lp.Filter):
            return self.structured_selectivity * self.estimate_rows(op.child)
        if isinstance(op, lp.SemanticFilter):
            return self.semantic_selectivity * self.estimate_rows(op.child)
        if isinstance(op, lp.Expand):
            return self.avg_degree * self.estimate_rows(op.child)
        if isinstance(op, lp.Join):
            lrows = self.estimate_rows(op.left)
            rrows = self.estimate_rows(op.right)
            shared = op.left.vars & op.right.vars
            if shared:
                return max(lrows, rrows)
            return lrows * rrows
        if isinstance(op, (lp.Projection, lp.Limit)):
            return self.estimate_rows(op.children()[0])
        return float(self.n_nodes)


def _sem_key(expr: Any) -> str:
    from repro_torch.core.cypherplus import BoolOp, SubProp
    if isinstance(expr, SubProp):
        return expr.sub_key
    if isinstance(expr, Compare):
        return _sem_key(expr.left) or _sem_key(expr.right)
    if isinstance(expr, BoolOp):
        for a in expr.args:
            k = _sem_key(a)
            if k:
                return k
    return ""


def suggest_phi_batch(avg_speed: float, default: int, max_batch: int,
                      target_s: float) -> int:
    """Pick the φ slice size from the observed per-row speed: one model call
    should take ~``target_s`` so slow extractors keep batches small (bounded
    latency per AIPM round-trip) while fast ones amortize dispatch overhead
    over bigger slices.  Falls back to the registered default until a speed
    has been observed."""
    if avg_speed <= 0:
        return max(1, min(default, max_batch))
    return max(1, min(max_batch, int(target_s / avg_speed)))


def estimate_cost(op: lp.PlanOp, stats: StatisticsService) -> float:
    """Est(o) = E[speed(o)|S] * Σ(row, T_input)  (Definition 5.1)."""
    if isinstance(op, (lp.AllNodeScan, lp.NodeByLabelScan)):
        input_rows = stats.estimate_rows(op)
    elif isinstance(op, lp.Join):
        input_rows = stats.estimate_rows(op.left) + stats.estimate_rows(op.right)
    else:
        input_rows = stats.estimate_rows(op.children()[0]) if op.children() else 1.0
    return stats.expected_speed(op) * input_rows


def estimate_plan_cost(plan: lp.PlanOp, stats: StatisticsService) -> float:
    """Total cost: Σ over operators of Est(o)."""
    total = estimate_cost(plan, stats)
    for c in plan.children():
        total += estimate_plan_cost(c, stats)
    return total
