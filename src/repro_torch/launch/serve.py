"""Serving launcher: stand up a PandaDB with extractors + index and serve a
mixed CypherPlus workload (Fig 8's harness as a CLI), single node.

  PYTHONPATH=src python -m repro_torch.launch.serve --persons 200 --clients 8

The db, its face index and the server run on the CUDA card; ``--device
cpu`` runs them on the CPU.

Overload mode (deadlines + admission control, §VII overload regime):

  # open-loop at ~2x measured capacity with per-request deadlines and a
  # bounded queue; prints goodput and the shed/expired/degraded counters
  PYTHONPATH=src python -m repro_torch.launch.serve --overload --deadline-ms 100

Cluster modes (``--shards``, ``--replicas``, ``--chaos``) come with the
port's cluster slice.
"""
import argparse
import json

from repro_torch.configs.pandadb import ServingConfig
from repro_torch.core import PandaDB
from repro_torch.core.aipm import feature_hash_extractor, label_extractor
from repro_torch.data.synthetic_graph import SNBConfig, build_snb
from repro_torch.obs import prometheus_dump
from repro_torch.serving.engine import QueryServer


def build_db(n_persons: int, device=None) -> PandaDB:
    db = PandaDB(device=device)
    db.register_extractor("face", feature_hash_extractor(dim=64))
    db.register_extractor("animal", label_extractor(["cat", "dog", "bird"]))
    build_snb(db, SNBConfig(n_persons=n_persons,
                            n_identities=max(2, n_persons // 3)))
    db.build_index("face", "photo")
    return db


QUERIES = [
    "MATCH (n:Person)-[:workFor]->(t:Team) WHERE n.name='person_3' RETURN t.name",
    "MATCH (n:Person) WHERE n.age > 40 RETURN n.name LIMIT 5",
    "MATCH (n:Person)-[:knows]->(m:Person) WHERE n.name='person_1' RETURN m.name",
    "MATCH (n:Person), (m:Person) WHERE n.name='person_2' "
    "AND n.photo->face ~: m.photo->face RETURN m.name",
]


def run_overload(db, queries, args) -> None:
    """Measure closed-loop capacity, then offer ~2x open-loop with
    per-request deadlines and a bounded admission queue; print goodput and
    every overload counter."""
    probe = QueryServer(db, n_workers=args.workers)
    cap = probe.run_closed_loop(queries, n_clients=args.clients,
                                duration_s=max(1.0, args.duration / 2))
    capacity_qps = cap.throughput_qps
    print(json.dumps({"capacity_qps": capacity_qps}, indent=1))

    serving = ServingConfig(queue_depth=args.queue_depth,
                            admission_policy="reject",
                            default_deadline_ms=args.deadline_ms,
                            shed_on_arrival=True)
    server = QueryServer(db, n_workers=args.workers, serving=serving)
    summary = server.run_open_loop(
        queries, rate_qps=max(2.0, 2.0 * capacity_qps),
        duration_s=args.duration, deadline_ms=args.deadline_ms)
    server.close()
    print("overload:", json.dumps(summary, indent=1))
    print("counters:", json.dumps(server.route_counts(), indent=1))
    if args.metrics:
        print(prometheus_dump(), end="")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--persons", type=int, default=200)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device of the db and server (default: the "
                         "CUDA card)")
    ap.add_argument("--overload", action="store_true",
                    help="open-loop overload mode: measure capacity, then "
                         "offer ~2x with per-request deadlines + admission "
                         "control and print shed/expired/degraded counters")
    ap.add_argument("--deadline-ms", type=float, default=100.0,
                    help="per-request budget in --overload mode")
    ap.add_argument("--queue-depth", type=int, default=32,
                    help="admission queue bound in --overload mode")
    ap.add_argument("--metrics", action="store_true",
                    help="print a Prometheus-style text dump of every live "
                         "metrics registry after the run")
    args = ap.parse_args()

    db = build_db(args.persons, device=args.device)
    if args.overload:
        run_overload(db, QUERIES, args)
        return

    server = QueryServer(db, n_workers=args.workers)
    stats = server.run_closed_loop(QUERIES, n_clients=args.clients,
                                   duration_s=args.duration)
    print(json.dumps(stats.summary(), indent=1))
    print("cache:", db.cache.stats())
    if args.metrics:
        print(prometheus_dump(), end="")


if __name__ == "__main__":
    main()
