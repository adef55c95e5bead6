"""LDBC-SNB-flavoured synthetic property graph + LFW-like unstructured
payloads (the paper's experimental setup, §VII-C, generated offline).

Persons belong to organisations and teams, know each other, and carry a
`photo` BLOB whose bytes are content-derived from a latent identity vector:
two photos of the same identity produce similar extractor features (so face
~: comparisons behave like the LFW experiments)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.database import PandaDB


@dataclasses.dataclass
class SNBConfig:
    n_persons: int = 200
    n_teams: int = 12
    n_orgs: int = 6
    photos_per_person: int = 1
    n_identities: Optional[int] = None     # < n_persons => duplicates exist
    avg_knows: int = 4
    photo_bytes: int = 2048
    seed: int = 0


def identity_photo(rng: np.random.Generator, identity: np.ndarray,
                   n_bytes: int, noise: float = 0.05) -> bytes:
    """Render an identity vector into bytes such that byte-histogram
    extractors (aipm.feature_hash_extractor) map same-identity photos close."""
    probs = np.exp(identity * 3.0)
    probs = probs / probs.sum()
    base = rng.choice(len(identity), size=n_bytes, p=probs).astype(np.uint8)
    flip = rng.random(n_bytes) < noise
    base[flip] = rng.integers(0, 256, flip.sum(), dtype=np.uint8)
    scale = max(1, 256 // len(identity))
    return (base.astype(np.int32) * scale % 256).astype(np.uint8).tobytes()


def build_snb(db: PandaDB, cfg: SNBConfig) -> Dict[str, List[int]]:
    rng = np.random.default_rng(cfg.seed)
    n_id = cfg.n_identities or cfg.n_persons
    identities = rng.standard_normal((n_id, 64))

    orgs = [db.graph.create_node("Organization", name=f"org_{i}", log=False)
            for i in range(cfg.n_orgs)]
    teams = [db.graph.create_node("Team", name=f"team_{i}", log=False)
             for i in range(cfg.n_teams)]
    persons = []
    for i in range(cfg.n_persons):
        ident = identities[i % n_id]
        photo = identity_photo(rng, ident, cfg.photo_bytes)
        pid = db.graph.create_node(
            "Person", name=f"person_{i}", identity=int(i % n_id),
            age=float(rng.integers(18, 80)), photo=photo, log=False)
        persons.append(pid)
        db.graph.create_relationship(pid, teams[i % cfg.n_teams], "workFor",
                                     log=False)
        db.graph.create_relationship(
            teams[i % cfg.n_teams], orgs[(i % cfg.n_teams) % cfg.n_orgs],
            "belongTo", log=False)
    # knows edges (preferential by team)
    for i, pid in enumerate(persons):
        k = rng.poisson(cfg.avg_knows)
        for _ in range(k):
            j = int(rng.integers(0, cfg.n_persons))
            if j != i:
                db.graph.create_relationship(pid, persons[j], "knows",
                                             log=False)
    db.graph.wal.append(f"BULK LOAD SNB persons={cfg.n_persons}")
    return {"persons": persons, "teams": teams, "orgs": orgs}


def sift_like_vectors(n: int, dim: int = 128, n_clusters: int = 64,
                      seed: int = 0) -> np.ndarray:
    """SIFT-1M-flavoured clustered vectors for index benchmarks (Fig 11/12)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)) * 4.0
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign]
            + rng.standard_normal((n, dim))).astype(np.float32)
