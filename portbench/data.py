"""The benchmark's inputs, made from the seed on the device.

One law serves every configuration's vectors: each row is the centre of a
cluster drawn uniformly plus Gaussian noise.  ``rows_per_cluster`` sets
how many rows share a centre (SIFT-like: 100, the law of the repository's
``sift_like_vectors`` with ``n_clusters = n // 100``; faces: 2.3 photos an
identity, as in LFW).  A query is a fresh draw around the centre of a
randomly chosen indexed row's cluster, never a copy of a row.

Every array comes from one ``torch.Generator`` on the run's device, in a
few large calls, so the same seed gives the same inputs on one device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1,
                                                        keepdim=True), 1e-9)


def make_vectors(spec: dict, n_queries: int, seed: int,
                 device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """(rows [n, dim], queries [n_queries, dim]) float32 host arrays.

    ``spec`` keys: ``n``, ``dim``, ``rows_per_cluster``, ``center_scale``
    (the centres' standard deviation), ``noise`` (the rows'),
    ``unit_centers`` and ``unit_rows`` (scale to unit length)."""
    n, d = int(spec["n"]), int(spec["dim"])
    n_clusters = max(1, int(n / float(spec["rows_per_cluster"])))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    centres = torch.randn((n_clusters, d), generator=gen, device=device)
    centres *= float(spec["center_scale"])
    if spec["unit_centers"]:
        centres = _unit(centres)
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=device)
    noise = float(spec["noise"])
    rows = centres[assign]
    rows += noise * torch.randn((n, d), generator=gen, device=device)
    pick = torch.randint(0, n, (n_queries,), generator=gen, device=device)
    queries = centres[assign[pick]]
    queries += noise * torch.randn((n_queries, d), generator=gen,
                                   device=device)
    if spec["unit_rows"]:
        rows, queries = _unit(rows), _unit(queries)
    out = (rows.float().cpu().numpy(), queries.float().cpu().numpy())
    del rows, queries, centres, assign
    return out


def batch_draws(seed: int, n_queries: int, batch: int):
    """Endless batches of ``batch`` distinct indices into the query set,
    drawn from the seed: every seed gives batches of the same size."""
    rng = np.random.default_rng([int(seed), 1])
    while True:
        yield rng.choice(n_queries, size=batch, replace=False)
