"""LM token pipeline: deterministic synthetic corpus.

The reference's ``data/lm_data.py`` (numpy only, no JAX), copied so the
port trains on the same batches: a batch is a pure function of (seed,
step, shard), byte for byte the reference's, so a restarted or reassigned
host reproduces exactly the batches it owes."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1


class SyntheticLM:
    """Zipf-distributed tokens with local n-gram structure (so loss can
    actually decrease)."""

    def __init__(self, cfg: LMDataConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._zipf_p = 1.0 / np.arange(1, v + 1) ** 1.1
        self._zipf_p /= self._zipf_p.sum()
        self._perm = rng.permutation(v)          # bigram successor map
        self._alpha = 0.7                        # P(next = perm[cur])

    def batch(self, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
        """{"tokens", "labels"}: int32 [global_batch / n_shards, seq_len],
        labels the tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + shard)
        b = cfg.global_batch // cfg.n_shards
        toks = np.empty((b, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self._zipf_p)
        follow = rng.random((b, cfg.seq_len)) < self._alpha
        rand_draws = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len),
                                p=self._zipf_p)
        for t in range(cfg.seq_len):
            nxt = self._perm[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand_draws[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, n_steps: int, start: int = 0,
                shard: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        for step in range(start, start + n_steps):
            yield self.batch(step, shard)
