"""Versioned write-ahead log (paper §VII-A).

The paper's cluster keeps graph structure consistent with a raft-flavoured
scheme: the leader assigns ascending version numbers to writing-queries,
records (version, statement) in a log, and a (re)joining node replays from
its local version to the leader's.  We reproduce exactly that log/catch-up
mechanism; leader election itself is out of scope for a single SPMD program
(see DESIGN.md §2).

Entries are opaque to the log: statement *text* on the coordinator's leader
log (JSON-persistable when a path is given), structured op tuples on a
replica set's per-shard op log -- replica catch-up replays whatever the
leader recorded through :meth:`catch_up`'s ``execute`` callback.  Only
string statements may be persisted to disk.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable, Iterator, List, Optional, Tuple


class WriteAheadLog:
    def __init__(self, path: Optional[str] = None) -> None:
        self.path = Path(path) if path else None
        self.entries: List[Tuple[int, Any]] = []
        self.version = 0
        if self.path and self.path.exists():
            for line in self.path.read_text().splitlines():
                if not line.strip():
                    continue
                rec = json.loads(line)
                self.entries.append((rec["version"], rec["statement"]))
            if self.entries:
                self.version = self.entries[-1][0]

    # -- leader side ---------------------------------------------------------

    def append(self, statement: Any) -> int:
        """Leader: record a writing-query with the next version number."""
        self.version += 1
        self.entries.append((self.version, statement))
        if self.path:
            if not isinstance(statement, str):
                raise TypeError("only string statements can be persisted; "
                                "op-log payloads need an in-memory WAL")
            with open(self.path, "a") as f:
                f.write(json.dumps({"version": self.version,
                                    "statement": statement}) + "\n")
        return self.version

    # -- follower side -------------------------------------------------------

    def entries_after(self, version: int) -> Iterator[Tuple[int, Any]]:
        for v, stmt in self.entries:
            if v > version:
                yield v, stmt

    def catch_up(self, local_version: int,
                 execute: Callable[[Any], None]) -> int:
        """Replay statements until the local version matches the log.

        Returns the new local version.  A node may join the cluster iff its
        version equals the leader's (paper §VII-A) -- this is the replica
        rejoin path: a revived replica replays every op it missed while
        dead, in log order, through ``execute``."""
        v = local_version
        for version, stmt in self.entries_after(local_version):
            execute(stmt)
            v = version
        return v

    def consistent_with(self, local_version: int) -> bool:
        return local_version == self.version

    def truncate_to(self, version: int) -> None:
        """Compact after a checkpoint at `version` (entries folded in)."""
        self.entries = [(v, s) for v, s in self.entries if v > version]
        if self.path:
            with open(self.path, "w") as f:
                for v, s in self.entries:
                    f.write(json.dumps({"version": v, "statement": s}) + "\n")
