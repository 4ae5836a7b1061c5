"""Consistent-hash ring for rid → shard assignment.

The router must keep assignments *stable* under replica-set changes: when
a replica joins or leaves, only the rids that hashed onto its arc move
(≈ 1/K of the keyspace), every other rid keeps its shard — so replica
loss re-hashes one shard's in-flight rids to survivors without
disturbing the rest of the fleet (the property the serving tests check).

Classic construction: each shard owns ``vnodes`` pseudo-random points on
a 64-bit ring (blake2b of ``"shard:replica"``), a key maps to the first
point clockwise from its own hash.  blake2b keeps the mapping
deterministic across processes and runs — sibling routers and replayed
benchmarks derive identical assignments without coordination.

The port's copy of ``repro/serving/hashring.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import hashlib
from bisect import bisect_right, insort
from typing import Hashable, Iterable

__all__ = ["HashRing"]

_DEFAULT_VNODES = 64


def _h64(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent mapping of keys onto a changing set of shard ids."""

    def __init__(self, shards: Iterable[Hashable] = (), *,
                 vnodes: int = _DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._points: list[tuple[int, Hashable]] = []  # sorted (hash, shard)
        self._shards: set[Hashable] = set()
        for s in shards:
            self.add(s)

    def __len__(self) -> int:
        return len(self._shards)

    def __contains__(self, shard: Hashable) -> bool:
        return shard in self._shards

    @property
    def shards(self) -> list:
        return sorted(self._shards, key=str)

    def add(self, shard: Hashable) -> None:
        if shard in self._shards:
            return
        self._shards.add(shard)
        for v in range(self.vnodes):
            insort(self._points, (_h64(f"{shard}:{v}"), shard))

    def remove(self, shard: Hashable) -> None:
        if shard not in self._shards:
            return
        self._shards.discard(shard)
        self._points = [p for p in self._points if p[1] != shard]

    def lookup(self, key) -> Hashable:
        """The shard owning ``key`` (first ring point clockwise)."""
        if not self._points:
            raise LookupError("hash ring is empty")
        i = bisect_right(self._points, (_h64(f"rid:{key}"),))
        return self._points[i % len(self._points)][1]

    def candidates(self, key, n: int = 2) -> list:
        """The first ``n`` *distinct* shards clockwise from ``key`` — the
        primary plus fallbacks, in deterministic preference order (used for
        load-aware tie-breaking: the router may pick a less-loaded
        candidate without perturbing any other key's assignment)."""
        if not self._points:
            raise LookupError("hash ring is empty")
        out: list = []
        start = bisect_right(self._points, (_h64(f"rid:{key}"),))
        for j in range(len(self._points)):
            shard = self._points[(start + j) % len(self._points)][1]
            if shard not in out:
                out.append(shard)
                if len(out) >= n:
                    break
        return out
