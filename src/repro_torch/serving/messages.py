"""Serving-plane message helpers the port's server needs.

A copy of ``GenerationGate`` from ``repro/serving/messages.py``: the port
keeps its own copy of the jax-free planes instead of importing the
reference package.  The ``SERVE_REQ``/``SERVE_RES`` schemas and their
readers come with the port's copy of the shm message plane (ROADMAP.md,
Queue 1 item 4).
"""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["GenerationGate"]


class GenerationGate:
    """Exactly-once-per-generation admission — the replica side of the
    SERVE_REQ replay protocol, used by ``InferenceServer``.

    A row whose generation supersedes a live copy of the same rid
    replaces it (``supersede`` callback cancels the stale one); stale or
    duplicate generations — including of *completed* rids, remembered in
    a bounded record — are rejected."""

    def __init__(self, done_limit: int = 4096):
        self._live: dict = {}
        self._done: OrderedDict = OrderedDict()
        self._done_limit = done_limit

    def admit(self, rid, gen: int, *, supersede=None) -> bool:
        """True iff (rid, gen) should be decoded, cancelling any older
        live copy through ``supersede(rid)`` first."""
        done = self._done.get(rid)
        if done is not None and gen <= done:
            return False
        cur = self._live.get(rid)
        if cur is not None:
            if gen <= cur:
                return False
            if supersede is not None:
                supersede(rid)
        self._live[rid] = gen
        return True

    def current(self, rid) -> int:
        return self._live.get(rid, 0)

    def drop(self, rid) -> None:
        """A live copy was cancelled without completing."""
        self._live.pop(rid, None)

    def finish(self, rid) -> None:
        """The rid's stream completed: its generation joins the bounded
        done-record so late replays of <= gen are rejected."""
        self._done[rid] = self._live.pop(rid, 0)
        while len(self._done) > self._done_limit:
            self._done.popitem(last=False)
