"""Serving-plane message schemas: sharded requests and streamed results.

Both types ride the unsized zero-copy plane (ragged rows in the
publisher's arena; only a constant-size descriptor crosses the metadata
queue), so a batch of prompts or a round's worth of token chunks costs
one publish regardless of payload bytes — the Fig. 13 property applied
to serving.

* ``SERVE_REQ`` — a router→replica batch: ragged prompt tokens packed
  flat with per-row lengths, plus per-row router-assigned ``rids`` and
  replay ``gens`` (a replayed rid travels with generation+1 so replicas
  and the collector can supersede/do exactly-once).  ``tids`` carries
  each row's ``repro_torch.obs`` trace id (0 when tracing is off) so the
  serving flow — head enqueue → flush → replica enqueue → reassembled
  chunks — reconstructs across processes.
* ``SERVE_RES`` — a replica→collector batch of per-rid token *chunks*:
  each row is ``(rid, gen, seq, tokens, eos)``; ``seq`` is the rid's
  chunk counter (the collector reassembles with a seq window + gap
  detection), ``eos`` marks the final chunk.  ``shard``/``depth``/
  ``stamp`` carry the publishing replica's identity and queue depth —
  the collector's per-shard load/latency snapshot feeds the router's
  load-aware tie-breaking.

The port's copy of ``repro/serving/messages.py``: only the import paths
differ, so the two packages' schemas are the same on the wire.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from collections import OrderedDict

from repro_torch.core.messages import Fixed, MessageType, Ragged

__all__ = ["SERVE_REQ", "SERVE_RES", "ReqRow", "ResRow", "GenerationGate",
           "pack_requests", "iter_requests", "pack_results", "iter_results"]

SERVE_REQ = MessageType(
    "ServeRequest",
    {
        "tokens": Ragged(np.int32),        # flat concatenated prompts
        "row_lengths": Ragged(np.int32),   # per-request prompt lengths
        "rids": Ragged(np.uint64),         # router-assigned request ids
        "gens": Ragged(np.uint32),         # replay generation per rid
        "tids": Ragged(np.uint64),         # per-row trace ids (0 = untraced)
        "stamp": Fixed(np.float64),        # router submit time (monotonic)
        "max_new": Fixed(np.int32),        # decode budget for the batch
    },
)

SERVE_RES = MessageType(
    "ServeResult",
    {
        "tokens": Ragged(np.int32),        # flat concatenated chunk tokens
        "row_lengths": Ragged(np.int32),   # per-chunk token counts
        "rids": Ragged(np.uint64),
        "gens": Ragged(np.uint32),
        "seqs": Ragged(np.uint32),         # per-rid chunk sequence number
        "eos": Ragged(np.uint8),           # 1 = final chunk of the stream
        "tids": Ragged(np.uint64),         # per-row trace ids (0 = untraced)
        "shard": Fixed(np.int32),          # publishing replica
        "depth": Fixed(np.int32),          # replica queue depth at publish
        "stamp": Fixed(np.float64),        # replica publish time (monotonic)
    },
)


class GenerationGate:
    """Exactly-once-per-generation admission — the replica side of the
    SERVE_REQ replay protocol, shared by ``InferenceServer`` and
    ``EchoServer`` so the rule cannot drift between flavours.

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


class ReqRow(NamedTuple):
    rid: int
    gen: int
    tokens: np.ndarray
    tid: int = 0                           # trace id (repro_torch.obs; 0 = untraced)


class ResRow(NamedTuple):
    rid: int
    gen: int
    seq: int
    tokens: np.ndarray
    eos: bool
    tid: int = 0                           # trace id (repro_torch.obs; 0 = untraced)


def pack_requests(loan, rows: list[ReqRow], *, stamp: float,
                  max_new: int) -> None:
    """Fill a borrowed ``SERVE_REQ`` loan with one batch of request rows."""
    for r in rows:
        loan.tokens.extend(np.asarray(r.tokens, np.int32))
        loan.row_lengths.extend(np.array([len(r.tokens)], np.int32))
        loan.rids.extend(np.array([r.rid], np.uint64))
        loan.gens.extend(np.array([r.gen], np.uint32))
        loan.tids.extend(np.array([r.tid], np.uint64))
    loan.set("stamp", stamp)
    loan.set("max_new", max_new)


def iter_requests(msg) -> Iterator[ReqRow]:
    """Unpack a ``SERVE_REQ`` message (or MessagePtr) into request rows."""
    lens = np.asarray(msg.row_lengths, np.int64)
    flat = np.asarray(msg.tokens, np.int32)
    rids = np.asarray(msg.rids, np.uint64)
    gens = np.asarray(msg.gens, np.uint32)
    tids = np.asarray(msg.tids, np.uint64)
    off = 0
    for i, n in enumerate(lens):
        n = int(n)
        tid = int(tids[i]) if i < len(tids) else 0
        yield ReqRow(int(rids[i]), int(gens[i]), flat[off:off + n].copy(),
                     tid)
        off += n


def pack_results(loan, rows: list[ResRow], *, shard: int, depth: int,
                 stamp: float) -> None:
    """Fill a borrowed ``SERVE_RES`` loan with one round's token chunks."""
    for r in rows:
        toks = np.asarray(r.tokens, np.int32)
        loan.tokens.extend(toks)
        loan.row_lengths.extend(np.array([len(toks)], np.int32))
        loan.rids.extend(np.array([r.rid], np.uint64))
        loan.gens.extend(np.array([r.gen], np.uint32))
        loan.seqs.extend(np.array([r.seq], np.uint32))
        loan.eos.extend(np.array([1 if r.eos else 0], np.uint8))
        loan.tids.extend(np.array([r.tid], np.uint64))
    loan.set("shard", shard)
    loan.set("depth", depth)
    loan.set("stamp", stamp)


def iter_results(msg) -> Iterator[ResRow]:
    """Unpack a ``SERVE_RES`` message (or MessagePtr) into chunk rows."""
    lens = np.asarray(msg.row_lengths, np.int64)
    flat = np.asarray(msg.tokens, np.int32)
    rids = np.asarray(msg.rids, np.uint64)
    gens = np.asarray(msg.gens, np.uint32)
    seqs = np.asarray(msg.seqs, np.uint32)
    eos = np.asarray(msg.eos, np.uint8)
    tids = np.asarray(msg.tids, np.uint64)
    off = 0
    for i, n in enumerate(lens):
        n = int(n)
        tid = int(tids[i]) if i < len(tids) else 0
        yield ResRow(int(rids[i]), int(gens[i]), int(seqs[i]),
                     flat[off:off + n].copy(), bool(eos[i]), tid)
        off += n
