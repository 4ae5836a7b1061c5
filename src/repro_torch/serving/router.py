"""rid-hash router: the serving plane's ingest sharder + admission gate.

One ``ShardRouter`` owns a publisher per request shard topic
(``<prefix>/<k>``) and consistent-hashes every request id onto the live
replica set (:class:`~repro_torch.serving.hashring.HashRing`).  Submissions are
buffered per shard and flushed as ONE unsized ``SERVE_REQ`` message per
shard (`flush`), published with ``publish_blocking`` — per-shard
backpressure is therefore event-driven end to end: a slow replica blocks
only its own shard's flush on the slot-freed FIFO, never the others.

The router is also the replay authority.  It records every in-flight rid
(prompt bytes included) until the collector confirms completion, so:

* a dead replica (``remove_shard``) re-hashes exactly its shard's
  in-flight rids onto the survivors, each with ``generation+1`` — the
  replica-side generation gate and the collector's supersede rule turn
  "at least once" into "exactly once";
* a respawned or freshly scaled-up replica joins through ``add_shard``
  (consistent hashing bounds future-rid movement to ~1/K; in-flight rids
  keep their recorded assignment) — its publisher is *revived from the
  parked set* when the shard served before, because registry publisher
  slots free only with the process: closing + re-creating one per death
  would leak a slot per respawn cycle (MAX_PUBS is finite);
* a rid whose stream stalls (lost result chunks, e.g. a QoS drop under
  extreme collector lag) can be replayed individually (``replay``) after
  ``stalled`` flags it;
* a drained replica can *steal* queued work: ``steal`` re-targets
  not-yet-progressed rids from the deepest shard onto the drained one
  with ``generation+1`` — the same SERVE_REQ generation gate that makes
  death-replay exactly-once makes a steal race (both replicas decode the
  rid) resolve to exactly one completion.

Replay records and buffered rows are reconciled at flush time: every
pending row is published only if its (rid, generation, shard) still
matches the live replay record, and duplicate (rid, generation) rows are
dropped — a row parked in ``_pending`` by a flush stall and then
superseded by ``replay``/``steal``/``remove_shard`` can therefore never
ship alongside its replacement (the double-buffering bug a static fleet
never exercises).

**Admission control**: with ``max_inflight_rids``/``max_inflight_bytes``
set, ``submit`` stops hashing new work into a saturated fleet.  Policy
``"shed"`` refuses (returns ``None``, counted in ``shed``); ``"queue"``
parks up to ``queue_limit`` requests head-side and admits them as
completions free budget (beyond the queue limit it sheds).  Both are
surfaced via ``stats()`` — a burst beyond the fleet's budget degrades to
refusals, never to unbounded in-flight state or a crash.

Load-aware tie-breaking (optional): with ``load_aware=True`` a new rid
may take the ring's *second* candidate when the primary is deeper than
the candidate by more than ``load_slack``.  Depth is the router's own
in-flight count per shard — exact and instantaneous, so even a blind
initial burst spreads — plus, when a ``stats_fn`` is wired (the
collector's ``shard_depths``), the replicas' self-reported queue depths.
Only ring candidates are ever considered, so assignment stays
hash-affine: every key whose primary is not overloaded keeps its
consistent-hash shard, and stability properties are untouched when
``load_aware`` is off (the default).

The port's copy of ``repro/serving/router.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.registry import AgnocastQueueFull
from repro_torch.core.topic import Domain, Publisher
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .hashring import HashRing
from .messages import SERVE_REQ, ReqRow, pack_requests

__all__ = ["ShardRouter", "InFlight"]


@dataclass
class InFlight:
    """One routed-but-not-yet-completed request (the replay record)."""

    rid: int
    shard: int
    gen: int
    tokens: np.ndarray
    stamp: float                      # first submit (latency measurements)
    last_progress: float = field(default=0.0)  # last in-order chunk advance
    progressed: bool = field(default=False)    # any chunk landed since the
    #                                            current (re)assignment —
    #                                            steal only takes cold rids
    tid: int = field(default=0)       # trace id of the CURRENT generation —
    #                                   replay/steal mint a fresh one, so a
    #                                   superseded attempt's flow stays
    #                                   truncated instead of absorbing the
    #                                   successor's records


class ShardRouter:
    def __init__(self, dom: Domain, shards, *, prefix: str = "serve/req",
                 depth: int = 8, max_new: int = 16, vnodes: int = 64,
                 load_aware: bool = False, load_slack: int = 4,
                 stats_fn=None, max_inflight_rids: int | None = None,
                 max_inflight_bytes: int | None = None,
                 admission: str = "shed", queue_limit: int = 1024):
        if admission not in ("shed", "queue"):
            raise ValueError("admission must be 'shed' or 'queue'")
        self.dom = dom
        self.prefix = prefix
        self.depth = depth
        self.max_new = max_new
        self.load_aware = load_aware
        self.load_slack = load_slack
        self.stats_fn = stats_fn
        self.max_inflight_rids = max_inflight_rids
        self.max_inflight_bytes = max_inflight_bytes
        self.admission = admission
        self.queue_limit = queue_limit
        self.ring = HashRing(shards, vnodes=vnodes)
        self.pubs: dict[int, Publisher] = {
            k: dom.create_publisher(SERVE_REQ, self.topic(k), depth=depth)
            for k in self.ring.shards
        }
        self._parked: dict[int, Publisher] = {}  # ex-shard pubs, revivable
        self.inflight: dict[int, InFlight] = {}
        self._inflight_bytes = _metrics.counter("router.inflight_bytes")
        self._pending: dict[int, list[ReqRow]] = {}
        self._queue: deque[tuple[int, np.ndarray, float]] = deque()
        self._queued_rids: set[int] = set()
        self._shard_load: dict[int, int] = {k: 0 for k in self.ring.shards}
        self._rid_counter = itertools.count(1)
        self._tr = _trace.tracer_for(dom.name)
        # counters (observability + tests): all in the unified metrics
        # registry (repro_torch.obs.metrics) — the head janitor timer and the
        # collector callback both touch them, so a bare `+= 1` loses
        # increments (agnolint AGNO-CNT-001) — with read-only attribute
        # shims below for every existing `router.shed`-style reader
        self._routed = _metrics.counter("router.routed")
        self._replays = _metrics.counter("router.replays")
        self._completions = _metrics.counter("router.completions")
        self._tie_breaks = _metrics.counter("router.tie_breaks")
        self._flush_stalls = _metrics.counter("router.flush_stalls")
        self._shed = _metrics.counter("router.shed")
        self._shed_bytes = _metrics.counter("router.shed_bytes")
        self._dropped_superseded = _metrics.counter("router.dropped_superseded")
        self._queued_total = _metrics.counter("router.queued_total")
        self._steals = _metrics.counter("router.steals")
        # gauges are weakly registered: the router must hold them alive
        self._gauges = (
            _metrics.gauge("router.inflight", fn=lambda: len(self.inflight)),
            _metrics.gauge("router.queued", fn=lambda: len(self._queue)),
        )

    # read-only back-compat shims over the migrated counters
    @property
    def shed(self) -> int:
        return self._shed.value

    @property
    def shed_bytes(self) -> int:
        return self._shed_bytes.value

    @property
    def dropped_superseded(self) -> int:
        return self._dropped_superseded.value

    @property
    def routed(self) -> int:
        return self._routed.value

    @property
    def replays(self) -> int:
        return self._replays.value

    @property
    def completions(self) -> int:
        return self._completions.value

    @property
    def tie_breaks(self) -> int:
        return self._tie_breaks.value

    @property
    def flush_stalls(self) -> int:
        return self._flush_stalls.value

    @property
    def queued_total(self) -> int:
        return self._queued_total.value

    @property
    def steals(self) -> int:
        return self._steals.value

    @property
    def inflight_bytes(self) -> int:
        return self._inflight_bytes.value

    # -- assignment -----------------------------------------------------------

    def topic(self, shard: int) -> str:
        return f"{self.prefix}/{shard}"

    def next_rid(self) -> int:
        return next(self._rid_counter)

    def route(self, rid: int) -> int:
        """The shard for ``rid``: consistent hash, with an optional
        load-aware hop to the ring's second candidate."""
        if not self.load_aware or len(self.ring) < 2:
            return self.ring.lookup(rid)
        primary, alt = self.ring.candidates(rid, 2)
        ext = (self.stats_fn() or {}) if self.stats_fn is not None else {}
        dp = self._shard_load.get(primary, 0) + ext.get(primary, 0)
        da = self._shard_load.get(alt, 0) + ext.get(alt, 0)
        if dp > da + self.load_slack:
            self._tie_breaks.inc()
            return alt
        return primary

    # -- submission + admission -----------------------------------------------

    def _within_budget(self, nbytes: int) -> bool:
        if (self.max_inflight_rids is not None
                and len(self.inflight) >= self.max_inflight_rids):
            return False
        if (self.max_inflight_bytes is not None
                and self.inflight_bytes + nbytes > self.max_inflight_bytes):
            return False
        return True

    def _admit(self, rid: int, toks: np.ndarray, stamp: float,
               shard: int | None = None) -> None:
        shard = self.route(rid) if shard is None else shard
        now = time.monotonic()
        tid = 0
        tr = self._tr
        if tr is not None:
            # serving flows are minted here: hop 0 = the head router
            tid = _trace.next_trace_id()
            tr.emit(tid, 0, _trace.Stage.SERVE_ENQ, arg=rid & 0xFFFF_FFFF)
        self.inflight[rid] = InFlight(rid, shard, 0, toks, stamp, now,
                                      tid=tid)
        self._inflight_bytes.inc(toks.nbytes)
        self._pending.setdefault(shard, []).append(ReqRow(rid, 0, toks, tid))
        self._shard_load[shard] = self._shard_load.get(shard, 0) + 1
        self._routed.inc()

    def submit(self, tokens, *, rid: int | None = None,
               shard: int | None = None) -> int | None:
        """Buffer one request for its hashed shard (``flush`` publishes).
        ``shard`` pins the assignment AND bypasses admission (warmup /
        tests).  Returns the rid — or ``None`` when admission control shed
        the request (budget exceeded, policy ``"shed"`` or queue full)."""
        rid = self.next_rid() if rid is None else int(rid)
        if rid in self.inflight or rid in self._queued_rids:
            raise ValueError(f"rid {rid} is already in flight")
        toks = np.asarray(tokens, np.int32).copy()
        if shard is None and not self._within_budget(toks.nbytes):
            if (self.admission == "queue"
                    and len(self._queue) < self.queue_limit):
                self._queue.append((rid, toks, time.monotonic()))
                self._queued_rids.add(rid)
                self._queued_total.inc()
                return rid
            self._shed.inc()
            self._shed_bytes.inc(toks.nbytes)
            return None
        self._admit(rid, toks, time.monotonic(), shard)
        return rid

    def admit_queued(self) -> int:
        """Drain the admission queue into the pending buffers while budget
        lasts (called on every completion and at flush time)."""
        n = 0
        while self._queue and self._within_budget(self._queue[0][1].nbytes):
            rid, toks, stamp = self._queue.popleft()
            self._queued_rids.discard(rid)
            self._admit(rid, toks, stamp)
            n += 1
        return n

    def _validate_rows(self, shard: int, rows: list[ReqRow]) -> list[ReqRow]:
        """Keep only rows whose replay record still points at this shard
        with this generation; dedup (rid, gen).  Everything else was
        superseded (completed, replayed, stolen, re-hashed) while the row
        sat in ``_pending`` — shipping it would double-publish."""
        out: list[ReqRow] = []
        seen: set[tuple[int, int]] = set()
        for r in rows:
            rec = self.inflight.get(r.rid)
            key = (r.rid, r.gen)
            if (rec is None or rec.gen != r.gen or rec.shard != shard
                    or key in seen):
                self._dropped_superseded.inc()
                continue
            seen.add(key)
            out.append(r)
        return out

    def flush(self, *, timeout: float | None = 30.0, should_stop=None) -> int:
        """Publish every buffered row: one ``SERVE_REQ`` per shard, with
        event-driven per-shard backpressure (``publish_blocking``)."""
        self.admit_queued()
        pending, self._pending = self._pending, {}
        published = 0
        for shard, rows in pending.items():
            rows = self._validate_rows(shard, rows)
            if not rows:
                continue
            pub = self.pubs.get(shard)
            if pub is None or shard not in self.ring:
                # shard died between buffering and flush: re-hash the rows
                for r in rows:
                    self._replay_locked(self.inflight[r.rid])
                continue
            loan = pub.borrow_loaded_message()
            pack_requests(loan, rows, stamp=time.monotonic(),
                          max_new=self.max_new)
            if self._tr is not None:
                # emitted BEFORE the publish: the replica's hop-1 enqueue
                # is causally after delivery, so flush->replica can never
                # read negative; a stalled flush re-emits on its retry
                # (first-record-wins in the breakdown)
                for r in rows:
                    if r.tid:
                        self._tr.emit(r.tid, 0, _trace.Stage.SERVE_FLUSH,
                                      arg=r.rid & 0xFFFF_FFFF)
            # no explicit reclaim: publish() itself prunes freed ring slots
            try:
                got = pub.publish_blocking(loan, timeout=timeout,
                                           should_stop=should_stop)
            except AgnocastQueueFull:
                got = None
            if got is None:
                # shard saturated for the whole timeout (or caller stopping):
                # return the loan and re-buffer — a periodic flush (the head
                # janitor) retries, and the stall-replay path re-hashes rids
                # that stay stuck.  Never let shard backpressure crash the
                # head's event loop.  Re-buffered rows go back through
                # _validate_rows on the next flush, so a replay that fires
                # while they sit here cannot double-publish them.
                loan.dealloc()
                self._pending.setdefault(shard, []).extend(rows)
                self._flush_stalls.inc()
                continue
            published += len(rows)
        return published

    # -- completion / replay / steal ------------------------------------------

    def touch(self, rid: int) -> None:
        """Progress report from the collector (an in-order chunk landed)."""
        rec = self.inflight.get(rid)
        if rec is not None:
            rec.last_progress = time.monotonic()
            rec.progressed = True

    def complete(self, rid: int) -> None:
        """The collector assembled this rid's full stream: drop the replay
        record (its prompt bytes are no longer needed) and let the freed
        budget pull queued admissions in."""
        rec = self.inflight.pop(rid, None)
        if rec is not None:
            self._completions.inc()
            self._inflight_bytes.inc(-(rec.tokens.nbytes))
            self._shard_load[rec.shard] = max(
                0, self._shard_load.get(rec.shard, 0) - 1)
            self.admit_queued()

    def _retarget(self, rec: InFlight, shard: int) -> int:
        """Move one record to ``shard`` with generation+1 and buffer the
        fresh row (the shared core of replay and steal)."""
        rec.gen += 1
        old = rec.shard
        rec.shard = shard
        rec.last_progress = time.monotonic()
        rec.progressed = False
        if self._tr is not None:
            # a retarget is a NEW causal attempt: fresh trace id, so the
            # superseded attempt's flow stays truncated (the evidence of
            # the death/steal) and this one reconstructs cleanly
            rec.tid = _trace.next_trace_id()
            self._tr.emit(rec.tid, 0, _trace.Stage.SERVE_ENQ,
                          arg=rec.rid & 0xFFFF_FFFF)
        self._pending.setdefault(rec.shard, []).append(
            ReqRow(rec.rid, rec.gen, rec.tokens, rec.tid))
        self._shard_load[old] = max(0, self._shard_load.get(old, 0) - 1)
        self._shard_load[rec.shard] = self._shard_load.get(rec.shard, 0) + 1
        return rec.shard

    def _replay_locked(self, rec: InFlight) -> int:
        self._replays.inc()
        return self._retarget(rec, self.route(rec.rid))

    def replay(self, rid: int) -> int | None:
        """Re-hash and re-buffer one in-flight rid with generation+1
        (stalled stream, lost chunks).  Returns the new shard, or ``None``
        if the rid is unknown/already complete.  Caller flushes."""
        rec = self.inflight.get(rid)
        return None if rec is None else self._replay_locked(rec)

    def steal(self, to_shard: int, from_shard: int, limit: int = 2) -> list[int]:
        """Work stealing: re-target up to ``limit`` *cold* rids (no chunk
        landed since their current assignment) from ``from_shard`` onto a
        drained ``to_shard``, generation+1 each.  The deep replica's stale
        copy still decodes — the generation gate plus the collector's
        supersede/dedup keep completion exactly-once, identical to the
        death-replay race.  Returns the moved rids; caller flushes."""
        if to_shard not in self.ring or to_shard not in self.pubs:
            return []
        moved: list[int] = []
        for rec in list(self.inflight.values()):
            if len(moved) >= limit:
                break
            if rec.shard != from_shard or rec.progressed:
                continue
            self._retarget(rec, to_shard)
            moved.append(rec.rid)
        self._steals.inc(len(moved))
        return moved

    # -- ring membership ------------------------------------------------------

    def add_shard(self, shard: int) -> None:
        """Grow the ring (respawned or freshly scaled-up replica) —
        idempotent.  Only call once the replica is subscribed (pool
        ``ready``): rows published before any subscriber exists are
        dropped by QoS keep-last, never delivered.  A parked publisher
        (this shard served before) is revived instead of re-created —
        registry publisher slots free only with the process, so
        close+recreate would leak one slot per respawn cycle."""
        shard = int(shard)
        if shard not in self.pubs:
            pub = self._parked.pop(shard, None)
            if pub is None:
                pub = self.dom.create_publisher(SERVE_REQ, self.topic(shard),
                                                depth=self.depth)
            self.pubs[shard] = pub
        self.ring.add(shard)
        self._shard_load.setdefault(shard, 0)

    def remove_shard(self, shard: int) -> list[int]:
        """A replica died (or is being scaled down): shrink the ring and
        replay exactly its in-flight rids onto the survivors
        (generation+1 each).  Returns the replayed rids.  Caller flushes."""
        self.ring.remove(shard)
        if not len(self.ring):
            raise RuntimeError("no live shard left to replay onto")
        # park the dead shard's publisher: its registry pub slot frees only
        # with this process, and a respawned incarnation of the same shard
        # revives it through add_shard instead of burning a fresh slot
        pub = self.pubs.pop(shard, None)
        if pub is not None:
            self._parked[shard] = pub
        self._shard_load.pop(shard, None)
        replayed = [rec.rid for rec in self.inflight.values()
                    if rec.shard == shard]
        # rows still buffered for the dead shard are superseded by the
        # replay below; _validate_rows drops them at the next flush
        self._pending.pop(shard, None)
        for rid in replayed:
            self._replay_locked(self.inflight[rid])
        return replayed

    def stalled(self, older_than_s: float) -> list[int]:
        """In-flight rids with no in-order progress for ``older_than_s``
        seconds — replay candidates (collector gap that will never fill)."""
        cut = time.monotonic() - older_than_s
        return [rec.rid for rec in self.inflight.values()
                if rec.last_progress < cut]

    # -- lifecycle ------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "inflight": len(self.inflight),
            "inflight_bytes": self.inflight_bytes,
            "routed": self.routed,
            "replays": self.replays,
            "completions": self.completions,
            "tie_breaks": self.tie_breaks,
            "flush_stalls": self.flush_stalls,
            "shed": self.shed,
            "shed_bytes": self.shed_bytes,
            "queued": len(self._queue),
            "queued_total": self.queued_total,
            "steals": self.steals,
            "dropped_superseded": self.dropped_superseded,
            "shards": list(self.ring.shards),
        }

    def close(self) -> None:
        for pub in self.pubs.values():
            pub.close()
        for pub in self._parked.values():
            pub.close()
        self.pubs = {}
        self._parked = {}
