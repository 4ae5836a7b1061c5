"""Results reassembly: merge shard subscriptions into per-rid streams.

Each replica publishes its decode rounds' token chunks on its *own*
per-shard ``SERVE_RES`` topic (``serve/res/<k>``) so K replicas never
contend on one topic's metadata row — the collector subscribes to all of
them (zero-copy; it reads chunk rows straight out of each replica's
arena) and is the single point where the shards converge.  A legacy
single-shared-topic mode (``shards=None``) remains for direct ingest.
The collector turns the interleaved, possibly out-of-order, possibly
replayed firehose back into per-rid in-order token streams:

* **seq window** — chunks carry a per-(rid, generation) sequence number;
  in-order chunks append directly, early ones wait in a bounded window
  and drain the moment the gap fills;
* **gap detection** — a chunk that opens a gap bumps ``gaps`` (and the
  stream's stall clock stops advancing, which is what the router's
  ``stalled``/``replay`` keys off);
* **generation supersede** — a chunk with a *newer* generation (the
  router replayed the rid after replica loss) discards the partial old
  stream and restarts reassembly; older-generation and duplicate-seq
  chunks are dropped and counted, so the assembled output is exactly
  once per rid;
* **per-shard snapshot** — each result message carries the publishing
  replica's queue depth and publish stamp; ``shard_stats``/
  ``shard_depths`` expose depth + delivery-latency quantiles for the
  router's load-aware tie-breaking.

Two consumption surfaces: callbacks (``on_complete``/``on_progress``,
wired to the router) and an iterator — ``pop_completed`` / iterating the
collector yields finished ``(rid, tokens)`` pairs exactly once.

The port's copy of ``repro/serving/collector.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import select
import time
from collections import OrderedDict, deque

import numpy as np

from repro_torch.core.topic import Domain
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .messages import SERVE_RES, ResRow, iter_results

__all__ = ["ResultsCollector"]

_LAT_WINDOW = 64  # per-shard delivery-latency samples kept for the snapshot
_DONE_RID_LIMIT = 4096  # completed rids remembered for late-dup detection


class _Stream:
    __slots__ = ("gen", "next_seq", "window", "tokens", "had_gap")

    def __init__(self, gen: int):
        self.gen = gen
        self.next_seq = 0
        self.window: dict[int, ResRow] = {}
        self.tokens: list[int] = []
        self.had_gap = False


class ResultsCollector:
    def __init__(self, dom: Domain, topic: str = "serve/res", *,
                 shards=None, on_complete=None, on_progress=None,
                 window_limit: int = 256):
        self.dom = dom
        self.topic = topic
        # ``shards``: merge per-shard results topics (``<topic>/<k>``) —
        # K replicas each publish on their own topic so results stop
        # contending on one topic's metadata row; the collector is the
        # only place the shards converge.  ``None`` keeps the single
        # shared-topic layout (direct-ingest tests, external replicas).
        if shards is None:
            self.subs = [dom.create_subscription(SERVE_RES, topic)]
        else:
            self.subs = [dom.create_subscription(SERVE_RES, f"{topic}/{int(k)}")
                         for k in shards]
        self.sub = self.subs[0]  # back-compat alias (single-topic callers)
        self.on_complete = on_complete      # callable(rid, tokens)
        self.on_progress = on_progress      # callable(rid)
        self.window_limit = window_limit
        self._executor = None               # remembered by attach_executor so
        self._group = None                  # watch() can wire late shards in
        self._streams: dict[int, _Stream] = {}
        self._completed: OrderedDict[int, list[int]] = OrderedDict()
        self._done_rids: OrderedDict[int, bool] = OrderedDict()  # bounded
        self._shard: dict[int, dict] = {}
        self._tr = _trace.tracer_for(dom.name)
        # counters (observability + tests): all in the unified metrics
        # registry — incremented from the executor's callback thread while
        # the head janitor reads them, so bare `+= 1` is a racy lost
        # update (agnolint AGNO-CNT-001); read-only shims for existing readers
        self._chunks = _metrics.counter("collector.chunks")
        self._duplicates = _metrics.counter("collector.duplicates")
        self._gaps = _metrics.counter("collector.gaps")
        self._superseded = _metrics.counter("collector.superseded")
        self._stale_gen = _metrics.counter("collector.stale_gen")
        self._dropped_window = _metrics.counter("collector.dropped_window")
        self._n_completed = _metrics.counter("collector.n_completed")

    @property
    def superseded(self) -> int:
        return self._superseded.value

    @property
    def dropped_window(self) -> int:
        return self._dropped_window.value

    @property
    def chunks(self) -> int:
        return self._chunks.value

    @property
    def duplicates(self) -> int:
        return self._duplicates.value

    @property
    def gaps(self) -> int:
        return self._gaps.value

    @property
    def stale_gen(self) -> int:
        return self._stale_gen.value

    @property
    def n_completed(self) -> int:
        return self._n_completed.value

    # -- ingestion ------------------------------------------------------------

    def attach_executor(self, executor, *, group=None):
        """Multiplex every results subscription into an EventExecutor loop
        (one handle per shard topic; returns them all).  The executor is
        remembered so :meth:`watch` can wire later-joining shards in."""
        self._executor, self._group = executor, group
        return [executor.add_subscription(sub, self._on_msg, group=group)
                for sub in self.subs]

    def watch(self, shard: int) -> bool:
        """Subscribe to one more shard's results topic (``<topic>/<k>``) —
        the elastic-fleet hook: a freshly scaled-up replica publishes on a
        topic no constructor-time subscription covers.  Idempotent (a
        respawned shard reuses its old topic, so its subscription already
        exists); only meaningful in sharded mode.  Returns True when a new
        subscription was created."""
        name = f"{self.topic}/{int(shard)}"
        if any(s.topic == name for s in self.subs):
            return False
        sub = self.dom.create_subscription(SERVE_RES, name)
        self.subs.append(sub)
        if self._executor is not None:
            self._executor.add_subscription(sub, self._on_msg,
                                            group=self._group)
        return True

    def pump(self, timeout: float = 0.05) -> int:
        """Standalone take loop (tests / executor-less heads): drain every
        shard subscription, blocking across all their wakeup FIFOs at once
        when nothing is pending."""
        n = 0
        ptrs = []
        for sub in self.subs:
            ptrs.extend(sub.take_all())
        if not ptrs:
            r, _, _ = select.select(self.subs, [], [], timeout)
            for sub in r:
                ptrs.extend(sub.take_all())
        for ptr in ptrs:
            try:
                self._on_msg(ptr)  # copies every row's tokens out
            finally:
                ptr.release()  # the executor path releases after callbacks;
                n += 1         # standalone must too, or rings fill forever
        return n

    def _on_msg(self, ptr) -> None:
        shard = int(ptr.get("shard"))
        stamp = float(ptr.get("stamp"))
        self._note_shard(shard, int(ptr.get("depth")), stamp)
        for row in iter_results(ptr):
            self.ingest(row)
        # the executor releases the ptr after the callback (tokens copied)

    def _note_shard(self, shard: int, depth: int, stamp: float) -> None:
        rec = self._shard.setdefault(
            shard, {"depth": 0, "lat": deque(maxlen=_LAT_WINDOW),
                    "chunks": 0, "last_seen": 0.0})
        now = time.monotonic()
        rec["depth"] = depth
        rec["last_seen"] = now
        if stamp > 0:
            rec["lat"].append(now - stamp)
        rec["chunks"] += 1

    def ingest(self, row: ResRow) -> None:
        """Feed one chunk row through the window/generation state machine."""
        self._chunks.inc()
        if row.rid in self._done_rids:
            self._duplicates.inc()  # late chunk of an already-assembled rid
            return
        st = self._streams.get(row.rid)
        if st is None:
            st = self._streams[row.rid] = _Stream(row.gen)
        elif row.gen > st.gen:
            # router replayed the rid: the fresh generation supersedes the
            # partial old stream wholesale (decode restarted from scratch)
            self._superseded.inc()
            st = self._streams[row.rid] = _Stream(row.gen)
        elif row.gen < st.gen:
            self._stale_gen.inc()
            return
        if row.seq < st.next_seq or row.seq in st.window:
            self._duplicates.inc()
            return
        # hop 2 = collector.  Emitted only for ACCEPTED chunks (buffered or
        # appended) — a dropped row (duplicate, stale/superseded generation,
        # window overflow) must leave no trace record, or a dead replica's
        # late eos chunk would stamp the superseded attempt's flow as
        # complete when reassembly in fact restarted under a fresh trace id
        if row.seq > st.next_seq:
            if not st.had_gap:
                st.had_gap = True
                self._gaps.inc()
            if len(st.window) >= self.window_limit:
                # pathological stream: stop buffering, await replay — but
                # never drop silently (same rule as the bridge's OOM path)
                self._dropped_window.inc()
                return
            if self._tr is not None and row.tid:
                self._tr.emit(row.tid, 2, _trace.Stage.SERVE_REASM,
                              arg=row.seq & 0xFFFF_FFFF)
            st.window[row.seq] = row
            return
        if self._tr is not None and row.tid:
            self._tr.emit(row.tid, 2, _trace.Stage.SERVE_REASM,
                          arg=row.seq & 0xFFFF_FFFF)
        self._advance(row.rid, st, row)

    def _advance(self, rid: int, st: _Stream, row: ResRow) -> None:
        while True:
            st.tokens.extend(int(t) for t in np.asarray(row.tokens))
            st.next_seq += 1
            st.had_gap = False
            if row.eos:
                if self._tr is not None and row.tid:
                    # the serving flow's TERMINAL record: emitted exactly
                    # when reassembly completes, so complete-flow counting
                    # matches the collector's exactly-once accounting
                    self._tr.emit(row.tid, 2, _trace.Stage.SERVE_REASM,
                                  arg=row.seq & 0xFFFF_FFFF,
                                  flags=_trace.FLAG_EOS)
                del self._streams[rid]
                self._completed[rid] = st.tokens
                self._done_rids[rid] = True  # late-duplicate detection
                while len(self._done_rids) > _DONE_RID_LIMIT:
                    self._done_rids.popitem(last=False)
                self._n_completed.inc()
                if self.on_complete is not None:
                    self.on_complete(rid, st.tokens)
                return
            if self.on_progress is not None:
                self.on_progress(rid)
            nxt = st.window.pop(st.next_seq, None)
            if nxt is None:
                return
            row = nxt

    # -- consumption ----------------------------------------------------------

    def pop_completed(self) -> list[tuple[int, list[int]]]:
        """Finished streams accumulated since the last pop — each rid is
        yielded exactly once across all pops (late duplicate chunks are
        still recognized through the bounded ``_done_rids`` record)."""
        out = list(self._completed.items())
        self._completed.clear()
        return out

    def __iter__(self):
        return iter(self.pop_completed())

    def result(self, rid: int) -> list[int] | None:
        return self._completed.get(rid)

    # -- per-shard snapshot (router tie-breaking + benchmark reporting) --------

    def shard_depths(self) -> dict[int, int]:
        return {k: rec["depth"] for k, rec in self._shard.items()}

    def shard_stats(self) -> dict[int, dict]:
        out: dict[int, dict] = {}
        for k, rec in self._shard.items():
            lat = sorted(rec["lat"])
            out[k] = {
                "depth": rec["depth"],
                "chunks": rec["chunks"],
                "last_seen": rec["last_seen"],
                "lat_p50": lat[len(lat) // 2] if lat else None,
                "lat_max": lat[-1] if lat else None,
            }
        return out

    def stats(self) -> dict:
        return {
            "chunks": self.chunks,
            "completed": self.n_completed,
            "open_streams": len(self._streams),
            "duplicates": self.duplicates,
            "gaps": self.gaps,
            "superseded": self.superseded,
            "stale_gen": self.stale_gen,
            "dropped_window": self.dropped_window,
        }

    def close(self) -> None:
        for sub in self.subs:
            sub.close()
