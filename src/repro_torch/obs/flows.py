"""Cross-process flow reconstruction over a domain's trace rings.

The aggregator attaches every ring segment of a domain (live and dead
writers alike — rings deliberately survive their process), merges the
records of one ``trace_id`` across ``(hop, process)`` boundaries into a
causally-ordered flow, and decomposes response time into per-stage
latencies — the repro's analogue of the paper's Fig. 13/14 CARET
analysis.

Two flow families share the machinery:

* **message flows** (minted by ``Publisher.publish``): canonical stage
  chain ``publish → notify → take → callback_start → callback_end →
  release``, with ``bridge_out``/``bridge_in`` pairs inserted per bridge
  hop (the ``hop`` field keeps repeated stages of a relayed message
  distinct);
* **serving flows** (minted per rid by ``ShardRouter``): ``serve_enqueue
  (hop 0, head) → serve_flush (hop 0) → serve_enqueue (hop 1, replica)
  → serve_reassemble × chunks (hop 2, collector)``; the stream's eos
  chunk carries ``FLAG_EOS`` and is the terminal record.

A flow with no terminal record is **truncated** — the writer died (or
the run stopped) mid-flow.  Reconstruction is snapshot-based and never
blocks on a writer, so a SIGKILLed replica yields a truncated flow, not
a hang; its respawned incarnation's records land in a *new* flow because
replay mints a fresh ``trace_id``.

The port's copy of ``repro/obs/flows.py``: only the import paths differ.
The rings are the reference's, so either package's aggregator reads
either package's rings and rebuilds the same flows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .trace import FLAG_EOS, STAGE_NAMES, Stage, TraceReader, ring_names

__all__ = ["Flow", "FlowAggregator", "MESSAGE_CHAIN", "BREAKDOWN_PAIRS"]

# the canonical single-hop message lifecycle, in causal order
MESSAGE_CHAIN = (Stage.PUBLISH, Stage.NOTIFY, Stage.TAKE, Stage.CB_START,
                 Stage.CB_END, Stage.RELEASE)

# per-stage latency decomposition (name, from_stage, to_stage); the deltas
# telescope to release_t - publish_t, which is what lets the fig18 check
# compare their sum against an independently measured end-to-end latency
BREAKDOWN_PAIRS = (
    ("publish_to_wakeup", Stage.PUBLISH, Stage.NOTIFY),
    ("wakeup_to_take", Stage.NOTIFY, Stage.TAKE),
    ("take_to_callback", Stage.TAKE, Stage.CB_START),
    ("callback", Stage.CB_START, Stage.CB_END),
    ("callback_to_release", Stage.CB_END, Stage.RELEASE),
)

_SERVE_STAGES = frozenset(
    (Stage.SERVE_ENQ, Stage.SERVE_FLUSH, Stage.SERVE_REASM))


@dataclass
class Flow:
    """Every record of one ``trace_id``, time-ordered (CLOCK_MONOTONIC is
    system-wide, so cross-process ordering is meaningful on one host)."""

    trace_id: int
    records: list = field(default_factory=list)  # (tid,t_ns,hop,stage,flags,arg,pid)

    @property
    def serving(self) -> bool:
        return any(r[3] in _SERVE_STAGES for r in self.records)

    @property
    def pids(self) -> set:
        return {r[6] for r in self.records}

    @property
    def complete(self) -> bool:
        """Did the flow reach its terminal stage?  Serving flows end at an
        eos ``serve_reassemble``; message flows end at ``release``."""
        if self.serving:
            return any(r[3] == Stage.SERVE_REASM and (r[4] & FLAG_EOS)
                       for r in self.records)
        return any(r[3] == Stage.RELEASE for r in self.records)

    @property
    def truncated(self) -> bool:
        return not self.complete

    def first(self, stage: int, hop: int | None = None):
        for r in self.records:
            if r[3] == stage and (hop is None or r[2] == hop):
                return r
        return None

    def stage_times(self) -> list[tuple[str, int, int]]:
        """``(stage_name, hop, t_ns)`` per record, time-ordered."""
        return [(STAGE_NAMES.get(r[3], str(r[3])), r[2], r[1])
                for r in self.records]

    def monotonic(self) -> bool:
        """Timestamps non-decreasing in record order (records are sorted
        by t_ns, so this is an invariant check on the *stage* order: the
        canonical chain positions must not run backwards in time)."""
        ts = [r[1] for r in self.records]
        return all(b >= a for a, b in zip(ts, ts[1:]))

    def breakdown(self) -> dict[str, float]:
        """Per-stage deltas in seconds for the canonical message chain
        (first matching record per stage, first hop); missing stages are
        skipped.  Serving flows get ``enqueue_to_replica`` /
        ``replica_to_first_chunk`` / ``stream`` instead."""
        out: dict[str, float] = {}
        if self.serving:
            enq = self.first(Stage.SERVE_ENQ, 0)
            flushed = self.first(Stage.SERVE_FLUSH, 0)
            renq = self.first(Stage.SERVE_ENQ, 1)
            chunks = [r for r in self.records if r[3] == Stage.SERVE_REASM]
            if enq and flushed:
                out["enqueue_to_flush"] = (flushed[1] - enq[1]) / 1e9
            if flushed and renq:
                out["flush_to_replica"] = (renq[1] - flushed[1]) / 1e9
            if renq and chunks:
                out["replica_to_first_chunk"] = (chunks[0][1] - renq[1]) / 1e9
            if len(chunks) > 1:
                out["stream"] = (chunks[-1][1] - chunks[0][1]) / 1e9
            if enq and chunks and self.complete:
                out["e2e"] = (chunks[-1][1] - enq[1]) / 1e9
            return out
        for name, a, b in BREAKDOWN_PAIRS:
            ra, rb = self.first(a), self.first(b)
            if ra is not None and rb is not None:
                out[name] = (rb[1] - ra[1]) / 1e9
        pub, rel = self.first(Stage.PUBLISH), self.first(Stage.RELEASE)
        if pub is not None and rel is not None:
            out["e2e"] = (rel[1] - pub[1]) / 1e9
        return out


def _pctl(xs: list[float]) -> dict[str, float]:
    a = sorted(xs)
    return {
        "n": len(a),
        "p50": a[len(a) // 2],
        "p99": a[min(len(a) - 1, int(len(a) * 0.99))],
        "max": a[-1],
    }


class FlowAggregator:
    """Attach every trace ring of a domain and rebuild flows.

    Snapshot semantics: ``collect`` re-reads every ring; records emitted
    after the snapshot simply show up next time.  Never blocks — a dead
    writer's ring is read exactly like a live one.
    """

    def __init__(self, domain_name: str):
        self.domain_name = domain_name
        self._readers: dict[str, TraceReader] = {}

    def attach(self) -> int:
        """(Re-)discover rings in /dev/shm; returns the reader count."""
        for name in ring_names(self.domain_name):
            if name in self._readers:
                continue
            try:
                self._readers[name] = TraceReader(name)
            except (FileNotFoundError, ValueError):
                continue  # raced an unlink, or foreign segment
        return len(self._readers)

    def collect(self) -> list[Flow]:
        """One snapshot: every record of every ring, merged by trace_id
        into time-ordered flows (sorted by first timestamp)."""
        self.attach()
        by_tid: dict[int, list] = {}
        for rd in self._readers.values():
            try:
                recs = rd.records()
            except ValueError:
                continue
            for r in recs:
                by_tid.setdefault(r[0], []).append(r)
        flows = []
        for tid, recs in by_tid.items():
            recs.sort(key=lambda r: (r[1], r[2], r[3]))
            flows.append(Flow(tid, recs))
        flows.sort(key=lambda f: f.records[0][1])
        return flows

    def serving_flows(self) -> list[Flow]:
        return [f for f in self.collect() if f.serving]

    def message_flows(self) -> list[Flow]:
        return [f for f in self.collect() if not f.serving]

    def breakdown_stats(self, flows: list[Flow] | None = None) -> dict:
        """p50/p99/max seconds per breakdown stage over ``flows``
        (complete message flows by default) — Fig. 13/14 style."""
        if flows is None:
            flows = [f for f in self.message_flows() if f.complete]
        acc: dict[str, list[float]] = {}
        for f in flows:
            for name, dt in f.breakdown().items():
                acc.setdefault(name, []).append(dt)
        return {name: _pctl(xs) for name, xs in acc.items() if xs}

    def close(self, *, unlink: bool = False) -> None:
        """Detach every reader; ``unlink=True`` additionally removes the
        segments (the aggregator owns cleanup — writers never unlink)."""
        for rd in self._readers.values():
            rd.close(unlink=unlink)
        self._readers = {}
