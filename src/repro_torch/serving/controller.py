"""FleetController: the elastic control loop over pool + router + collector.

One ``tick()`` — run from the head's event loop on a timer — closes the
loop the static fleet never had.  Each tick:

1. **death handling** — ``pool.poll()`` reports crashed/wedged replicas;
   their shard leaves the router's ring (re-hashing exactly its in-flight
   rids onto survivors, generation+1) and a respawn starts immediately,
   bounded by a per-shard budget + backoff so a crash-looping replica
   cannot flap the ring forever.  A death that would empty the ring is
   parked and retried once a survivor exists — rids wait in the replay
   records, never route into the void;
2. **respawn/scale-up completion** — a (re)spawned replica joins the ring
   only once ``pool.ready(shard)``: rows published before its
   subscription exists would be QoS-dropped, never delivered.  The
   collector ``watch``\\ es new shards' results topics the moment they are
   conceived, so no chunk can beat its subscription;
3. **autoscale** — the fleet's load signal is outstanding rids per live
   replica (router in-flight + admission queue, plus the collector's
   replica-reported depths).  Sustained above ``depth_high`` for
   ``sustain_s`` → spawn one replica (up to ``max_k``); sustained below
   ``depth_low`` → retire the shallowest (down to ``min_k``), replaying
   its in-flight rids first.  ``cooldown_s`` separates scaling actions so
   one burst cannot thrash the fleet size.  Consistent hashing bounds the
   rid movement of every membership change to ~1/K;
4. **work stealing** — when one live shard is drained (no router load, no
   replica-reported depth) while another holds at least
   ``steal_threshold`` outstanding rids, up to ``steal_batch`` *cold*
   rids (no chunk landed yet) move to the drained shard through
   ``router.steal`` — the SERVE_REQ generation gate resolves the
   resulting race to exactly one completion;
5. **flush + reap** — everything the tick buffered (replays, steals,
   queued admissions) ships, and retired replicas that finished draining
   are reaped without ever join()ing inline on the event loop.

Scale-down ordering matters: the ring shrinks *before* the replica is
told to stop, so its in-flight rids are already replayed (gen+1) onto
survivors while the retiree drains — whichever copy completes first
wins, the other is superseded/deduped by the collector.  Zero loss,
exactly once, no drain barrier.

The port's copy of ``repro/serving/controller.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import time

from repro_torch.obs import metrics as _metrics

__all__ = ["FleetController"]


class FleetController:
    def __init__(self, pool, router, collector, *,
                 min_k: int = 1, max_k: int = 8,
                 depth_high: float = 8.0, depth_low: float = 1.0,
                 sustain_s: float = 1.0, cooldown_s: float = 3.0,
                 autoscale: bool = True, respawn: bool = True,
                 max_respawns: int = 5, respawn_backoff_s: float = 0.5,
                 steal_threshold: int = 4, steal_batch: int = 2,
                 stall_replay_s: float = 10.0, flush_timeout_s: float = 10.0):
        if min_k < 1 or max_k < min_k:
            raise ValueError("need 1 <= min_k <= max_k")
        self.pool = pool
        self.router = router
        self.collector = collector
        self.min_k = min_k
        self.max_k = max_k
        self.depth_high = depth_high
        self.depth_low = depth_low
        self.sustain_s = sustain_s
        self.cooldown_s = cooldown_s
        self.autoscale = autoscale
        self.respawn = respawn
        self.max_respawns = max_respawns
        self.respawn_backoff_s = respawn_backoff_s
        self.steal_threshold = steal_threshold
        self.steal_batch = steal_batch
        self.stall_replay_s = stall_replay_s
        self.flush_timeout_s = flush_timeout_s
        self._joining: set[int] = set()       # spawned, awaiting ready
        self._respawn_at: dict[int, float] = {}   # backoff deadlines
        self._respawn_count: dict[int, int] = {}
        self._pending_removal: set[int] = set()   # ring would have emptied
        self._above_since: float | None = None
        self._below_since: float | None = None
        self._last_scale_at = 0.0
        # counters (observability + tests) — unified metrics registry,
        # with read-only shims for every existing `ctl.deaths` reader
        self._deaths = _metrics.counter("controller.deaths")
        self._respawns = _metrics.counter("controller.respawns")
        self._scale_ups = _metrics.counter("controller.scale_ups")
        self._scale_downs = _metrics.counter("controller.scale_downs")
        self._gauges = (
            _metrics.gauge("controller.load", fn=self._load),
            _metrics.gauge("controller.k", fn=lambda: len(self.router.ring)),
        )
        self.abandoned: list[int] = []        # respawn budget exhausted

    @property
    def deaths(self) -> int:
        return self._deaths.value

    @property
    def respawns(self) -> int:
        return self._respawns.value

    @property
    def scale_ups(self) -> int:
        return self._scale_ups.value

    @property
    def scale_downs(self) -> int:
        return self._scale_downs.value

    # -- wiring ---------------------------------------------------------------

    def attach_executor(self, executor, *, period_s: float = 0.05,
                        group=None):
        """Run the control loop on the head's event loop."""
        return executor.add_timer(period_s, self.tick, group=group)

    # -- the control loop -----------------------------------------------------

    def tick(self) -> None:
        now = time.monotonic()
        self._handle_deaths(now)
        self._complete_joins()
        if self.autoscale:
            self._autoscale(now)
        self._steal()
        for rid in self.router.stalled(self.stall_replay_s):
            self.router.replay(rid)  # lost-chunk safety net (gap never fills)
        self.pool.reap()
        self.router.flush(timeout=self.flush_timeout_s)

    # -- death + respawn ------------------------------------------------------

    def _handle_deaths(self, now: float) -> None:
        for shard in self.pool.poll():
            self._deaths.inc()
            self._joining.discard(shard)  # died before (or after) joining
            if shard in self.router.ring:
                if len(self.router.ring) > 1:
                    self.router.remove_shard(shard)
                else:
                    # sole survivor died: removal would strand the replay
                    # records with no target — keep the ring as-is and
                    # finish the removal (which replays) once a respawn or
                    # scale-up produced a live target
                    self._pending_removal.add(shard)
            if self.respawn:
                n = self._respawn_count.get(shard, 0)
                if n >= self.max_respawns:
                    if shard not in self.abandoned:
                        self.abandoned.append(shard)
                    continue
                # linear backoff: a replica that dies during startup would
                # otherwise hot-loop spawn (each spawn costs a core)
                self._respawn_at[shard] = now + self.respawn_backoff_s * n
        for shard, at in list(self._respawn_at.items()):
            if now < at or self.pool.is_alive(shard):
                continue
            del self._respawn_at[shard]
            self._respawn_count[shard] = self._respawn_count.get(shard, 0) + 1
            self.pool.respawn(shard)
            self.collector.watch(shard)
            self._joining.add(shard)
            self._respawns.inc()

    def _complete_joins(self) -> None:
        for shard in [s for s in self._joining if self.pool.ready(s)]:
            self._joining.discard(shard)
            self._finish_pending_removal(live=shard)
            self.router.add_shard(shard)

    def _finish_pending_removal(self, live: int) -> None:
        """A parked sole-survivor removal can complete now that ``live``
        is joining: its rids finally have somewhere to replay to."""
        for dead in list(self._pending_removal):
            self._pending_removal.discard(dead)
            if dead == live:
                # the same shard came back: its rids were never replayed
                # (no survivor existed) and their delivered-but-unprocessed
                # copies died with the old incarnation — replay them now,
                # gen+1, onto the fresh incarnation
                for rec in list(self.router.inflight.values()):
                    if rec.shard == dead:
                        self.router.replay(rec.rid)
                continue
            if dead in self.router.ring:
                self.router.add_shard(live)  # ensure a target exists first
                self.router.remove_shard(dead)

    # -- autoscale ------------------------------------------------------------

    def _load(self) -> float:
        """Outstanding rids per live replica: the router's exact in-flight
        count + head-side admission queue, cross-checked with the
        replicas' self-reported depths (which lag but include work the
        router already handed off)."""
        live = [s for s in self.router.ring.shards
                if self.pool.is_alive(int(s))]
        if not live:
            return 0.0
        rstats = self.router.stats()
        outstanding = rstats["inflight"] + rstats["queued"]
        depths = self.collector.shard_depths()
        reported = sum(depths.get(int(s), 0) for s in live)
        return max(outstanding, reported) / len(live)

    def _autoscale(self, now: float) -> None:
        load = self._load()
        k = len([s for s in self.router.ring.shards
                 if self.pool.is_alive(int(s))])
        if load > self.depth_high and k + len(self._joining) < self.max_k:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            elif (now - self._above_since >= self.sustain_s
                    and now - self._last_scale_at >= self.cooldown_s):
                self.scale_up()
                self._above_since = None
        elif load < self.depth_low and k > self.min_k:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            elif (now - self._below_since >= self.sustain_s
                    and now - self._last_scale_at >= self.cooldown_s):
                self.scale_down()
                self._below_since = None
        else:
            self._above_since = self._below_since = None

    def scale_up(self) -> int:
        """Spawn one fresh replica (joins the ring on ready)."""
        shard = self.pool.next_shard()
        self.pool.spawn(shard)
        self.collector.watch(shard)  # before any chunk can possibly publish
        self._joining.add(shard)
        self._last_scale_at = time.monotonic()
        self._scale_ups.inc()
        return shard

    def scale_down(self, shard: int | None = None) -> int | None:
        """Retire one replica (the shallowest, unless pinned): ring first
        — replays its in-flight rids onto survivors — then a clean drain."""
        live = [int(s) for s in self.router.ring.shards
                if self.pool.is_alive(int(s))]
        if len(live) <= self.min_k:
            return None
        if shard is None:
            loads = self.router._shard_load
            shard = min(live, key=lambda s: loads.get(s, 0))
        if len(self.router.ring) > 1 and shard in self.router.ring:
            self.router.remove_shard(shard)
        self.pool.retire(shard)
        self._last_scale_at = time.monotonic()
        self._scale_downs.inc()
        return shard

    # -- work stealing --------------------------------------------------------

    def _steal(self) -> None:
        depths = self.collector.shard_depths()
        loads = self.router._shard_load
        live = [int(s) for s in self.router.ring.shards
                if self.pool.is_alive(int(s)) and self.pool.ready(int(s))]
        if len(live) < 2:
            return
        def outstanding(s: int) -> int:
            return loads.get(s, 0) + depths.get(s, 0)
        drained = [s for s in live
                   if loads.get(s, 0) == 0 and depths.get(s, 0) == 0]
        if not drained:
            return
        deepest = max(live, key=outstanding)
        if outstanding(deepest) < self.steal_threshold:
            return
        self.router.steal(drained[0], deepest, limit=self.steal_batch)

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "deaths": self.deaths,
            "respawns": self.respawns,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "joining": sorted(self._joining),
            "pending_removal": sorted(self._pending_removal),
            "abandoned": list(self.abandoned),
            "load": self._load(),
            "k": len(self.router.ring),
        }
