"""Replica pool: spawn/own an *elastic* set of server replicas.

Each replica is one child process running
:func:`repro_torch.serving.replica.replica_main`: its own ``EventExecutor``,
its own request-shard subscription (``<prefix>/<k>``), its own results
publisher.  The pool is the head-side owner of the fleet's process
lifecycle; the :class:`~repro_torch.serving.controller.FleetController` drives
it from the head's event loop:

* **spawn / respawn** — every (re)spawn is a fresh *incarnation*: a new
  ``Process``, a new ready event, a new per-shard stop event.  All
  per-shard state (``_procs``/``_ready``/``_stops``) is keyed off the
  current incarnation, so ``kill``/``wait_ready`` after a respawn target
  the live process, never a dead predecessor's objects;
* **retire / reap** — clean scale-down: ``retire`` flips the shard's own
  stop event (the replica drains: in-flight callbacks finish, buffered
  chunks flush) and parks the process on the non-blocking reap list —
  the head's event loop must never join() a child inline, or the
  collector stops pumping exactly when the retiree flushes its last
  chunks;
* **liveness** — two detectors, both required by the respawn story:
  PID death (``Process.is_alive``) for crashed/killed replicas, and the
  registry's *subscriber lease* (stamped by every ``take`` and by the
  replica's heartbeat timer) for wedged ones — alive but no longer
  consuming.  ``poll()`` reports newly-dead shards exactly once; the
  controller removes them from the router's ring (re-hashing their
  in-flight rids onto survivors) and respawns them.

Liveness-cache invalidation rules (the ``_tidx`` cache): the request
topic's index is cached per shard so the lease poll stays off the
``topic_index`` path, but a cached index is only trusted while the
topic row's *generation* matches the one captured at resolve time —
layout v4 recycles topic slots (destroy + create bumps ``gen``), and a
stale index would read another topic's leases.  The cache is dropped
eagerly on every death, respawn, and retire (the events that change
which incarnation's lease matters) and lazily on any generation
mismatch.

The port's copy of ``repro/serving/pool.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import time

from repro_torch.core.topic import Domain
from repro_torch.obs import metrics as _metrics

from .replica import replica_main

__all__ = ["ReplicaPool"]


class ReplicaPool:
    def __init__(self, dom: Domain, shards, *, req_prefix: str = "serve/req",
                 res_topic: str = "serve/res", model: str = "echo",
                 model_kwargs: dict | None = None, slots: int = 4,
                 max_seq: int = 256, depth: int = 16, arena_mb: int = 32,
                 round_period_s: float = 0.002, lease_period_s: float = 0.25,
                 lease_timeout_s: float = 10.0, flush_every: int = 1,
                 sharded_results: bool = True):
        self.dom = dom
        self.req_prefix = req_prefix
        self.res_topic = res_topic
        # per-shard results topics (<res_topic>/<k>): replicas stop
        # contending on one topic row; pair with ResultsCollector(shards=…)
        self.sharded_results = sharded_results
        self.model = model
        self.model_kwargs = model_kwargs
        self.slots = slots
        self.max_seq = max_seq
        self.depth = depth
        self.arena_mb = arena_mb
        self.round_period_s = round_period_s
        self.lease_period_s = lease_period_s
        self.lease_timeout_s = lease_timeout_s
        self.flush_every = flush_every
        # shard -> (request-topic index, topic generation at resolve time);
        # see "Liveness-cache invalidation rules" in the module docstring
        self._tidx: dict[int, tuple[int, int]] = {}
        self._ctx = mp.get_context("spawn")
        self._procs: dict[int, mp.Process] = {}
        self._ready: dict[int, mp.Event] = {}
        self._stops: dict[int, mp.Event] = {}
        self._retiring: dict[int, mp.Process] = {}
        self._incarnation: dict[int, int] = {}
        self._alive: set[int] = set()
        self._dead: set[int] = set()
        # fleet-size gauges (weakly registered — the pool keeps them alive)
        self._gauges = (
            _metrics.gauge("pool.alive", fn=lambda: len(self._alive)),
            _metrics.gauge("pool.dead", fn=lambda: len(self._dead)),
            _metrics.gauge("pool.retiring", fn=lambda: len(self._retiring)),
        )
        self._spawns = _metrics.counter("pool.spawns")
        for k in shards:
            self._spawn(int(k))

    # -- lifecycle ------------------------------------------------------------

    def res_topic_for(self, shard: int) -> str:
        return (f"{self.res_topic}/{shard}" if self.sharded_results
                else self.res_topic)

    def _spawn(self, shard: int) -> None:
        ready = self._ctx.Event()
        stop = self._ctx.Event()  # per-shard: retire() must not stop siblings
        self._tidx.pop(shard, None)  # fresh incarnation: cached index is void
        proc = self._ctx.Process(
            target=replica_main,
            args=(self.dom.name, shard, f"{self.req_prefix}/{shard}",
                  self.res_topic_for(shard)),
            kwargs=dict(model=self.model, model_kwargs=self.model_kwargs,
                        slots=self.slots, max_seq=self.max_seq,
                        depth=self.depth, arena_mb=self.arena_mb,
                        round_period_s=self.round_period_s,
                        lease_period_s=self.lease_period_s,
                        flush_every=self.flush_every,
                        stop_event=stop, ready_event=ready),
            daemon=True,
        )
        proc.start()
        self._procs[shard] = proc
        self._ready[shard] = ready
        self._stops[shard] = stop
        self._incarnation[shard] = self._incarnation.get(shard, -1) + 1
        self._alive.add(shard)
        self._spawns.inc()

    def spawn(self, shard: int) -> None:
        """Scale-up: launch a brand-new shard's replica (the caller adds it
        to the router's ring once :meth:`ready` reports it subscribed)."""
        shard = int(shard)
        if shard in self._alive or shard in self._retiring:
            raise ValueError(f"shard {shard} already running")
        self._dead.discard(shard)
        self._spawn(shard)

    def respawn(self, shard: int) -> None:
        """Re-spawn a dead shard's process as a fresh incarnation.

        Reaps the dead predecessor (a *wedged* one — stale lease, PID
        alive — is SIGKILLed first: two incarnations must never consume
        the same shard topic) and sweeps the registry so the dead
        subscriber's slot and held refs are released before the successor
        subscribes.  The generation gate makes any replayed rids the
        successor re-receives safe (stale generations are rejected; the
        collector supersedes/dedups the rest)."""
        shard = int(shard)
        if shard in self._alive:
            raise ValueError(f"shard {shard} is still alive")
        if shard in self._retiring:
            raise ValueError(f"shard {shard} is retiring — two incarnations "
                             "must never consume the same shard topic")
        old = self._procs.get(shard)
        if old is not None:
            if old.is_alive():  # wedged, not dead: evict the incarnation
                if old.pid is not None:
                    os.kill(old.pid, signal.SIGKILL)
            old.join(timeout=10)
        self.dom.registry.sweep()
        self._dead.discard(shard)
        self._spawn(shard)

    def next_shard(self) -> int:
        """The next unused shard index (scale-up picks fresh topics so a
        new replica never inherits a retired shard's backlog)."""
        used = (set(self._procs) | set(self._retiring) | self._dead
                | set(self._incarnation))
        return max(used, default=-1) + 1

    def ready(self, shard: int) -> bool:
        """Has the *current* incarnation subscribed + loaded its model?"""
        ev = self._ready.get(shard)
        return ev is not None and ev.is_set()

    def incarnation(self, shard: int) -> int:
        """0 for the first spawn, +1 per respawn (tests / observability)."""
        return self._incarnation.get(shard, -1)

    def wait_ready(self, timeout: float = 120.0, shards=None) -> None:
        """Block until every *live* replica (or ``shards``) subscribed +
        loaded its model.  Keyed off the current incarnations only: dead
        shards' stale events are never waited on (a shard that died before
        ready is the controller's problem, not a reason to burn the whole
        timeout here).  Unlike the reference's, it raises as soon as a
        replica's process exits before it is ready (a failed model build)."""
        targets = sorted(self._alive) if shards is None else \
            [int(s) for s in shards]
        deadline = time.monotonic() + timeout
        for shard in targets:
            ev = self._ready.get(shard)
            if ev is None:
                raise KeyError(f"shard {shard} has no live incarnation")
            # a replica whose build failed exits before it is ready: raise
            # then, not at the timeout
            proc = self._procs[shard]
            while not ev.wait(min(0.5, max(0.0, deadline - time.monotonic()))):
                if not proc.is_alive() and not ev.is_set():
                    raise RuntimeError(f"replica {shard} exited (code "
                                       f"{proc.exitcode}) before it was ready")
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"replica {shard} not ready in {timeout}s")

    @property
    def shards(self) -> list[int]:
        return sorted(self._alive)

    def is_alive(self, shard: int) -> bool:
        return shard in self._alive

    # -- chaos hook (tests / benchmark kill-one) -------------------------------

    def kill(self, shard: int) -> None:
        """SIGKILL a replica mid-run (no cleanup, no atexit): the crash the
        respawn + replay path exists for.  Targets the current incarnation
        — after a respawn, ``_procs[shard]`` *is* the live process."""
        proc = self._procs[shard]
        if proc.pid is not None and proc.is_alive():
            os.kill(proc.pid, signal.SIGKILL)
        proc.join(timeout=10)

    # -- liveness -------------------------------------------------------------

    def _lease_stale(self, shard: int) -> bool:
        """True when the replica's request-topic subscriber lease (stamped
        on every take and by its heartbeat timer) is past the timeout —
        the wedged-replica detector.  The cached topic index is validated
        against the topic row's generation: a recycled slot (destroy +
        re-create bumps ``gen``) must never be read as this shard's
        leases."""
        reg = self.dom.registry
        cached = self._tidx.get(shard)
        if cached is not None:
            tidx, tgen = cached
            if reg.topic_gen(tidx) != tgen:
                self._tidx.pop(shard, None)  # slot recycled under us
                cached = None
        if cached is None:
            try:
                tidx = reg.topic_index(f"{self.req_prefix}/{shard}",
                                       create=False)
            except Exception:
                return False  # replica has not subscribed yet
            self._tidx[shard] = (tidx, reg.topic_gen(tidx))
        else:
            tidx = cached[0]
        ages = reg.lease_ages(tidx)
        if not ages:
            return False
        return min(ages.values()) > self.lease_timeout_s

    def poll(self) -> list[int]:
        """Newly-dead shards (reported exactly once per incarnation): PID
        death or a stale lease.  Sweeps the registry when anything died so
        the dead subscriber's held refs and publisher slots are released,
        and drops the dead shard's liveness cache (its next incarnation
        re-resolves)."""
        dead: list[int] = []
        for shard in sorted(self._alive):
            proc = self._procs[shard]
            if not proc.is_alive() or self._lease_stale(shard):
                dead.append(shard)
        if dead:
            for shard in dead:
                self._alive.discard(shard)
                self._dead.add(shard)
                self._tidx.pop(shard, None)
            self.dom.registry.sweep()
        return dead

    # -- scale-down -----------------------------------------------------------

    def retire(self, shard: int) -> None:
        """Begin a clean scale-down of one replica: flip its own stop event
        (the replica drains and exits) and park the process for
        :meth:`reap`.  Non-blocking by design — the head's event loop must
        keep pumping the collector while the retiree flushes its final
        chunks, so nobody join()s here."""
        shard = int(shard)
        if shard not in self._alive:
            raise ValueError(f"shard {shard} is not alive")
        self._stops[shard].set()
        self._alive.discard(shard)
        self._retiring[shard] = self._procs.pop(shard)
        self._ready.pop(shard, None)
        self._stops.pop(shard, None)
        self._tidx.pop(shard, None)

    def reap(self) -> list[int]:
        """Collect retirees that finished draining (non-blocking); sweeps
        once when any were reaped."""
        done = []
        for shard, proc in list(self._retiring.items()):
            if not proc.is_alive():
                proc.join(timeout=1)
                del self._retiring[shard]
                done.append(shard)
        if done:
            self.dom.registry.sweep()
        return done

    # -- teardown -------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "alive": sorted(self._alive),
            "dead": sorted(self._dead),
            "retiring": sorted(self._retiring),
            "incarnations": dict(self._incarnation),
        }

    def stop(self, timeout: float = 30.0) -> None:
        for stop in self._stops.values():
            stop.set()
        procs = list(self._procs.values()) + list(self._retiring.values())
        deadline = time.monotonic() + timeout
        for proc in procs:
            proc.join(timeout=max(0.1, deadline - time.monotonic()))
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        self.dom.registry.sweep()

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
