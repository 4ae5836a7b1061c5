"""Replica process: one shard's server behind one EventExecutor.

``replica_main`` is the spawn-safe entrypoint the pool launches: join the
domain, subscribe to this shard's request topic, publish token chunks on
the shared results topic, and run one continuous-batching server on one
event loop.  Two server flavours behind the same wiring:

* ``model="echo"`` — :class:`EchoServer`, a torch-free stand-in that emits
  one deterministic token per rid per round (tests, fast demos: spawn
  cost is numpy + repro_torch.core only);
* anything else — the port's :class:`repro_torch.runtime.InferenceServer`
  (prefill/decode through the Hopper kernels on the GPU, or their plain
  versions when ``model_kwargs`` asks for ``device="cpu"``), built from
  ``model_kwargs`` inside the child so the spawn args stay primitives.

Both implement the replica discipline:

* requests enter through ``ingest_serve_message`` — the generation gate
  makes replayed rids decode exactly once per generation;
* every decode round's new tokens flush as ONE ``SERVE_RES`` publish
  (``on_round_end``), with event-driven backpressure toward the
  collector;
* a heartbeat timer refreshes the subscriber lease while idle (busy
  replicas are stamped by every take, and a publish waiting on a full
  results ring stamps it too), so the pool can tell wedged from quiet;
* shutdown is drain-then-exit: pending callbacks finish, in-flight
  requests run to completion (bounded), buffered chunks flush.

The port's copy of ``repro/serving/replica.py``.  ``_build_torch_server``
takes the place of the reference's ``_build_jax_server``.  A publish that
waits on a full results ring keeps the lease fresh (the reference's lets
it go stale, and the pool then declares a backpressured replica dead).  A
torch replica exports its kernel launch counts
(``kernel.<name>.launches``), its device and its peak device memory
through the metrics plane (:class:`repro_torch.obs.metrics.MetricsExporter`;
``read_exports`` reads them from another process).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from repro_torch.core.executor import EventExecutor
from repro_torch.core.registry import AgnocastQueueFull
from repro_torch.core.topic import Domain
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .messages import (
    SERVE_REQ,
    SERVE_RES,
    GenerationGate,
    ResRow,
    iter_requests,
    pack_results,
)

__all__ = ["EchoServer", "replica_main"]


class EchoServer:
    """torch-free continuous-batching stand-in.

    One token per active rid per ``step_rounds`` call, deterministic in
    (prompt, position) — a replayed rid reproduces the identical stream on
    any replica, which is what lets the exactly-once tests compare replayed
    output bit-for-bit.  Mirrors the ``InferenceServer`` serving surface
    (``queue``/``_active``/``step_rounds``/``ingest_serve_message``/
    ``stream_sink``/``idle``) so the same executor wiring drives both.
    """

    def __init__(self, *, slots: int = 4, vocab: int = 50021):
        self.slots = slots
        self.vocab = vocab
        self.queue: deque[dict] = deque()
        self._active: dict[int, dict] = {}
        self.stream_sink = None           # callable(rid, gen, seq, tokens, eos)
        self.steps = 0
        self._gate = GenerationGate()

    # -- deterministic "decode" ------------------------------------------------

    def _token(self, st: dict, i: int) -> int:
        return int((st["base"] + 131 * i + 7) % self.vocab)

    # -- ingest (the shared SERVE_REQ generation gate) -------------------------

    def ingest_serve_message(self, ptr, *, max_new: int = 16) -> int:
        mnew = int(ptr.get("max_new")) or max_new
        admitted = 0
        for row in iter_requests(ptr):
            if not self._gate.admit(row.rid, row.gen, supersede=self.cancel):
                continue
            self.queue.append({
                "rid": row.rid, "gen": row.gen, "max_new": mnew,
                "base": int(np.asarray(row.tokens, np.int64).sum()),
                "emitted": 0,
            })
            admitted += 1
        return admitted

    def cancel(self, rid: int) -> bool:
        self._gate.drop(rid)
        if rid in self._active:
            del self._active[rid]
            return True
        n = len(self.queue)
        self.queue = deque(st for st in self.queue if st["rid"] != rid)
        return len(self.queue) != n

    # -- rounds ----------------------------------------------------------------

    def _emit(self, st: dict, eos: bool) -> None:
        i = st["emitted"]
        if self.stream_sink is not None:
            self.stream_sink(st["rid"], st["gen"], i, [self._token(st, i)],
                             eos)
        st["emitted"] = i + 1

    def _finish(self, rid: int) -> None:
        self._active.pop(rid, None)
        self._gate.finish(rid)

    def step_rounds(self) -> None:
        while self.queue and len(self._active) < self.slots:
            st = self.queue.popleft()
            self._emit(st, st["max_new"] <= 1)  # "prefill": first token
            if st["max_new"] <= 1:
                self._finish(st["rid"])
            else:
                self._active[st["rid"]] = st
        for rid in list(self._active):
            st = self._active[rid]
            eos = st["emitted"] + 1 >= st["max_new"]
            self._emit(st, eos)
            if eos:
                self._finish(rid)
        self.steps += 1

    @property
    def idle(self) -> bool:
        return not self.queue and not self._active

    def attach_executor(self, executor, sub, *, group=None, max_new: int = 16,
                        round_period_s: float = 0.002, on_round_end=None):
        """The shared arm-only-while-busy wiring
        (:func:`repro_torch.serving.attach.attach_server_executor`), with the
        serve-row ingest bound in."""
        from .attach import attach_server_executor

        return attach_server_executor(
            self, executor, sub, group=group, max_new=max_new,
            round_period_s=round_period_s,
            ingest=lambda ptr: self.ingest_serve_message(ptr,
                                                         max_new=max_new),
            on_round_end=on_round_end)


# the kernel wrappers a torch replica counts, by the name of their metric
# ``kernel.<name>.launches``: (module, wrapper)
KERNEL_WRAPPERS = {
    "rmsnorm": ("repro_torch.kernels.rmsnorm.ops", "fused_rmsnorm"),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops",
                        "flash_attention"),
    "decode_attention": ("repro_torch.kernels.decode_attention.ops",
                         "decode_attention"),
    "slstm_scan": ("repro_torch.kernels.slstm_scan.ops", "slstm_scan"),
}
PREWARM_PROMPT = 384  # the longest prompt the fleet sends by default


MODEL_KEYS = ("arch", "size", "dtype", "device")


def model_config(model_kwargs: dict | None):
    """The ``(ModelConfig, device)`` a torch replica serves for
    ``model_kwargs``: ``arch`` (default qwen2-1.5b), ``size`` (``smoke``,
    ``100m`` or ``full``; default ``100m``, the reference replica's
    ``model_100m``), ``dtype`` (the config's own unless given) and
    ``device`` (``cuda`` unless ``"cpu"``).  Any other key raises."""
    from repro_torch.launch.serve import build_config

    kw = dict(model_kwargs or {})
    unknown = sorted(set(kw) - set(MODEL_KEYS))
    if unknown:
        raise ValueError(f"model_kwargs: unknown keys {unknown}; "
                         f"a torch replica takes {list(MODEL_KEYS)}")
    cfg = build_config(kw.get("arch", "qwen2-1.5b"), kw.get("size", "100m"))
    dtype = kw.get("dtype")
    if dtype is not None:
        cfg = cfg.scaled(param_dtype=dtype, compute_dtype=dtype)
    return cfg, kw.get("device")


def _build_torch_server(model: str, model_kwargs: dict | None, *, slots: int,
                        max_seq: int, shard: int):
    """Real replica: the port's InferenceServer for :func:`model_config`
    ``(model_kwargs)``, built inside the child.  Without a card and without
    ``device="cpu"`` the build raises, and the replica never reports ready.
    Every replica loads ``init(seed=0)``, the same weights, and serves one
    request before it reports ready, so the first real request builds
    nothing."""
    import os

    # one replica = one host thread: the fleet's parallelism is processes
    # (and the card), and K replicas each spinning a full OpenMP pool
    # thrash the host.  Set before the child's first torch import (spawn
    # guarantees this function runs pre-import).
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

    import torch

    from repro_torch.launch.serve import warmup
    from repro_torch.models import Model
    from repro_torch.runtime.server import InferenceServer

    cfg, device = model_config(model_kwargs)
    m = Model(cfg, device=device)
    if m.device.type == "cpu":
        torch.set_num_threads(1)
    server = InferenceServer(m, slots=slots, max_seq=max_seq)
    server.load(m.init(0))  # every replica: same weights
    # prewarm BEFORE ready: loading the kernels, the cuBLAS handles and
    # the allocator's first blocks must not happen inside the first
    # request's callback, where it would starve the lease heartbeat
    warmup(server, cfg.vocab_size, min(PREWARM_PROMPT, max_seq - 3))
    return server


def _kernel_metrics(server, shard: int):
    """Counters ``kernel.<name>.launches`` over the wrappers' own launch
    counts (zeroed here, after the prewarm, so they count served requests
    only), plus the replica's shard, device and peak device memory as
    gauges.
    Returns ``sync()``, which copies the wrappers' counts into the
    counters, and the metrics (the registry holds them weakly)."""
    import importlib

    import torch

    wrappers = {name: getattr(importlib.import_module(mod), fn)
                for name, (mod, fn) in KERNEL_WRAPPERS.items()}
    for w in wrappers.values():
        w.launches = 0
    counters = {name: _metrics.counter(f"kernel.{name}.launches")
                for name in wrappers}
    dev = server.device
    held = [
        *counters.values(),
        _metrics.gauge("replica.shard", fn=lambda: shard),
        _metrics.gauge("replica.device", fn=lambda: str(dev)),
        _metrics.gauge("replica.peak_mem_bytes",
                       fn=lambda: (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0)),
    ]

    def sync():
        for name, w in wrappers.items():
            counters[name].set(w.launches)

    return sync, held


def replica_main(dom_name: str, shard: int, req_topic: str, res_topic: str, *,
                 model: str = "echo", model_kwargs: dict | None = None,
                 slots: int = 4, max_seq: int = 256, max_new: int = 16,
                 depth: int = 16, arena_mb: int = 32,
                 round_period_s: float = 0.002, lease_period_s: float = 0.25,
                 flush_every: int = 1,
                 stop_event=None, ready_event=None) -> None:
    """Entry point for one replica process (spawn-safe).

    ``flush_every`` optionally batches result publishes across decode
    rounds.  It defaults to 1 (publish every round): the metadata plane is
    sharded per topic, so a replica's request takes contend on nobody and
    its result publishes bid only on the results topic's own lock — the
    domain-wide-flock era, when chunk batching was *required* for
    aggregate throughput to scale with K at all, is over.  Values > 1
    still trade completion latency for fewer metadata ops under extreme
    fan-in.  A round that produced an ``eos`` chunk flushes immediately
    (completion latency is never deferred)."""
    dom = Domain.join(dom_name, arena_capacity=arena_mb << 20)
    exporter = None
    if model == "echo":
        server = EchoServer(slots=slots)
    else:
        server = _build_torch_server(model, model_kwargs, slots=slots,
                                     max_seq=max_seq, shard=shard)
        server.keep_results = False  # we stream; never accumulate
        sync_kernels, _held = _kernel_metrics(server, shard)
        exporter = _metrics.MetricsExporter(dom_name)
        exporter.publish()
    # subscribe only once the server can actually consume: the subscriber
    # lease doubles as the liveness signal, and it must not start ticking
    # while a slow (fleet-contended) model build is still in progress
    sub = dom.create_subscription(SERVE_REQ, req_topic)
    res_pub = dom.create_publisher(SERVE_RES, res_topic, depth=depth)

    should_stop = stop_event.is_set if stop_event is not None else None
    rows: list[ResRow] = []
    eos_pending = [False]
    rounds_unflushed = [0]

    # tracing (repro_torch.obs): each SERVE_REQ row carries the head's trace id;
    # record rid -> tid at ingest (hop 1 = this replica) so every chunk the
    # sink emits travels back to the collector tagged with its flow.  The
    # map is bounded: an entry retires with its rid's eos chunk.
    tr = _trace.tracer_for(dom_name)
    rid_tid: dict[int, int] = {}

    def traced_ingest(ptr):
        if tr is not None:
            for row in iter_requests(ptr):
                if row.tid:
                    rid_tid[row.rid] = row.tid
                    tr.emit(row.tid, 1, _trace.Stage.SERVE_ENQ,
                            arg=row.rid & 0xFFFF_FFFF)
        return server.ingest_serve_message(ptr, max_new=max_new)

    def sink(rid, gen, seq, tokens, eos):
        rid = int(rid)
        tid = rid_tid.get(rid, 0)
        if eos:
            rid_tid.pop(rid, None)
        rows.append(ResRow(rid, gen, seq,
                           np.asarray(tokens, np.int32), eos, tid))
        eos_pending[0] |= eos

    server.stream_sink = sink

    def backpressured():
        # consulted every 50 ms while a publish waits on a full results
        # ring: the replica is alive, so it keeps its lease fresh; a blocked
        # wait without it reads as a wedged replica past the pool's lease
        # timeout
        dom.registry.refresh_lease(sub.tidx, sub.sidx)
        return should_stop is not None and should_stop()

    def publish_rows():
        loan = res_pub.borrow_loaded_message()
        pack_results(loan, rows, shard=shard,
                     depth=len(server.queue) + len(server._active),
                     stamp=time.monotonic())
        try:
            got = res_pub.publish_blocking(loan, timeout=30.0,
                                           should_stop=backpressured)
        except AgnocastQueueFull:
            got = None  # collector stalled past the timeout
        if got is None:
            # stopping or saturated: return the loan, KEEP the rows — the
            # next round's flush retries, and backpressure toward a wedged
            # collector must never crash the replica (mirrors
            # ShardRouter.flush on the request side)
            loan.dealloc()
            return
        rows.clear()
        eos_pending[0] = False
        rounds_unflushed[0] = 0

    def flush(force: bool = True):
        """Publish accumulated chunk rows as one unsized message (event-
        driven backpressure).  The per-round path (``force=False``) defers
        until ``flush_every`` rounds accumulated or a stream completed."""
        if not rows:
            rounds_unflushed[0] = 0
            return
        rounds_unflushed[0] += 1
        if force or eos_pending[0] or rounds_unflushed[0] >= flush_every:
            publish_rows()

    def round_flush():
        if exporter is not None:
            # before the round's chunks leave: a parent that has seen a
            # chunk of this round reads counts that include it
            sync_kernels()
            exporter.publish()
        flush(force=False)

    ex = EventExecutor(name=f"replica-{shard}")
    if model == "echo":
        from .attach import attach_server_executor

        attach_server_executor(server, ex, sub, max_new=max_new,
                               round_period_s=round_period_s,
                               ingest=traced_ingest,
                               on_round_end=round_flush)
    else:
        from repro_torch.runtime.server import attach_serving_executor

        attach_serving_executor(
            server, ex, sub, max_new=max_new, round_period_s=round_period_s,
            ingest=traced_ingest,
            on_round_end=round_flush)
    # idle heartbeat: take() stamps the lease while busy; this covers quiet.
    # It also beacons an empty SERVE_RES once per drain transition — the
    # collector's per-shard depth snapshot otherwise only updates on result
    # publishes, so a drained replica would look as deep as its last busy
    # round forever, and the controller's steal / scale-down decisions key
    # off depth reaching zero.
    last_depth = [-1]

    def heartbeat():
        dom.registry.refresh_lease(sub.tidx, sub.sidx)
        depth = len(server.queue) + len(server._active)
        if depth == 0 and not rows and last_depth[0] != 0:
            loan = res_pub.borrow_loaded_message()
            pack_results(loan, [], shard=shard, depth=0,
                         stamp=time.monotonic())
            try:
                res_pub.publish(loan)
            except AgnocastQueueFull:
                loan.dealloc()  # collector lagging: it has fresher problems
                return
        last_depth[0] = depth

    ex.add_timer(lease_period_s, heartbeat)
    if ready_event is not None:
        ready_event.set()
    try:
        ex.spin(until=should_stop)
        # clean shutdown: finish queued callbacks, run in-flight requests to
        # completion (bounded), flush the last chunks
        ex.drain(2.0)
        deadline = time.monotonic() + 10.0
        while not server.idle and time.monotonic() < deadline:
            server.step_rounds()
            flush()
        flush()
    finally:
        ex.shutdown()
        if exporter is not None:
            sync_kernels()
            exporter.publish()
            exporter.close()  # the segment stays for the parent to read
        res_pub.reclaim()
        dom.close()
