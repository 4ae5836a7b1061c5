"""Elastic sharded serving plane: routing, admission, reassembly, and the
fleet control loop (respawn / autoscale / admission control / stealing).

The first subsystem composed *on top of* the agnocast core rather than
inside it: the Fig. 13 pipeline shape (many nodes, large messages,
selective zero-copy paths) applied to production-style serving.  K server
replicas each own one request shard topic; payloads stay in shared memory
from router to replica to collector — and K is no longer static: the
control loop grows, shrinks, and heals the fleet under load.

    router (head)            replicas (K procs, elastic)   collector (head)
    ShardRouter ──serve/req/k──▶ EchoServer /      ──serve/res/k──▶ ResultsCollector
      consistent hash on rid     InferenceServer               seq window +
      admission shed/queue       one EventExecutor each        gap detection +
      replay gen+1 on loss       lease heartbeats +            gen supersede
      steal to drained shards    idle-depth beacon             per-shard snapshot
                 ▲                          ▲
                 └────── FleetController ───┘
                   respawn dead shards (fresh incarnation, re-add on ready)
                   scale K up/down on sustained depth (ring moves ~1/K rids)
                   steal cold rids deep→drained through the generation gate

The elastic loop in one pass (see :mod:`repro_torch.serving.controller`):
**respawn** — a dead replica's shard leaves the ring (its in-flight rids
replay onto survivors, generation+1), a fresh incarnation spawns with its
own ready/stop events, and the shard rejoins the ring only once the new
process subscribed; **autoscale** — sustained outstanding-rids-per-replica
above/below thresholds spawns/retires replicas between ``min_k`` and
``max_k``, with consistent hashing bounding every membership change's rid
movement to ~1/K; **admission control** — the router sheds (or queues) new
rids at a byte/rid budget instead of hashing bursts into a saturated
fleet; **work stealing** — a drained replica pulls cold rids from the
deepest shard, racing it through the same generation gate that makes
death-replay exactly-once.

Liveness-cache invalidation rules: the pool caches each shard's request
topic index for the lease poll, but trusts it only while the topic row's
generation matches the value captured at resolve time (layout v4 recycles
topic slots); the cache is also dropped eagerly on every death, respawn,
and retire.  Process handles (``Process``/ready/stop) are keyed off the
*current incarnation* — after a respawn, ``kill``/``wait_ready`` can never
target a dead predecessor's objects.

* :mod:`repro_torch.serving.hashring` — consistent rid→shard assignment: only
  ~1/K of rids move when the replica set changes;
* :mod:`repro_torch.serving.messages` — ``SERVE_REQ``/``SERVE_RES`` unsized
  schemas (ragged token rows + per-row rid/gen/seq/eos metadata) and the
  shared :class:`GenerationGate`;
* :mod:`repro_torch.serving.router` — ``ShardRouter``: per-shard batched
  publishes with event-driven backpressure, in-flight tracking, replay
  (generation+1) on replica loss or stalled streams, admission
  shed/queue at a rid/byte budget, directed work stealing, and
  flush-time (rid, generation, shard) reconciliation so superseded
  buffered rows never double-publish;
* :mod:`repro_torch.serving.replica` — the replica process entrypoint (real
  ``InferenceServer`` or the jax-free ``EchoServer``), streaming each
  decode round's tokens as one results publish, heartbeating its lease
  and an idle-depth beacon;
* :mod:`repro_torch.serving.collector` — ``ResultsCollector``: windowed
  in-order per-rid reassembly, exactly-once completion, per-shard
  depth/latency stats, late-joining shard topics via ``watch``;
* :mod:`repro_torch.serving.pool` — ``ReplicaPool``: spawn/respawn/retire the
  replica processes (one incarnation at a time per shard), detect loss
  by PID death *and* generation-validated registry subscriber leases;
* :mod:`repro_torch.serving.controller` — ``FleetController``: the tick that
  closes the loop (death handling, ready re-adds, autoscale, stealing,
  stall replay, flush).

The port's copy of ``repro/serving/__init__.py``.  Replicas build the
port's ``InferenceServer`` (``repro_torch.serving.replica``) on the GPU
unless asked for the CPU.
"""

from .attach import attach_server_executor
from .collector import ResultsCollector
from .controller import FleetController
from .hashring import HashRing
from .messages import (
    SERVE_REQ,
    SERVE_RES,
    ReqRow,
    ResRow,
    iter_requests,
    iter_results,
    pack_requests,
    pack_results,
)
from .pool import ReplicaPool
from .replica import EchoServer, replica_main
from .router import InFlight, ShardRouter

__all__ = [
    "SERVE_REQ", "SERVE_RES", "ReqRow", "ResRow",
    "pack_requests", "iter_requests", "pack_results", "iter_results",
    "HashRing", "ShardRouter", "InFlight",
    "ResultsCollector", "ReplicaPool", "EchoServer", "replica_main",
    "FleetController", "attach_server_executor",
]
