"""Observability plane: message-flow tracing + the unified metrics registry.

The paper's headline numbers (16% average / 25% worst-case response-time
improvement in the Autoware PointCloud pipeline) were produced with
CARET-style *message-flow tracing*: every lifecycle stage of every message
is stamped, flows are reconstructed offline, and the end-to-end response
time is decomposed into per-stage latencies.  This package is the repro's
equivalent, built with the same discipline the data plane uses — nothing
on the hot path but a few stores, control-sized records only, zero copies
of payloads (the TZC rule applied to instrumentation).

Observability
=============

Three layers, importable without jax:

**Trace events** (:mod:`repro_torch.obs.trace`).  Each process lazily opens one
single-writer shm ring buffer per domain (``agno-tr-<hash>-<pid>``) and
appends fixed-size 24-byte records — ``(trace_id, t_ns, hop, stage,
flags, arg)`` packed with :mod:`struct` — at each lifecycle stage:
``publish``, ``notify``, ``take``, ``callback_start/end``, ``release``,
``bridge_in/out``, ``route``, ``serve_enqueue/flush/reassemble``.  The
writer takes no lock and issues no syscall per event (one ``pack_into`` +
one head store, in the spirit of the registry's v4 seqlock rows); readers
detect torn/overwritten records from the monotonic head counter.  A
monotonic ``trace_id`` is minted at first publish (pid-salted, so ids are
unique across the domain without coordination) and travels with the
message: through the ``Registry`` entry's ``trace_id`` column (layout
v6), through ``transport.Frame`` route metadata across bridges, and
through per-row ``tids`` columns in ``SERVE_REQ``/``SERVE_RES``.  When
``AGNOCAST_TRACE`` is unset/``0`` (the default — tier-1 runs this way)
every call site holds a ``None`` tracer and the hot path pays a single
pointer test.

**Flow reconstruction** (:mod:`repro_torch.obs.flows`).
:class:`~repro_torch.obs.flows.FlowAggregator` attaches every ring buffer of a
domain (including rings of processes that died — rings survive their
writer precisely so a SIGKILLed replica's half-finished flows stay
reconstructable), merges records by ``(trace_id, hop)`` into
causally-ordered flows spanning processes and bridge hops, flags
truncated flows (no terminal stage), and computes per-stage latency
breakdowns (publish→wakeup, wakeup→take, take→callback,
callback→release, per-bridge-hop) with p50/p99/max — the repro's
analogue of the paper's Fig. 13/14 response-time analysis.  Reads are
snapshot-based: the aggregator never blocks on a writer, so it cannot
hang on a dead or wedged process.

**Unified metrics** (:mod:`repro_torch.obs.metrics`).  One process-global
registry of named counters/gauges replaces the scattered per-object
``self.xxx += 1`` attributes.  ``Counter.inc`` is lock-guarded (several
of the old bare increments raced their owning object's thread — the bus
thread vs. stats readers, the collector callback vs. the janitor timer);
owners keep back-compat read-only attribute shims so existing tests and
dashboards read the same names.  ``snapshot()`` returns every live
metric; :class:`~repro_torch.obs.metrics.MetricsExporter` publishes snapshots
into a seqlock-guarded shm segment (``agno-mx-<hash>-<pid>``) so
``scripts/agno_top.py`` can render live per-topic / per-shard depth,
throughput, and drop counters from outside the process.

Env knobs (read when a tracer/exporter is first requested, so spawned
children honour the environment they inherit):

* ``AGNOCAST_TRACE`` — ``1`` enables trace rings + metric export;
  unset/``0`` compiles the whole plane down to ``None`` checks.
* ``AGNOCAST_TRACE_CAP`` — ring capacity in records (power of two,
  default 4096; the ring keeps the newest ``cap`` records).

The trace record wire format is documented next to the registry layout
history in :mod:`repro_torch.core.registry`.

The port's copy of ``repro/obs/__init__.py``.
"""

from .flows import Flow, FlowAggregator
from .metrics import (Counter, Gauge, MetricsExporter, MetricsRegistry,
                      counter, gauge, read_exports, snapshot)
from .trace import (STAGE_NAMES, TraceReader, TraceRing, Stage, enabled,
                    next_trace_id, tracer_for)

__all__ = [
    "Stage", "STAGE_NAMES", "TraceRing", "TraceReader", "enabled",
    "next_trace_id", "tracer_for",
    "Flow", "FlowAggregator",
    "Counter", "Gauge", "MetricsRegistry", "MetricsExporter",
    "counter", "gauge", "snapshot", "read_exports",
]
