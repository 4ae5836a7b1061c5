"""Unified metrics registry: named counters/gauges + live shm export.

Before this module every subsystem grew its own ad-hoc ``self.xxx = 0``
attributes (bus ``dropped_backlog``, bridge ``oom_retries``, router
``shed``, collector ``superseded`` …), incremented bare — several from a
different thread than their readers (the bus increments on its own event
thread; the collector's callback races the head janitor timer).  Here
every counter is a named object in one process-global registry:

* :class:`Counter` — lock-guarded ``inc`` (the racing bare increments
  were the satellite bug this migration fixes), readable as a plain int;
* :class:`Gauge` — a sampled value or a zero-arg callable;
* owners keep **back-compat attribute shims** (properties returning the
  counter's value), so every existing ``bridge.dropped_oom`` read keeps
  working;
* ``snapshot()`` walks the registry (weakly referenced: a dead bridge's
  counters vanish with it) and returns ``{qualified_name: value}``.

Cross-process: :class:`MetricsExporter` publishes pickled snapshots into
a fixed-size shm segment (``agno-mx-<domainhash>-<pid>``) under a
seqlock (odd ``wseq`` = write in progress, readers retry), which is what
lets ``scripts/agno_top.py`` render another process's live counters
without touching it.  Export segments follow the trace-ring lifecycle:
gated by ``AGNOCAST_TRACE``/explicit construction, never unlinked by the
writer, cleaned by the reader or :func:`repro_torch.obs.trace.purge`-style
teardown.

The port's copy of ``repro/obs/metrics.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import os
import pickle
import struct
import threading
import weakref

def _new_shm(name, *, create, size):
    # deferred import: repro_torch.core's package init imports the executor,
    # which imports repro_torch.obs back — a module-level import here would
    # break any program whose FIRST import is repro_torch.obs.  Export segments
    # open once per process, so the lazy lookup costs nothing hot.
    from repro_torch.core.arena import _new_shm as impl
    return impl(name, create=create, size=size)


def _domain_hash(domain_name: str) -> str:
    # same derivation as repro_torch.obs.trace._domain_hash, duplicated rather
    # than imported: importing trace here closes a cycle (trace ->
    # repro_torch.core -> executor -> obs.metrics) that breaks any program whose
    # FIRST import is repro_torch.obs
    return hashlib.blake2s(domain_name.encode(), digest_size=6).hexdigest()

__all__ = ["Counter", "Gauge", "MetricsRegistry", "MetricsExporter",
           "counter", "gauge", "snapshot", "read_exports"]


class Counter:
    """Monotonic (but resettable) named counter; ``inc`` is lock-guarded
    so producers on one thread and readers/restarts on another can never
    lose an increment."""

    __slots__ = ("name", "_v", "_lock", "__weakref__")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._v += n
            return self._v

    def set(self, v: int) -> None:
        with self._lock:
            self._v = int(v)

    @property
    def value(self) -> int:
        return self._v

    def __int__(self) -> int:
        return self._v

    def __repr__(self) -> str:
        return f"<Counter {self.name}={self._v}>"


class Gauge:
    """Point-in-time value: either ``set()`` by the owner or sampled from
    a zero-arg callable at snapshot time."""

    __slots__ = ("name", "_v", "_fn", "__weakref__")

    def __init__(self, name: str, fn=None):
        self.name = name
        self._v = 0
        self._fn = fn

    def set(self, v) -> None:
        self._v = v

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return None
        return self._v

    def __repr__(self) -> str:
        return f"<Gauge {self.name}={self.value}>"


def _qualify(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Process-global name → metric table (weak references: metrics die
    with their owning object, so repeated benchmark runs in one process
    never accumulate a dead bridge's counts)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: dict[str, weakref.ref] = {}

    def _register(self, key: str, obj) -> None:
        with self._lock:
            base, n = key, 1
            while key in self._items and self._items[key]() is not None:
                n += 1
                key = f"{base}#{n}"     # same-named sibling (two bridges…)
            self._items[key] = weakref.ref(obj)

    def counter(self, name: str, **labels) -> Counter:
        c = Counter(_qualify(name, labels))
        self._register(c.name, c)
        return c

    def gauge(self, name: str, fn=None, **labels) -> Gauge:
        g = Gauge(_qualify(name, labels), fn)
        self._register(g.name, g)
        return g

    def snapshot(self) -> dict:
        out = {}
        with self._lock:
            dead = []
            for key, ref in self._items.items():
                obj = ref()
                if obj is None:
                    dead.append(key)
                    continue
                out[key] = obj.value
            for key in dead:
                del self._items[key]
        return out


registry = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    """A fresh counter registered in the process-global registry."""
    return registry.counter(name, **labels)


def gauge(name: str, fn=None, **labels) -> Gauge:
    return registry.gauge(name, fn, **labels)


def snapshot() -> dict:
    return registry.snapshot()


# -- cross-process export ------------------------------------------------------

_MX_MAGIC = 0xA6_3C_0D_01
_MX_HDR = struct.Struct("<III")         # magic, wseq, len
_MX_U32 = struct.Struct("<I")           # single-field stores (seqlock order)
_MX_SIZE = 1 << 16


def export_name(domain_name: str, pid: int) -> str:
    return f"agno-mx-{_domain_hash(domain_name)}-{pid}"


# agnolint: single-writer -- one export segment per pid; the seqlock wseq store order below is the readers' consistency fence
class MetricsExporter:
    """Publish this process's registry snapshots into shm for external
    readers (``agno_top``).  Single writer; seqlock on ``wseq``."""

    def __init__(self, domain_name: str, *, reg: MetricsRegistry = None,
                 extra=None):
        self.domain_name = domain_name
        self.reg = reg if reg is not None else registry
        self.extra = extra              # zero-arg callable merged in
        self.name = export_name(domain_name, os.getpid())
        self._shm = _new_shm(self.name, create=True, size=_MX_SIZE)
        self._wseq = 0
        _MX_HDR.pack_into(self._shm.buf, 0, _MX_MAGIC, 0, 0)

    def publish(self, snap: dict | None = None) -> None:
        if snap is None:
            snap = self.reg.snapshot()
        if self.extra is not None:
            try:
                snap = {**snap, **(self.extra() or {})}
            except Exception:
                pass
        payload = pickle.dumps(snap, protocol=5)
        if len(payload) > _MX_SIZE - _MX_HDR.size:
            payload = pickle.dumps(
                {"_overflow": len(snap)}, protocol=5)
        buf = self._shm.buf
        # Seqlock write order, one field per store: the odd ("dirty")
        # wseq must LAND in shm before any data byte changes, and the
        # even wseq after the last one.  The previous combined header
        # pack_into wrote wseq and len in a single 12-byte store, so a
        # cross-process reader could observe the *old even* wseq next to
        # the *new* len mid-write and validate a torn payload (readers
        # share no GIL with us — only store order protects them).
        self._wseq += 1
        _MX_U32.pack_into(buf, 4, self._wseq)           # odd: write begins
        _MX_U32.pack_into(buf, 8, len(payload))
        buf[_MX_HDR.size:_MX_HDR.size + len(payload)] = payload
        self._wseq += 1
        _MX_U32.pack_into(buf, 4, self._wseq)           # even: stable

    def close(self, *, unlink: bool = False) -> None:
        try:
            self._shm.close()
        except Exception:
            pass
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


def _read_export(name: str) -> dict | None:
    try:
        shm = _new_shm(name, create=False, size=0)
    except FileNotFoundError:
        return None
    try:
        buf = shm.buf
        for _ in range(64):             # bounded seqlock retry
            magic, s1, ln = _MX_HDR.unpack_from(buf, 0)
            if magic != _MX_MAGIC:
                return None
            if s1 % 2 == 1 or ln == 0:
                continue
            payload = bytes(buf[_MX_HDR.size:_MX_HDR.size + ln])
            _, s2, _ = _MX_HDR.unpack_from(buf, 0)
            if s1 == s2:
                try:
                    return pickle.loads(payload)
                except Exception:
                    return None
        return None
    finally:
        shm.close()


def read_exports(domain_name: str) -> dict[int, dict]:
    """``{pid: snapshot}`` for every export segment of a domain."""
    pat = f"/dev/shm/agno-mx-{_domain_hash(domain_name)}-*"
    out: dict[int, dict] = {}
    for path in sorted(_glob.glob(pat)):
        name = os.path.basename(path)
        snap = _read_export(name)
        if snap is not None:
            try:
                pid = int(name.rsplit("-", 1)[1])
            except ValueError:
                continue
            out[pid] = snap
    return out
