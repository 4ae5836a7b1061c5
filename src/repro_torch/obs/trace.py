"""Per-process shm trace rings: the lock-free event capture layer.

One ring per (process, domain), created lazily on the first emit.  The
writer is the owning process alone (single-writer by construction — the
same property that lets registry v4 fold ``released`` bytes without a
lock), so ``emit`` is one ``struct.pack_into`` plus one monotonic head
store; no lock, no syscall.  Readers attach the segment read-only and
recover the newest ``cap`` records, discarding any record the writer
overwrote mid-copy (torn-record rule below).

Wire format (also documented next to the registry layout history):

* header, 32 bytes: ``magic u32 | cap u32 | head u64 | pid u32 | pad``.
  ``head`` is the monotonic count of records ever written; the slot of
  record ``i`` is ``32 + (i % cap) * 24``.
* record, 24 bytes, ``struct '<QQHBBI'``:
  ``trace_id u64 | t_ns u64 | hop u16 | stage u8 | flags u8 | arg u32``.
  ``t_ns`` is ``time.monotonic_ns()`` — CLOCK_MONOTONIC is system-wide
  on one host, so cross-process stage deltas are directly meaningful.
* torn-record rule: after copying the window ``[head-cap, head)`` a
  reader re-reads ``head`` as ``h2`` and keeps only records with
  ``i >= h2 - cap`` — anything older may have been overwritten while
  the copy ran.
* pairing: the hot paths write their records two-at-a-time via
  :meth:`TraceRing.emit2` — PUBLISH is back-stamped and written with
  NOTIFY, TAKE back-stamped and written with RELEASE.  Ring *slot*
  order therefore lags stage order for the back-stamped record, but
  ``t_ns`` carries the true stage time and readers order by it, so the
  wire view is indistinguishable from four separate emits.

Rings are **not** unlinked when their process exits: a SIGKILLed
replica's ring is exactly the evidence a flow aggregator needs to mark
its half-finished flows truncated.  Cleanup belongs to the aggregator
(:meth:`repro_torch.obs.flows.FlowAggregator.close` with ``unlink=True``) or
:func:`purge`.

Env: ``AGNOCAST_TRACE`` gates everything (unset/``0`` → ``tracer_for``
returns ``None`` and call sites pay one pointer test);
``AGNOCAST_TRACE_CAP`` sets ring capacity in records (power of two,
default 4096).

The port's copy of ``repro/obs/trace.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import atexit
import glob as _glob
import hashlib
import itertools
import os
import struct
import time

def _new_shm(name, *, create, size):
    # deferred import: repro_torch.core's package init imports the executor,
    # which imports repro_torch.obs back — a module-level import here would
    # break any program whose FIRST import is repro_torch.obs.  Ring open/create
    # happens once per process, so the lazy lookup costs nothing hot.
    from repro_torch.core.arena import _new_shm as impl
    return impl(name, create=create, size=size)

__all__ = ["Stage", "STAGE_NAMES", "TraceRing", "TraceReader", "enabled",
           "next_trace_id", "tracer_for", "ring_names", "purge",
           "FLAG_EOS"]

_MAGIC = 0xA6_7C_0D_01
_HDR = struct.Struct("<IIQII")          # magic, cap, head, pid, pad
_HDR_SIZE = 32                          # header rounded up (head at off 8)
_REC = struct.Struct("<QQHBBI")         # trace_id, t_ns, hop, stage, flags, arg
REC_SIZE = _REC.size                    # 24
DEFAULT_CAP = 4096

FLAG_EOS = 0x01                         # serve_reassemble: stream completed


class Stage:
    """Lifecycle stage ids (u8 on the wire)."""

    PUBLISH = 1        # Publisher.publish / publish_descriptor entered
    NOTIFY = 2         # wakeup FIFO bytes written (arg = subs woken)
    TAKE = 3           # Subscription claimed the entry (arg = seq)
    CB_START = 4       # executor dispatched the callback
    CB_END = 5         # callback returned
    RELEASE = 6        # last local reference dropped (held--)
    BRIDGE_IN = 7      # bridge copied/attached a frame into this domain
    BRIDGE_OUT = 8     # bridge relayed a local message onto a bus
    ROUTE = 9          # router admitted a frame's dedup key
    SERVE_ENQ = 10     # rid admitted (head router, or replica gate: hop 1)
    SERVE_FLUSH = 11   # rid's row shipped in a SERVE_REQ publish
    SERVE_REASM = 12   # collector ingested one result chunk (arg = seq)


STAGE_NAMES = {
    Stage.PUBLISH: "publish", Stage.NOTIFY: "notify", Stage.TAKE: "take",
    Stage.CB_START: "callback_start", Stage.CB_END: "callback_end",
    Stage.RELEASE: "release", Stage.BRIDGE_IN: "bridge_in",
    Stage.BRIDGE_OUT: "bridge_out", Stage.ROUTE: "route",
    Stage.SERVE_ENQ: "serve_enqueue", Stage.SERVE_FLUSH: "serve_flush",
    Stage.SERVE_REASM: "serve_reassemble",
}


def enabled() -> bool:
    """Tracing on?  Read from the environment at call time (NOT import
    time) so spawned children and late ``os.environ`` edits are honoured;
    hot paths never call this — they hold the tracer reference instead."""
    return os.environ.get("AGNOCAST_TRACE", "0").lower() not in (
        "", "0", "false", "no")


def _cap() -> int:
    try:
        cap = int(os.environ.get("AGNOCAST_TRACE_CAP", DEFAULT_CAP))
    except ValueError:
        cap = DEFAULT_CAP
    cap = max(64, cap)
    return 1 << (cap - 1).bit_length()   # round up to a power of two


def _domain_hash(domain_name: str) -> str:
    return hashlib.blake2s(domain_name.encode(), digest_size=6).hexdigest()


def ring_name(domain_name: str, pid: int) -> str:
    return f"agno-tr-{_domain_hash(domain_name)}-{pid}"


def ring_names(domain_name: str) -> list[str]:
    """Every ring segment of ``domain_name`` currently in /dev/shm —
    including rings whose writer process is dead (that is the point)."""
    pat = f"/dev/shm/agno-tr-{_domain_hash(domain_name)}-*"
    return sorted(os.path.basename(p) for p in _glob.glob(pat))


# pid-salted monotonic mint: unique across every process of a domain
# without coordination (22 pid bits | 40 counter bits, never zero)
_tid_counter = itertools.count(1)


def next_trace_id() -> int:
    return ((os.getpid() & 0x3F_FFFF) << 40) | (
        next(_tid_counter) & 0xFF_FFFF_FFFF)


# agnolint: single-writer -- one ring per (process, domain); only the owning pid emits, readers tolerate the torn newest record (head fence)
class TraceRing:
    """Single-writer ring over one shm segment.  Create with
    :func:`tracer_for`; only the owning process may ``emit``."""

    __slots__ = ("name", "pid", "cap", "_mask", "_shm", "_buf", "_head",
                 "_head_mv", "_pack", "_mono", "_offs")

    def __init__(self, domain_name: str, *, cap: int | None = None):
        self.pid = os.getpid()
        self.cap = cap if cap is not None else _cap()
        self._mask = self.cap - 1
        self.name = ring_name(domain_name, self.pid)
        self._shm = _new_shm(self.name, create=True,
                             size=_HDR_SIZE + self.cap * REC_SIZE)
        self._buf = self._shm.buf
        _HDR.pack_into(self._buf, 0, _MAGIC, self.cap, 0, self.pid, 0)
        self._head = 0
        self._head_mv = self._buf[8:16].cast("Q")
        # bound locals for the hot path: one pack_into + one head store
        self._pack = _REC.pack_into
        self._mono = time.monotonic_ns
        # slot index -> byte offset, precomputed: the emit fast path spends
        # its budget in pack_into, not in offset arithmetic (~6 µs/cycle of
        # tracing cost on the fig18 closed loop bought the 5% gate)
        self._offs = tuple(_HDR_SIZE + j * REC_SIZE for j in range(self.cap))

    def emit(self, trace_id: int, hop: int, stage: int, arg: int = 0,
             flags: int = 0) -> None:
        i = self._head
        try:
            # maskless fast path: every producer passes in-range fields
            # (trace ids are minted < 2^64; args are masked at call sites)
            self._pack(self._buf, self._offs[i & self._mask],
                       trace_id, self._mono(), hop, stage, flags, arg)
        except struct.error:
            self._pack(self._buf, self._offs[i & self._mask],
                       trace_id & 0xFFFF_FFFF_FFFF_FFFF, self._mono(),
                       hop & 0xFFFF, stage & 0xFF, flags & 0xFF,
                       arg & 0xFFFF_FFFF)
        self._head = i + 1
        self._head_mv[0] = i + 1        # readers see records <= head only

    def emit2(self, trace_id: int, hop: int, stage1: int, t1: int,
              stage2: int, arg2: int = 0, flags2: int = 0) -> None:
        """Two records, one call: ``stage1`` back-stamped at ``t1`` (the
        caller sampled ``time.monotonic_ns`` when that stage happened) and
        ``stage2`` stamped now.  The publish hot path uses this for its
        PUBLISH/NOTIFY pair — on the fig18 closed loop the method call
        itself costs more than the record write, so halving the call count
        halves the dominant term.  Wire format is unchanged: readers see
        two ordinary records."""
        i = self._head
        buf = self._buf
        offs = self._offs
        m = self._mask
        pk = self._pack
        try:
            pk(buf, offs[i & m], trace_id, t1, hop, stage1, 0, 0)
            pk(buf, offs[(i + 1) & m], trace_id, self._mono(), hop, stage2,
               flags2, arg2)
        except struct.error:
            pk(buf, offs[i & m], trace_id & 0xFFFF_FFFF_FFFF_FFFF,
               t1 & 0xFFFF_FFFF_FFFF_FFFF, hop & 0xFFFF, stage1 & 0xFF, 0, 0)
            pk(buf, offs[(i + 1) & m], trace_id & 0xFFFF_FFFF_FFFF_FFFF,
               self._mono(), hop & 0xFFFF, stage2 & 0xFF, flags2 & 0xFF,
               arg2 & 0xFFFF_FFFF)
        self._head = i + 2
        self._head_mv[0] = i + 2

    def close(self, *, unlink: bool = False) -> None:
        try:
            self._head_mv.release()
        except Exception:
            pass
        try:
            self._shm.close()
        except Exception:
            pass
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class TraceReader:
    """Snapshot reader over one ring segment (any process, read-only).
    Never blocks — a dead or wedged writer cannot hang the reader."""

    def __init__(self, name: str):
        self.name = name
        self._shm = _new_shm(name, create=False, size=0)
        buf = self._shm.buf
        magic, cap, _, pid, _ = _HDR.unpack_from(buf, 0)
        if magic != _MAGIC:
            self._shm.close()
            raise ValueError(f"{name}: not a trace ring (magic {magic:#x})")
        self.cap = cap
        self.pid = pid

    def _head(self) -> int:
        return struct.unpack_from("<Q", self._shm.buf, 8)[0]

    def records(self) -> list[tuple]:
        """The newest ``cap`` records as ``(trace_id, t_ns, hop, stage,
        flags, arg, pid)`` tuples, oldest first, torn records dropped."""
        buf = self._shm.buf
        h1 = self._head()
        lo = max(0, h1 - self.cap)
        raw = [(i, bytes(buf[_HDR_SIZE + (i % self.cap) * REC_SIZE:
                             _HDR_SIZE + (i % self.cap) * REC_SIZE
                             + REC_SIZE]))
               for i in range(lo, h1)]
        h2 = self._head()                # torn-record rule (module doc)
        floor = max(lo, h2 - self.cap)
        out = []
        for i, rec in raw:
            if i < floor:
                continue
            tid, t_ns, hop, stage, flags, arg = _REC.unpack(rec)
            out.append((tid, t_ns, hop, stage, flags, arg, self.pid))
        return out

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


# one writer ring per (domain, pid); the pid check guards fork/spawn reuse
_tracers: dict[str, TraceRing] = {}


def _close_tracers() -> None:
    """atexit: detach writer rings (NOT unlink — the segments must outlive
    the process for post-mortem flow reconstruction)."""
    for tr in _tracers.values():
        tr.close()
    _tracers.clear()


atexit.register(_close_tracers)


def tracer_for(domain_name: str) -> TraceRing | None:
    """The calling process's ring for ``domain_name`` — or ``None`` when
    ``AGNOCAST_TRACE`` is off (call sites cache the result and guard the
    hot path with a single ``is not None`` test)."""
    if not enabled():
        return None
    tr = _tracers.get(domain_name)
    if tr is None or tr.pid != os.getpid():
        tr = TraceRing(domain_name)
        _tracers[domain_name] = tr
    return tr


def purge(domain_name: str) -> int:
    """Unlink every ring of a domain (test/benchmark cleanup); returns the
    number of segments removed."""
    n = 0
    for name in ring_names(domain_name):
        try:
            TraceReader(name).close(unlink=True)
            n += 1
        except (FileNotFoundError, ValueError):
            pass
    return n
