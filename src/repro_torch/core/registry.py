"""Transactional pub/sub metadata — the Agnocast kernel-module analogue.

The paper keeps topic metadata (message addresses, reference counts,
unreceived-subscriber tracking) in a kernel module driven by ``ioctl``,
for one reason (§IV-B): **transactionality** — metadata operations must
complete (or roll back) even if a participating process dies at an
arbitrary instruction.  The kernel also hooks process exit to release a
dead participant's references.

We cannot load kernel code in this environment, so we keep the *property*
with user-space mechanisms the kernel still underwrites.  Layout **v4**
additionally makes the single-topic hot path lock-free: reads take no
lock at all, and the common-case ``release`` is a single byte store.

Metadata lives in a shared-memory segment of fixed-layout structured
arrays (the "module state"): a header, an open-addressed topic-name hash
table, one journal slot per topic, the topic rows, and the entry rings.

Locking (the transactional slow plane)
--------------------------------------

* The lock plane is **sharded by topic**: every per-topic *mutation*
  (publish / take / participant add-remove / slow-path release) runs
  under that topic's own ``flock`` (``topic_lock_path``).  A **domain
  lock** (``domain_lock_path``) is held only for topic create/destroy and
  the janitor sweep.  Both are OS-owned locks that **the kernel releases
  when the holder dies**, so a crashed participant can never wedge the
  plane.  Lock order is domain → topic, never the reverse; topic locks
  are never nested with each other.
* Row mutations are write-ahead journaled with before-images into a
  **per-topic journal slot** (``journal[tidx]``), guarded by that topic's
  lock.  The next acquirer of *that topic's* lock rolls back any PENDING
  mutation left by a dead process — recovery is per topic.  This is the
  "complete atomically or roll back" alternative the paper names for a
  user-space implementation (§IV-B).  Rollback is **seqlock-aware**: a
  topic before-image is restored with its write-sequence forced to a
  fresh, strictly larger even value (never the stale one from the image),
  so no concurrent lock-free reader can validate a snapshot that spans
  the rollback; and an entry before-image is restored with the current
  ``released`` bytes OR-merged back in, so a subscriber's lock-free
  release intent survives any rollback.
* A janitor sweep detects dead PIDs (``kill(pid, 0)``) and releases their
  unreceived/held bits — the process-exit hook analogue.

The lock-free fast plane (layout v4)
------------------------------------

* **Seqlock reads**: every topic row carries a write-sequence counter
  (``wseq``).  Writers (always under the topic's flock) bump it to odd on
  entry and even on exit; lock-free readers (``can_publish``,
  ``publishers``, ``queue_depth``, ``stats`` snapshots) read the counter,
  read the data, and re-read the counter — an odd or changed value means
  the snapshot may be torn and the read retries.  After a bounded number
  of retries the reader falls back to the locked path, whose recovery
  also repairs the parity a writer that died mid-write leaves behind
  (odd ``wseq``), so readers cannot spin forever on a crashed writer.
  The protocol assumes total-store-order visibility (x86-64) plus the
  interpreter's per-op atomicity for the 8-byte counter loads/stores.
* **Waiter-free release**: each entry carries a per-subscriber
  ``released`` byte array.  A release is one byte store —
  ``released[sidx] = 1`` — with no lock, no journal, and no FIFO write,
  valid because each byte has exactly one writer (that subscriber) and
  folding is monotonic.  Lock holders fold the bytes into the ``held``
  mask (``_fold_releases``) before reading it, and lock-free readers
  compute the *effective* held mask ``held & ~packbits(released)``.  The
  fast path is taken only when no rollback is pending and the owner's
  waiter flag is clear; it re-checks the flag *after* the byte store
  (Dekker-style) and falls through to the locked protocol — which folds,
  clears the bit and wakes the owner — if a waiter armed concurrently.
  The waiter side arms its flag *before* re-checking ``can_publish``,
  and that re-check reads the released bytes, so a release that slips
  past the flag is always visible to the waiter's re-check.
* **O(1) topic lookup**: an open-addressed hash table in the segment
  header maps ``blake2b(name)`` to a topic row (linear probing,
  tombstones).  Inserts (under the domain lock) publish the row
  reference last; lock-free lookups validate every candidate against the
  authoritative topic row (``in_use`` + exact name), so a torn or stale
  table slot can cause a retry or a locked-path fallback, never a wrong
  topic.  The locked path keeps a linear name-scan safety net for rows
  whose creator died between committing the row and inserting it, and
  repairs the table when the scan finds one.
* **Generation counters (name-ABA guard)**: every topic row carries a
  ``gen`` bumped on (re)create.  A participant captures the generation
  at attach; ``publish`` raises, ``take`` returns nothing and ``release``
  no-ops when the row has been destroyed and recycled under the same or
  a different name — stale handles can never mutate a successor topic.

Entry lifetime follows the paper's two-counter rule (§IV-C): an entry's
payload may be freed only when its reference holders ("held" minus the
folded ``released`` bytes) and its unreceived-subscriber set are both
empty — and only by the owning publisher.

Two extensions ride on the same plane:

* **Route metadata** (multi-domain federation, :mod:`repro_torch.core.routing`):
  each entry carries ``hops`` / ``src_tag`` / ``route_seq`` so a message
  copied in from a remote agnocast domain keeps its origin identity.
* **Owner-side backpressure wakeups**: every publisher owns a reverse
  "slot freed" FIFO (``pub_fifo_path``).  When a release drops an
  entry's last *held* reference and the owner's **waiter flag** is
  armed, the releaser takes the locked path and writes one byte to the
  owner's FIFO.  The no-reader path re-checks the waiter's liveness and
  retries briefly before dropping a wakeup (a waiter may be mid-open of
  its FIFO read end), mirroring the subscriber-side EPIPE retry.
* **Subscriber liveness leases**: every ``take`` (and the explicit
  ``refresh_lease``) stamps a per-subscriber monotonic-clock lease in
  the shared topic header; the serving plane uses it to detect wedged
  (alive but stuck) replicas.

Two more extensions serve the cross-host data plane (layout v5,
:mod:`repro_torch.core.routing`'s attach-by-name path):

* **Cross-bridge pins with lease expiry**: a bridge that advertises an
  entry's payload *by reference* (arena name + offsets in a control
  frame, no bus payload) must keep the source entry alive until the
  remote side has read it — the remote reader holds no ``held`` bit in
  this registry.  ``pin(tidx, pidx, seq, lease_s)`` bumps a per-entry
  pin count and extends a monotonic-clock deadline; a pin-active entry
  is treated as *held* by ``publish`` (QueueFull instead of keep-last
  drop), ``can_publish`` and ``reclaimable``.  ``unpin`` drops the
  count and wakes a blocked owner.  The lease is the crash backstop:
  if the pinning bridge dies before unpinning, the entry un-pins
  itself when ``now > pin_deadline_ns`` — lease-expiry reclaim needs
  no janitor pass, every owner-side reclaim check applies it.
* **Cross-arena entries** (``xarena``): an entry whose descriptor's
  offsets live in *another* publisher's arena (named per entry), so a
  same-host bridge can re-publish a remote message without copying its
  payload — subscribers attach ``xarena`` instead of the publishing
  bridge's own arena.  Lifetime of the foreign payload is the pin/ack
  protocol's job (routing layer); the registry only carries the name.

Layout history: v4 raises ``MAX_TOPICS`` 64 → 1024, widens entries with
``released`` bytes, adds ``wseq``/``gen`` to topic rows and the name-hash
table to the header.  v5 widens entries again with ``pins`` /
``pin_deadline_ns`` / ``xarena`` (cross-host data plane).  v6 adds one
``trace_id`` u8 column to entries (``repro_torch.obs`` message-flow tracing:
the id minted at publish travels with the entry so take/callback/release
events in other processes land in the same flow).  The magic is bumped
per layout (``0x…06`` now); there is no in-place upgrade — older
attachers are rejected and must be restarted (segments are ephemeral
per-run shm, so this costs a restart).

Trace record wire format (``repro_torch.obs.trace``; kept next to the layout
docs because the trace ring is the registry's observability sibling —
same single-writer/seqlock-spirit discipline, separate shm segments):
one ring per (process, domain) named ``agno-tr-<domainhash>-<pid>``;
header ``magic u32 | cap u32 | head u64 | pid u32 | pad`` (32 bytes,
``head`` = monotonic record count); records 24 bytes each, packed
``'<QQHBBI'`` = ``trace_id u64 | t_ns u64 (CLOCK_MONOTONIC) | hop u16 |
stage u8 | flags u8 | arg u32``.  Env knobs: ``AGNOCAST_TRACE`` (unset
or ``0`` — the tier-1 default — disables all emission; call sites hold a
``None`` tracer and pay one pointer test), ``AGNOCAST_TRACE_CAP`` (ring
capacity in records, rounded up to a power of two, default 4096).

Invariants (machine-checked by ``scripts/agnolint_torch.py``)
-------------------------------------------------------------

The disciplines above are enforced by the static analyzer in
``repro_torch.analysis`` (``scripts/agnolint_torch.py --strict --model
fast``; ``tests/test_torch_analysis.py`` runs it in tier 1); each carries
a rule ID so a violation message points back at this spec:

* ``AGNO-LOCK-001`` — every store into this segment happens inside
  ``_locked(tidx)`` (seqlock'd write section), ``_topic_flock(tidx)``
  (raw topic lock; the callee owns seqlock handling) or ``_lock`` (the
  domain lock, name table/header only).  The *only* lock-free stores are
  the allow-listed ones: the per-subscriber ``released`` byte (release
  fast path), the owner's ``pub_waiters`` flag (``set_pub_waiter``), the
  subscriber's own ``sub_lease_ns`` stamp (``refresh_lease``) and the
  owner's magic store before the segment name is shared.  Helpers whose
  *caller* holds the lock (``_recover``, ``_Txn``, ``_fold_releases``,
  ``_drop_subscriber``, ``_hash_insert``/``_hash_remove``) are marked
  ``# agnolint: locked-context`` at their ``def`` — the annotation is
  the machine-readable form of their docstring's "caller holds the
  lock" contract.
* ``AGNO-LOCK-002`` — lock order is domain → topic, never the reverse,
  and topic locks never nest with each other.
* ``AGNO-LOCK-003`` — no blocking call (sleep / join / recv / flock …)
  while any lock is held.  This module's two ``time.sleep`` calls —
  the ``_open_and_wake`` FIFO retry and the ``_seqlock_read`` spin —
  both run outside every lock, which is why they are legal.
* ``AGNO-LAYOUT-001/002`` — the dtypes/constants above are fingerprinted
  in ``repro_torch/analysis/layout_lock.json`` (equal to the reference's
  lock, section for section); changing any layout-bearing
  constant without bumping ``_MAGIC`` (the v5→v6 precedent) fails CI,
  as does any internal inconsistency (mask widths vs ``MAX_SUBS``,
  journal image sizes vs row dtypes, the trace-record format quoted
  above vs ``repro_torch.obs.trace``'s actual struct).
* ``AGNO-MODEL-*`` — the publish/take/release/rollback/sweep protocol
  itself is exhaustively model-checked over 2–3-process interleavings
  with SIGKILL injected at every step (``repro_torch.analysis.model``):
  no lost release, no double-take, seqlock parity restored, rollback
  idempotent, no lost wakeup (the Dekker re-check in ``release``).  Its
  fold is this module's ``_fold_releases`` in two steps, a read and a
  zeroing of the bytes read, with a lock-free release able to land
  between them (scenario ``fold_race``).

The port's copy of ``repro/core/registry.py``: the import paths differ, and
``_fold_releases`` zeroes only the release bytes it folded (the reference's
zeroes them all and can drop a release that lands mid-fold).  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import fcntl
import glob as _glob
import hashlib
import os
import secrets
import shutil
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from .arena import _new_shm

__all__ = ["Registry", "RegistryError", "AgnocastQueueFull", "Entry",
           "MAX_TOPICS", "MAX_PUBS", "MAX_SUBS", "DEPTH_MAX", "HASH_CAP",
           "fifo_dir", "sub_fifo_path", "pub_fifo_path",
           "domain_lock_path", "topic_lock_path"]

MAX_TOPICS = 1024
MAX_PUBS = 8           # a sharded results topic fans in one pub per replica
MAX_SUBS = 64          # one bit per subscriber in uint64 masks
DEPTH_MAX = 64
HASH_CAP = 2048        # topic-name hash table: 2x MAX_TOPICS, power of two
_MAGIC = 0xA6_0C_0D_06  # layout v6: v5 + entry trace_id (flow tracing)

# Escape hatch for benchmarking the lock-free fast plane against the v3
# locked protocol on identical code: when true, every read/release takes
# the locked slow path (set AGNOCAST_LOCKED_HOTPATH=1, or assign the
# module global before attaching).  Correctness is identical either way.
FORCE_LOCKED_HOTPATH = os.environ.get("AGNOCAST_LOCKED_HOTPATH", "0") not in ("", "0")

_SEQ_RETRIES = 96      # torn-read retries before falling back to the lock

ST_FREE, ST_USED, ST_DEAD = 0, 1, 2
ORIGIN_AGNOCAST, ORIGIN_BRIDGE = 0, 1

TOPIC_DT = np.dtype(
    [
        ("name", "S96"),
        ("in_use", "u1"),
        ("_pad", "u1", (7,)),
        ("wseq", "u8"),                      # seqlock write-sequence (odd = writer active)
        ("gen", "u8"),                       # bumped on (re)create: name-ABA guard
        ("sub_pids", "u8", (MAX_SUBS,)),
        ("sub_alive", "u8"),                 # bitmask of live subscriber slots
        ("sub_lease_ns", "u8", (MAX_SUBS,)),  # CLOCK_MONOTONIC stamp of last take
        ("pub_pids", "u8", (MAX_PUBS,)),
        ("pub_alive", "u1", (MAX_PUBS,)),
        ("pub_waiters", "u1", (MAX_PUBS,)),  # publisher blocked on a full ring
        ("pub_arena", "S32", (MAX_PUBS,)),
        ("pub_depth", "u4", (MAX_PUBS,)),
        ("pub_next_seq", "u8", (MAX_PUBS,)),
        ("pub_drops", "u8", (MAX_PUBS,)),
    ]
)

ENTRY_DT = np.dtype(
    [
        ("seq", "u8"),
        ("desc_off", "u8"),
        ("desc_len", "u8"),
        ("unreceived", "u8"),   # bitmask: subscribers that have not taken it
        ("held", "u8"),         # bitmask: subscribers currently holding a ref
        ("state", "u1"),
        ("origin", "u1"),
        ("hops", "u1"),         # bus hops taken to reach this domain (0 = local)
        ("_pad", "u1"),
        ("pub_refs", "u4"),     # publisher-local refs (0 after move-publish)
        ("src_tag", "u8"),      # origin-domain tag (0 = no route metadata)
        ("route_seq", "u8"),    # origin-unique message id for dedup
        ("released", "u1", (MAX_SUBS,)),  # lock-free release intent, one byte
                                          # per subscriber (single-writer each);
                                          # folded into ``held`` under the lock
        ("pins", "u4"),             # cross-bridge pin count (attach-by-name)
        ("_pad2", "u4"),
        ("pin_deadline_ns", "u8"),  # monotonic lease: pins ignored past this
        ("xarena", "S32"),          # descriptor offsets live in THIS arena
                                    # (empty = the publisher's own arena)
        ("trace_id", "u8"),     # repro_torch.obs flow id minted at publish
                                # (0 = untraced; ids are pid-salted nonzero)
    ]
)

# open-addressed topic-name table: tref = 0 empty, -1 tombstone, tidx+1 live.
# Inserts write ``h`` first and publish ``tref`` last; readers validate every
# hit against the topic row, so the table is advisory — never authoritative.
HASH_DT = np.dtype([("h", "u8"), ("tref", "i8")])

_J_CLEAN, _J_PENDING = 0, 1
JOURNAL_DT = np.dtype(
    [
        ("state", "u8"),
        ("pid", "u8"),
        ("tidx", "i8"),
        ("pidx", "i8"),
        ("slot", "i8"),
        ("has_topic", "u8"),
        ("has_entry", "u8"),
        ("topic_img", "V%d" % TOPIC_DT.itemsize),
        ("entry_img", "V%d" % ENTRY_DT.itemsize),
    ]
)


class RegistryError(RuntimeError):
    pass


class AgnocastQueueFull(RegistryError):
    """All ring slots hold messages still referenced by subscribers."""


@dataclass(frozen=True)
class Entry:
    seq: int
    desc_off: int
    desc_len: int
    origin: int
    pub_idx: int
    hops: int = 0
    src_tag: int = 0
    route_seq: int = 0
    xarena: str = ""  # nonempty: descriptor offsets live in this arena,
                      # not the publisher's own (same-host zero-copy relay)
    trace_id: int = 0  # repro_torch.obs flow id (0 = untraced)


def domain_lock_path(reg: str) -> str:
    """The domain lock: topic create/destroy and the janitor sweep only."""
    return f"/tmp/.agnocast-{reg}.lock"


def topic_lock_path(reg: str, tidx: int) -> str:
    """Topic ``tidx``'s lock: every metadata *mutation* (reads are lock-free)."""
    return f"/tmp/.agnocast-{reg}.t{tidx}.lock"


def fifo_dir(reg: str) -> str:
    return f"/tmp/.agnocast-{reg}.d"


def sub_fifo_path(reg: str, tidx: int, sidx: int) -> str:
    """Subscriber wakeup FIFO: publishers write one byte per publish."""
    return os.path.join(fifo_dir(reg), f"t{tidx}s{sidx}.fifo")


def pub_fifo_path(reg: str, tidx: int, pidx: int) -> str:
    """Owner-side reverse FIFO: releasers write one byte per freed slot."""
    return os.path.join(fifo_dir(reg), f"t{tidx}p{pidx}.pub.fifo")


def _open_and_wake(path: str, still_wanted=None, retry_s: float = 0.05) -> int | None:
    """Open a FIFO write end (non-blocking) and write one wakeup byte.

    The recycled-inode retry shared by the owner-side
    (:meth:`Registry._notify_owner`) and subscriber-side
    (``Publisher._notify``) wakeup paths: the sweep unlinks dead slots'
    FIFO files and a successor mkfifos a fresh inode, so a cached write fd
    can go stale — callers drop it and re-send through here.

    ``ENXIO``/``ENOENT`` means no reader *right now* — which is also what
    a live waiter mid-open of its read end looks like.  When a
    ``still_wanted()`` predicate is supplied the open is retried for up
    to ``retry_s`` while it stays true, instead of silently dropping the
    wakeup (the lost-wakeup asymmetry fix: both notify directions now
    re-check the peer before giving up).  Returns the fresh fd for the
    caller's cache, or ``None`` if nobody wants the wakeup."""
    deadline = time.monotonic() + retry_s
    while True:
        try:
            fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK)
            break
        except OSError:
            if still_wanted is None:
                return None
            try:
                wanted = bool(still_wanted())
            except Exception:
                return None
            if not wanted or time.monotonic() >= deadline:
                return None
            time.sleep(0.002)
    try:
        os.write(fd, b"\x01")
    except OSError:
        pass  # full pipe: a wakeup is already pending
    return fd


def _alive(pid: int) -> bool:
    if pid == 0:
        return False
    try:
        os.kill(int(pid), 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:  # exists, not ours
        return True


def _name_hash(key: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little") or 1


def _rel_masks(rel: np.ndarray) -> np.ndarray:
    """Fold ``released`` byte vectors (…, MAX_SUBS) into uint64 bitmasks."""
    return np.packbits(rel != 0, axis=-1, bitorder="little").view("<u8")[..., 0]


class _Flock:
    """Kernel-released mutual exclusion (survives holder death).

    ``flock`` is held per *open file description*: two threads sharing this
    object would both "acquire" it at once (the second LOCK_EX on an
    already-held fd is a no-op), so a thread mutex restores in-process
    exclusion — executor worker threads share one ``Registry``.
    """

    def __init__(self, path: str):
        self._path = path
        self._fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o666)
        try:
            # the O_CREAT mode is masked by umask: a registry created under
            # a restrictive umask must still be attachable cross-user
            os.chmod(path, 0o666)
        except OSError:
            pass  # pre-existing file owned by another uid
        self._mu = threading.Lock()

    def __enter__(self):
        self._mu.acquire()
        try:
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except BaseException:
            self._mu.release()
            raise
        return self

    def __exit__(self, *exc):
        try:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
        finally:
            self._mu.release()

    def close(self):
        try:
            os.close(self._fd)
        except OSError:
            pass


class Registry:
    """The shared metadata plane. One per "domain" (cf. ROS_DOMAIN_ID)."""

    def __init__(self, shm, *, owner: bool, name: str):
        self.name = name
        self._shm = shm
        self.owner = owner
        buf = shm.buf
        self._hdr = np.frombuffer(buf, dtype=np.uint64, count=8)
        off = 64
        self._hash = np.frombuffer(buf, dtype=HASH_DT, count=HASH_CAP, offset=off)
        off += HASH_DT.itemsize * HASH_CAP
        off = (off + 63) & ~63
        # one journal slot per topic: journal[tidx] is guarded by topic
        # tidx's lock, so disjoint-topic mutations journal concurrently
        self._journal = np.frombuffer(buf, dtype=JOURNAL_DT, count=MAX_TOPICS,
                                      offset=off)
        off += JOURNAL_DT.itemsize * MAX_TOPICS
        off = (off + 63) & ~63
        self.topics = np.frombuffer(buf, dtype=TOPIC_DT, count=MAX_TOPICS, offset=off)
        off += TOPIC_DT.itemsize * MAX_TOPICS
        off = (off + 63) & ~63
        n_entries = MAX_TOPICS * MAX_PUBS * DEPTH_MAX
        self.entries = np.frombuffer(buf, dtype=ENTRY_DT, count=n_entries, offset=off).reshape(
            MAX_TOPICS, MAX_PUBS, DEPTH_MAX
        )
        self._lock = _Flock(domain_lock_path(name))  # create/destroy + sweep
        self._tlocks: list[_Flock | None] = [None] * MAX_TOPICS
        self._tlock_mu = threading.Lock()  # lazy per-topic lock-file opens
        self._closed = False               # set under _tlock_mu: close() vs lazy open
        self._pub_fds: dict[tuple[int, int], int] = {}  # (tidx,pidx) -> write fd
        self._pub_fds_mu = threading.Lock()  # executor worker threads share us
        if owner:
            self._hdr[0] = _MAGIC  # agnolint: allow[AGNO-LOCK-001] -- owner's create-time store, before the segment name is shared
        elif int(self._hdr[0]) != _MAGIC:
            raise RegistryError(f"{name!r} is not an agnocast (layout v4) registry")

    # -- lifecycle -----------------------------------------------------------

    @staticmethod
    def segment_size() -> int:
        off = 64 + HASH_DT.itemsize * HASH_CAP
        off = (off + 63) & ~63
        off += JOURNAL_DT.itemsize * MAX_TOPICS
        off = (off + 63) & ~63
        off += TOPIC_DT.itemsize * MAX_TOPICS
        off = (off + 63) & ~63
        off += ENTRY_DT.itemsize * MAX_TOPICS * MAX_PUBS * DEPTH_MAX
        return off

    @classmethod
    def create(cls, name: str | None = None) -> "Registry":
        name = name or f"agnoreg-{secrets.token_hex(4)}"
        shm = _new_shm(name, create=True, size=cls.segment_size())
        return cls(shm, owner=True, name=name)

    @classmethod
    def attach(cls, name: str) -> "Registry":
        return cls(_new_shm(name, create=False), owner=False, name=name)

    def close(self):
        import gc

        with self._pub_fds_mu:
            for fd in self._pub_fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._pub_fds = {}
        with self._tlock_mu:
            # flag first, then close: a worker thread racing us in
            # _topic_flock either sees _closed and raises, or completed its
            # open under this mutex before we got it — no fd can leak into
            # a lock slot after it was closed here
            self._closed = True
            for lk in self._tlocks:
                if lk is not None:
                    lk.close()
            self._tlocks = [None] * MAX_TOPICS
        self._lock.close()
        for a in ("_hdr", "_hash", "_journal", "topics", "entries"):
            setattr(self, a, None)
        gc.collect()
        try:
            self._shm.close()
        except BufferError:
            pass

    def unlink(self):
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
            # every artifact this registry strews across /tmp goes with it:
            # the domain lock, every per-topic lock (globbed: at 1024 topics
            # an unconditional unlink loop is 1024 syscalls for a handful of
            # lazily-created files), and the FIFO directory
            try:
                os.unlink(domain_lock_path(self.name))
            except OSError:
                pass
            for p in _glob.glob(f"/tmp/.agnocast-{self.name}.t*.lock"):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            shutil.rmtree(fifo_dir(self.name), ignore_errors=True)

    # -- sharded locking + journaled row mutation (transactionality core) -----

    def _topic_flock(self, tidx: int) -> _Flock:
        """Topic ``tidx``'s lock file, opened lazily (most participants only
        ever touch a handful of the 1024 possible topics).  Lazy init is
        guarded by ``_tlock_mu``: without it two executor worker threads
        can both see ``None`` and open/overwrite the same slot — leaking an
        fd and splitting the in-process thread mutex between two _Flock
        objects (both threads then "hold" the topic lock at once)."""
        lk = self._tlocks[tidx]
        if lk is None:
            with self._tlock_mu:
                if self._closed:
                    raise RegistryError("registry is closed")
                lk = self._tlocks[tidx]
                if lk is None:
                    lk = _Flock(topic_lock_path(self.name, tidx))
                    self._tlocks[tidx] = lk
        return lk

    @contextmanager
    def _locked(self, tidx: int, *, write: bool = True):
        """The per-topic critical section every metadata *mutation* runs in:
        acquire topic ``tidx``'s lock, roll back any dead writer's pending
        mutation on *this* topic, then run the op with the seqlock write
        counter held odd so lock-free readers retry instead of observing a
        torn row.  ``write=False`` is the locked *read* fallback: it still
        recovers, but leaves ``wseq`` alone so sibling readers don't churn."""
        with self._topic_flock(tidx):
            self._recover(tidx)
            if not write:
                yield
                return
            t = self.topics[tidx]
            t["wseq"] = int(t["wseq"]) + 1      # odd: writer active
            try:
                yield
            finally:
                t["wseq"] = int(t["wseq"]) + 1  # even: row quiescent

    # agnolint: locked-context -- caller holds topic tidx's lock (see docstring)
    def _recover(self, tidx: int):
        """Roll back a dead writer's in-flight mutation on topic ``tidx``
        (before-images).  Caller holds topic ``tidx``'s lock — recovery is
        per topic: a pending journal on another topic is that topic's next
        acquirer's job, never ours.

        Seqlock interplay: a restored topic image carries a *stale* (and
        even) ``wseq``; installing it verbatim would let a reader that
        snapshotted the same value before the torn write validate a torn
        read (ABA).  The restore therefore forces ``wseq`` to an even
        value strictly above both the current and restored counters.  A
        restored entry image is OR-merged with the current ``released``
        bytes: a subscriber's lock-free release intent is never undone by
        someone else's rollback.  The same rule covers the topic row's
        lock-free single-writer columns — ``pub_waiters`` is OR-merged and
        ``sub_lease_ns`` keeps the newer stamp — because a verbatim
        restore would wipe a waiter flag armed after the image was taken
        (a permanent lost wakeup: releasers skip the FIFO write when the
        flag reads clear) or age a live subscriber's lease into sweep
        range.  Finally, a writer that died *inside* its
        critical section leaves ``wseq`` odd with no (or a clean) journal;
        the parity repair below un-wedges lock-free readers."""
        j = self._journal[tidx]
        if int(j["state"]) == _J_PENDING and not _alive(int(j["pid"])):
            t, p, s = int(j["tidx"]), int(j["pidx"]), int(j["slot"])
            if int(j["has_topic"]) and t >= 0:
                cur = int(self.topics[t]["wseq"])
                cur_waiters = self.topics[t]["pub_waiters"].copy()
                cur_lease = self.topics[t]["sub_lease_ns"].copy()
                self.topics[t] = np.frombuffer(bytes(j["topic_img"]), dtype=TOPIC_DT)[0]
                self.topics[t]["wseq"] = (max(cur, int(self.topics[t]["wseq"])) + 2) & ~1
                # Lock-free single-writer columns are never undone by
                # someone else's rollback (the topic-row analogue of the
                # entry 'released' OR-merge below): a waiter that armed
                # ``pub_waiters`` after the image was captured would
                # otherwise be wiped back to 0 — and since releasers skip
                # the slot-freed FIFO write when the flag is clear, that
                # waiter parks in wait_for_slot forever.  Leases keep the
                # *newer* stamp so a rollback can never age a live
                # subscriber into sweep range.
                self.topics[t]["pub_waiters"] |= cur_waiters
                np.maximum(self.topics[t]["sub_lease_ns"], cur_lease,
                           out=self.topics[t]["sub_lease_ns"])
            if int(j["has_entry"]) and t >= 0 and s >= 0:
                cur_rel = self.entries[t, p, s]["released"].copy()
                self.entries[t, p, s] = np.frombuffer(bytes(j["entry_img"]), dtype=ENTRY_DT)[0]
                self.entries[t, p, s]["released"] |= cur_rel
            j["state"] = _J_CLEAN
        w = int(self.topics[tidx]["wseq"])
        if w & 1:
            self.topics[tidx]["wseq"] = w + 1

    def _recover_dead_topics(self) -> None:
        """Opportunistic pass under the domain lock: roll back every dead
        writer's pending journal before trusting the topic-name scan (a
        creator that died mid-create may have left a torn row).  Each
        rollback still takes its topic's lock (domain → topic order), so a
        concurrent *live* acquirer of that topic — who may already have
        recovered and started a fresh transaction — is never disturbed:
        ``_recover`` re-checks writer liveness under the lock."""
        pending = np.nonzero(self._journal["state"] == _J_PENDING)[0]
        for i in pending:
            i = int(i)
            if not _alive(int(self._journal[i]["pid"])):
                with self._topic_flock(i):
                    self._recover(i)

    class _Txn:
        def __init__(self, reg: "Registry", tidx: int, pidx: int = -1, slot: int = -1,
                     *, topic: bool = False, entry: bool = False):
            self.reg, self.tidx, self.pidx, self.slot = reg, tidx, pidx, slot
            self.topic, self.entry = topic, entry

        # agnolint: locked-context -- caller holds the topic lock; the journal slot is topic-lock-guarded
        def __enter__(self):
            # journal slot = the topic's own: guarded by the topic lock the
            # caller already holds, so sibling topics journal concurrently
            r, t = self.reg, self.tidx
            j = self.reg._journal
            j[t]["pid"] = os.getpid()
            j[t]["tidx"], j[t]["pidx"], j[t]["slot"] = self.tidx, self.pidx, self.slot
            j[t]["has_topic"] = 1 if self.topic else 0
            j[t]["has_entry"] = 1 if self.entry else 0
            if self.topic:
                j[t]["topic_img"] = r.topics[self.tidx].tobytes()
            if self.entry:
                j[t]["entry_img"] = r.entries[self.tidx, self.pidx, self.slot].tobytes()
            j[t]["state"] = _J_PENDING  # fence: images valid before PENDING
            return self

        # agnolint: locked-context -- caller still holds the topic lock through __exit__
        def __exit__(self, et, ev, tb):
            if et is None:
                self.reg._journal[self.tidx]["state"] = _J_CLEAN
            # on exception: we are still alive, so roll back now.  Same
            # seqlock rules as _recover, except the caller's _locked(write)
            # frame holds wseq odd and will bump it even on exit — so the
            # topic restore must keep the *current* (odd, larger) counter,
            # not the stale even one from the image; and the entry restore
            # must OR-merge concurrent lock-free release bytes.
            elif int(self.reg._journal[self.tidx]["state"]) == _J_PENDING:
                j = self.reg._journal[self.tidx]
                if int(j["has_topic"]):
                    row = self.reg.topics[self.tidx]
                    cur = int(row["wseq"])
                    cur_waiters = row["pub_waiters"].copy()
                    cur_lease = row["sub_lease_ns"].copy()
                    self.reg.topics[self.tidx] = np.frombuffer(bytes(j["topic_img"]), dtype=TOPIC_DT)[0]
                    row = self.reg.topics[self.tidx]
                    row["wseq"] = max(cur, int(row["wseq"]))
                    # same single-writer-column preservation as _recover:
                    # a concurrent lock-free waiter arm / lease refresh
                    # must survive this rollback too
                    row["pub_waiters"] |= cur_waiters
                    np.maximum(row["sub_lease_ns"], cur_lease,
                               out=row["sub_lease_ns"])
                if int(j["has_entry"]):
                    cur_rel = self.reg.entries[self.tidx, self.pidx, self.slot]["released"].copy()
                    self.reg.entries[self.tidx, self.pidx, self.slot] = np.frombuffer(
                        bytes(j["entry_img"]), dtype=ENTRY_DT)[0]
                    self.reg.entries[self.tidx, self.pidx, self.slot]["released"] |= cur_rel
                j["state"] = _J_CLEAN
            return False

    # -- seqlock read plane ----------------------------------------------------

    def _seqlock_read(self, tidx: int, fn, *, advisory: bool = False):
        """Run ``fn()`` between two reads of topic ``tidx``'s write counter.
        Returns ``(True, value)`` for a provably-untorn snapshot, or
        ``(False, None)`` after ``_SEQ_RETRIES`` — e.g. a writer died
        mid-write and left ``wseq`` odd — at which point the caller falls
        back to the locked path (whose recovery repairs the parity).

        ``advisory=True`` caps the spin at two attempts — for hint reads
        (see :meth:`_read_hint`) that have their own cheap resolution: on
        a write-hot row every failed attempt re-evaluates ``fn`` (numpy
        field math, ~10µs), so a long advisory spin costs more than the
        dirty tier it is trying to avoid."""
        t = self.topics[tidx]
        for attempt in range(2 if advisory else _SEQ_RETRIES):
            s0 = int(t["wseq"])
            if not (s0 & 1):
                val = fn()
                if int(t["wseq"]) == s0:
                    return True, val
            # Mostly SPIN: on a write-hot topic the even windows between
            # critical sections are tens of µs wide, and a sleeping reader
            # misses every one of them (then eats the contended lock as a
            # "fallback" — the exact serialization this plane exists to
            # avoid).  Sleep only occasionally to stay polite to a genuinely
            # wedged row (crashed writer) before the locked repair.
            if not advisory and attempt & 15 == 15:
                time.sleep(0.00005)
        return False, None

    _NO_HINT = object()

    def _read_hint(self, tidx: int, fn):
        """Advisory read for boolean/scalar *hints* whose consumers
        re-validate under the lock anyway (``can_publish`` before an actual
        ``publish``, ``queue_depth`` as a load signal).  Three tiers:

        1. a short validated seqlock spin — exact whenever the row is calm;
        2. on a write-hot row (live writers hold ``wseq`` odd for the whole
           critical section — waiting out their sections is the exact
           serialization this plane exists to avoid): an UNVALIDATED read.
           A possibly-torn hint costs one spurious QueueFull or one wasted
           poll, never correctness;
        3. ``_NO_HINT`` when the row is *wedged* — a PENDING journal from a
           dead writer — so the caller takes the locked path and its
           recovery repairs the row instead of serving dirty reads off a
           corpse's torn write forever.  (A writer that dies in the sliver
           between lock and journal leaves no PENDING record; that wedge is
           repaired by the topic's next locked op, and hints stay dirty —
           not wrong — until then.)"""
        ok, val = self._seqlock_read(tidx, fn, advisory=True)
        if ok:
            return val
        j = self._journal[tidx]
        if int(j["state"]) == _J_PENDING and not _alive(int(j["pid"])):
            return self._NO_HINT
        try:
            return fn()
        except Exception:
            return self._NO_HINT  # torn arithmetic (e.g. depth mid-write)

    # -- O(1) topic lookup (open-addressed name hash) --------------------------

    def _lookup_fast(self, key: bytes) -> int:
        """Lock-free probe of the name table.  Advisory only: every hit is
        validated against the authoritative topic row, so torn table slots
        or mid-flight inserts produce a miss (→ locked fallback), never a
        wrong index."""
        h = _name_hash(key)
        table = self._hash
        for i in range(HASH_CAP):
            slot = table[(h + i) % HASH_CAP]
            tref = int(slot["tref"])
            if tref == 0:
                return -1
            if tref == -1:  # tombstone
                continue
            if int(slot["h"]) == h:
                tidx = tref - 1
                if 0 <= tidx < MAX_TOPICS:
                    t = self.topics[tidx]
                    if t["in_use"] and bytes(t["name"]).rstrip(b"\0") == key:
                        return tidx
        return -1

    # agnolint: locked-context -- caller holds the domain lock (name table writes)
    def _hash_insert(self, key: bytes, tidx: int) -> None:
        """Caller holds the domain lock.  Publishes ``tref`` last so a
        concurrent lock-free probe sees either no slot or a complete one.
        Dangling slots (same hash, row no longer matching) are tombstoned
        in passing — they arise when a creator died after insert and the
        row was later recycled for another name."""
        h = _name_hash(key)
        table = self._hash
        ins = -1
        for i in range(HASH_CAP):
            idx = (h + i) % HASH_CAP
            slot = table[idx]
            tref = int(slot["tref"])
            if tref == -1:
                if ins < 0:
                    ins = idx
                continue
            if tref == 0:
                if ins < 0:
                    ins = idx
                break
            if int(slot["h"]) == h:
                t = self.topics[tref - 1] if 0 <= tref - 1 < MAX_TOPICS else None
                if t is not None and t["in_use"] and bytes(t["name"]).rstrip(b"\0") == key:
                    slot["tref"] = tidx + 1  # re-point (repair path)
                    return
                slot["tref"] = -1            # dangling: tombstone, reuse
                if ins < 0:
                    ins = idx
        if ins < 0:
            raise RegistryError("topic name table full")
        table[ins]["h"] = h
        table[ins]["tref"] = tidx + 1        # published last

    # agnolint: locked-context -- caller holds the domain lock (name table writes)
    def _hash_remove(self, key: bytes, tidx: int) -> None:
        """Caller holds the domain lock: tombstone the slot for ``key``."""
        h = _name_hash(key)
        table = self._hash
        for i in range(HASH_CAP):
            idx = (h + i) % HASH_CAP
            slot = table[idx]
            tref = int(slot["tref"])
            if tref == 0:
                return
            if tref == tidx + 1 and int(slot["h"]) == h:
                slot["tref"] = -1
                return

    def _lookup_locked(self, key: bytes) -> int:
        """Caller holds the domain lock.  Probe the table, then fall back
        to a linear scan of in-use rows: a creator that died between
        committing its row and inserting it leaves a findable row with no
        table slot — the scan is the safety net, and it repairs the table."""
        tidx = self._lookup_fast(key)
        if tidx >= 0:
            return tidx
        names = self.topics["name"]
        in_use = np.nonzero(self.topics["in_use"])[0]
        for i in in_use:
            i = int(i)
            if bytes(names[i]).rstrip(b"\0") == key:
                self._hash_insert(key, i)
                return i
        return -1

    # -- topic / participant management --------------------------------------

    def topic_index(self, name: str, *, create: bool = True) -> int:
        key = name.encode()
        if not FORCE_LOCKED_HOTPATH:
            tidx = self._lookup_fast(key)
            if tidx >= 0:
                return tidx
        with self._lock:  # the domain lock: create/destroy only
            self._recover_dead_topics()
            tidx = self._lookup_locked(key)
            if tidx >= 0:
                return tidx
            if not create:
                raise RegistryError(f"unknown topic {name!r}")
            free_rows = np.nonzero(self.topics["in_use"] == 0)[0]
            if len(free_rows) == 0:
                raise RegistryError("topic table full")
            free = int(free_rows[0])
            # the create mutation journals into the new topic's own slot,
            # under its lock (domain → topic order): if we die here, the
            # slot's next acquirer — or the next topic_index/sweep — rolls
            # the torn row back to free; if we die after the commit but
            # before the table insert, _lookup_locked's scan finds the row
            # and repairs the table
            with self._locked(free):
                with self._Txn(self, free, topic=True):
                    t = self.topics[free]
                    t["name"] = key
                    t["in_use"] = 1
                    t["gen"] = int(t["gen"]) + 1  # name-ABA guard: recycled
                    t["sub_alive"] = 0            # slots get a fresh identity
                    t["sub_pids"][:] = 0
                    t["pub_alive"][:] = 0
                    t["pub_pids"][:] = 0
                    t["pub_waiters"][:] = 0
            self._hash_insert(key, free)
            return free

    def topic_gen(self, tidx: int) -> int:
        """The row's current generation — captured by participants at
        attach; stale-generation ops are rejected (see class docstring)."""
        return int(self.topics[tidx]["gen"])

    def destroy_topic(self, name: str) -> bool:
        """Tear a topic down: free the row for reuse, tombstone its table
        slot, and unlink its FIFO files so a recycled slot can never
        deliver wakeups through a dead topic's inodes.  The row keeps its
        ``gen`` (bumped again on re-create), so handles captured against
        the destroyed incarnation are rejected everywhere."""
        key = name.encode()
        with self._lock:
            self._recover_dead_topics()
            tidx = self._lookup_locked(key)
            if tidx < 0:
                return False
            with self._locked(tidx):
                with self._Txn(self, tidx, topic=True):
                    t = self.topics[tidx]
                    t["in_use"] = 0
                    t["sub_alive"] = 0
                    t["pub_alive"][:] = 0
                    t["pub_waiters"][:] = 0
                self.entries[tidx]["state"] = ST_FREE
                self.entries[tidx]["released"] = 0
                self.entries[tidx]["pins"] = 0
                self.entries[tidx]["pin_deadline_ns"] = 0
                self.entries[tidx]["xarena"] = b""
            self._hash_remove(key, tidx)
            with self._pub_fds_mu:
                for p in range(MAX_PUBS):
                    fd = self._pub_fds.pop((tidx, p), None)
                    if fd is not None:
                        try:
                            os.close(fd)
                        except OSError:
                            pass
            for pat in (f"t{tidx}s*.fifo", f"t{tidx}p*.pub.fifo"):
                for p in _glob.glob(os.path.join(fifo_dir(self.name), pat)):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            return True

    def add_publisher(self, tidx: int, pid: int, arena_name: str, depth: int) -> int:
        if not (1 <= depth <= DEPTH_MAX):
            raise RegistryError(f"depth must be in [1,{DEPTH_MAX}]")
        with self._locked(tidx):
            t = self.topics[tidx]
            for p in range(MAX_PUBS):
                if not t["pub_alive"][p] or not _alive(int(t["pub_pids"][p])):
                    with self._Txn(self, tidx, topic=True):
                        t["pub_pids"][p] = pid
                        t["pub_alive"][p] = 1
                        t["pub_waiters"][p] = 0
                        t["pub_arena"][p] = arena_name.encode()
                        t["pub_depth"][p] = depth
                        t["pub_next_seq"][p] = 1
                        t["pub_drops"][p] = 0
                    self.entries[tidx, p, :] = np.zeros((), dtype=ENTRY_DT)
                    return p
            raise RegistryError("publisher table full")

    def add_subscriber(self, tidx: int, pid: int) -> int:
        with self._locked(tidx):
            t = self.topics[tidx]
            alive = int(t["sub_alive"])
            for s in range(MAX_SUBS):
                if not (alive >> s) & 1 or not _alive(int(t["sub_pids"][s])):
                    with self._Txn(self, tidx, topic=True):
                        t["sub_pids"][s] = pid
                        t["sub_alive"] = np.uint64(alive | (1 << s))
                        t["sub_lease_ns"][s] = time.monotonic_ns()
                    # a recycled slot may carry predecessors' unfolded
                    # release bytes: they must not fold against entries the
                    # new tenant takes
                    self.entries[tidx]["released"][:, :, s] = 0
                    # the slot's wakeup FIFO is (re)created here, under the
                    # topic lock: sweep/remove unlink a dead slot's FIFO
                    # file, so creation must be ordered with the slot claim
                    # or a publish racing the new subscriber's own mkfifo
                    # would find no file at all (ENOENT, silently skipped)
                    try:
                        os.makedirs(fifo_dir(self.name), exist_ok=True)
                        os.mkfifo(sub_fifo_path(self.name, tidx, s))
                    except FileExistsError:
                        pass
                    return s
            raise RegistryError("subscriber table full")

    def remove_subscriber(self, tidx: int, sidx: int, *, gen: int | None = None) -> None:
        with self._locked(tidx):
            if gen is not None and int(self.topics[tidx]["gen"]) != gen:
                return  # slot was recycled: the tenant is somebody else now
            owners = self._drop_subscriber(tidx, sidx)
        self._notify_owners(owners)

    # agnolint: locked-context -- caller holds topic tidx's lock (see docstring)
    def _drop_subscriber(self, tidx: int, sidx: int) -> list[tuple[int, int]]:
        """Caller holds topic ``tidx``'s lock.  Returns the (tidx, pidx)
        owners to wake (dropping refs may have freed ring slots) — the FIFO
        writes happen after the lock is released."""
        mask = np.uint64(~np.uint64(1 << sidx))
        t = self.topics[tidx]
        with self._Txn(self, tidx, topic=True):
            t["sub_alive"] = np.uint64(int(t["sub_alive"]) & int(mask))
            t["sub_pids"][sidx] = 0
        e = self.entries[tidx]
        e["unreceived"] &= mask
        e["held"] &= mask  # releases the dead subscriber's references (§IV-C)
        e["released"][:, :, sidx] = 0
        try:  # the slot's wakeup FIFO file goes with the slot (no /tmp leak)
            os.unlink(sub_fifo_path(self.name, tidx, sidx))
        except OSError:
            pass
        return [(tidx, p) for p in range(MAX_PUBS) if t["pub_alive"][p]]

    def _notify_owners(self, owners: list[tuple[int, int]]) -> None:
        for tidx, pidx in owners:
            self._notify_owner(tidx, pidx)

    # -- owner-side "slot freed" wakeup (reverse FIFO) -------------------------

    def _waiter_wants_wakeup(self, tidx: int, pidx: int) -> bool:
        """Is there (still) a live, armed waiter behind (tidx, pidx)?  The
        no-reader retry predicate: ENXIO with this true means the waiter is
        mid-open of its FIFO read end, not gone."""
        try:
            t = self.topics[tidx]
            return bool(t["pub_waiters"][pidx]) and bool(t["pub_alive"][pidx]) \
                and _alive(int(t["pub_pids"][pidx]))
        except TypeError:
            return False  # registry torn down concurrently

    def _notify_owner(self, tidx: int, pidx: int) -> None:
        """Write one byte to the owning publisher's slot-freed FIFO.

        Best-effort and non-blocking — but *not* fire-and-forget: the
        publisher creates its reverse FIFO at construction and opens the
        read end O_RDWR immediately after, so "no reader" (ENXIO/ENOENT)
        while the waiter flag is armed and the owner alive almost always
        means the owner is mid-open.  Dropping the byte there is the exact
        lost-wakeup the subscriber-side EPIPE retry already guards
        against, so this path now re-checks the owner and retries briefly
        (``_open_and_wake``'s ``still_wanted`` loop) instead of returning
        silently.  A full pipe still short-circuits: wakeups coalesce.

        Skipped entirely unless the owner's waiter flag is set: a release
        with no blocked publisher is the common case, and the flag check is
        one shared-memory load instead of an ``os.write`` syscall.  The
        waiter sets the flag *before* re-checking ``can_publish``, and the
        re-check reads the released bytes a fast-path release stores, so a
        releaser that misses the flag is always ordered before a re-check
        that sees its freed slot.
        """
        try:
            if not self.topics[tidx]["pub_waiters"][pidx]:
                return
        except TypeError:  # registry torn down concurrently
            return
        key = (tidx, pidx)
        path = pub_fifo_path(self.name, tidx, pidx)
        wanted = lambda: self._waiter_wants_wakeup(tidx, pidx)  # noqa: E731
        with self._pub_fds_mu:  # fd cache shared by executor worker threads
            fd = self._pub_fds.get(key)
            if fd is None:
                fd = _open_and_wake(path, still_wanted=wanted)
                if fd is not None:
                    self._pub_fds[key] = fd
                return
            try:
                os.write(fd, b"\x01")
            except BlockingIOError:
                pass  # pipe full: a wakeup is already pending
            except OSError:
                try:
                    os.close(fd)
                except OSError:
                    pass
                self._pub_fds.pop(key, None)
                # recycled slot: retry against the fresh inode (and keep
                # retrying while a live waiter is mid-open of it)
                fd = _open_and_wake(path, still_wanted=wanted)
                if fd is not None:
                    self._pub_fds[key] = fd

    def set_pub_waiter(self, tidx: int, pidx: int, waiting: bool) -> None:
        """Raise/clear the owner's "blocked on a full ring" flag.

        A single shared-memory byte store: no lock is needed because the
        readers (``_notify_owner`` and the fast-path release) tolerate both
        races — a spurious set costs one redundant FIFO write or one
        locked-path release, and a clear-vs-release race is resolved by
        the waiter's post-set ``can_publish`` re-check."""
        # agnolint: allow[AGNO-LOCK-001] -- lock-free by design: the owner is the byte's single writer; release's Dekker re-check pairs with it
        self.topics[tidx]["pub_waiters"][pidx] = 1 if waiting else 0

    def pub_waiter(self, tidx: int, pidx: int) -> bool:
        """Current waiter-flag state (owners save/restore around nested
        waits: a transient ``wait_for_slot`` must not clear a flag an
        executor handle armed for its whole lifetime)."""
        return bool(self.topics[tidx]["pub_waiters"][pidx])

    # -- subscriber liveness leases -------------------------------------------

    def refresh_lease(self, tidx: int, sidx: int) -> None:
        """Stamp subscriber ``sidx``'s lease now (idle replicas heartbeat
        through this; busy ones are stamped by every ``take``)."""
        # agnolint: allow[AGNO-LOCK-001] -- lock-free by design: the subscriber is its lease stamp's single writer; staleness checks tolerate a torn read
        self.topics[tidx]["sub_lease_ns"][sidx] = time.monotonic_ns()

    def lease_ages(self, tidx: int) -> dict[int, float]:
        """Seconds since each *live* subscriber of ``tidx`` last took or
        heartbeat — the wedged-consumer detector (PID liveness only catches
        dead ones).  Lock-free monitoring read: the poller runs on a timer,
        so a torn race costs one stale sample, never a wrong decision —
        keeping it off the topic lock matters because liveness polls must
        not bid against the data plane's hot path."""
        now = time.monotonic_ns()
        t = self.topics[tidx]
        alive = int(t["sub_alive"])
        return {
            s: (now - int(t["sub_lease_ns"][s])) / 1e9
            for s in range(MAX_SUBS)
            if (alive >> s) & 1
        }

    def publishers(self, tidx: int) -> list[tuple[int, str]]:
        """Live publishers of ``tidx`` with their arena names.  Called on
        every ``take`` (subscribers resolve entry → arena through it), so
        it is a seqlock read: no lock on the hot path."""
        def read():
            t = self.topics[tidx]
            return [
                (p, bytes(t["pub_arena"][p]).rstrip(b"\0").decode())
                for p in range(MAX_PUBS)
                if t["pub_alive"][p]
            ]
        if not FORCE_LOCKED_HOTPATH:
            ok, val = self._seqlock_read(tidx, read)
            if ok:
                return val
        with self._locked(tidx, write=False):
            return read()

    # -- the ioctl surface: publish / take / release --------------------------

    def _effective_held(self, e) -> int:
        """An entry's held mask minus its unfolded release bytes — what the
        held count *will be* once a lock holder folds."""
        rel = e["released"]
        if not rel.any():
            return int(e["held"])
        return int(e["held"]) & ~int(_rel_masks(rel))

    @staticmethod
    def _pin_active(e) -> bool:
        """Is a cross-bridge pin keeping this entry alive?  False once the
        lease deadline passes — lease-expiry reclaim is this comparison,
        applied wherever liveness is decided (no sweeper needed)."""
        return (int(e["pins"]) > 0
                and time.monotonic_ns() < int(e["pin_deadline_ns"]))

    def _entry_busy(self, e) -> bool:
        """Held by a subscriber OR pinned by a live cross-bridge lease —
        the condition under which a ring slot must not be recycled."""
        return bool(self._effective_held(e)) or self._pin_active(e)

    # agnolint: locked-context -- caller holds topic tidx's lock; fold is idempotent by store order
    def _fold_releases(self, tidx: int, pidx: int | None = None) -> None:
        """Fold lock-free release bytes into the ``held`` masks.  Caller
        holds topic ``tidx``'s lock.  Unjournaled by design: the byte array
        *is* the durable intent (the subscriber already released), clearing
        ``held`` before zeroing ``released`` makes a crash mid-fold
        re-foldable, and rollbacks OR-merge the bytes back — fold is
        idempotent and monotonic.

        Only the bytes read here are zeroed.  A subscriber's lock-free store
        that lands between the read and the zeroing stays for the next fold;
        zeroing the whole array (as the reference's fold does) would drop
        it, and its held bit would never clear: the publisher's ring slot
        stays referenced for good and a later publish onto it blocks."""
        ring = self.entries[tidx] if pidx is None else self.entries[tidx, pidx]
        rel = ring["released"]
        seen = rel != 0
        if not seen.any():
            return
        ring["held"][...] = ring["held"] & ~_rel_masks(seen)
        rel[seen] = 0

    def can_publish(self, tidx: int, pidx: int) -> bool:
        """Would :meth:`publish` succeed right now?  The target ring slot is
        publishable unless a subscriber still *holds* its occupant (an
        unreceived-only occupant is dropped by QoS keep-last).  Lock-free:
        a seqlock read of the slot, counting unfolded release bytes as
        already released — this is what makes the waiter-side re-check see
        a fast-path release that raced its flag arming."""
        def read():
            t = self.topics[tidx]
            depth = int(t["pub_depth"][pidx]) or 1
            slot = int(t["pub_next_seq"][pidx]) % depth
            e = self.entries[tidx, pidx, slot]
            return not (int(e["state"]) == ST_USED and self._entry_busy(e))
        if not FORCE_LOCKED_HOTPATH:
            val = self._read_hint(tidx, read)
            if val is not self._NO_HINT:
                return bool(val)
        with self._locked(tidx, write=False):
            return read()

    def queue_depth(self, tidx: int, pidx: int) -> int:
        """Occupied ring slots for (tidx, pidx) — a lock-free monitoring
        snapshot (collectors and backpressure heuristics poll this)."""
        def read():
            return int(np.count_nonzero(
                self.entries["state"][tidx, pidx] == ST_USED))
        if not FORCE_LOCKED_HOTPATH:
            val = self._read_hint(tidx, read)
            if val is not self._NO_HINT:
                return int(val)
        with self._locked(tidx, write=False):
            return read()

    def _prune_mask(self, ring) -> np.ndarray:
        """Vectorized "owner may reclaim" mask: fully released, fully
        received, no publisher refs, and no live cross-bridge pin (an
        expired lease counts as no pin — that IS the lease reclaim)."""
        unpinned = (ring["pins"] == 0) | \
                   (ring["pin_deadline_ns"] <= np.uint64(time.monotonic_ns()))
        return ((ring["state"] == ST_USED) & (ring["unreceived"] == 0) &
                (ring["held"] == 0) & (ring["pub_refs"] == 0) & unpinned)

    def publish(self, tidx: int, pidx: int, desc_off: int, desc_len: int,
                *, origin: int = ORIGIN_AGNOCAST, exclude_sub: int = -1,
                hops: int = 0, src_tag: int = 0,
                route_seq: int = 0, gen: int | None = None,
                xarena: str = "", trace_id: int = 0) -> tuple[int, list[int]]:
        """Enqueue an entry; returns (seq, freeable_seqs_for_owner).

        QoS keep-last(depth): an *unreceived* occupant of the target slot is
        dropped; a *held* (or pin-active: a remote bridge is reading it by
        reference) occupant means every slot is still alive —
        AgnocastQueueFull (cf. loaned-chunk exhaustion in iceoryx).

        ``xarena`` names the arena the descriptor's offsets live in when it
        is not the publisher's own (same-host zero-copy relay).
        """
        freeable: list[int] = []
        with self._locked(tidx):
            t = self.topics[tidx]
            if gen is not None and int(t["gen"]) != gen:
                raise RegistryError(
                    f"topic {tidx} generation changed (destroyed/recycled)")
            self._fold_releases(tidx, pidx)
            depth = int(t["pub_depth"][pidx])
            seq = int(t["pub_next_seq"][pidx])
            slot = seq % depth
            e = self.entries[tidx, pidx, slot]
            if int(e["state"]) == ST_USED:
                if int(e["held"]) or self._pin_active(e):
                    raise AgnocastQueueFull(
                        f"topic {tidx} pub {pidx}: ring slot {slot} still referenced"
                    )
                if int(e["unreceived"]):
                    with self._Txn(self, tidx, pidx, slot, topic=True, entry=True):
                        t["pub_drops"][pidx] += 1
                        e["state"] = ST_FREE
                else:
                    e["state"] = ST_FREE
                freeable.append(int(e["seq"]))
            # prune: any fully-released older entries the owner may reclaim
            ring = self.entries[tidx, pidx]
            for s in np.nonzero(self._prune_mask(ring))[0]:
                freeable.append(int(ring[s]["seq"]))
                ring[s]["state"] = ST_FREE
            sub_mask = int(t["sub_alive"])
            if exclude_sub >= 0:
                sub_mask &= ~(1 << exclude_sub)
            with self._Txn(self, tidx, pidx, slot, topic=True, entry=True):
                e["seq"] = seq
                e["desc_off"] = desc_off
                e["desc_len"] = desc_len
                e["unreceived"] = np.uint64(sub_mask)
                e["held"] = 0
                e["origin"] = origin
                e["hops"] = hops
                e["src_tag"] = np.uint64(src_tag)
                e["route_seq"] = np.uint64(route_seq)
                e["pub_refs"] = 0  # move semantics: rvalue publish (§VII-A)
                e["released"][:] = 0  # fresh entry: no release intent yet
                e["pins"] = 0
                e["pin_deadline_ns"] = 0
                e["xarena"] = xarena.encode()
                e["trace_id"] = np.uint64(trace_id)
                e["state"] = ST_USED
                t["pub_next_seq"][pidx] = seq + 1
        return seq, freeable

    def take(self, tidx: int, sidx: int, limit: int | None = None,
             *, gen: int | None = None) -> list[Entry]:
        """Claim unreceived entries for subscriber ``sidx`` (clears the
        unreceived bit, sets the held bit — refcount acquisition).

        ``limit`` bounds the batch (executor ``take_all`` drains up to the
        queue depth per wakeup); entries beyond it stay unreceived and are
        claimed by a later call.  Lowest sequence numbers are claimed first.
        """
        got: list[Entry] = []
        bit = np.uint64(1 << sidx)
        with self._locked(tidx):
            if gen is not None and int(self.topics[tidx]["gen"]) != gen:
                return []  # topic destroyed/recycled under this handle
            # lease refresh on take: an actively-consuming subscriber never
            # needs a separate heartbeat (repro_torch.serving replica liveness)
            self.topics[tidx]["sub_lease_ns"][sidx] = time.monotonic_ns()
            blk = self.entries[tidx]
            mask = (blk["state"] == ST_USED) & ((blk["unreceived"] & bit) != 0)
            ps, ss = np.nonzero(mask)
            if ps.size == 0:
                return got
            order = np.argsort(blk["seq"][ps, ss], kind="stable")
            if limit is not None:
                order = order[:max(limit, 0)]
            ps, ss = ps[order], ss[order]
            if FORCE_LOCKED_HOTPATH:
                # v3 protocol: every claim individually journaled — the
                # before-image discipline the journal-free batch below
                # replaced.  Kept so the hotpath benchmark's baseline
                # measures layout-v3 *semantics*, not just v3 locking.
                for pidx, s in zip(ps.tolist(), ss.tolist()):
                    with self._Txn(self, tidx, int(pidx), int(s), entry=True):
                        e = self.entries[tidx, pidx, s]
                        e["unreceived"] = np.uint64(
                            int(e["unreceived"]) & ~int(bit))
                        e["held"] = np.uint64(int(e["held"]) | int(bit))
                        e["released"][sidx] = 0
            else:
                # The claim is journal-free (this was most of the hot
                # path's in-lock cost): each entry's transfer is two
                # monotonic bit stores ordered held-then-unreceived, so a
                # taker that dies between them leaves "held by AND
                # unreceived for a dead sub" — exactly the state sweep()
                # already converges (it clears both masks for dead
                # subscribers).  A live taker cannot fail between two numpy
                # field stores, so no before-image is ever needed.
                blk["released"][ps, ss, sidx] = 0  # re-take after fast rel.
                blk["held"][ps, ss] |= bit
                blk["unreceived"][ps, ss] &= ~bit
            claimed = blk[ps, ss].copy()  # snapshot, built into Entries below
        # Entry construction happens OUTSIDE the critical section: the held
        # bits above pin every claimed slot, so the copied rows are stable
        # and the per-entry Python work doesn't extend the lock hold.
        for pidx, row in zip(ps.tolist(), claimed):
            got.append(
                Entry(int(row["seq"]), int(row["desc_off"]),
                      int(row["desc_len"]), int(row["origin"]),
                      pidx, hops=int(row["hops"]),
                      src_tag=int(row["src_tag"]),
                      route_seq=int(row["route_seq"]),
                      xarena=bytes(row["xarena"]).rstrip(b"\0").decode(),
                      trace_id=int(row["trace_id"]))
            )
        return got

    def release(self, tidx: int, pidx: int, sidx: int, seq: int,
                *, gen: int | None = None) -> None:
        """Drop subscriber ``sidx``'s reference on entry ``seq``.

        **Fast path (the common case): one byte store, no lock.**  The
        subscriber owns ``released[sidx]`` exclusively, so setting it needs
        no read-modify-write on the shared ``held`` mask; a later lock
        holder folds it.  Taken only when no rollback is pending and the
        owner's waiter flag is clear — and the flag is re-checked *after*
        the store: if a waiter armed concurrently we fall through to the
        locked path so the held→0 transition still produces a FIFO wakeup.
        (A waiter that arms after even that re-check is safe too: its own
        ``can_publish`` re-check reads the released bytes.)

        **Locked path** (waiter armed, rollback pending, or
        ``FORCE_LOCKED_HOTPATH``): fold, journaled held-bit clear, and —
        when this drops the entry's last *held* reference — an owner wakeup
        through its slot-freed FIFO: publish only blocks on held occupants
        (an unreceived-only one is dropped by QoS keep-last), so the
        held→0 transition is exactly when a blocked publisher can make
        progress."""
        if not FORCE_LOCKED_HOTPATH:
            try:
                t = self.topics[tidx]
                if gen is not None and int(t["gen"]) != gen:
                    return  # stale handle: the slot belongs to someone else
                if (int(self._journal[tidx]["state"]) != _J_PENDING
                        and not t["pub_waiters"][pidx]):
                    depth = int(t["pub_depth"][pidx]) or 1
                    e = self.entries[tidx, pidx, seq % depth]
                    if (int(e["seq"]) == seq and int(e["state"]) == ST_USED
                            and (int(e["held"]) >> sidx) & 1):
                        # agnolint: allow[AGNO-LOCK-001] -- THE lock-free release: one byte, single-writer per sidx, folded under the next lock holder
                        e["released"][sidx] = 1
                        # Dekker re-check: a waiter arming between our flag
                        # load and the byte store must not lose its wakeup
                        if (not t["pub_waiters"][pidx]
                                and int(self._journal[tidx]["state"]) != _J_PENDING):
                            return
                    else:
                        return  # already released / entry recycled: no-op
            except TypeError:
                return  # registry torn down concurrently
        bit = np.uint64(1 << sidx)
        freed = False
        with self._locked(tidx):
            t = self.topics[tidx]
            if gen is not None and int(t["gen"]) != gen:
                return
            self._fold_releases(tidx, pidx)
            slot = seq % (int(t["pub_depth"][pidx]) or 1)
            e = self.entries[tidx, pidx, slot]
            if int(e["seq"]) == seq and int(e["state"]) == ST_USED:
                with self._Txn(self, tidx, pidx, slot, entry=True):
                    e["held"] = np.uint64(int(e["held"]) & ~int(bit))
                    e["released"][sidx] = 0
                # EFFECTIVE held, not raw: a sibling's lock-free release
                # byte landing after our fold above still counts toward
                # "this slot is now publishable" — deciding on the raw
                # mask here would skip the FIFO write and strand a parked
                # waiter (that sibling's fast path already returned, so
                # nobody else will wake it)
                freed = self._effective_held(e) == 0
        if freed:
            # outside the topic lock: the FIFO write is best-effort/non-
            # blocking and must not lengthen the critical section
            self._notify_owner(tidx, pidx)

    def reclaimable(self, tidx: int, pidx: int) -> list[int]:
        """Owner-side query: seqs whose payload may now be freed (both
        counters zero — the paper's deallocation condition, Fig. 7 —
        and no live cross-bridge pin; an expired pin lease reclaims
        here, which is what bounds a crashed pinner's damage)."""
        out: list[int] = []
        with self._locked(tidx):
            self._fold_releases(tidx, pidx)
            ring = self.entries[tidx, pidx]
            for s in np.nonzero(self._prune_mask(ring))[0]:
                out.append(int(ring[s]["seq"]))
                ring[s]["state"] = ST_FREE
        return out

    # -- cross-bridge pins (attach-by-name data plane) -------------------------

    def pin(self, tidx: int, pidx: int, seq: int, lease_s: float,
            *, gen: int | None = None) -> bool:
        """Pin entry ``seq`` against release/recycling for up to ``lease_s``
        seconds: the bridge-side half of advertising the entry's payload by
        reference.  Returns ``False`` when the entry is already gone (the
        caller must fall back to a by-value send).  Re-pinning extends the
        deadline monotonically."""
        deadline = time.monotonic_ns() + int(lease_s * 1e9)
        with self._locked(tidx):
            t = self.topics[tidx]
            if gen is not None and int(t["gen"]) != gen:
                return False
            slot = seq % (int(t["pub_depth"][pidx]) or 1)
            e = self.entries[tidx, pidx, slot]
            if int(e["seq"]) != seq or int(e["state"]) != ST_USED:
                return False
            with self._Txn(self, tidx, pidx, slot, entry=True):
                e["pins"] = int(e["pins"]) + 1
                e["pin_deadline_ns"] = max(int(e["pin_deadline_ns"]), deadline)
        return True

    def unpin(self, tidx: int, pidx: int, seq: int,
              *, gen: int | None = None) -> None:
        """Drop one pin on entry ``seq``.  When this (with held==0) makes
        the entry reclaimable, the owner gets a slot-freed wakeup — a
        publisher blocked on a pin-held ring can make progress."""
        freed = False
        with self._locked(tidx):
            t = self.topics[tidx]
            if gen is not None and int(t["gen"]) != gen:
                return
            self._fold_releases(tidx, pidx)
            slot = seq % (int(t["pub_depth"][pidx]) or 1)
            e = self.entries[tidx, pidx, slot]
            if int(e["seq"]) != seq or int(e["state"]) != ST_USED:
                return
            if int(e["pins"]) > 0:
                with self._Txn(self, tidx, pidx, slot, entry=True):
                    e["pins"] = int(e["pins"]) - 1
                    if int(e["pins"]) == 0:
                        e["pin_deadline_ns"] = 0
            # effective held for the same reason as release(): a byte
            # landing after our fold must not hide the freed transition
            freed = int(e["pins"]) == 0 and self._effective_held(e) == 0
        if freed:
            self._notify_owner(tidx, pidx)

    # -- process-exit hook analogue -------------------------------------------

    def sweep(self) -> dict:
        """Detect dead participants and release their references/slots.

        The paper's kernel module hooks process exit; our janitor detects
        death via PID liveness and is invoked by any participant. Idempotent
        (safe to crash mid-sweep and re-run).

        Lock scope: the domain lock is held across the pass (freezing topic
        create/destroy, so the ``in_use`` scan stays coherent) and each
        topic's own lock is taken while that topic is swept — the data
        plane of a healthy topic only ever contends with the sweep for the
        instant its own topic is under the broom.  The in-use scan is
        vectorized: at 1024 rows a Python loop over the whole table would
        dominate the sweep."""
        report = {"dead_subs": 0, "dead_pubs": 0, "orphan_arenas": []}
        owners: list[tuple[int, int]] = []
        with self._lock:
            self._recover_dead_topics()
            for tidx in np.nonzero(self.topics["in_use"])[0]:
                tidx = int(tidx)
                with self._locked(tidx):
                    t = self.topics[tidx]
                    if not t["in_use"]:
                        continue
                    self._fold_releases(tidx)
                    alive = int(t["sub_alive"])
                    for s in range(MAX_SUBS):
                        if (alive >> s) & 1 and not _alive(int(t["sub_pids"][s])):
                            owners.extend(self._drop_subscriber(tidx, s))
                            report["dead_subs"] += 1
                    for p in range(MAX_PUBS):
                        if t["pub_alive"][p] and not _alive(int(t["pub_pids"][p])):
                            arena = bytes(t["pub_arena"][p]).rstrip(b"\0").decode()
                            with self._Txn(self, tidx, topic=True):
                                t["pub_alive"][p] = 0
                                t["pub_pids"][p] = 0
                            self.entries[tidx, p]["state"] = ST_DEAD
                            report["dead_pubs"] += 1
                            report["orphan_arenas"].append(arena)
                            with self._pub_fds_mu:  # drop any cached write fd
                                fd = self._pub_fds.pop((tidx, p), None)
                            if fd is not None:
                                try:
                                    os.close(fd)
                                except OSError:
                                    pass
                            try:  # dead slot's reverse FIFO file (no leak)
                                os.unlink(pub_fifo_path(self.name, tidx, p))
                            except OSError:
                                pass
        self._notify_owners(owners)  # FIFO writes outside the locks
        return report

    # -- introspection ---------------------------------------------------------

    def stats(self, tidx: int) -> dict:
        """Topic occupancy snapshot — a seqlock read (collectors poll this;
        monitoring must not contend with the data plane).  Unfolded release
        bytes count as released, so the held count matches what a lock
        holder would see after folding."""
        def read():
            t = self.topics[tidx]
            ring = self.entries[tidx]
            used = ring["state"] == ST_USED
            held = (ring["held"] & ~_rel_masks(ring["released"])) != 0
            return {
                "subs_alive": bin(int(t["sub_alive"])).count("1"),
                "pubs_alive": int(np.sum(t["pub_alive"])),
                "drops": [int(d) for d in t["pub_drops"]],
                "used_entries": int(np.sum(used)),
                "held_entries": int(np.sum(used & held)),
            }
        if not FORCE_LOCKED_HOTPATH:
            ok, val = self._seqlock_read(tidx, read)
            if ok:
                return val
        with self._locked(tidx, write=False):
            return read()
