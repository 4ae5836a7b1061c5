"""Publisher / Subscription API — the paper's Fig. 2 surface.

Usage mirrors the paper::

    dom = Domain.create()
    pub = dom.create_publisher(POINT_CLOUD2, "mytopic", depth=10)
    msg = pub.borrow_loaded_message()
    msg.data.extend(points)             # unsized: push_back/extend freely
    pub.publish(msg)                    # move; constant-cost metadata op

    sub = dom.create_subscription(POINT_CLOUD2, "mytopic")
    for ptr in sub.take():              # zero-copy read-only views
        consume(ptr.data)
        ptr.release()

Publish passes only a constant-size descriptor through the metadata plane;
payload bytes are never copied (true zero-copy).  Wake-ups use a per-
subscriber FIFO write of one byte — O(1) in payload size, preserving the
paper's size-independent latency property.

Backpressure is symmetric and event-driven: each publisher owns a reverse
"slot freed" FIFO written by releasers (``Registry.release`` / the
janitor), so a publisher hitting ``AgnocastQueueFull`` blocks in
``wait_for_slot``/``publish_blocking`` (or multiplexes ``fileno()`` into an
``EventExecutor``) instead of sleep-polling the ring.

The port's copy of ``repro/core/topic.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import errno
import os
import pickle
import secrets
import select
import time

from .arena import Arena
from .messages import LoanedMessage, MessageType, ReceivedMessage
from .registry import (
    ORIGIN_AGNOCAST,
    AgnocastQueueFull,
    Registry,
    _open_and_wake,
    fifo_dir as _fifo_dir,
    pub_fifo_path as _pub_fifo_path,
    sub_fifo_path as _fifo_path,
)
from .smart_ptr import MessagePtr
from repro_torch.obs import trace as _trace

# stage ids preloaded as plain ints: the traced hot path pays one
# LOAD_GLOBAL per emit instead of a module+class attribute chain (which
# costs as much as the record write itself on the fig18 closed loop)
_ST_PUBLISH = _trace.Stage.PUBLISH
_ST_NOTIFY = _trace.Stage.NOTIFY
_ST_TAKE = _trace.Stage.TAKE

__all__ = ["Domain", "Publisher", "Subscription"]

_DEFAULT_ARENA = 64 << 20


class Domain:
    """A participant's handle on one agnocast metadata plane + its arena."""

    def __init__(self, registry: Registry, arena: Arena | None, *, owner: bool):
        self.registry = registry
        self.arena = arena  # this process's own heap (publishers only)
        self._owner = owner
        self._closed = False
        self._attached: dict[str, Arena] = {}
        self._pubs: list[Publisher] = []
        self._subs: list[Subscription] = []
        os.makedirs(_fifo_dir(registry.name), exist_ok=True)
        import atexit

        atexit.register(self.close)

    # -- lifecycle -------------------------------------------------------------

    @classmethod
    def create(cls, name: str | None = None, *, arena_capacity: int = _DEFAULT_ARENA) -> "Domain":
        reg = Registry.create(name)
        arena = Arena.create(arena_capacity)
        return cls(reg, arena, owner=True)

    @classmethod
    def join(cls, name: str, *, arena_capacity: int = _DEFAULT_ARENA,
             publisher: bool = True) -> "Domain":
        reg = Registry.attach(name)
        arena = Arena.create(arena_capacity) if publisher else None
        return cls(reg, arena, owner=False)

    @property
    def name(self) -> str:
        return self.registry.name

    def attach_arena(self, name: str) -> Arena:
        a = self._attached.get(name)
        if a is None:
            if self.arena is not None and name == self.arena.name:
                a = self.arena
            else:
                a = Arena.attach(name)
            self._attached[name] = a
        return a

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for s in self._subs:
            s.close()
        for p in self._pubs:
            p.close()
        for a in self._attached.values():
            if self.arena is None or a.name != self.arena.name:
                a.close()
        if self.arena is not None:
            self.arena.close()
            self.arena.unlink()
        self.registry.close()
        if self._owner:
            self.registry.unlink()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def sweep(self) -> dict:
        return self.registry.sweep()

    # -- factory (paper Fig. 2) --------------------------------------------------

    def create_publisher(self, mtype: MessageType, topic: str, *, depth: int = 10) -> "Publisher":
        if self.arena is None:
            raise RuntimeError("this domain handle was joined without a heap arena")
        p = Publisher(self, mtype, topic, depth)
        self._pubs.append(p)
        return p

    def create_subscription(self, mtype: MessageType, topic: str, callback=None) -> "Subscription":
        s = Subscription(self, mtype, topic, callback)
        self._subs.append(s)
        return s


class Publisher:
    def __init__(self, dom: Domain, mtype: MessageType, topic: str, depth: int):
        self.dom = dom
        self.mtype = mtype
        self.topic = topic
        self.tidx = dom.registry.topic_index(topic)
        self.tgen = dom.registry.topic_gen(self.tidx)  # name-ABA guard
        self.pidx = dom.registry.add_publisher(self.tidx, os.getpid(), dom.arena.name, depth)
        self._inflight: dict[int, tuple[int, int, list[int]]] = {}  # seq -> (desc_off, desc_len, payload offs)
        # optional hook(seqs) fired when published entries are reclaimed —
        # the attach-by-name bridge acks its upstream pin from here (ref
        # mode: the source entry must outlive our local republication)
        self.on_reclaimed = None
        self._fifo_fds: dict[int, int] = {}
        # owner-side "slot freed" reverse FIFO: releasers (Registry.release /
        # the janitor) write a byte when a ring slot becomes reusable.  The
        # read end is held open for the publisher's whole life so wakeups are
        # never lost while we are not waiting.  O_RDWR (not O_RDONLY): the
        # publisher itself anchors a write end, so the fd can never reach
        # EOF-permanently-readable when a releaser process closes its cached
        # write fd — the POLLHUP hazard Subscription handles with hung_up
        # parking cannot occur here by construction.
        path = _pub_fifo_path(dom.name, self.tidx, self.pidx)
        try:
            os.mkfifo(path)
        except FileExistsError:
            pass
        self._slot_fifo = os.open(path, os.O_RDWR | os.O_NONBLOCK)
        # flow tracing (repro_torch.obs): None when AGNOCAST_TRACE is off — the
        # publish hot path then pays a single ``is not None`` test
        self._tr = _trace.tracer_for(dom.name)

    # -- the Fig. 2 API ----------------------------------------------------------

    def borrow_loaded_message(self) -> LoanedMessage:
        return self.mtype.loan(self.dom.arena)

    def publish(self, loan: LoanedMessage, *, origin: int = ORIGIN_AGNOCAST,
                exclude_sub: int = -1, hops: int = 0, src_tag: int = 0,
                route_seq: int = 0, trace_id: int = 0) -> int:
        """Move-publish: the loan is consumed (rvalue semantics, §VII-A).

        ``hops``/``src_tag``/``route_seq`` are route metadata for messages
        relayed in from other agnocast domains (see :mod:`repro_torch.core.routing`);
        locally originated messages leave them zero.  ``trace_id`` nonzero
        preserves an in-flight flow id across a bridge hop; zero mints a
        fresh one (when tracing is on).  The PUBLISH event is stamped at
        entry — before the descriptor write — so a flow's stage deltas
        telescope to the same interval a caller's own t0/t1 would measure."""
        if loan.arena is not self.dom.arena:
            raise ValueError("loan does not belong to this publisher's arena")
        tr = self._tr
        if tr is not None:
            if not trace_id:
                trace_id = _trace.next_trace_id()
            t_pub = tr._mono()      # PUBLISH stamp; record written with NOTIFY
        desc = pickle.dumps(loan.descriptor(), protocol=5)  # constant-size metadata
        off = self.dom.arena.alloc(len(desc))
        self.dom.arena.write_bytes(off, desc)
        try:
            seq, freeable = self.dom.registry.publish(
                self.tidx, self.pidx, off, len(desc), origin=origin,
                exclude_sub=exclude_sub, hops=hops, src_tag=src_tag,
                route_seq=route_seq, gen=self.tgen, trace_id=trace_id
            )
        except Exception:
            self.dom.arena.free(off)  # queue full: loan stays valid for retry
            raise
        self._inflight[seq] = (off, len(desc), loan.alloc_offsets())
        loan._ragged, loan._fixed = {}, {}  # invalidate: ownership moved
        self._reclaim(freeable)
        woke = self._notify()
        if tr is not None:
            # one call writes the PUBLISH (back-stamped) + NOTIFY pair
            tr.emit2(trace_id, hops, _ST_PUBLISH, t_pub, _ST_NOTIFY, woke)
        return seq

    def publish_descriptor(self, desc, *, xarena: str,
                           origin: int = ORIGIN_AGNOCAST, exclude_sub: int = -1,
                           hops: int = 0, src_tag: int = 0,
                           route_seq: int = 0, trace_id: int = 0) -> int:
        """Publish a message whose payload bytes live in a *foreign* arena.

        Same-host zero-copy relay: the bridge republishes a received
        descriptor verbatim, tagging the entry with ``xarena`` (the source
        publisher's arena name) so subscribers resolve offsets against that
        segment instead of ours.  Only the pickled descriptor is written to
        our arena; no payload bytes move.  The caller is responsible for
        keeping the source entry pinned until this entry is reclaimed
        (see :attr:`on_reclaimed`)."""
        tr = self._tr
        if tr is not None:
            if not trace_id:
                trace_id = _trace.next_trace_id()
            t_pub = tr._mono()      # PUBLISH stamp; record written with NOTIFY
        raw = pickle.dumps(desc, protocol=5)
        off = self.dom.arena.alloc(len(raw))
        self.dom.arena.write_bytes(off, raw)
        try:
            seq, freeable = self.dom.registry.publish(
                self.tidx, self.pidx, off, len(raw), origin=origin,
                exclude_sub=exclude_sub, hops=hops, src_tag=src_tag,
                route_seq=route_seq, gen=self.tgen, xarena=xarena,
                trace_id=trace_id
            )
        except Exception:
            self.dom.arena.free(off)
            raise
        self._inflight[seq] = (off, len(raw), [])
        self._reclaim(freeable)
        woke = self._notify()
        if tr is not None:
            tr.emit2(trace_id, hops, _ST_PUBLISH, t_pub, _ST_NOTIFY, woke)
        return seq

    # -- owner-side deallocation (Fig. 7 timing) ----------------------------------

    def _reclaim(self, seqs) -> None:
        freed: list[int] = []
        for seq in seqs:
            rec = self._inflight.pop(seq, None)
            if rec is None:
                continue
            desc_off, _, offs = rec
            self.dom.arena.free(desc_off)
            for o in offs:
                self.dom.arena.free(o)
            freed.append(seq)
        if freed and self.on_reclaimed is not None:
            self.on_reclaimed(freed)

    def reclaim(self) -> int:
        seqs = self.dom.registry.reclaimable(self.tidx, self.pidx)
        self._reclaim(seqs)
        return len(seqs)

    # -- event-driven backpressure (slot-freed reverse FIFO) -----------------------

    def fileno(self) -> int:
        """The slot-freed FIFO's read end — selectable by an event loop.
        Readable exactly when a releaser freed a ring slot since the last
        :meth:`drain_slot_wakeups`."""
        return self._slot_fifo

    def set_waiting(self, waiting: bool) -> None:
        """Publish this publisher's "blocked" state to releasers.

        Releasers skip the slot-freed FIFO write when the flag is clear, so
        anything that waits on :meth:`fileno` outside :meth:`wait_for_slot`
        (executor ``add_publisher`` handles, a parked bridge copy-in) must
        raise the flag for the wait's duration.  Always set the flag
        *before* re-checking ``can_publish`` — the topic's lock orders the
        two sides, which makes the protocol lost-wakeup-free."""
        self.dom.registry.set_pub_waiter(self.tidx, self.pidx, waiting)

    def drain_slot_wakeups(self) -> int:
        """Consume pending slot-freed tokens without blocking."""
        n = 0
        try:
            while True:
                chunk = os.read(self._slot_fifo, 4096)
                if not chunk:
                    break  # no writer currently holds the other end
                n += len(chunk)
        except BlockingIOError:
            pass
        except OSError:
            pass
        return n

    def wait_for_slot(self, timeout: float | None = None) -> bool:
        """Block until :meth:`publish` can succeed (a ring slot is free or
        droppable), waking event-driven on the slot-freed FIFO.

        Returns ``True`` when a slot is available, ``False`` on timeout.
        Reclaims fully-released payloads as a side effect."""
        deadline = None if timeout is None else time.monotonic() + timeout
        # save/restore, not set/clear: an executor _PublisherHandle may have
        # armed the flag for its whole registration — a transient wait here
        # must not strip that handle of its wakeups
        prior = self.dom.registry.pub_waiter(self.tidx, self.pidx)
        self.set_waiting(True)  # before can_publish: releasers must see us
        try:
            while True:
                self.reclaim()
                if self.dom.registry.can_publish(self.tidx, self.pidx):
                    return True
                left = None
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                r, _, _ = select.select([self._slot_fifo], [], [], left)
                if r:
                    self.drain_slot_wakeups()
        finally:
            self.set_waiting(prior)

    def publish_blocking(self, loan: LoanedMessage, *,
                         timeout: float | None = None, should_stop=None,
                         origin: int = ORIGIN_AGNOCAST, exclude_sub: int = -1,
                         hops: int = 0, src_tag: int = 0,
                         route_seq: int = 0, trace_id: int = 0) -> int | None:
        """Publish with event-driven backpressure: on ``AgnocastQueueFull``
        wait on the slot-freed FIFO (never sleep-poll) and retry.

        ``should_stop()`` is consulted between waits (bounded at 50 ms) so
        long stalls stay cancellable; returns ``None`` if it fired, raises
        ``AgnocastQueueFull`` if ``timeout`` elapses first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self.publish(loan, origin=origin, exclude_sub=exclude_sub,
                                    hops=hops, src_tag=src_tag,
                                    route_seq=route_seq, trace_id=trace_id)
            except AgnocastQueueFull:
                if should_stop is not None and should_stop():
                    return None
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise
                step = left if should_stop is None else (
                    0.05 if left is None else min(0.05, left))
                self.wait_for_slot(step)

    # -- O(1) wake-ups -------------------------------------------------------------

    def _notify(self) -> int:
        """Wake every live subscriber; returns how many FIFO writes landed
        (the trace NOTIFY event's ``arg``)."""
        reg = self.dom.registry
        woke = 0
        # generation gate (name-ABA guard): if the topic row was destroyed
        # and recycled under our feet, its FIFO files belong to the new
        # tenant — a stale publisher must not wake somebody else's subs
        if reg.topic_gen(self.tidx) != self.tgen:
            return woke
        t = reg.topics[self.tidx]
        alive = int(t["sub_alive"])
        s = 0
        while alive >> s:
            if (alive >> s) & 1:
                # a live subscriber with no openable FIFO is usually one
                # mid-open of its read end (the slot claim mkfifos the file
                # under the topic lock, the open comes after): retry while
                # the slot stays claimed instead of silently dropping the
                # wakeup — the same lost-wakeup guard as the EPIPE path
                sub_live = (lambda s=s:
                            (int(t["sub_alive"]) >> s) & 1
                            and reg.topic_gen(self.tidx) == self.tgen)
                fd = self._fifo_fds.get(s)
                if fd is None:
                    fd = _open_and_wake(_fifo_path(self.dom.name, self.tidx, s),
                                        still_wanted=sub_live)
                    if fd is not None:
                        self._fifo_fds[s] = fd
                        woke += 1
                else:
                    try:
                        os.write(fd, b"\x01")
                        woke += 1
                    except OSError as e:
                        if e.errno == errno.EPIPE:
                            os.close(fd)
                            self._fifo_fds.pop(s, None)
                            # recycled slot (sweep unlinked the dead sub's
                            # FIFO, a successor mkfifo'd a fresh inode):
                            # retry against the fresh inode so the wakeup
                            # is not lost
                            fd = _open_and_wake(
                                _fifo_path(self.dom.name, self.tidx, s),
                                still_wanted=sub_live)
                            if fd is not None:
                                self._fifo_fds[s] = fd
                                woke += 1
            s += 1
        return woke

    def close(self) -> None:
        try:  # a handle may still have us armed as a waiter
            self.set_waiting(False)
        except Exception:
            pass  # registry already torn down
        for fd in self._fifo_fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self._fifo_fds = {}
        if self._slot_fifo is not None:
            try:
                os.close(self._slot_fifo)
            except OSError:
                pass
            self._slot_fifo = None


class Subscription:
    def __init__(self, dom: Domain, mtype: MessageType, topic: str, callback=None):
        self.dom = dom
        self.mtype = mtype
        self.topic = topic
        self.callback = callback
        self.tidx = dom.registry.topic_index(topic)
        self.tgen = dom.registry.topic_gen(self.tidx)  # name-ABA guard
        self.sidx = dom.registry.add_subscriber(self.tidx, os.getpid())
        path = _fifo_path(dom.name, self.tidx, self.sidx)
        try:
            os.mkfifo(path)
        except FileExistsError:
            pass
        self._fifo = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        self._arenas: dict[int, str] = {}
        self.hung_up = False  # EOF seen: no publisher holds the write end
        self._tr = _trace.tracer_for(dom.name)  # None = tracing off

    # -- zero-copy take -------------------------------------------------------------

    def take(self, limit: int | None = None) -> list[MessagePtr]:
        out: list[MessagePtr] = []
        entries = self.dom.registry.take(self.tidx, self.sidx, limit,
                                         gen=self.tgen)
        if not entries:
            return out
        pubs = dict(self.dom.registry.publishers(self.tidx))
        for e in entries:
            desc_arena = pubs.get(e.pub_idx)
            if desc_arena is None:
                continue  # publisher died; entry payload is gone
            # xarena: a bridge republished a foreign descriptor by reference
            # — payload offsets resolve in the *source* arena, while the
            # pickled descriptor itself lives in the republisher's arena
            arena_name = e.xarena or desc_arena
            try:
                arena = self.dom.attach_arena(arena_name)
                darena = (arena if arena_name == desc_arena
                          else self.dom.attach_arena(desc_arena))
            except (FileNotFoundError, OSError):
                continue  # source arena gone (lease expired upstream)
            raw = darena.read_bytes(e.desc_off, e.desc_len)
            desc = pickle.loads(raw)
            msg = ReceivedMessage(arena, desc)
            # TAKE is stamped here but *written* at release time, paired
            # with RELEASE in one emit2 call (readers order by t_ns, so
            # the wire view is identical; the hot path saves a call)
            take_t = (self._tr._mono()
                      if self._tr is not None and e.trace_id else 0)
            out.append(MessagePtr.first(msg, self.dom.registry, self.tidx,
                                        self.sidx, e, gen=self.tgen,
                                        tracer=self._tr, take_t=take_t))
        return out

    # -- event-loop surface (consumed by repro_torch.core.executor) -----------------------

    def fileno(self) -> int:
        """The wakeup FIFO's read end — selectable by an event loop."""
        return self._fifo

    def drain_wakeups(self) -> int:
        """Consume pending one-byte wake tokens without blocking.

        Sets :attr:`hung_up` when the pipe is at EOF — every publisher that
        ever opened the write end has closed it, which leaves the fd
        *permanently* select-readable (POLLHUP); event loops must stop
        level-polling it until a writer may have returned.
        """
        n = 0
        self.hung_up = False
        try:
            while True:
                chunk = os.read(self._fifo, 4096)
                if not chunk:
                    self.hung_up = True
                    break
                n += len(chunk)
        except BlockingIOError:
            pass
        except OSError:
            pass
        return n

    def take_all(self, limit: int | None = None) -> list[MessagePtr]:
        """Batched zero-copy take for one wakeup: drain the FIFO, then claim
        up to ``limit`` descriptors (``None`` = everything pending, which the
        keep-last QoS bounds at ``depth`` per publisher)."""
        self.drain_wakeups()
        return self.take(limit)

    def wait(self, timeout: float | None = None) -> bool:
        r, _, _ = select.select([self._fifo], [], [], timeout)
        if r:
            self.drain_wakeups()
            return True
        return False

    def spin_once(self, timeout: float | None = 1.0) -> int:
        """Wait for a wake-up, take, and run the callback on each message."""
        msgs = self.take()
        if not msgs and self.wait(timeout):
            msgs = self.take()
        for ptr in msgs:
            if self.callback is not None:
                self.callback(ptr)
            else:
                ptr.release()
        return len(msgs)

    def close(self) -> None:
        try:
            os.close(self._fifo)
        except OSError:
            pass
        try:
            self.dom.registry.remove_subscriber(self.tidx, self.sidx,
                                                gen=self.tgen)
        except Exception:
            pass
