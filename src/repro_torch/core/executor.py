"""Event-driven executor: the ROS 2 callback/executor layer analogue.

The paper's evaluation (§V, Fig. 12/13) runs nodes that react to *many*
topics through ROS 2 executors; per-subscription blocking ``take()`` forces
consumers to busy-poll serially, which throws away the one property the
per-subscriber one-byte FIFO wakeups were designed for: **O(1) wakeup cost
across fan-in, independent of payload size**.  :class:`EventExecutor`
restores that layer:

* one ``selectors``-based (epoll on Linux) event loop multiplexes any
  number of :class:`~repro_torch.core.topic.Subscription` wakeup FIFOs,
  :class:`~repro_torch.core.transport.BusClient` sockets, whole
  :class:`~repro_torch.core.routing.DomainBridge` instances (every endpoint FIFO
  + bus socket + any blocked publisher's slot-freed FIFO), blocked
  :class:`~repro_torch.core.topic.Publisher` wakeups (``add_publisher``), plus
  monotonic timers;
* each subscription wakeup triggers one **batched zero-copy take**
  (``take_all`` claims up to the queue depth of descriptors under a single
  registry lock) and dispatches the resulting ``MessagePtr``s to the
  registered callback;
* callbacks are organized into ROS 2-style **callback groups** —
  *mutually exclusive* (callbacks of the group never run concurrently, and
  run in enqueue order) or *reentrant* (free parallelism) — honoured by
  both the inline single-threaded dispatcher and the optional worker-thread
  pool (``threads=N``);
* ``unregister``/``shutdown`` are deterministic: pending-but-undispatched
  ``MessagePtr``s are released immediately (dropping the registry held
  bits), so a departing consumer never strands a publisher's ring slots.

Ownership rule: the executor releases each ``MessagePtr`` after its
callback returns; a callback that needs the message beyond its own scope
must ``ptr.clone()``.

The port's copy of ``repro/core/executor.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

import heapq
import itertools
import os
import selectors
import sys
import threading
import time
import traceback
from collections import deque

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import Stage as _Stage

__all__ = [
    "CallbackGroup",
    "MutuallyExclusiveCallbackGroup",
    "ReentrantCallbackGroup",
    "EventExecutor",
]

MUTUALLY_EXCLUSIVE = "mutually_exclusive"
REENTRANT = "reentrant"


class CallbackGroup:
    """A scheduling domain for callbacks (ROS 2 semantics).

    ``mutually_exclusive``: at most one callback of the group executes at a
    time, in enqueue order.  ``reentrant``: callbacks may run concurrently
    on a threaded executor.
    """

    def __init__(self, kind: str = MUTUALLY_EXCLUSIVE, *, name: str | None = None):
        if kind not in (MUTUALLY_EXCLUSIVE, REENTRANT):
            raise ValueError(f"unknown callback group kind {kind!r}")
        self.kind = kind
        self.name = name or f"{kind}-{id(self):x}"
        self._queue: deque[_Work] = deque()
        self._running = 0

    @property
    def reentrant(self) -> bool:
        return self.kind == REENTRANT

    def __repr__(self) -> str:
        return f"<CallbackGroup {self.name} kind={self.kind}>"


def MutuallyExclusiveCallbackGroup(name: str | None = None) -> CallbackGroup:
    return CallbackGroup(MUTUALLY_EXCLUSIVE, name=name)


def ReentrantCallbackGroup(name: str | None = None) -> CallbackGroup:
    return CallbackGroup(REENTRANT, name=name)


class _Work:
    """One dispatchable callback invocation."""

    __slots__ = ("handle", "fn", "cleanup")

    def __init__(self, handle: "_Handle", fn, cleanup=None):
        self.handle = handle
        self.fn = fn
        self.cleanup = cleanup

    def discard(self) -> None:
        if self.cleanup is not None:
            self.cleanup()


class _Handle:
    """Base registration record: fds to watch + how to turn readiness into
    work items.  Subclasses fill ``_on_ready``."""

    def __init__(self, executor: "EventExecutor", group: CallbackGroup, label: str):
        self.executor = executor
        self.group = group
        self.label = label
        self.cancelled = False
        self.fds: list[int] = []

    def _on_ready(self, fd: int) -> list["_Work"]:  # pragma: no cover
        raise NotImplementedError

    def _detach(self) -> None:
        """Handle-specific teardown, run on unregister/shutdown (e.g. clear
        a publisher's waiter flag so releasers stop paying FIFO writes)."""

    def cancel(self) -> None:
        self.executor.unregister(self)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.label}>"


class _SubscriptionHandle(_Handle):
    def __init__(self, executor, group, sub, callback, batch):
        super().__init__(executor, group, f"sub:{sub.topic}")
        self.sub = sub
        self.callback = callback
        self.batch = batch
        self.fds = [sub.fileno()]

    def _on_ready(self, fd: int) -> list[_Work]:
        ptrs = self.sub.take_all(self.batch)
        if self.batch is not None and len(ptrs) == self.batch:
            # a full batch may leave claimable messages behind, and their
            # wake tokens are already drained — ask the loop to re-poll us
            self.executor._request_repoll(self)
        if not ptrs and getattr(self.sub, "hung_up", False):
            # every publisher closed the FIFO write end: the fd is now
            # permanently readable (POLLHUP) and level-polling it would spin
            # a core. Park it and re-arm on a slow timer in case a new
            # publisher joins the topic later.
            self.executor._park_hangup(fd, self)
        out = []
        for ptr in ptrs:
            out.append(_Work(self, self._runner(ptr), ptr.release))
        return out

    def _runner(self, ptr):
        # trace hooks resolved per dispatch, not per event: the subscription
        # caches its ring, the ptr carries the flow id (zero when untraced)
        tr = getattr(self.sub, "_tr", None)
        tid = ptr.trace_id if tr is not None else 0

        def run():
            if tid:
                tr.emit(tid, ptr.hops, _Stage.CB_START)
            try:
                self.callback(ptr)
            finally:
                if tid:
                    # CB_END strictly before the release so the
                    # callback→release stage delta stays non-negative
                    tr.emit(tid, ptr.hops, _Stage.CB_END)
                ptr.release()  # idempotent; callbacks clone() to keep

        return run


class _BusHandle(_Handle):
    def __init__(self, executor, group, client, callback):
        super().__init__(executor, group, "bus-client")
        self.client = client
        self.callback = callback
        self.fds = [client.fileno()]

    def _on_ready(self, fd: int) -> list[_Work]:
        out = []
        while True:
            got = self.client.recv(timeout=0.0)
            if got is None:
                break
            topic, origin, payload = got
            out.append(_Work(
                self, lambda t=topic, o=origin, p=payload: self.callback(t, o, p)))
        return out


class _PublisherHandle(_Handle):
    """A Publisher's slot-freed FIFO: dispatch when backpressure lifts."""

    def __init__(self, executor, group, pub, callback):
        super().__init__(executor, group, f"pub:{pub.topic}")
        self.pub = pub
        self.callback = callback
        self.fds = [pub.fileno()]
        # the handle waits on the publisher's behalf for its whole life:
        # releasers only write the slot-freed FIFO while this flag is up.
        # (Registry v4 note: an armed flag also routes this topic's
        # releases onto the locked slow path — that is the protocol, not a
        # bug: the wakeup FIFO write must be ordered with the held→0
        # transition, which only the lock provides.)
        pub.set_waiting(True)

    def _detach(self) -> None:
        try:
            self.pub.set_waiting(False)
        except Exception:
            pass  # registry/publisher already closed

    def _on_ready(self, fd: int) -> list[_Work]:
        self.pub.drain_slot_wakeups()
        return [_Work(self, lambda: self.callback(self.pub))]


class _BridgeHandle(_Handle):
    """All planes of a :class:`repro_torch.core.routing.DomainBridge` in one loop:
    every endpoint's wakeup FIFO, the bus socket, and — per endpoint whose
    copy-in is parked on ``AgnocastQueueFull`` — that topic's blocked-
    publisher slot-freed FIFO.  Parking is per topic: intake keeps running
    (frames for a parked topic join its bounded backlog inside the bridge)
    while each armed publisher fd drives its own topic's retries."""

    def __init__(self, executor, group, bridge):
        super().__init__(executor, group, f"bridge:{bridge.name}")
        self.bridge = bridge
        self._sock = bridge.bus.fileno()
        self._sub_eps = {ep.sub.fileno(): ep for ep in bridge.endpoints.values()}
        self._pub_fds: dict[int, object] = {}  # fd -> blocked Publisher
        self.fds = list(self._sub_eps) + [self._sock]
        bridge._handle = self  # topics attached later are watched too

    def watch_endpoint(self, ep) -> None:
        """Multiplex an endpoint attached after registration."""
        fd = ep.sub.fileno()
        if fd in self._sub_eps:
            return
        self._sub_eps[fd] = ep
        self.fds.append(fd)
        self.executor._resume_fd(fd, self)

    def _on_ready(self, fd: int) -> list[_Work]:
        if fd in self._sub_eps:
            ep = self._sub_eps[fd]
            ep.sub.drain_wakeups()  # consume tokens in the loop thread
            if getattr(ep.sub, "hung_up", False):
                # every writer closed: the fd is POLLHUP-readable forever —
                # park it on the slow re-poll timer exactly like a plain
                # subscription, or this loop would spin a core
                self.executor._park_hangup(fd, self)
            return [_Work(self, lambda ep=ep: self.bridge.pump_agnocast(ep.topic))]
        pub = self._pub_fds.get(fd)
        if pub is not None:
            pub.drain_slot_wakeups()
            return [_Work(self, self._retry_blocked)]
        if fd != self._sock:
            return []  # stale pub fd: its parked publish already landed
        # bus socket: frames are only consumed when the pump runs, so suppress
        # the fd until then or a threaded loop would re-enqueue the same event
        self.executor._suspend_fd(fd)

        def run():
            try:
                self.bridge.pump_bus(0.0)
            finally:
                self._after_bus_pump()

        return [_Work(self, run, cleanup=self._after_bus_pump)]

    # -- blocked-publisher multiplexing (backpressure) -------------------------

    def _after_bus_pump(self) -> None:
        self._sync_pubs()
        self.executor._resume_fd(self._sock, self)

    def _sync_pubs(self) -> None:
        """Make the armed slot-freed fds mirror the bridge's parked set:
        newly parked topics get their publisher fd multiplexed in, lifted
        ones get theirs disarmed."""
        blocked = {pub.fileno(): pub
                   for pub in self.bridge.blocked_publishers}
        for fd in list(self._pub_fds):
            if fd not in blocked:
                self._disarm_pub(fd)
        for fd, pub in blocked.items():
            if fd not in self._pub_fds:
                self._arm_pub(fd, pub)

    def _arm_pub(self, fd: int, pub) -> None:
        pub.set_waiting(True)  # park already set it; re-arm is idempotent
        self._pub_fds[fd] = pub
        if fd not in self.fds:
            self.fds.append(fd)
        self.executor._resume_fd(fd, self)

    def _disarm_pub(self, fd: int) -> None:
        self._pub_fds.pop(fd, None)
        self.executor._suspend_fd(fd)
        if fd in self.fds:
            self.fds.remove(fd)

    def _retry_blocked(self) -> None:
        # a raising retry drops that topic's parked frame (loan freed by
        # the bridge): _sync_pubs disarms whatever is no longer parked, so
        # a poisoned frame can never wedge the remaining topics' wakeups
        try:
            self.bridge.retry_pending()
        finally:
            self._sync_pubs()


class _TimerHandle(_Handle):
    def __init__(self, executor, group, period, callback, oneshot):
        super().__init__(executor, group, f"timer:{period}s")
        self.period = period
        self.callback = callback
        self.oneshot = oneshot
        self.deadline = time.monotonic() + period

    def _work(self) -> _Work:
        return _Work(self, self.callback)


class EventExecutor:
    """Multiplex subscriptions, bus clients, bridges, and timers.

    Single-threaded by default: ``spin_once``/``spin`` run callbacks inline
    in enqueue order.  With ``threads=N`` a worker pool executes callbacks
    while the spin loop keeps polling, honouring callback-group kinds.
    """

    def __init__(self, *, threads: int = 0, name: str = "executor"):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._cond = threading.Condition()
        self._handles: list[_Handle] = []
        self._groups: dict[int, CallbackGroup] = {}
        self._runnable: deque[CallbackGroup] = deque()
        self._timers: list[tuple[float, int, _TimerHandle]] = []
        self._repoll: list[_Handle] = []
        self._tie = itertools.count()
        self._active = 0              # callbacks currently executing (workers)
        self._shutdown = False
        self._spin_thread: threading.Thread | None = None
        self.default_group = CallbackGroup(MUTUALLY_EXCLUSIVE, name="default")
        # unified metrics: workers and the inline dispatcher both increment
        # this — the old bare ``+= 1`` raced across the pool
        self._dispatched = _metrics.counter("executor.dispatched",
                                            executor=name)
        # self-pipe: interrupts a blocking select on shutdown / cross-thread edits
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._workers = [
            threading.Thread(target=self._worker, name=f"{name}-worker-{i}",
                             daemon=True)
            for i in range(threads)
        ]
        for w in self._workers:
            w.start()

    # -- registration ---------------------------------------------------------

    def _adopt(self, handle: _Handle) -> _Handle:
        with self._cond:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            self._handles.append(handle)
            self._groups[id(handle.group)] = handle.group
        for fd in handle.fds:
            self._sel.register(fd, selectors.EVENT_READ, handle)
        self._poke()
        return handle

    def add_subscription(self, sub, callback=None, *, group: CallbackGroup | None = None,
                         batch: int | None = None) -> _Handle:
        """Watch a Subscription's wakeup FIFO; dispatch ``callback(ptr)`` per
        message.  ``batch`` caps descriptors claimed per wakeup (default: all
        pending, bounded by queue depth)."""
        cb = callback if callback is not None else sub.callback
        if cb is None:
            raise ValueError("subscription has no callback")
        return self._adopt(_SubscriptionHandle(
            self, group or self.default_group, sub, cb, batch))

    def add_bus_client(self, client, callback, *,
                       group: CallbackGroup | None = None) -> _Handle:
        """Watch a BusClient socket; dispatch ``callback(topic, origin,
        payload)`` per frame."""
        return self._adopt(_BusHandle(self, group or self.default_group,
                                      client, callback))

    def add_publisher(self, pub, callback, *,
                      group: CallbackGroup | None = None) -> _Handle:
        """Watch a Publisher's slot-freed FIFO; dispatch ``callback(pub)``
        whenever backpressure lifts (a subscriber released the last ref on
        a ring slot) — the event-driven alternative to sleep-retrying
        ``AgnocastQueueFull``."""
        h = self._adopt(_PublisherHandle(self, group or self.default_group,
                                         pub, callback))
        # late-registration guard: a slot freed between the caller's failed
        # publish and the waiter flag going up produced no FIFO byte — under
        # registry v4 not even a locked release would have (an unarmed-flag
        # release is a lock-free byte store with no notify at all), so this
        # re-check is load-bearing: can_publish counts unfolded release
        # intent bytes, which is exactly what makes it see those silent
        # frees.  Synthesize the first wakeup if the ring is publishable
        try:
            free = pub.dom.registry.can_publish(pub.tidx, pub.pidx)
        except Exception:
            free = False
        if free:
            self._request_repoll(h)
        return h

    def add_bridge(self, bridge, *, group: CallbackGroup | None = None) -> _Handle:
        """Pump a DomainBridge/Bridge from this loop (its own exclusive
        group by default: the pumps share the bridge's publisher/bus
        state)."""
        label = getattr(bridge, "name", None) or getattr(bridge, "topic", "?")
        g = group or CallbackGroup(MUTUALLY_EXCLUSIVE, name=f"bridge:{label}")
        return self._adopt(_BridgeHandle(self, g, bridge))

    def add_timer(self, period_s: float, callback, *,
                  group: CallbackGroup | None = None,
                  oneshot: bool = False) -> _Handle:
        h = _TimerHandle(self, group or self.default_group, period_s, callback,
                         oneshot)
        with self._cond:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            self._handles.append(h)
            self._groups[id(h.group)] = h.group
            heapq.heappush(self._timers, (h.deadline, next(self._tie), h))
        self._poke()
        return h

    def unregister(self, handle: _Handle) -> int:
        """Remove a handle; pending undispatched work is discarded **now**
        (MessagePtrs released, registry held-bits dropped).  Returns the
        number of discarded work items."""
        dropped = 0
        bridge = getattr(handle, "bridge", None)
        if bridge is not None and getattr(bridge, "_handle", None) is handle:
            bridge._handle = None
        with self._cond:
            handle.cancelled = True
            if handle in self._handles:
                self._handles.remove(handle)
            if handle in self._repoll:
                self._repoll.remove(handle)
            keep = deque()
            for w in handle.group._queue:
                if w.handle is handle:
                    w.discard()
                    dropped += 1
                else:
                    keep.append(w)
            handle.group._queue = keep
        for fd in handle.fds:
            try:
                self._sel.unregister(fd)
            except (KeyError, ValueError, OSError):
                pass
        handle._detach()
        self._poke()
        return dropped

    # -- wakeup plumbing ------------------------------------------------------

    def _request_repoll(self, handle: _Handle) -> None:
        with self._cond:
            if handle not in self._repoll:
                self._repoll.append(handle)
        self._poke()

    HANGUP_REPOLL_S = 0.05  # slow-poll cadence for writer-less FIFOs

    def _park_hangup(self, fd: int, handle: _Handle) -> None:
        self._suspend_fd(fd)
        try:
            self.add_timer(self.HANGUP_REPOLL_S,
                           lambda: self._resume_fd(fd, handle),
                           group=handle.group, oneshot=True)
        except RuntimeError:
            pass  # shutting down: the fd stays parked

    def _suspend_fd(self, fd: int) -> None:
        try:
            self._sel.unregister(fd)
        except (KeyError, ValueError, OSError):
            pass

    def _resume_fd(self, fd: int, handle: _Handle) -> None:
        with self._cond:
            if self._shutdown or handle.cancelled:
                return
        try:
            self._sel.register(fd, selectors.EVENT_READ, handle)
        except (KeyError, ValueError, OSError):
            pass
        self._poke()

    def _poke(self) -> None:
        try:
            os.write(self._wake_w, b"\x01")
        except OSError:
            pass

    def _drain_wake_pipe(self) -> None:
        try:
            while os.read(self._wake_r, 4096):
                pass
        except (BlockingIOError, OSError):
            pass

    # -- work queue (shared by inline dispatch and workers) --------------------

    def _enqueue(self, works: list[_Work]) -> int:
        n = 0
        with self._cond:
            for w in works:
                if w.handle.cancelled or self._shutdown:
                    w.discard()
                    continue
                g = w.handle.group
                g._queue.append(w)
                self._runnable.append(g)
                n += 1
            if n:
                self._cond.notify(n)
        return n

    def _pop_work_locked(self):
        """Next runnable work item honouring group kinds; None if nothing is
        runnable right now.  Caller holds ``self._cond``."""
        rq = self._runnable
        for _ in range(len(rq)):
            g = rq.popleft()
            if not g._queue or (not g.reentrant and g._running):
                continue  # stale entry (drained, or ME group busy)
            w = g._queue.popleft()
            g._running += 1
            if g._queue and g.reentrant:
                rq.append(g)  # more parallelism available immediately
            return w, g
        return None

    def _finish(self, g: CallbackGroup) -> None:
        with self._cond:
            g._running -= 1
            self._active -= 1
            if g._queue:
                self._runnable.append(g)
                self._cond.notify()
            self._cond.notify_all()  # wait_idle watchers

    @property
    def dispatched(self) -> int:
        """Back-compat shim: callbacks completed without raising."""
        return self._dispatched.value

    def _run_work(self, w: _Work, g: CallbackGroup) -> None:
        try:
            w.fn()
            self._dispatched.inc()
        finally:
            self._finish(g)

    def _worker(self) -> None:
        while True:
            with self._cond:
                item = self._pop_work_locked()
                while item is None:
                    if self._shutdown:
                        return
                    self._cond.wait(0.2)
                    item = self._pop_work_locked()
                self._active += 1
            w, g = item
            try:
                self._run_work(w, g)
            except Exception:  # worker survives callback errors
                traceback.print_exc(file=sys.stderr)

    # -- the loop --------------------------------------------------------------

    def _next_timer_delay(self, timeout: float | None) -> float | None:
        with self._cond:
            if not self._timers:
                return timeout
            delay = max(self._timers[0][0] - time.monotonic(), 0.0)
        return delay if timeout is None else min(delay, timeout)

    def _collect_due_timers(self) -> list[_Work]:
        out: list[_Work] = []
        now = time.monotonic()
        with self._cond:
            while self._timers and self._timers[0][0] <= now:
                _, _, h = heapq.heappop(self._timers)
                if h.cancelled:
                    continue
                out.append(h._work())
                if not h.oneshot:
                    h.deadline = now + h.period
                    heapq.heappush(self._timers, (h.deadline, next(self._tie), h))
                else:
                    if h in self._handles:
                        self._handles.remove(h)
        return out

    def spin_once(self, timeout: float | None = None) -> int:
        """One poll-and-dispatch iteration.  Returns callbacks executed
        (inline mode) or enqueued (threaded mode)."""
        if self._shutdown:
            return 0
        works: list[_Work] = []
        with self._cond:
            repoll, self._repoll = self._repoll, []
        for h in repoll:
            if not h.cancelled:
                works.extend(h._on_ready(h.fds[0]))
        delay = self._next_timer_delay(timeout)
        if works:
            delay = 0.0  # don't sleep on freshly re-polled work
        for key, _ in self._sel.select(delay):
            if key.data is None:
                self._drain_wake_pipe()
                continue
            handle: _Handle = key.data
            if handle.cancelled:
                continue
            works.extend(handle._on_ready(key.fd))
        works.extend(self._collect_due_timers())
        n = self._enqueue(works)
        if self._workers:
            return n
        executed = 0
        while True:
            with self._cond:
                item = self._pop_work_locked()
                if item is None:
                    break
                self._active += 1
            self._run_work(*item)
            executed += 1
        return executed

    def spin(self, *, until=None, timeout: float | None = None,
             poll: float = 0.1) -> None:
        """Spin until ``until()`` is true, ``timeout`` elapses, or
        :meth:`shutdown` is called."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._shutdown:
            if until is not None and until():
                return
            step = poll
            if deadline is not None:
                step = min(step, deadline - time.monotonic())
                if step <= 0:
                    return
            self.spin_once(step)

    def start(self) -> "EventExecutor":
        """Run :meth:`spin` on a background thread (for threaded consumers)."""
        if self._spin_thread is None:
            self._spin_thread = threading.Thread(
                target=self.spin, name=f"{self.name}-spin", daemon=True)
            self._spin_thread.start()
        return self

    def drain(self, timeout: float = 5.0) -> bool:
        """Run every *already pending* piece of work to completion, then
        return: ready fds are polled with a zero wait, queued callbacks are
        dispatched (inline or by the worker pool), and anything they enqueue
        in turn is drained too.  Timers that are not yet due do NOT hold
        drain open — this is the clean-shutdown hook, not a spin loop: a
        serving replica calls ``drain()`` after its stop signal so in-flight
        ingests/rounds finish deterministically before ``shutdown()``.

        Returns ``True`` when the executor went quiescent, ``False`` on
        timeout."""
        deadline = time.monotonic() + timeout
        while not self._shutdown:
            n = self.spin_once(0.0)
            with self._cond:
                busy = bool(self._active or self._repoll
                            or any(g._queue for g in self._groups.values()))
            if n == 0 and not busy:
                return True
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            if self._workers:
                self.wait_idle(min(left, 0.1))
        return False

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until no callback is queued or executing (threaded mode)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                busy = self._active or any(
                    g._queue for g in self._groups.values())
                if not busy:
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.1))

    # -- teardown --------------------------------------------------------------

    def shutdown(self) -> int:
        """Stop the loop and workers; discard pending work deterministically
        (every undispatched MessagePtr is released).  Returns the number of
        discarded work items."""
        with self._cond:
            if self._shutdown:
                return 0
            self._shutdown = True
            self._cond.notify_all()
        self._poke()
        me = threading.current_thread()
        if self._spin_thread is not None and self._spin_thread is not me:
            self._spin_thread.join(timeout=5)
        for w in self._workers:
            if w is not me:  # a callback may itself call shutdown()
                w.join(timeout=5)
        dropped = 0
        with self._cond:
            for g in self._groups.values():
                while g._queue:
                    g._queue.popleft().discard()
                    dropped += 1
            self._runnable.clear()
            self._timers.clear()
            for h in self._handles:
                h.cancelled = True
            detached, self._handles = list(self._handles), []
        for h in detached:
            h._detach()  # outside the lock: may touch the shared registry
        try:
            self._sel.close()
        except OSError:
            pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        return dropped

    def __enter__(self) -> "EventExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
