"""Federated routing plane: multi-domain bridging over the conventional bus
(§IV-D generalized to N≥3 agnocast domains).

The paper's bridge federates exactly one topic between one agnocast domain
and one conventional bus.  This module grows that into a routing subsystem
(the HPRM / service-discovery-middleware shape — rule-based selection
between the local zero-copy plane and networked planes):

* :class:`RoutingTable` — longest-topic-prefix rules mapping a topic to
  the remote bus(es)/domain(s) that should see it.  Among the rules whose
  prefix matches a topic, only those at the *longest* matching prefix
  apply; a rule whose remote is ``None`` is a blackhole (keep the topic
  local), shadowing any shorter-prefix rule.
* :class:`DomainBridge` — one bridge per remote bus, federating any number
  of topics (today's single-topic ``Bridge`` is the one-rule special
  case).  Agnocast → bus relays serialize (the Fig. 11 cost); bus →
  agnocast relays deserialize into a loaned arena message and
  move-publish.
* :class:`Router` — owns the table and the bridges of one domain,
  registers them all on one :class:`~repro_torch.core.executor.EventExecutor`,
  and enforces loop prevention across the federation.

Loop-prevention invariants (each message is delivered at most once per
domain, and relay chains terminate, even under cyclic bus topologies):

1. **Origin tag**: every routed frame carries ``src_tag``, the tag of the
   agnocast domain it originated in (assigned at first relay).  A bridge
   drops any frame whose ``src_tag`` equals its own domain's tag — a
   message can never re-enter its origin domain (no ping-pong).  Frames
   from *conventional* bus publishers carry no origin; each domain that
   bridges that bus adopts them independently under its own tag (dedup and
   exactly-once guarantees apply to agnocast-origin routed messages).
2. **Route id dedup**: frames carry ``route_seq``, an origin-unique id
   (derived deterministically from the origin ring position, so sibling
   bridges of one router assign the *same* id to the same message).  A
   router admits each ``(src_tag, route_seq)`` once; copies arriving over
   other paths of a cyclic topology are dropped.
3. **Hop count**: frames carry ``hops``; entries copied into a domain keep
   it, and re-relays increment it.  Frames beyond ``max_hops`` are dropped
   — the backstop if 1–2 are ever misconfigured (e.g. colliding tags).
4. **Self-subscription exclusion**: a bridge's copy-in publish excludes the
   bridge's own subscription slot, so a bridge never re-relays a message it
   itself imported; sibling bridges of the same router *do* see it, which
   is exactly what lets a middle domain relay A → B → C.

Backpressure FIFO protocol (event-driven end to end, no sleep-polling):

* Every publisher owns a reverse "slot freed" FIFO
  (``registry.pub_fifo_path``); ``Registry.release`` — and the janitor
  releasing a dead subscriber's refs — writes one byte to it when an
  entry's last *held* reference drops (the only counter a publish can
  block on).
* Parking is **per endpoint**: a copy-in that hits ``AgnocastQueueFull``
  parks that *topic's* filled loan (one parked loan per topic) plus a
  bounded backlog of raw frames behind it (per-topic FIFO order
  preserved, overflow counted and dropped) — frames for every other topic
  of the bridge keep flowing, so one stalled consumer never head-of-line
  blocks the whole bridge.  Each parked endpoint exposes its blocked
  publisher's ``fileno()``; the executor multiplexes those fds and
  retries the parked publishes on wakeup.
* Standalone (executor-less) bridges select on the same fds in
  ``spin_once``; plain publishers use ``Publisher.wait_for_slot`` /
  ``publish_blocking``.

Copy-in is abort-safe: if deserialization or field copy-in raises
mid-fill, the borrowed loan's arena blocks are returned (``dealloc``) —
a malformed frame can never leak publisher arena memory.  Arena pressure
(``OutOfArenaMemory``) is not a silent drop: the bridge counts it, waits
once (bounded) on the endpoint publisher's slot-freed FIFO — a freed
reference is what lets ``reclaim()`` return bytes to the arena — and
retries before giving up; the frame's dedup key is released on the final
drop so another route can still deliver it.

Data planes (``data_plane=`` on :class:`DomainBridge` / :class:`Router`):

* ``"serialized"`` — the PR-5 baseline: ``serialize()`` assembles one
  payload buffer, ``deserialize()`` + per-field copy on the far side.
* ``"parts"`` (default) — scatter-gather: the same byte stream, but sent
  via ``BusClient.publish_parts`` (one ``sendmsg`` straight off the loaned
  numpy views, no assembly buffer) and copied in from zero-copy
  ``deserialize(..., copy=False)`` views.  Wire-identical to
  ``"serialized"``, so the two interoperate freely.
* ``"attach"`` — same-host TZC split: only a *control frame* (arena name +
  field layout, a few hundred bytes) transits the bus; the receiving
  bridge attaches the source arena read-only (cached, see
  :class:`~repro_torch.core.arena.ArenaAttachCache`) and either republishes the
  descriptor by reference (``attach_mode="ref"``, true zero-copy — the
  entry is tagged ``xarena`` so subscribers resolve offsets in the source
  arena) or copies fields directly into its own loan
  (``attach_mode="copy"``).

Pin/ack protocol (what makes the attach plane abort-safe): before sending
a control frame the bridge *pins* the source entry in its registry
(``Registry.pin`` — refcount + monotonic lease), then releases its own
message reference; the pin alone keeps the entry alive.  Each receiver
answers with an ACK (data consumed: after the copy in ``copy`` mode;
when the local republication is reclaimed in ``ref`` mode — which makes
chain relays transitively safe) or a NACK (attach/read failed: the
source arena is gone or the lease is nearly out).  The bus echoes a
FANOUT receipt telling the sender how many ACKs to await.  The sender
unpins when fully acked; on a NACK or an ack timeout it re-sends the
message *serialized* under the same ``(src_tag, route_seq)`` identity —
receivers that already delivered drop it as a duplicate, the one that
nacked has forgotten the key and admits it — so every failure mode
degrades to exactly-once by-value delivery, never a drop.  A crashed
pinner cannot wedge the source ring: the lease expiry lets the owner
reclaim (``Registry._prune_mask``).  ``ref`` mode assumes consumers
release within the lease; ``copy`` mode has no such constraint.

The port's copy of ``repro/core/routing.py``: the import paths differ,
and an attach-plane delivery in ``copy`` mode counts once in
``relayed_in`` (the reference's counts it twice).  Frames, route ids, dedup keys, control-frame pickles and ACKs are
the reference's, so a port router and a reference router federate over
one bus.
"""

from __future__ import annotations

import itertools
import pickle
import secrets
import select
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import NamedTuple

import numpy as np

from .arena import ArenaAttachCache, OutOfArenaMemory
from .messages import (MessageType, Ragged, ReceivedMessage, deserialize,
                       serialize, serialize_parts)
from .registry import ORIGIN_BRIDGE, AgnocastQueueFull
from .topic import Domain, Publisher, Subscription
from .transport import K_ACK, K_CTRL, K_FANOUT, BusClient, Frame, _FANOUT
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["RoutingRule", "RoutingTable", "DomainBridge", "Router",
           "Bridge", "domain_tag"]

DEFAULT_MAX_HOPS = 8
_SEEN_LIMIT = 8192
OOM_RETRY_WAIT_S = 0.05  # one bounded slot-freed wait before dropping on OOM


def domain_tag(name: str) -> int:
    """Stable nonzero tag for a domain name (every participant of the same
    domain derives the same tag without coordination)."""
    return zlib.crc32(name.encode()) | 0x1_0000_0000


# route_seq id spaces are disjoint: bit 63 marks ids minted for *adopted*
# conventional frames; origin ids stay below bit 63, so the two can never
# collide in a dedup window keyed on (src_tag, route_seq).  Both spaces are
# salted per *incarnation* — ring seqs restart at 1 when a publisher
# re-registers and counters restart with the process, and src_tag is a
# stable name hash, so unsalted ids would replay into remote dedup windows
# after a restart and silently drop fresh messages.
_ADOPTED_ID = 1 << 63


def _origin_salt(arena: str, tidx: int, pidx: int) -> int:
    """Publisher-incarnation salt: the arena name is random per process, so
    a re-registered publisher can never reproduce its predecessor's ids —
    while every sibling bridge reading the same registry derives the same
    salt for the same message."""
    return zlib.crc32(f"{arena}:{tidx}:{pidx}".encode())


def _origin_route_seq(salt: int, seq: int) -> int:
    """Deterministic origin-unique id from (incarnation salt, ring seq)."""
    return ((salt & 0x7FFF_FFFF) << 32) | (seq & 0xFFFF_FFFF)


class _AdoptedIdMint:
    """Mints adopted-frame ids: _ADOPTED_ID | random incarnation salt |
    counter — shared by Router and standalone DomainBridge so the id-space
    layout lives in exactly one place."""

    def __init__(self):
        self._salt = secrets.randbits(31) << 32
        self._counter = itertools.count(1)

    def next(self) -> int:
        return _ADOPTED_ID | self._salt | (next(self._counter) & 0xFFFF_FFFF)


class _DedupWindow:
    """Bounded record-and-test window over ``(src_tag, route_seq)`` — the
    one dedup implementation shared by :class:`Router` (across its bridges)
    and standalone :class:`DomainBridge` instances."""

    def __init__(self, limit: int = _SEEN_LIMIT):
        self._seen: OrderedDict[tuple[int, int], bool] = OrderedDict()
        self._limit = limit
        self._lock = threading.Lock()

    def admit(self, src_tag: int, route_seq: int) -> bool:
        """True exactly once per key; later calls with the same key are
        duplicates."""
        key = (src_tag, route_seq)
        with self._lock:
            if key in self._seen:
                return False
            self._seen[key] = True
            while len(self._seen) > self._limit:
                self._seen.popitem(last=False)
            return True

    def forget(self, src_tag: int, route_seq: int) -> None:
        """Un-admit a key whose message was NOT delivered (failed copy-in):
        a copy arriving over another path must not be treated as a dup."""
        with self._lock:
            self._seen.pop((src_tag, route_seq), None)


class RoutingRule(NamedTuple):
    prefix: str
    remote: str | None  # DomainBridge name; None = keep local (blackhole)


class RoutingTable:
    """Longest-topic-prefix rules → remote bus/domain selection."""

    def __init__(self):
        self.rules: list[RoutingRule] = []

    def add(self, prefix: str, remote: str | None) -> RoutingRule:
        rule = RoutingRule(prefix, remote)
        self.rules.append(rule)
        return rule

    def match(self, topic: str) -> RoutingRule | None:
        """The single best rule (longest prefix; insertion order breaks
        ties).  ``None`` if no rule matches."""
        best: RoutingRule | None = None
        for r in self.rules:
            if topic.startswith(r.prefix):
                if best is None or len(r.prefix) > len(best.prefix):
                    best = r
        return best

    def lookup(self, topic: str) -> list[str]:
        """Remotes that should federate ``topic``: every distinct remote at
        the longest matching prefix length.  A blackhole rule at that
        length keeps the topic local ([])."""
        best = -1
        chosen: list[RoutingRule] = []
        for r in self.rules:
            if topic.startswith(r.prefix):
                if len(r.prefix) > best:
                    best, chosen = len(r.prefix), [r]
                elif len(r.prefix) == best:
                    chosen.append(r)
        if best < 0 or any(r.remote is None for r in chosen):
            return []
        out: list[str] = []
        for r in chosen:
            if r.remote not in out:
                out.append(r.remote)
        return out


class _Endpoint:
    """One federated topic on one bridge: the bridge's pub/sub pair."""

    __slots__ = ("mtype", "topic", "pub", "sub", "depth")

    def __init__(self, mtype: MessageType, topic: str, pub: Publisher,
                 sub: Subscription, depth: int):
        self.mtype = mtype
        self.topic = topic
        self.pub = pub
        self.sub = sub
        self.depth = depth  # ring depth; also bounds the parked backlog


class _Pending(NamedTuple):
    """A filled loan parked on AgnocastQueueFull, awaiting a freed slot."""

    ep: _Endpoint
    loan: object
    hops: int
    src_tag: int
    route_seq: int
    trace_id: int = 0  # flow id preserved across the park (repro_torch.obs)


class _Await:
    """Sender-side state for one in-flight attach control frame: the pin we
    hold on the source entry, the message (for the serialized fallback),
    and the ack bookkeeping (``need`` arrives via the FANOUT receipt)."""

    __slots__ = ("ep", "msg", "pin", "hops", "need", "acks",
                 "fallback_at", "fell_back", "tid")

    def __init__(self, ep: _Endpoint, msg, pin: tuple, hops: int,
                 fallback_at: float, tid: int = 0):
        self.ep = ep
        self.msg = msg
        self.pin = pin  # (tidx, pidx, seq, gen) in OUR registry
        self.hops = hops
        self.need: int | None = None  # acks expected; None until the receipt
        self.acks = 0
        self.fallback_at = fallback_at
        self.fell_back = False
        self.tid = tid  # flow id: the fallback re-send keeps the flow


class DomainBridge:
    """Bridge between one agnocast domain and one remote bus, federating a
    set of topics.  Usually owned by a :class:`Router`; standalone use (one
    bus, no routing table) is the legacy single-topic :class:`Bridge`."""

    def __init__(self, dom: Domain, bus_path: str, *, name: str = "remote",
                 router: "Router | None" = None, depth: int = 10,
                 max_hops: int = DEFAULT_MAX_HOPS,
                 data_plane: str = "parts", attach_mode: str = "ref",
                 pin_lease_s: float = 5.0):
        if data_plane not in ("serialized", "parts", "attach"):
            raise ValueError(f"unknown data_plane {data_plane!r}")
        if attach_mode not in ("ref", "copy"):
            raise ValueError(f"unknown attach_mode {attach_mode!r}")
        self.dom = dom
        self.name = name
        self.router = router
        self.tag = router.tag if router is not None else domain_tag(dom.name)
        self.depth = depth
        self.max_hops = router.max_hops if router is not None else max_hops
        self.data_plane = data_plane
        self.attach_mode = attach_mode
        self.pin_lease_s = pin_lease_s
        self.bus = BusClient(bus_path)
        self.endpoints: dict[str, _Endpoint] = {}
        # attach plane state: cached foreign-arena mappings, the in-flight
        # control frames we hold pins for, and the ref-mode republications
        # whose acks are deferred to local reclaim
        self._attach_cache = ArenaAttachCache()
        self._awaiting: dict[tuple[str, int, int], _Await] = {}
        self._ref_pending: dict[tuple[str, int], tuple[int, int]] = {}
        # per-endpoint parking: topic -> the one parked loan, plus a bounded
        # FIFO backlog of raw frames that arrived behind it (bounded by the
        # endpoint's own ring depth)
        self._pending: dict[str, _Pending] = {}
        self._backlog: dict[str, deque] = {}
        # standalone bridges own their dedup window + id mint; router-owned
        # ones share the router's
        self._seen = _DedupWindow() if router is None else None
        self._mint = _AdoptedIdMint() if router is None else None
        self._handle = None  # set by the executor's bridge handle
        self._tr = _trace.tracer_for(dom.name)  # repro_torch.obs (None = off)
        # counters (observability + tests): all on the unified metrics
        # registry — they are incremented on whichever thread pumps the
        # bridge while tests/monitors read them from another, so a bare
        # `+= 1` is a racy lost update (agnolint AGNO-CNT-001).  Read-only
        # property shims below keep the old attribute names working.
        self._relayed_out = _metrics.counter(
            "bridge.relayed_out", bridge=name)     # agnocast -> bus
        self._relayed_in = _metrics.counter(
            "bridge.relayed_in", bridge=name)      # bus -> agnocast
        self._dropped_loops = _metrics.counter(
            "bridge.dropped_loops", bridge=name)   # src_tag == own tag, or hop cap
        self._dropped_dups = _metrics.counter(
            "bridge.dropped_dups", bridge=name)    # (src_tag, route_seq) already admitted
        self._copy_errors = _metrics.counter(
            "bridge.copy_errors", bridge=name)     # aborted copy-ins (loan returned)
        self._oom_retries = _metrics.counter(
            "bridge.oom_retries", bridge=name)     # arena pressure, retried
        self._dropped_oom = _metrics.counter(
            "bridge.dropped_oom", bridge=name)     # dropped after the retry
        self._dropped_backlog = _metrics.counter(
            "bridge.dropped_backlog", bridge=name)  # parked-backlog overflow
        self._n_attach_out = _metrics.counter(
            "bridge.attach_out", bridge=name)      # control frames sent (pin held)
        self._n_attach_in = _metrics.counter(
            "bridge.attach_in", bridge=name)       # control frames delivered locally
        self._attach_nacks = _metrics.counter(
            "bridge.attach_nacks", bridge=name)    # attach/read failures we NACKed
        self._ack_timeouts = _metrics.counter(
            "bridge.ack_timeouts", bridge=name)    # awaited acks that never came
        self._attach_fallbacks = _metrics.counter(
            "bridge.attach_fallbacks", bridge=name)  # serialized re-sends (nack or timeout)

    # -- back-compat counter shims (values live on repro_torch.obs.metrics) ----------

    @property
    def oom_retries(self) -> int:
        return self._oom_retries.value

    @property
    def dropped_oom(self) -> int:
        return self._dropped_oom.value

    @property
    def dropped_backlog(self) -> int:
        return self._dropped_backlog.value

    @property
    def relayed_out(self) -> int:
        return self._relayed_out.value

    @property
    def relayed_in(self) -> int:
        return self._relayed_in.value

    @property
    def dropped_loops(self) -> int:
        return self._dropped_loops.value

    @property
    def dropped_dups(self) -> int:
        return self._dropped_dups.value

    @property
    def copy_errors(self) -> int:
        return self._copy_errors.value

    @property
    def attach_out(self) -> int:
        return self._n_attach_out.value

    @property
    def attach_in(self) -> int:
        return self._n_attach_in.value

    @property
    def attach_nacks(self) -> int:
        return self._attach_nacks.value

    @property
    def ack_timeouts(self) -> int:
        return self._ack_timeouts.value

    @property
    def attach_fallbacks(self) -> int:
        return self._attach_fallbacks.value

    # -- federation surface ---------------------------------------------------

    def attach(self, mtype: MessageType, topic: str, *,
               depth: int | None = None) -> _Endpoint:
        """Federate ``topic`` over this bridge (idempotent per topic).
        Safe after :meth:`register`: a live executor handle is told to
        start watching the new endpoint's wakeup FIFO."""
        ep = self.endpoints.get(topic)
        if ep is None:
            d = depth or self.depth
            pub = self.dom.create_publisher(mtype, topic, depth=d)
            sub = self.dom.create_subscription(mtype, topic)
            # ref-mode attach acks ride the reclaim of our republication:
            # the source entry must stay pinned until our readers are done
            pub.on_reclaimed = lambda seqs, t=topic: self._ref_reclaimed(t, seqs)
            ep = _Endpoint(mtype, topic, pub, sub, d)
            self.endpoints[topic] = ep
            self.bus.subscribe(topic)
            if self._handle is not None:
                self._handle.watch_endpoint(ep)
        return ep

    # -- loop prevention ------------------------------------------------------

    def _admit(self, src_tag: int, route_seq: int) -> bool:
        if self.router is not None:
            return self.router.admit(src_tag, route_seq)
        return self._seen.admit(src_tag, route_seq)

    def _forget(self, src_tag: int, route_seq: int) -> None:
        if self.router is not None:
            self.router.forget(src_tag, route_seq)
        else:
            self._seen.forget(src_tag, route_seq)

    def _next_rseq(self) -> int:
        if self.router is not None:
            return self.router.next_route_seq()
        return self._mint.next()

    # -- agnocast -> conventional ----------------------------------------------

    def pump_agnocast(self, topic: str | None = None) -> int:
        """Relay pending agnocast messages onto the bus.

        ``data_plane`` picks the cost: ``serialized`` assembles one buffer
        (the Fig. 11 cost), ``parts`` scatter-gathers the loaned views in
        one ``sendmsg``, ``attach`` sends only a control frame and pins the
        entry (see module docstring).  Locally originated messages get
        fresh route metadata; messages a sibling bridge copied in keep
        theirs (hop count incremented)."""
        n = 0
        self._tick_awaiting()
        eps = ([self.endpoints[topic]] if topic is not None
               else list(self.endpoints.values()))
        for ep in eps:
            for ptr in ep.sub.take():
                try:
                    hops = ptr.hops
                    if ptr.origin == ORIGIN_BRIDGE:
                        # keep the identity it arrived with (src == self.tag
                        # means this domain *adopted* a conventional frame —
                        # still relayed; true ping-pong is dropped at frame
                        # admission, where src names the frame's origin)
                        src, rseq = ptr.src_tag, ptr.route_seq
                        if hops >= self.max_hops:
                            self._dropped_loops.inc()
                            continue
                    else:  # local origin: first relay assigns identity.
                        # The salt comes from the message's own arena name
                        # (pinned at take()): no registry lookup, and every
                        # sibling bridge derives the same id even if the
                        # origin publisher dies / its slot is swept between
                        # their pumps.
                        src = self.tag
                        rseq = _origin_route_seq(
                            _origin_salt(ptr.msg.arena_name, ep.sub.tidx,
                                         ptr.pub_idx),
                            ptr.seq)
                    tid = ptr.trace_id
                    if (self.data_plane == "attach"
                            and self._attach_out(ep, ptr, hops, src, rseq)):
                        if self._tr is not None and tid:
                            self._tr.emit(tid, hops + 1,
                                          _trace.Stage.BRIDGE_OUT)
                        n += 1
                        continue  # pin (not the ptr) keeps the entry alive
                    header, views = serialize_parts(ptr.msg)
                    if self.data_plane == "serialized":
                        self.bus.publish(ep.topic, header + b"".join(views),
                                         origin=1, hops=hops + 1, src_tag=src,
                                         route_seq=rseq, trace_id=tid)
                    else:  # "parts": zero-assembly scatter-gather
                        self.bus.publish_parts(ep.topic, header, views,
                                               origin=1, hops=hops + 1,
                                               src_tag=src, route_seq=rseq,
                                               trace_id=tid)
                    if self._tr is not None and tid:
                        self._tr.emit(tid, hops + 1, _trace.Stage.BRIDGE_OUT)
                    n += 1
                finally:
                    ptr.release()
        self._relayed_out.inc(n)
        return n

    # -- attach plane: sender side ---------------------------------------------

    def _attach_out(self, ep: _Endpoint, ptr, hops: int, src: int,
                    rseq: int) -> bool:
        """Send one attach control frame: pin the source entry in our
        registry, ship (arena name, descriptor) instead of payload bytes,
        and hold the pin until acked.  False = caller should fall back to
        a by-value send (entry already gone, or no descriptor)."""
        desc = getattr(ptr.msg, "descriptor", None)
        if desc is None:
            return False
        if not self.dom.registry.pin(ep.sub.tidx, ptr.pub_idx, ptr.seq,
                                     self.pin_lease_s, gen=ep.sub.tgen):
            return False
        # receivers must stop starting reads before our lease runs out —
        # CLOCK_MONOTONIC is system-wide, so the deadline travels verbatim
        stale_ns = time.monotonic_ns() + int(self.pin_lease_s * 0.90e9)
        ctrl = pickle.dumps({"arena": ptr.msg.arena_name, "desc": desc,
                             "stale_ns": stale_ns}, protocol=5)
        key = (ep.topic, src, rseq)
        self._awaiting[key] = _Await(
            ep, ptr.msg, (ep.sub.tidx, ptr.pub_idx, ptr.seq, ep.sub.tgen),
            hops, time.monotonic() + self.pin_lease_s * 0.95,
            tid=ptr.trace_id)
        try:
            self.bus.publish_ctrl(ep.topic, ctrl, origin=1, hops=hops + 1,
                                  src_tag=src, route_seq=rseq,
                                  trace_id=ptr.trace_id)
        except OSError:
            self._settle(key)  # bus gone: unpin, let the caller's path fail
            raise
        self._n_attach_out.inc()
        return True

    def _tick_awaiting(self) -> None:
        """Expire overdue in-flight control frames: re-send serialized (the
        message still pinned in our arena — exactly why the fallback is
        taken strictly *before* the pin lease runs out) and unpin."""
        if not self._awaiting:
            return
        now = time.monotonic()
        for key, aw in list(self._awaiting.items()):
            if aw.need is not None and aw.acks >= aw.need:
                self._settle(key)
            elif now >= aw.fallback_at:
                self._ack_timeouts.inc()
                self._send_fallback(key, aw)
                self._settle(key)

    def _send_fallback(self, key: tuple, aw: _Await) -> None:
        """Degrade one attach send to by-value, same route identity:
        receivers that delivered dedup it, the one that nacked admits it."""
        if aw.fell_back:
            return
        aw.fell_back = True
        self._attach_fallbacks.inc()
        topic, src, rseq = key
        try:
            self.bus.publish(topic, serialize(aw.msg), origin=1,
                             hops=aw.hops + 1, src_tag=src, route_seq=rseq,
                             trace_id=aw.tid)
        except OSError:
            pass  # bus gone; the pin release below still must happen

    def _settle(self, key: tuple) -> None:
        aw = self._awaiting.pop(key, None)
        if aw is None:
            return
        tidx, pidx, seq, gen = aw.pin
        try:
            self.dom.registry.unpin(tidx, pidx, seq, gen=gen)
        except Exception:
            pass  # registry torn down mid-close

    # -- conventional -> agnocast ------------------------------------------------

    def pump_bus(self, timeout: float = 0.0) -> int:
        """Copy admitted bus frames into the agnocast plane.

        Parked topics are retried first; a frame for a still-parked topic
        joins that topic's bounded backlog (per-topic FIFO order preserved,
        overflow dropped and counted) while every other topic's frames are
        copied in immediately — intake never stops for the whole bridge."""
        n = 0
        seen = 0
        self._tick_awaiting()
        if self._ref_pending:
            # deferred ref-mode acks ride reclaim: sweep the endpoints that
            # still owe one so a quiet topic's ack isn't deferred forever
            for t in {t for (t, _) in self._ref_pending}:
                ep = self.endpoints.get(t)
                if ep is not None:
                    ep.pub.reclaim()
        self.retry_pending()
        while True:
            fr = self.bus.recv_frame(timeout if seen == 0 else 0.0)
            if fr is None:
                return n
            seen += 1
            n += self._intake_frame(fr)

    def _intake_frame(self, fr: Frame) -> int:
        """Route one received frame: deliver now, or queue it behind its
        topic's parked copy-in.  ACK/FANOUT frames are control-plane
        answers to *our* sends — handled immediately, never backlogged."""
        if fr.kind == K_ACK:
            self._ack_in(fr)
            return 0
        if fr.kind == K_FANOUT:
            self._fanout_in(fr)
            return 0
        ep = self.endpoints.get(fr.topic)
        if ep is None:
            return 0
        if fr.topic in self._pending:
            q = self._backlog.setdefault(fr.topic, deque())
            if len(q) >= max(ep.depth, 4):
                self._dropped_backlog.inc()  # bounded memory: shed, counted
                return 0
            q.append(fr)
            return 0
        return self._handle_frame(fr)

    def _handle_frame(self, fr: Frame) -> int:
        ep = self.endpoints.get(fr.topic)
        if ep is None:
            return 0
        if fr.src_tag == self.tag or fr.hops > self.max_hops:
            self._dropped_loops.inc()  # returned to origin, or runaway chain
            return 0
        if fr.origin == 1:  # routed frame: identity travels with it
            src, rseq = fr.src_tag, fr.route_seq
            if not self._admit(src, rseq):
                self._dropped_dups.inc()
                return 0
            if self._tr is not None and fr.trace_id:
                self._tr.emit(fr.trace_id, fr.hops, _trace.Stage.ROUTE)
        else:  # conventional publisher: this domain adopts the message
            src, rseq = self.tag, self._next_rseq()
        if fr.kind == K_CTRL:
            return self._attach_in(ep, fr, src, rseq)
        try:
            self._copy_in_bounded(ep, fr, src, rseq)
        except Exception as e:
            if getattr(e, "_bridge_accounted", False):
                return 0  # the inline parked-retry already counted + forgot
            if not isinstance(e, OutOfArenaMemory):
                self._copy_errors.inc()  # malformed frame: dropped, no leak
            if fr.origin == 1:
                # the message was NOT delivered: release its dedup key so a
                # copy arriving over another path still can be (transient
                # failures like arena pressure must not burn exactly-once)
                self._forget(src, rseq)
            return 0
        return 1

    def _copy_in_bounded(self, ep: _Endpoint, fr: Frame, src: int,
                         rseq: int) -> None:
        """Copy-in with one bounded arena-pressure retry.

        Cross-topic arena exhaustion has no dedicated wakeup path, but a
        freed *reference* is exactly what lets ``reclaim()`` return payload
        bytes to this endpoint's arena — so on ``OutOfArenaMemory`` wait
        once on the endpoint publisher's slot-freed FIFO (waiter flag up so
        releasers actually write it), reclaim, and retry before giving up.
        A second failure counts in ``dropped_oom`` and propagates; the
        caller releases the frame's dedup key on the final drop."""
        try:
            self._copy_in(ep, fr, src, rseq)
            return
        except OutOfArenaMemory:
            self._oom_retries.inc()
        ep.pub.set_waiting(True)
        try:
            r, _, _ = select.select([ep.pub], [], [], OOM_RETRY_WAIT_S)
            if r:
                ep.pub.drain_slot_wakeups()
        finally:
            ep.pub.set_waiting(False)
        ep.pub.reclaim()
        try:
            self._copy_in(ep, fr, src, rseq)
        except OutOfArenaMemory:
            self._dropped_oom.inc()
            raise

    def _copy_in(self, ep: _Endpoint, fr: Frame, src: int, rseq: int) -> None:
        # copy=False: frombuffer views over the received frame — the one
        # copy left on this path is the field write into the loan
        fields = deserialize(fr.payload, copy=False)
        loan = self._fill_loan(ep, fields)
        self._publish_or_park(ep, loan, fr.hops, src, rseq, fr.trace_id)

    def _fill_loan(self, ep: _Endpoint, fields: dict):
        """Borrow a loan and copy ``fields`` into it; abort-safe (the arena
        blocks are returned if any field write raises)."""
        loan = ep.pub.borrow_loaded_message()
        try:
            for name, spec in ep.mtype.fields.items():
                arr = fields[name]
                if isinstance(spec, Ragged):
                    getattr(loan, name).extend(arr)  # the Fig. 11 copy-in
                else:
                    loan.set(name, arr if spec.shape
                             else np.asarray(arr).reshape(-1)[0])
        except Exception:
            loan.dealloc()  # abort path: return the arena blocks
            raise
        return loan

    # -- attach plane: receiver side ---------------------------------------------

    def _attach_in(self, ep: _Endpoint, fr: Frame, src: int, rseq: int) -> int:
        """Deliver one attach control frame: attach the source arena by
        name and read the fields in place.  Any failure — segment gone,
        stale lease, full ring — un-admits the dedup key and NACKs, so the
        sender's serialized fallback is delivered exactly once."""
        arena_name = None
        try:
            ctrl = pickle.loads(fr.payload)
            arena_name = ctrl["arena"]
            if time.monotonic_ns() >= int(ctrl["stale_ns"]):
                raise TimeoutError("attach lease nearly expired")
            arena = self._attach_cache.attach(arena_name)
            if self.attach_mode == "ref":
                # true zero-copy: republish the descriptor verbatim, tagged
                # with the source arena; ack deferred to our entry's reclaim
                seq = ep.pub.publish_descriptor(
                    ctrl["desc"], xarena=arena_name, origin=ORIGIN_BRIDGE,
                    exclude_sub=ep.sub.sidx, hops=fr.hops,
                    src_tag=src, route_seq=rseq, trace_id=fr.trace_id)
                self._ref_pending[(ep.topic, seq)] = (src, rseq)
                self._relayed_in.inc()
                if self._tr is not None and fr.trace_id:
                    self._tr.emit(fr.trace_id, fr.hops,
                                  _trace.Stage.BRIDGE_IN)
            else:  # "copy": read fields straight from the source entry
                msg = ReceivedMessage(arena, ctrl["desc"])
                loan = self._fill_loan(ep, msg.fields())
                # the source entry is consumed the moment the copy lands —
                # ack now, park/retry later cannot touch it again
                self.bus.publish_ack(ep.topic, True, src_tag=src,
                                     route_seq=rseq)
                self._publish_or_park(ep, loan, fr.hops, src, rseq,
                                      fr.trace_id)
        except Exception:
            self._attach_nacks.inc()
            self._forget(src, rseq)
            if arena_name is not None:
                self._attach_cache.evict(arena_name)  # maybe stale segment
            try:
                self.bus.publish_ack(ep.topic, False, src_tag=src,
                                     route_seq=rseq)
            except OSError:
                pass
            return 0
        # relayed_in counts the delivery where it happens: here in ref mode,
        # in _publish_or_park (or the parked retry) in copy mode.  The
        # reference counts a copy-mode delivery twice.
        self._n_attach_in.inc()
        return 1

    def _ack_in(self, fr: Frame) -> None:
        aw = self._awaiting.get((fr.topic, fr.src_tag, fr.route_seq))
        if aw is None:
            return  # not ours (sibling's message), or already settled
        key = (fr.topic, fr.src_tag, fr.route_seq)
        if fr.payload[:1] == b"\x00":  # NACK: degrade to by-value now,
            self._send_fallback(key, aw)  # but keep the pin for other
            aw.acks += 1                  # receivers still mid-read
        else:
            aw.acks += 1
        if aw.need is not None and aw.acks >= aw.need:
            self._settle(key)

    def _fanout_in(self, fr: Frame) -> None:
        key = (fr.topic, fr.src_tag, fr.route_seq)
        aw = self._awaiting.get(key)
        if aw is None:
            return
        (aw.need,) = _FANOUT.unpack(fr.payload[:_FANOUT.size])
        if aw.acks >= aw.need:
            self._settle(key)  # 0 receivers (or acks beat the receipt)

    def _ref_reclaimed(self, topic: str, seqs) -> None:
        """Our ref-mode republication was reclaimed — every local reader is
        done with the source entry; ack so the sender can unpin."""
        for s in seqs:
            rec = self._ref_pending.pop((topic, s), None)
            if rec is not None:
                try:
                    self.bus.publish_ack(topic, True, src_tag=rec[0],
                                         route_seq=rec[1])
                except OSError:
                    pass  # bus gone: the sender's lease expiry covers it

    def _publish_or_park(self, ep: _Endpoint, loan, hops: int, src: int,
                         rseq: int, trace_id: int = 0) -> None:
        ep.pub.reclaim()
        try:
            ep.pub.publish(loan, origin=ORIGIN_BRIDGE,
                           exclude_sub=ep.sub.sidx, hops=hops,
                           src_tag=src, route_seq=rseq, trace_id=trace_id)
            self._relayed_in.inc()
            if self._tr is not None and trace_id:
                self._tr.emit(trace_id, hops, _trace.Stage.BRIDGE_IN)
        except AgnocastQueueFull:
            # park THIS endpoint: the loan stays valid; the blocked
            # publisher's slot-freed FIFO is the wakeup source (executor-
            # multiplexed or select()ed).  Waiter flag up so releasers
            # write that FIFO at all.  Other endpoints keep flowing.
            self._pending[ep.topic] = _Pending(ep, loan, hops, src, rseq,
                                               trace_id)
            ep.pub.set_waiting(True)
            # lost-wakeup guard (same rule as wait_for_slot): a release that
            # landed between the failed publish and the flag store produced
            # no FIFO byte — re-check under the topic lock, retry now
            if self.dom.registry.can_publish(ep.pub.tidx, ep.pub.pidx):
                self._retry_topic(ep.topic)
        except Exception:
            loan.dealloc()  # any other failure: return the arena blocks
            raise

    def retry_pending(self) -> bool:
        """Retry every parked copy-in (then drain the unparked topics'
        backlogs, in arrival order); True when nothing remains parked.

        One topic's poisoned retry must not wedge its siblings: the error
        is re-raised only after every parked topic got its retry, and the
        poisoned topic's backlog is shed (counted) — its frames must not
        deliver stale and out of order behind newer intake."""
        err: Exception | None = None
        for topic in list(self._pending):
            try:
                unparked = self._retry_topic(topic)
            except Exception as e:
                q = self._backlog.pop(topic, None)
                if q:
                    self._dropped_backlog.inc(len(q))
                if err is None:
                    err = e
                continue
            if unparked:
                self._drain_backlog(topic)
        if err is not None:
            raise err
        return not self._pending

    def _retry_topic(self, topic: str) -> bool:
        """Retry one topic's parked publish; True when that topic is
        unblocked (its backlog may still hold frames — see caller)."""
        pending = self._pending.get(topic)
        if pending is None:
            return True
        ep, loan, hops, src, rseq, tid = pending
        ep.pub.reclaim()
        try:
            ep.pub.publish(loan, origin=ORIGIN_BRIDGE,
                           exclude_sub=ep.sub.sidx, hops=hops,
                           src_tag=src, route_seq=rseq, trace_id=tid)
        except AgnocastQueueFull:
            return False
        except Exception as e:
            del self._pending[topic]  # poisoned: drop the frame, free loan
            self._copy_errors.inc()
            loan.dealloc()
            ep.pub.set_waiting(False)
            # undelivered: release its dedup key so another route can still
            # deliver (no-op for adopted ids — they are never re-admitted)
            self._forget(src, rseq)
            # the immediate lost-wakeup retry re-raises through
            # _handle_frame's catch-all: mark the frame as accounted so the
            # drop is not counted (and its key not forgotten) twice
            e._bridge_accounted = True
            raise
        del self._pending[topic]
        self._relayed_in.inc()
        if self._tr is not None and tid:
            self._tr.emit(tid, hops, _trace.Stage.BRIDGE_IN)
        ep.pub.set_waiting(False)
        return True

    def _drain_backlog(self, topic: str) -> None:
        """Deliver frames queued behind a (now lifted) parked copy-in, in
        arrival order; stops where the topic re-parks."""
        q = self._backlog.get(topic)
        while q:
            fr = q.popleft()
            self._handle_frame(fr)
            if topic in self._pending:
                return  # re-parked: the rest stays queued, order intact
        self._backlog.pop(topic, None)

    @property
    def blocked_publisher(self) -> Publisher | None:
        """One publisher whose full ring is stalling its topic's copy-ins
        (compat accessor; see :attr:`blocked_publishers` for all of them)."""
        for pending in self._pending.values():
            return pending.ep.pub
        return None

    @property
    def blocked_publishers(self) -> list[Publisher]:
        """Every parked endpoint's publisher — one selectable slot-freed
        fd per stalled topic; unrelated topics are not represented because
        they are not blocked."""
        return [p.ep.pub for p in self._pending.values()]

    # -- standalone spinning -----------------------------------------------------

    def spin_once(self, timeout: float = 0.05) -> int:
        """Pump both planes once, then wait on every relevant fd at once:
        each endpoint's wakeup FIFO, the bus socket, and every parked
        endpoint's blocked-publisher slot-freed FIFO (intake keeps running
        while individual topics are parked — their frames backlog)."""
        moved = self.pump_agnocast() + self.pump_bus(0.0)
        if moved == 0:
            rlist: list = [ep.sub for ep in self.endpoints.values()]
            rlist.extend(self.blocked_publishers)
            rlist.append(self.bus)
            r, _, _ = select.select(rlist, [], [], timeout)
            for obj in r:
                if isinstance(obj, Subscription):
                    obj.drain_wakeups()
                elif isinstance(obj, Publisher):
                    obj.drain_slot_wakeups()
            moved = self.pump_agnocast() + self.pump_bus(0.0)
        return moved

    def register(self, executor, *, group=None):
        """Run this bridge on an :class:`repro_torch.core.executor.EventExecutor`:
        every endpoint FIFO, the bus socket, and any blocked publisher's
        slot-freed FIFO are multiplexed into the loop."""
        return executor.add_bridge(self, group=group)

    def stats(self) -> dict:
        """Observability snapshot (CI artifacts + the OOM regression gate)."""
        return {
            "relayed_out": self.relayed_out,
            "relayed_in": self.relayed_in,
            "dropped_loops": self.dropped_loops,
            "dropped_dups": self.dropped_dups,
            "copy_errors": self.copy_errors,
            "oom_retries": self.oom_retries,
            "dropped_oom": self.dropped_oom,
            "dropped_backlog": self.dropped_backlog,
            "parked": len(self._pending),
            "attach_out": self.attach_out,
            "attach_in": self.attach_in,
            "attach_nacks": self.attach_nacks,
            "ack_timeouts": self.ack_timeouts,
            "attach_fallbacks": self.attach_fallbacks,
            "awaiting": len(self._awaiting),
        }

    def close(self) -> None:
        for pending in list(self._pending.values()):
            try:
                pending.loan.dealloc()  # return the parked loan's arena
            except Exception:
                pass
            try:
                pending.ep.pub.set_waiting(False)
            except Exception:
                pass
            # a parked frame was admitted but never delivered: release its
            # dedup key so other routes (or a restarted bridge) can deliver
            self._forget(pending.src_tag, pending.route_seq)
        self._pending = {}
        self._backlog = {}
        # flush unresolved attach sends by value (receivers that already
        # delivered dedup the re-send), then drop every pin we hold — a
        # closing bridge must never leave the source ring wedged
        for key, aw in list(self._awaiting.items()):
            if aw.need is None or aw.acks < aw.need:
                self._send_fallback(key, aw)
            self._settle(key)
        self._ref_pending = {}
        self._attach_cache.close()
        self.bus.close()


class Bridge(DomainBridge):
    """The paper's single-topic bridge (§IV-D) as a one-rule special case
    of :class:`DomainBridge` — kept for API compatibility."""

    def __init__(self, dom: Domain, bus_path: str, mtype: MessageType,
                 topic: str, *, depth: int = 10):
        super().__init__(dom, bus_path, name=f"bridge:{topic}", depth=depth)
        ep = self.attach(mtype, topic)
        self.mtype = mtype
        self.topic = topic
        self.pub = ep.pub
        self.sub = ep.sub


class Router:
    """One domain's view of the federation: the routing table plus one
    :class:`DomainBridge` per remote bus, sharing a dedup window."""

    def __init__(self, dom: Domain, *, tag: int | None = None,
                 max_hops: int = DEFAULT_MAX_HOPS,
                 seen_limit: int = _SEEN_LIMIT,
                 data_plane: str = "parts", attach_mode: str = "ref",
                 pin_lease_s: float = 5.0):
        self.dom = dom
        self.tag = tag if tag is not None else domain_tag(dom.name)
        self.max_hops = max_hops
        self.data_plane = data_plane
        self.attach_mode = attach_mode
        self.pin_lease_s = pin_lease_s
        self.table = RoutingTable()
        self.bridges: dict[str, DomainBridge] = {}
        self._seen = _DedupWindow(seen_limit)
        self._mint = _AdoptedIdMint()

    # -- topology -------------------------------------------------------------

    def add_remote(self, name: str, bus_path: str, *, depth: int = 10,
                   data_plane: str | None = None,
                   attach_mode: str | None = None) -> DomainBridge:
        if name in self.bridges:
            raise ValueError(f"remote {name!r} already exists")
        br = DomainBridge(self.dom, bus_path, name=name, router=self,
                          depth=depth,
                          data_plane=data_plane or self.data_plane,
                          attach_mode=attach_mode or self.attach_mode,
                          pin_lease_s=self.pin_lease_s)
        self.bridges[name] = br
        return br

    def add_route(self, prefix: str, remote: str | None) -> RoutingRule:
        if remote is not None and remote not in self.bridges:
            raise ValueError(f"unknown remote {remote!r}")
        return self.table.add(prefix, remote)

    def activate(self, mtype: MessageType, topic: str) -> list[DomainBridge]:
        """Start federating ``topic``: attach an endpoint on every remote
        the table selects (longest-prefix rules)."""
        out = []
        for name in self.table.lookup(topic):
            br = self.bridges[name]
            br.attach(mtype, topic)
            out.append(br)
        return out

    # -- shared loop-prevention state ------------------------------------------

    def admit(self, src_tag: int, route_seq: int) -> bool:
        """Record-and-test the dedup window: True exactly once per
        ``(src_tag, route_seq)`` across all of this router's bridges."""
        return self._seen.admit(src_tag, route_seq)

    def forget(self, src_tag: int, route_seq: int) -> None:
        """Un-admit a key whose message was not delivered (failed copy-in)."""
        self._seen.forget(src_tag, route_seq)

    def next_route_seq(self) -> int:
        """Mint an id for an adopted conventional frame: disjoint from the
        ring-derived origin ids (``_ADOPTED_ID``) and salted per router
        incarnation so restarts / sibling routers never reuse a key."""
        return self._mint.next()

    # -- running ----------------------------------------------------------------

    def register(self, executor, *, group=None) -> list:
        """Put every bridge on one EventExecutor loop."""
        return [br.register(executor, group=group)
                for br in self.bridges.values()]

    def spin_once(self, timeout: float = 0.05) -> int:
        """Standalone round-robin pump (tests / executor-less deployments)."""
        moved = sum(br.pump_agnocast() + br.pump_bus(0.0)
                    for br in self.bridges.values())
        if moved == 0 and timeout > 0:
            per = timeout / max(len(self.bridges), 1)
            moved = sum(br.spin_once(per) for br in self.bridges.values())
        return moved

    def close(self) -> None:
        for br in self.bridges.values():
            br.close()
        self.bridges = {}
