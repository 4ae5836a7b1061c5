"""Conventional transports — the paths Agnocast is compared against (§V).

* :class:`Bus` / :class:`BusClient` — a loopback publish/subscribe bus over
  Unix domain sockets with length-prefixed frames.  This is the "ROS 2 via
  CycloneDDS" analogue: a plain publish pays serialization + two socket
  copies + deserialization, all O(payload).
* :class:`ShmRing` — a shared-memory ring.  In ``copy`` mode the producer
  serializes into a slot and the consumer deserializes out (the "IceOryx
  with unsized message types" case the paper measures: transparent
  serialization to/from shared memory).  In ``loan`` mode the producer
  writes payload bytes directly in the slot and the consumer reads in
  place (the "IceOryx with static-sized types" true zero-copy case —
  constant latency, but only for fixed-size payloads).

These exist so the benchmarks reproduce Fig. 9/10/11's *comparisons*, and
so the bridge (§IV-D) has a conventional space to relay to.

Wire format — control/data frame split (TZC-style, cf. PAPERS.md)
-----------------------------------------------------------------

Every frame on the wire is ``<u32 length><u8 kind><PUBHDR><topic>...``
where ``PUBHDR = <u16 topic_len><u8 origin><u8 hops><u64 src_tag>
<u64 route_seq><u64 trace_id>`` carries the route metadata the
multi-domain bridges (:mod:`repro_torch.core.routing`) need for duplicate
suppression and loop prevention, plus the ``repro_torch.obs`` flow id so a
traced message keeps one flow across bridge hops (0 = untraced).  The
``kind`` byte selects what follows the topic:

=====  =========  ==========================================================
kind   name       body after topic
=====  =========  ==========================================================
0      PUB        serialized payload (``messages.serialize`` bytes).  The
                  scatter-gather fast path (:meth:`BusClient.publish_parts`)
                  emits this *same* byte stream via ``socket.sendmsg`` with
                  the layout header and each field's loaned numpy view as
                  separate iovecs — no intermediate assembly buffer — so
                  receivers cannot tell (and need not care) which path the
                  sender used.
1      SUB        topic name only (subscription registration).
2      CTRL       an *attach control frame*: a pickled dict carrying the
                  source arena name and per-field ``AllocRef`` words
                  instead of payload bytes.  The data part never transits
                  the bus — a same-host receiver attaches the source arena
                  read-only and reads the fields in place (routing.py).
3      ACK        1-byte status (``\\x01`` ack / ``\\x00`` nack) answering a
                  CTRL frame; ``src_tag``/``route_seq`` name the message.
                  Published on the CTRL's topic; non-owners ignore it.
4      FANOUT     bus → CTRL-publisher receipt: ``<u32 n>`` = how many
                  subscribers the CTRL frame was fanned out to, i.e. how
                  many ACKs the sender should await before unpinning.
=====  =========  ==========================================================

The bus itself never inspects payloads; CTRL/ACK frames fan out exactly
like PUB frames (kind ≠ SUB ⇒ fan out), so the control plane needs no bus
routing state beyond topic subscriptions.  Fan-out is non-blocking: each
connection owns an outbound buffer drained on ``EVENT_WRITE``; a receiver
whose backlog exceeds ``max_backlog`` bytes has the frame dropped and
counted (``Bus.dropped_backlog``) instead of stalling the event loop.

Subscribing is asynchronous: ``subscribe`` returns once its SUB frame is
written, before the bus has read it.  :func:`sync_subscriptions` waits
until it has: the bus reads one connection's frames in order and answers
a CTRL frame with a FANOUT receipt on the same connection, so a receipt
for a probe sent after the SUB frames proves they are registered.
:class:`SubscriptionProbe` does the same for a client whose socket a
bridge reads.

The port's copy of ``repro/core/transport.py``: the import paths differ
and :func:`sync_subscriptions` and :class:`SubscriptionProbe` are added.  The wire (frame kinds, headers,
``WIRE_REV``) is the reference's byte for byte, so a client of one
package works on a bus of the other.
"""

from __future__ import annotations

import os
import secrets
import selectors
import socket
import struct
import threading
from collections import deque
from dataclasses import dataclass
from multiprocessing import shared_memory

import numpy as np

from .arena import _new_shm
from repro_torch.obs import metrics as _metrics

__all__ = ["Bus", "BusClient", "Frame", "ShmRing", "WIRE_REV",
           "K_PUB", "K_SUB", "K_CTRL", "K_ACK", "K_FANOUT",
           "sync_subscriptions", "SubscriptionProbe"]

# Wire-layout revision for everything that crosses a bus socket: the
# _FRAME length prefix, _PUBHDR, the fan-out count and the K_* kinds.
# Bump on ANY layout-bearing change.  The reference's layout verifier
# fingerprints its copy of these constants; this copy must stay equal to
# it (tests/test_torch_transport_routing.py holds every one equal).
WIRE_REV = 1

_FRAME = struct.Struct("<I")
# topic_len, origin, hops, src_tag, route_seq, trace_id — src_tag/route_seq
# are the route metadata the multi-domain bridges (repro_torch.core.routing) need
# for duplicate suppression and hop-count loop prevention; trace_id is the
# repro_torch.obs flow id; plain publishers leave them all 0.
_PUBHDR = struct.Struct("<HBBQQQ")
_FANOUT = struct.Struct("<I")

# frame kinds (see module docstring)
K_PUB = 0
K_SUB = 1
K_CTRL = 2
K_ACK = 3
K_FANOUT = 4


@dataclass(frozen=True)
class Frame:
    """One bus frame with its route metadata."""

    topic: str
    origin: int      # 0 = conventional publisher, 1 = a bridge
    hops: int        # bus hops taken so far (origin domain -> here)
    src_tag: int     # origin agnocast-domain tag (0 = conventional origin)
    route_seq: int   # origin-unique message id (dedup key with src_tag)
    payload: "bytes | memoryview"  # view over this frame's own recv buffer
    kind: int = K_PUB  # frame kind (K_PUB/K_CTRL/K_ACK/K_FANOUT)
    trace_id: int = 0  # repro_torch.obs flow id carried across bridge hops


def _recv_exact(sock: socket.socket, n: int) -> memoryview | None:
    """Read exactly ``n`` bytes into one exact-size buffer (``recv_into`` —
    no chunk list, no join copy, no final ``bytes()`` copy)."""
    buf = memoryview(bytearray(n))
    got = 0
    while got < n:
        r = sock.recv_into(buf[got:])
        if not r:
            return None
        got += r
    return buf


class _Conn:
    """Per-connection bus state: parse buffer in, bounded backlog out."""

    __slots__ = ("sock", "topics", "inbuf", "outq", "out_bytes")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.topics: set[str] = set()
        self.inbuf = bytearray()
        self.outq: deque = deque()  # memoryviews pending send
        self.out_bytes = 0


class Bus:
    """Loopback pub/sub hub (the conventional-middleware stand-in).

    The event loop never blocks on any one connection: reads go through
    per-connection parse buffers, fan-out goes through per-connection
    outbound queues drained on ``EVENT_WRITE``.  A slow subscriber whose
    backlog exceeds ``max_backlog`` bytes gets frames *dropped* (counted in
    :attr:`dropped_backlog`) rather than stalling every other participant —
    the head-of-line-blocking fix the routing plane's liveness depends on."""

    def __init__(self, path: str | None = None, *, max_backlog: int = 64 << 20):
        self.path = path or f"\0agnobus-{secrets.token_hex(6)}"
        self.max_backlog = max_backlog
        # unified metrics (repro_torch.obs): incremented on the bus event thread,
        # read from arbitrary threads — the Counter lock makes both safe
        self._dropped_backlog = _metrics.counter("bus.dropped_backlog")
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(self.path)
        self._srv.listen(64)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._srv, selectors.EVENT_READ, None)
        self._conns: dict[socket.socket, _Conn] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Bus":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            for key, events in self._sel.select(timeout=0.1):
                if key.data is None:
                    conn, _ = self._srv.accept()
                    conn.setblocking(False)
                    c = _Conn(conn)
                    self._conns[conn] = c
                    self._sel.register(conn, selectors.EVENT_READ, c)
                    continue
                c = key.data
                if events & selectors.EVENT_READ:
                    self._readable(c)
                if events & selectors.EVENT_WRITE and c.sock in self._conns:
                    self._flush(c)

    # -- event-loop halves ---------------------------------------------------

    def _readable(self, c: _Conn) -> None:
        try:
            while True:
                chunk = c.sock.recv(1 << 20)
                if not chunk:
                    self._drop(c)
                    return
                c.inbuf += chunk
                if len(chunk) < (1 << 20):
                    break
        except BlockingIOError:
            pass
        except OSError:
            self._drop(c)
            return
        pos = 0
        buf = c.inbuf
        while len(buf) - pos >= 4:
            (n,) = _FRAME.unpack_from(buf, pos)
            if len(buf) - pos - 4 < n:
                break
            # hand a *view* into the parse buffer to dispatch; it copies the
            # frame exactly once (prefix + body in one buffer) for fan-out
            self._dispatch(c, memoryview(buf)[pos + 4 : pos + 4 + n])
            pos += 4 + n
            if c.sock not in self._conns:  # dispatch dropped us
                return
        if pos:
            del buf[:pos]

    def _dispatch(self, c: _Conn, frame: memoryview) -> None:
        kind = frame[0]
        if kind == K_SUB:
            c.topics.add(bytes(frame[1:]).decode())
            frame.release()  # inbuf compaction needs the view gone
            return
        tlen, _, _, src_tag, route_seq, _ = _PUBHDR.unpack_from(frame, 1)
        topic = bytes(frame[1 + _PUBHDR.size : 1 + _PUBHDR.size + tlen]).decode()
        out = bytearray(_FRAME.pack(len(frame)))
        out += frame  # the single fan-out copy (shared by every receiver)
        frame.release()
        fanout = 0
        for oc in list(self._conns.values()):
            if topic in oc.topics and oc is not c:
                if self._enqueue(oc, out):
                    fanout += 1
        if kind == K_CTRL and c.sock in self._conns:
            # receipt: tell the CTRL publisher how many ACKs to await
            t = topic.encode()
            body = (bytes([K_FANOUT])
                    + _PUBHDR.pack(len(t), 0, 0, src_tag, route_seq, 0)
                    + t + _FANOUT.pack(fanout))
            self._enqueue(c, _FRAME.pack(len(body)) + body)

    @property
    def dropped_backlog(self) -> int:
        """Back-compat shim: frames dropped on over-backlog connections."""
        return self._dropped_backlog.value

    def _enqueue(self, c: _Conn, out: bytes) -> bool:
        if c.out_bytes + len(out) > self.max_backlog:
            self._dropped_backlog.inc()
            return False
        c.outq.append(memoryview(out))
        c.out_bytes += len(out)
        self._flush(c)
        return c.sock in self._conns

    def _flush(self, c: _Conn) -> None:
        try:
            while c.outq:
                mv = c.outq[0]
                sent = c.sock.send(mv)
                c.out_bytes -= sent
                if sent < len(mv):
                    c.outq[0] = mv[sent:]
                    break
                c.outq.popleft()
        except BlockingIOError:
            pass
        except OSError:
            self._drop(c)
            return
        want = selectors.EVENT_READ | (selectors.EVENT_WRITE if c.outq else 0)
        self._sel.modify(c.sock, want, c)

    def _drop(self, c: _Conn) -> None:
        if self._conns.pop(c.sock, None) is None:
            return
        try:
            self._sel.unregister(c.sock)
        except (KeyError, ValueError):
            pass
        c.sock.close()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self._srv.close()


class BusClient:
    def __init__(self, path: str):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(path)

    def fileno(self) -> int:
        """The bus socket fd — selectable by an event loop (executor bridge)."""
        return self._sock.fileno()

    def subscribe(self, topic: str) -> None:
        body = b"\x01" + topic.encode()
        self._sock.sendall(_FRAME.pack(len(body)) + body)

    def publish(self, topic: str, payload: bytes, *, origin: int = 0,
                hops: int = 0, src_tag: int = 0, route_seq: int = 0,
                kind: int = K_PUB, trace_id: int = 0) -> None:
        t = topic.encode()
        body = (bytes([kind])
                + _PUBHDR.pack(len(t), origin, hops, src_tag, route_seq,
                               trace_id)
                + t + payload)
        self._sock.sendall(_FRAME.pack(len(body)) + body)

    def publish_parts(self, topic: str, header: bytes, views, *, origin: int = 0,
                      hops: int = 0, src_tag: int = 0, route_seq: int = 0,
                      trace_id: int = 0) -> None:
        """Scatter-gather publish: one ``sendmsg`` straight off the loaned
        numpy views — no ``b"".join`` assembly buffer, no payload copy on
        this side of the socket.  Emits a byte stream identical to
        :meth:`publish` of ``header + b"".join(views)`` (see
        ``messages.serialize_parts``), so receivers need no new code."""
        t = topic.encode()
        prefix = (bytes([K_PUB])
                  + _PUBHDR.pack(len(t), origin, hops, src_tag, route_seq,
                                 trace_id)
                  + t + header)
        total = len(prefix) + sum(v.nbytes for v in views)
        bufs = [memoryview(_FRAME.pack(total) + prefix)]
        bufs += [mv for v in views if (mv := memoryview(v)).nbytes]
        while bufs:
            sent = self._sock.sendmsg(bufs)
            while sent:  # partial send: advance across the iovec list
                if sent >= len(bufs[0]):
                    sent -= len(bufs[0])
                    bufs.pop(0)
                else:
                    bufs[0] = bufs[0][sent:]
                    sent = 0

    def publish_ctrl(self, topic: str, ctrl: bytes, *, origin: int = 0,
                     hops: int = 0, src_tag: int = 0, route_seq: int = 0,
                     trace_id: int = 0) -> None:
        """Publish an attach control frame (kind 2): route metadata + the
        pickled attach descriptor; payload bytes stay in the source arena."""
        self.publish(topic, ctrl, origin=origin, hops=hops, src_tag=src_tag,
                     route_seq=route_seq, kind=K_CTRL, trace_id=trace_id)

    def publish_ack(self, topic: str, ok: bool, *, src_tag: int,
                    route_seq: int) -> None:
        """Answer a CTRL frame: ack (data read done, pin releasable) or
        nack (attach/read failed — sender must fall back to serialized)."""
        self.publish(topic, b"\x01" if ok else b"\x00",
                     src_tag=src_tag, route_seq=route_seq, kind=K_ACK)

    def recv_frame(self, timeout: float | None = None) -> Frame | None:
        """Receive one frame with its route metadata (bridges use this)."""
        import select as _select

        if timeout is not None:
            r, _, _ = _select.select([self._sock], [], [], timeout)
            if not r:
                return None
        # frame is available (or timeout=None): blocking reads for the frame
        self._sock.settimeout(None)
        hdr = _recv_exact(self._sock, 4)
        if hdr is None:
            return None
        (n,) = _FRAME.unpack(hdr)
        frame = _recv_exact(self._sock, n)
        if frame is None:
            return None
        tlen, origin, hops, src_tag, route_seq, trace_id = \
            _PUBHDR.unpack_from(frame, 1)
        off = 1 + _PUBHDR.size
        topic = bytes(frame[off : off + tlen]).decode()
        # payload stays a view over the frame's own exact-size buffer: the
        # 16 MiB case pays zero receive-side assembly copies (deserialize /
        # pickle / struct all take bytes-likes)
        return Frame(topic, origin, hops, src_tag, route_seq,
                     frame[off + tlen :], kind=frame[0], trace_id=trace_id)

    def recv(self, timeout: float | None = None) -> tuple[str, int, bytes] | None:
        fr = self.recv_frame(timeout)
        return None if fr is None else (fr.topic, fr.origin, fr.payload)

    def close(self) -> None:
        self._sock.close()


def _recv_until(client, want, timeout: float, what: str):
    """Read ``client``'s frames until ``want(frame)``; raise ``TimeoutError``
    after ``timeout`` s."""
    import time as _time

    deadline = _time.monotonic() + timeout
    while True:
        left = deadline - _time.monotonic()
        fr = client.recv_frame(left) if left > 0 else None
        if fr is None:
            raise TimeoutError(f"no {what} within {timeout} s")
        if want(fr):
            return fr


def sync_subscriptions(client, timeout: float = 10.0) -> None:
    """Return once the bus has registered every SUB frame ``client`` sent
    (module docstring): send a CTRL probe on a fresh topic and read the
    bus's FANOUT receipt for it.  Only for a client whose socket nothing
    else reads and on whose topics nothing is published meanwhile: frames
    read before the receipt are dropped.  ``client`` is any bus client with
    ``publish_ctrl`` and ``recv_frame`` (the reference's too)."""
    probe = f"_probe/{secrets.token_hex(6)}"
    client.publish_ctrl(probe, b"")
    _recv_until(client, lambda fr: fr.kind == K_FANOUT and fr.topic == probe,
                timeout, "FANOUT receipt for a subscription probe")


class SubscriptionProbe:
    """Waits until the bus has registered every SUB frame another client
    sent, without reading that client's socket (a bridge's pump reads it).
    The client publishes a token on the probe's own topic; the bus reads
    the client's frames in order, so the token reaching the probe's
    watcher proves the earlier SUB frames are in.  The client must not be
    sending from another thread meanwhile (one socket, one writer)."""

    def __init__(self, bus_path: str, timeout: float = 10.0):
        self.topic = f"_probe/{secrets.token_hex(6)}"
        self._watch = BusClient(bus_path)
        self._watch.subscribe(self.topic)
        sync_subscriptions(self._watch, timeout)

    def wait(self, client, timeout: float = 10.0) -> None:
        token = secrets.token_bytes(8)
        client.publish(self.topic, token)
        _recv_until(self._watch, lambda fr: bytes(fr.payload) == token, timeout,
                    "subscription probe token")

    def close(self) -> None:
        self._watch.close()


# ---------------------------------------------------------------------------
# Shared-memory ring (IceOryx analogue)
# ---------------------------------------------------------------------------

_RING_HDR = 64  # head (u8 x 8 reserved)
_SLOT_HDR = 16  # seq u8, nbytes u8


# agnolint: single-writer -- single-producer by construction; commit order (nbytes, seq, then head) is the consumer's consistency fence
class ShmRing:
    """Single-producer shared-memory ring with ``loan`` and ``copy`` modes."""

    def __init__(self, shm, slots: int, slot_bytes: int, *, owner: bool):
        self._shm = shm
        self.slots = slots
        self.slot_bytes = slot_bytes
        self.owner = owner
        self.name = shm.name
        self._head = np.frombuffer(shm.buf, dtype=np.uint64, count=8)
        self._buf = np.frombuffer(shm.buf, dtype=np.uint8, offset=_RING_HDR)
        if owner:
            self._head[0] = 0  # next seq to write
        self._rseq = 1  # consumer cursor

    @classmethod
    def create(cls, slots: int, slot_bytes: int, name: str | None = None) -> "ShmRing":
        name = name or f"agnoring-{secrets.token_hex(6)}"
        size = _RING_HDR + slots * (_SLOT_HDR + slot_bytes)
        return cls(_new_shm(name, create=True, size=size), slots, slot_bytes, owner=True)

    @classmethod
    def attach(cls, name: str, slots: int, slot_bytes: int) -> "ShmRing":
        return cls(_new_shm(name, create=False), slots, slot_bytes, owner=False)

    def _slot(self, seq: int) -> int:
        return (seq % self.slots) * (_SLOT_HDR + self.slot_bytes)

    # producer -----------------------------------------------------------------

    def loan(self) -> np.ndarray:
        """Zero-copy produce: write payload directly into the next slot."""
        seq = int(self._head[0]) + 1
        off = self._slot(seq)
        return self._buf[off + _SLOT_HDR : off + _SLOT_HDR + self.slot_bytes]

    def commit(self, nbytes: int) -> int:
        seq = int(self._head[0]) + 1
        off = self._slot(seq)
        hdr = self._buf[off : off + _SLOT_HDR].view(np.uint64)
        hdr[1] = nbytes
        hdr[0] = seq
        self._head[0] = seq  # release
        return seq

    def push_copy(self, payload: bytes | np.ndarray) -> int:
        """Copy-mode produce (IceOryx-with-unsized: serialize into shm)."""
        data = np.frombuffer(payload, dtype=np.uint8) if isinstance(payload, (bytes, bytearray, memoryview)) else payload.view(np.uint8).reshape(-1)
        slot = self.loan()
        slot[: data.size] = data  # the copy the paper measures
        return self.commit(data.size)

    # consumer -----------------------------------------------------------------

    def poll(self) -> tuple[int, np.ndarray] | None:
        """Read next message; returns (seq, read-only view) — view is only
        stable until the producer laps the ring (benchmark harness keeps
        slots ≥ in-flight)."""
        latest = int(self._head[0])
        if latest < self._rseq:
            return None
        seq = self._rseq
        off = self._slot(seq)
        hdr = self._buf[off : off + _SLOT_HDR].view(np.uint64)
        if int(hdr[0]) != seq:  # lapped: jump forward
            seq = latest
            off = self._slot(seq)
            hdr = self._buf[off : off + _SLOT_HDR].view(np.uint64)
        n = int(hdr[1])
        self._rseq = seq + 1
        view = self._buf[off + _SLOT_HDR : off + _SLOT_HDR + n]
        ro = view[...]
        ro.flags.writeable = False
        return seq, ro

    def pop_copy(self, timeout_spin: int = 0) -> tuple[int, bytes] | None:
        """Copy-mode consume (deserialize out of shm)."""
        got = self.poll()
        if got is None:
            return None
        seq, view = got
        return seq, view.tobytes()  # the copy-out

    def close(self) -> None:
        self._head = None
        self._buf = None
        try:
            self._shm.close()
        except BufferError:
            pass

    def unlink(self) -> None:
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
