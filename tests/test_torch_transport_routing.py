"""The port's copies of the cross-host planes held against the originals.

``repro_torch.core.transport`` (the serialized bus, its clients, the shm
ring) and ``repro_torch.core.routing`` (routing table, domain bridges,
routers) are copies of the reference's modules of the same names.  The
wire is the reference's byte for byte, so the tests hold the copies
faithful by interoperation: a client of one package on a bus of the
other, a reference router in one domain relaying to a port router in
another over one bus (both ways, on each data plane), and a three-domain
cycle that mixes the packages.  The bridges' failure paths (copy-in abort,
per-endpoint parking, arena pressure, ack timeout) are driven on the port.

Every wait is on a condition with a deadline and fails loudly.  A bus
subscription is confirmed by a probe round trip (the bus reads one
connection's frames in order), never by a fixed sleep."""

import dataclasses
import secrets
import socket
import threading
import time

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.routing as ref_routing
import repro.core.transport as ref_transport
import repro_torch.core as port_core
import repro_torch.core.routing as port_routing
import repro_torch.core.transport as port_transport
from _port_env import port_test_env  # noqa: F401  (autouse)
from repro_torch.core.transport import SubscriptionProbe, sync_subscriptions

PKGS = {"reference": ref_core, "port": port_core}
# (data_plane, attach_mode): the four ways a bridge moves a message
PLANES = [("serialized", "ref"), ("parts", "ref"), ("attach", "copy"), ("attach", "ref")]
PLANE_IDS = ["serialized", "parts", "attach-copy", "attach-ref"]
TOPIC = "xhost/pc"


def _domain(pkg, cap: int = 16 << 20):
    return pkg.Domain.create(f"ttr-{secrets.token_hex(4)}", arena_capacity=cap)


def _wait(cond, what: str, *, pump=(), timeout: float = 20.0) -> None:
    """Spin the routers or bridges in ``pump`` until ``cond()``; fail after
    ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        for r in pump:
            r.spin_once(0.005)


def _quiet(routers, bridges=(), *, idle: int = 20, timeout: float = 20.0) -> None:
    """Spin until no bridge holds an unsettled attach send and ``idle``
    rounds in a row moved nothing: a duplicate or a ping-pong copy still on
    the bus would have moved."""
    everyone = list(bridges) + [b for r in routers for b in r.bridges.values()]
    deadline, still = time.monotonic() + timeout, 0
    while still < idle:
        if time.monotonic() > deadline:
            raise AssertionError(f"the routers did not settle within {timeout} s")
        moved = sum(r.spin_once(0.002) for r in routers)
        moved += sum(b.spin_once(0.002) for b in bridges)
        busy = any(b._awaiting or b._pending for b in everyone)
        still = 0 if moved or busy else still + 1


def _payload(i: int, n: int) -> np.ndarray:
    return np.random.default_rng(1000 + i).integers(0, 256, n, dtype=np.uint8)


def _publish(pub, i: int, n: int) -> None:
    m = pub.borrow_loaded_message()
    m.data.extend(_payload(i, n))
    m.set("width", i)
    m.set("stamp", time.monotonic())
    pub.reclaim()
    pub.publish_blocking(m, timeout=10.0)


def _take(sub, got: list) -> int:
    for ptr in sub.take():
        got.append((int(ptr.msg.get("width")), bytes(np.asarray(ptr.data))))
        ptr.release()
    return len(got)


def _probe_bridges(bus_path: str, bridges) -> None:
    """Return once the bus at ``bus_path`` has registered every topic the
    ``bridges`` (all on that bus) subscribed to."""
    probe = SubscriptionProbe(bus_path)
    try:
        for br in bridges:
            probe.wait(br.bus)
    finally:
        probe.close()


def _probe_routers(bus_path: str, *routers) -> None:
    _probe_bridges(bus_path, [br for r in routers for br in r.bridges.values()])


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


def test_wire_constants_and_frame_equal_the_reference():
    for name in ("WIRE_REV", "K_PUB", "K_SUB", "K_CTRL", "K_ACK", "K_FANOUT", "_RING_HDR",
                 "_SLOT_HDR"):
        assert getattr(port_transport, name) == getattr(ref_transport, name), name
    for name in ("_FRAME", "_PUBHDR", "_FANOUT"):
        a, b = getattr(port_transport, name), getattr(ref_transport, name)
        assert (a.format, a.size) == (b.format, b.size), name
    pf, rf = dataclasses.fields(port_transport.Frame), dataclasses.fields(ref_transport.Frame)
    assert [(f.name, f.default) for f in pf] == [(f.name, f.default) for f in rf]
    args = dict(topic="t", origin=1, hops=2, src_tag=3, route_seq=4, payload=b"x", kind=2,
                trace_id=5)
    assert dataclasses.astuple(port_transport.Frame(**args)) == \
        dataclasses.astuple(ref_transport.Frame(**args))
    for name in ("DEFAULT_MAX_HOPS", "_SEEN_LIMIT", "_ADOPTED_ID"):
        assert getattr(port_routing, name) == getattr(ref_routing, name), name
    for name in ("a", "domain-b", "ttr-0123abcd"):
        assert port_routing.domain_tag(name) == ref_routing.domain_tag(name)
    for arena, t, p, seq in (("agnoheap-aaaa", 3, 0, 5), ("agnoheap-bbbb", 0, 7, 1 << 33)):
        assert port_routing._origin_route_seq(port_routing._origin_salt(arena, t, p), seq) == \
            ref_routing._origin_route_seq(ref_routing._origin_salt(arena, t, p), seq)


def _sent_bytes(pkg_transport, send) -> bytes:
    """Everything a client of ``pkg_transport`` writes to a raw listener
    while ``send(client)`` runs."""
    path = f"\0ttr-raw-{secrets.token_hex(6)}"
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    try:
        cli = pkg_transport.BusClient(path)
        conn, _ = srv.accept()
        send(cli)
        cli.close()
        out = bytearray()
        conn.settimeout(10.0)
        while chunk := conn.recv(1 << 16):
            out += chunk
        conn.close()
        return bytes(out)
    finally:
        srv.close()


def test_client_frames_are_the_references_byte_for_byte():
    m = port_core.POINT_CLOUD2.plain()
    m.data = _payload(0, 3000)
    m.stamp = 2.5
    header, views = port_core.serialize_parts(m)

    def send(cli):
        cli.subscribe("xhost/a")
        cli.publish("xhost/a", b"payload", origin=1, hops=3, src_tag=7 << 32, route_seq=11,
                    trace_id=13)
        cli.publish_parts("xhost/a", header, views, origin=1, hops=1, src_tag=5, route_seq=6,
                          trace_id=7)
        cli.publish_ctrl("xhost/a", b"ctrl", origin=1, hops=2, src_tag=9, route_seq=10)
        cli.publish_ack("xhost/a", True, src_tag=9, route_seq=10)
        cli.publish_ack("xhost/a", False, src_tag=9, route_seq=12)

    got = _sent_bytes(port_transport, send)
    assert got == _sent_bytes(ref_transport, send)
    assert len(got) > 3000


@pytest.mark.parametrize("bus_pkg,client_pkg", [("reference", "port"), ("port", "reference")])
def test_clients_work_on_the_other_packages_bus(bus_pkg, client_pkg):
    bus = PKGS[bus_pkg].Bus().start()
    a, b = PKGS[client_pkg].BusClient(bus.path), PKGS[client_pkg].BusClient(bus.path)
    try:
        b.subscribe("xhost/t")
        sync_subscriptions(b)
        a.publish("xhost/t", b"abc" * 1000, origin=1, hops=2, src_tag=3, route_seq=4,
                  trace_id=5)
        fr = b.recv_frame(10.0)
        assert fr is not None
        assert (fr.topic, fr.origin, fr.hops, fr.src_tag, fr.route_seq, fr.trace_id, fr.kind) \
            == ("xhost/t", 1, 2, 3, 4, 5, port_transport.K_PUB)
        assert bytes(fr.payload) == b"abc" * 1000
        # a CTRL frame fans out to b, and the bus tells a how many got it
        a.publish_ctrl("xhost/t", b"ctrl", src_tag=3, route_seq=8)
        fr = b.recv_frame(10.0)
        assert fr.kind == port_transport.K_CTRL and bytes(fr.payload) == b"ctrl"
        fr = a.recv_frame(10.0)
        assert fr.kind == port_transport.K_FANOUT and (fr.src_tag, fr.route_seq) == (3, 8)
        assert port_transport._FANOUT.unpack(fr.payload[:4]) == (1,)
    finally:
        a.close()
        b.close()
        bus.stop()


@pytest.mark.parametrize("writer,reader", [(port_transport, ref_transport),
                                           (ref_transport, port_transport)])
def test_shm_ring_between_the_packages(writer, reader):
    ring = writer.ShmRing.create(4, 256, name=f"ttr-ring-{secrets.token_hex(4)}")
    other = reader.ShmRing.attach(ring.name, 4, 256)
    try:
        for i in range(6):            # laps the 4 slots
            if i % 2:
                ring.push_copy(_payload(i, 100 + i).tobytes())
            else:
                slot = ring.loan()
                slot[:50] = _payload(i, 50)
                slot = None
                ring.commit(50)
            seq, data = other.pop_copy()
            assert seq == i + 1 and data == _payload(i, 50 if i % 2 == 0 else 100 + i).tobytes()
        assert other.poll() is None
    finally:
        other.close()
        ring.close()
        ring.unlink()


# ---------------------------------------------------------------------------
# routers of the two packages on one bus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane,mode", PLANES, ids=PLANE_IDS)
@pytest.mark.parametrize("sender,receiver", [("reference", "port"), ("port", "reference")])
def test_routers_of_both_packages_relay_exactly_once(sender, receiver, plane, mode):
    """A message published in the sender's domain reaches the receiver's
    domain exactly once with its bytes, whichever package runs which
    router; the attach plane settles every send without a fallback."""
    n_msgs, sizes = 6, (4 << 10, 200 << 10)
    bus = PKGS[sender].Bus().start()
    da, db = _domain(PKGS[sender]), _domain(PKGS[receiver])
    routers = []
    try:
        for pkg, dom in ((sender, da), (receiver, db)):
            r = PKGS[pkg].Router(dom, data_plane=plane, attach_mode=mode, pin_lease_s=5.0)
            r.add_remote("link", bus.path, depth=8)
            r.add_route("xhost/", "link")
            r.activate(PKGS[pkg].POINT_CLOUD2, TOPIC)
            routers.append(r)
        pub = da.create_publisher(PKGS[sender].POINT_CLOUD2, TOPIC, depth=8)
        sub = db.create_subscription(PKGS[receiver].POINT_CLOUD2, TOPIC)
        _probe_routers(bus.path, *routers)
        got = []
        for i in range(n_msgs):
            _publish(pub, i, sizes[i % 2])
            _wait(lambda: _take(sub, got) > i, f"message {i}", pump=routers)
        _quiet(routers)
        _take(sub, got)
        assert [i for i, _ in got] == list(range(n_msgs))
        assert all(b == _payload(i, sizes[i % 2]).tobytes() for i, b in got)
        ra, rb = (r.bridges["link"] for r in routers)
        # the reference counts an attach-plane copy-in twice in relayed_in
        twice = receiver == "reference" and (plane, mode) == ("attach", "copy")
        assert (ra.relayed_out, rb.relayed_in) == (n_msgs, n_msgs * (2 if twice else 1))
        assert rb.dropped_dups == 0 and rb.copy_errors == 0
        if plane == "attach":
            assert (ra.attach_out, rb.attach_in) == (n_msgs, n_msgs)
            assert ra.attach_fallbacks == ra.ack_timeouts == rb.attach_nacks == 0
    finally:
        for r in routers:
            r.close()
        db.close()
        da.close()
        bus.stop()


def test_routing_table_lookup_equals_the_reference():
    """``lookup`` and ``match`` on seeded random rule sets equal the
    reference's, and ``lookup`` a brute force over the rules."""
    prefixes = ["", "s/", "s/a", "s/a/b", "s/b", "t/", "t/a"]
    remotes = ["r1", "r2", "r3", None]
    topics = ["s/a/b/c", "s/a", "s/b/x", "t/a/y", "t/z", "u/v"]
    rng = np.random.default_rng(9)
    for _ in range(300):
        rules = [(prefixes[rng.integers(len(prefixes))], remotes[rng.integers(len(remotes))])
                 for _ in range(rng.integers(0, 9))]
        pt, rt = port_core.RoutingTable(), ref_core.RoutingTable()
        for p, r in rules:
            pt.add(p, r)
            rt.add(p, r)
        for topic in topics:
            assert pt.lookup(topic) == rt.lookup(topic)
            assert pt.match(topic) == rt.match(topic)
            matching = [(p, r) for p, r in rules if topic.startswith(p)]
            want = []
            if matching:
                longest = max(len(p) for p, _ in matching)
                at_best = [r for p, r in matching if len(p) == longest]
                if None not in at_best:
                    want = list(dict.fromkeys(at_best))
            assert pt.lookup(topic) == want


def test_three_domain_cycle_mixing_the_packages():
    """A ring of buses (A-B, B-C, C-A; A and C port, B reference): a message
    from A, and one from B, reaches each other domain exactly once, and no
    copy returns to its origin domain (its own subscriber sees it once)."""
    pkgs = {"A": "port", "B": "reference", "C": "port"}
    links = {"A": ("ab", "ca"), "B": ("ab", "bc"), "C": ("bc", "ca")}
    buses = {"ab": port_core.Bus().start(), "bc": ref_core.Bus().start(),
             "ca": port_core.Bus().start()}
    doms = {k: _domain(PKGS[p]) for k, p in pkgs.items()}
    routers = {}
    try:
        for k, dom in doms.items():
            r = PKGS[pkgs[k]].Router(dom)
            for name in links[k]:
                r.add_remote(name, buses[name].path, depth=8)
                r.add_route("xhost/", name)
            r.activate(PKGS[pkgs[k]].POINT_CLOUD2, TOPIC)
            routers[k] = r
        subs = {k: doms[k].create_subscription(PKGS[pkgs[k]].POINT_CLOUD2, TOPIC) for k in doms}
        pubs = {k: doms[k].create_publisher(PKGS[pkgs[k]].POINT_CLOUD2, TOPIC, depth=8)
                for k in "AB"}
        for name, bus in buses.items():
            _probe_bridges(bus.path, [routers[k].bridges[name] for k in doms if name in links[k]])
        got = {k: [] for k in doms}
        sent = [("A", 0), ("A", 1), ("B", 2), ("B", 3), ("A", 4)]
        for origin, i in sent:
            _publish(pubs[origin], i, 1024)
            _wait(lambda: all(_take(subs[k], got[k]) >= len([s for s in sent if s[1] <= i])
                              for k in doms), f"message {i} everywhere", pump=routers.values())
        _quiet(routers.values())
        for k in doms:
            _take(subs[k], got[k])
            assert sorted(i for i, _ in got[k]) == [i for _, i in sent], k
        drops = {k: sum(b.dropped_loops for b in r.bridges.values()) for k, r in routers.items()}
        dups = sum(b.dropped_dups for r in routers.values() for b in r.bridges.values())
        assert drops["A"] > 0 and dups > 0        # the loop prevention fired
    finally:
        for r in routers.values():
            r.close()
        for d in doms.values():
            d.close()
        for b in buses.values():
            b.stop()


def test_executor_runs_port_routers_and_a_bus_client():
    """The port's executor drives real bridges (``Router.register``, its
    bridge handles) and a conventional subscriber (``add_bus_client``): a
    message from A reaches B's subscriber and the plain client."""
    bus = port_core.Bus().start()
    da, db = _domain(port_core), _domain(port_core)
    plain = port_core.BusClient(bus.path)
    routers, frames, got = [], [], []
    try:
        for dom in (da, db):
            r = port_core.Router(dom)
            r.add_remote("hub", bus.path)
            r.add_route("xhost/", "hub")
            r.activate(port_core.POINT_CLOUD2, TOPIC)
            routers.append(r)
        plain.subscribe(TOPIC)
        sync_subscriptions(plain)
        _probe_routers(bus.path, *routers)
        pub = da.create_publisher(port_core.POINT_CLOUD2, TOPIC, depth=4)
        sub = db.create_subscription(port_core.POINT_CLOUD2, TOPIC)
        with port_core.EventExecutor(name="ttr") as ex:
            ex.add_subscription(sub, lambda ptr: got.append(bytes(np.asarray(ptr.data))))
            ex.add_bus_client(plain, lambda t, o, p: frames.append((t, o, bytes(p))))
            for r in routers:
                r.register(ex)
            _publish(pub, 7, 5000)
            ex.spin(until=lambda: got and frames, timeout=20.0)
        assert got == [_payload(7, 5000).tobytes()]
        assert len(frames) == 1 and frames[0][:2] == (TOPIC, 1)
        assert port_core.deserialize(frames[0][2])["data"].tobytes() == got[0]
    finally:
        plain.close()
        for r in routers:
            r.close()
        db.close()
        da.close()
        bus.stop()


# ---------------------------------------------------------------------------
# the port's bridge failure paths
# ---------------------------------------------------------------------------


def _bridge_and_client(cap: int = 8 << 20, **kw):
    bus = port_core.Bus().start()
    dom = _domain(port_core, cap)
    br = port_core.DomainBridge(dom, bus.path, name="r", **kw)
    cli = port_core.BusClient(bus.path)
    return bus, dom, br, cli


def _frame(value: int, n: int = 16) -> bytes:
    m = port_core.POINT_CLOUD2.plain()
    m.data = np.full(n, value, np.uint8)
    return port_core.serialize(m)


def _pump(br, cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        br.pump_bus(0.02)


def test_copy_in_abort_returns_its_loan():
    bus, dom, br, cli = _bridge_and_client()
    try:
        br.attach(port_core.POINT_CLOUD2, "t")
        app = dom.create_subscription(port_core.POINT_CLOUD2, "t")
        probe = SubscriptionProbe(bus.path)
        probe.wait(br.bus)
        probe.close()
        baseline = dom.arena.live_bytes
        cli.publish("t", b"\x00\x01junk-not-a-frame")             # fails before the borrow
        cli.publish("t", port_core.serialize(port_core.TOKEN_BATCH.plain()))  # mid-fill
        _pump(br, lambda: br.copy_errors >= 2, "two copy errors")
        assert br.copy_errors == 2 and br.relayed_in == 0
        assert dom.arena.live_bytes == baseline
        cli.publish("t", _frame(5, 24))
        _pump(br, lambda: br.relayed_in >= 1, "the good frame")
        got = app.take()
        assert [np.asarray(p.data).tolist() for p in got] == [[5] * 24]
        for p in got:
            p.release()
    finally:
        cli.close()
        br.close()
        dom.close()
        bus.stop()


def test_parking_is_per_endpoint():
    """A full ring on one topic parks only that endpoint: the other topic's
    frames land meanwhile, and the parked ones arrive in order once its
    references are released."""
    bus, dom, br, cli = _bridge_and_client(depth=2)
    try:
        br.attach(port_core.POINT_CLOUD2, "hol/a")
        br.attach(port_core.POINT_CLOUD2, "hol/b", depth=8)
        sub_a = dom.create_subscription(port_core.POINT_CLOUD2, "hol/a")
        sub_b = dom.create_subscription(port_core.POINT_CLOUD2, "hol/b")
        probe = SubscriptionProbe(bus.path)
        probe.wait(br.bus)
        probe.close()
        cli.publish("hol/a", _frame(0))
        cli.publish("hol/a", _frame(1))
        _pump(br, lambda: br.relayed_in >= 2, "A's first two")
        held = sub_a.take()
        assert len(held) == 2
        cli.publish("hol/a", _frame(2))
        cli.publish("hol/a", _frame(3))
        _pump(br, lambda: br.stats()["parked"] >= 1, "A parked")
        for i in range(4):
            cli.publish("hol/b", _frame(10 + i))
        _pump(br, lambda: br.relayed_in >= 6, "B's four while A is parked")
        ptrs = sub_b.take()
        assert [int(np.asarray(p.data)[0]) for p in ptrs] == [10, 11, 12, 13]
        for p in ptrs:
            p.release()
        assert br.stats()["parked"] == 1 and br.relayed_in == 6
        for p in held:
            p.release()
        _pump(br, lambda: br.relayed_in >= 8, "A's parked frames")
        got = sub_a.take()
        assert [int(np.asarray(p.data)[0]) for p in got] == [2, 3]
        for p in got:
            p.release()
        assert br.stats()["parked"] == 0 and br.stats()["dropped_backlog"] == 0
    finally:
        cli.close()
        br.close()
        dom.close()
        bus.stop()


def test_oom_final_drop_releases_the_dedup_key():
    """A copy-in that hits arena pressure twice is dropped and counted, its
    blocks returned and its dedup key released: the same routed message
    offered again once memory is free is delivered, not taken for a
    duplicate."""
    bus, dom, br, cli = _bridge_and_client(cap=1 << 20)
    try:
        br.attach(port_core.POINT_CLOUD2, "oomt")
        probe = SubscriptionProbe(bus.path)
        probe.wait(br.bus)
        probe.close()
        hog = dom.arena.alloc(dom.arena.capacity - (192 << 10))
        live = dom.arena.live_bytes
        big = _frame(1, 256 << 10)
        cli.publish("oomt", big, origin=1, hops=1, src_tag=777_000, route_seq=42)
        _pump(br, lambda: br.dropped_oom >= 1, "the OOM drop")
        assert (br.dropped_oom, br.relayed_in, br.copy_errors) == (1, 0, 0)
        assert br.oom_retries == 1
        assert dom.arena.live_bytes == live
        dom.arena.free(hog)
        cli.publish("oomt", big, origin=1, hops=1, src_tag=777_000, route_seq=42)
        _pump(br, lambda: br.relayed_in >= 1, "the re-offered frame")
        assert br.relayed_in == 1 and br.dropped_dups == 0
    finally:
        cli.close()
        br.close()
        dom.close()
        bus.stop()


@pytest.mark.parametrize("receiver", ["port", "reference"])
def test_ack_timeout_falls_back_by_value_exactly_once(receiver):
    """The receiving bridge dies with the attach control frame unread in its
    socket: the port sender's ack timeout re-sends the message serialized,
    and the receiving router's replacement bridge delivers it exactly once."""
    bus = port_core.Bus().start()
    da, db = _domain(port_core), _domain(PKGS[receiver])
    ra = port_core.Router(da, data_plane="attach", attach_mode="copy", pin_lease_s=0.4)
    rb = PKGS[receiver].Router(db, data_plane="attach", attach_mode="copy", pin_lease_s=0.4)
    try:
        for r, pkg in ((ra, port_core), (rb, PKGS[receiver])):
            r.add_remote("link", bus.path)
            r.add_route("xhost/", "link")
            r.activate(pkg.POINT_CLOUD2, TOPIC)
        pub = da.create_publisher(port_core.POINT_CLOUD2, TOPIC, depth=8)
        sub = db.create_subscription(PKGS[receiver].POINT_CLOUD2, TOPIC)
        _probe_routers(bus.path, ra, rb)
        _publish(pub, 3, 4096)
        ba = ra.bridges["link"]
        ba.pump_agnocast()
        assert len(ba._awaiting) == 1
        # the FANOUT receipt says the frame reached the receiver's socket
        _pump(ba, lambda: all(aw.need == 1 for aw in ba._awaiting.values()), "the receipt")
        rb.bridges.pop("link").close()                       # dies without reading it
        repl = rb.add_remote("link", bus.path)
        repl.attach(PKGS[receiver].POINT_CLOUD2, TOPIC)
        probe = SubscriptionProbe(bus.path)
        probe.wait(repl.bus)
        probe.close()
        got = []
        _wait(lambda: not ba._awaiting and _take(sub, got) >= 1, "the by-value re-send",
              pump=(ra, rb))
        _quiet((ra, rb))
        _take(sub, got)
        assert got == [(3, _payload(3, 4096).tobytes())]
        assert (ba.ack_timeouts, ba.attach_fallbacks) == (1, 1)
    finally:
        ra.close()
        rb.close()
        db.close()
        da.close()
        bus.stop()


def test_subscription_probe_fails_loudly_without_a_bus_answer():
    """A probe whose token never comes back raises instead of returning."""
    path = f"\0ttr-mute-{secrets.token_hex(6)}"
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    conns = []
    th = threading.Thread(target=lambda: conns.append(srv.accept()[0]), daemon=True)
    th.start()
    cli = port_core.BusClient(path)
    try:
        with pytest.raises(TimeoutError):
            sync_subscriptions(cli, timeout=0.2)
    finally:
        cli.close()
        th.join(5.0)
        for c in conns:
            c.close()
        srv.close()
