"""The port's copies of the shm planes held against the originals.

``repro_torch.core`` (arena, registry, messages, smart pointer, topics,
executor) and ``repro_torch.obs`` (trace rings, metrics) are copies, not
imports, of the reference's modules of the same names.  Their layouts,
magic numbers and shm names are the reference's, so the tests hold the
copy faithful by interoperating with the original: a message published
through one package is taken, byte for byte, by the other in the same
process, and the same seeded operations give the same results in both."""

import dataclasses
import os
import secrets
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.arena as ref_arena
import repro.core.registry as ref_registry
import repro.obs.metrics as ref_metrics
import repro.obs.trace as ref_trace
import repro.serving.messages as ref_serving_messages
import repro_torch.core as port_core
import repro_torch.core.arena as port_arena
import repro_torch.core.registry as port_registry
import repro_torch.obs.metrics as port_metrics
import repro_torch.obs.trace as port_trace
import repro_torch.serving.messages as port_serving_messages
from _port_env import port_test_env  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"reference": ref_core, "port": port_core}


def _domain(pkg, name=None):
    return pkg.Domain.create(name or f"tt-{secrets.token_hex(4)}", arena_capacity=16 << 20)


@pytest.fixture()
def dom_pair():
    """One domain created by the port and joined by the reference (the
    first) or the other way round: two handles on one shared plane."""
    made = []

    def make(creator, joiner):
        a = _domain(creator)
        b = joiner.Domain.join(a.name, arena_capacity=16 << 20)
        made.extend([b, a])                   # the joiner closes first
        return a, b

    yield make
    for d in made:
        d.close()


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _schema(mtype) -> tuple:
    return (mtype.name, [(k, type(v).__name__, dataclasses.asdict(v))
                         for k, v in mtype.fields.items()])


def test_layout_constants_match_reference():
    for name in ("ENTRY_DT", "TOPIC_DT", "HASH_DT", "JOURNAL_DT"):
        got, want = getattr(port_registry, name), getattr(ref_registry, name)
        assert got == want and got.descr == want.descr, name
    for name in ("MAX_TOPICS", "MAX_PUBS", "MAX_SUBS", "DEPTH_MAX", "HASH_CAP", "_MAGIC"):
        assert getattr(port_registry, name) == getattr(ref_registry, name), name
    for name in ("_ALIGN", "_HEADER", "_MAGIC"):
        assert getattr(port_arena, name) == getattr(ref_arena, name), name
    assert (port_trace._MAGIC, port_trace._HDR.format, port_trace._HDR_SIZE,
            port_trace._REC.format, port_trace.REC_SIZE, port_trace.DEFAULT_CAP,
            port_trace.FLAG_EOS) == (
        ref_trace._MAGIC, ref_trace._HDR.format, ref_trace._HDR_SIZE, ref_trace._REC.format,
        ref_trace.REC_SIZE, ref_trace.DEFAULT_CAP, ref_trace.FLAG_EOS)
    assert port_trace.STAGE_NAMES == ref_trace.STAGE_NAMES
    assert (port_metrics._MX_MAGIC, port_metrics._MX_HDR.format, port_metrics._MX_SIZE) == (
        ref_metrics._MX_MAGIC, ref_metrics._MX_HDR.format, ref_metrics._MX_SIZE)
    # the shm and /tmp names the two packages derive for one domain
    assert port_trace.ring_name("d", 7) == ref_trace.ring_name("d", 7)
    assert port_metrics.export_name("d", 7) == ref_metrics.export_name("d", 7)
    assert port_registry.domain_lock_path("d") == ref_registry.domain_lock_path("d")
    assert port_registry.topic_lock_path("d", 3) == ref_registry.topic_lock_path("d", 3)


@pytest.mark.parametrize("name", ["POINT_CLOUD2", "TOKEN_BATCH", "BYTES_BLOB", "SERVE_REQ",
                                  "SERVE_RES"])
def test_message_schemas_match_reference(name):
    if name.startswith("SERVE"):
        got, want = getattr(port_serving_messages, name), getattr(ref_serving_messages, name)
    else:
        got, want = getattr(port_core, name), getattr(ref_core, name)
    assert _schema(got) == _schema(want)


# ---------------------------------------------------------------------------
# one plane, two packages
# ---------------------------------------------------------------------------


def _ragged_rows(seed: int) -> list[np.ndarray]:
    """Unsized rows of 1-4096 tokens, both ends included."""
    rng = np.random.default_rng(seed)
    lens = [1, 4096] + [int(n) for n in rng.integers(1, 4097, 6)]
    return [rng.integers(0, 2**31 - 1, n, dtype=np.int64).astype(np.int32) for n in lens]


@pytest.mark.parametrize("creator,taker", [("port", "reference"), ("reference", "port")])
def test_ragged_message_crosses_packages_byte_for_byte(dom_pair, creator, taker):
    """A TOKEN_BATCH published through one package's Domain is taken by
    the other's subscription in the same process: the same bytes, read
    zero-copy out of the publisher's arena."""
    pub_dom, sub_dom = dom_pair(PACKAGES[creator], PACKAGES[taker])
    sub = sub_dom.create_subscription(PACKAGES[taker].TOKEN_BATCH, "cross/tokens")
    pub = pub_dom.create_publisher(PACKAGES[creator].TOKEN_BATCH, "cross/tokens", depth=4)
    rows = _ragged_rows(1 if creator == "port" else 2)
    loan = pub.borrow_loaded_message()
    for r in rows:
        loan.tokens.extend(r)
        loan.row_lengths.extend(np.array([len(r)], np.int32))
    loan.set("stamp", 12.5)
    loan.set("step", 7)
    pub.publish(loan)
    ptrs = sub.take()
    assert len(ptrs) == 1
    ptr = ptrs[0]
    flat = np.concatenate(rows)
    got = np.asarray(ptr.tokens)
    assert got.tobytes() == flat.tobytes()
    assert np.asarray(ptr.row_lengths).tolist() == [len(r) for r in rows]
    assert float(ptr.get("stamp")) == 12.5 and int(ptr.get("step")) == 7
    assert not got.flags.writeable            # a read-only view, not a copy
    ptr.release()
    assert pub.reclaim() == 1


@pytest.mark.parametrize("creator,taker", [("port", "reference"), ("reference", "port")])
def test_serve_request_rows_cross_packages(dom_pair, creator, taker):
    """SERVE_REQ packed by one package's ``pack_requests`` and read back by
    the other's ``iter_requests``: rids, generations, trace ids, tokens."""
    msgs = {"port": port_serving_messages, "reference": ref_serving_messages}
    pub_dom, sub_dom = dom_pair(PACKAGES[creator], PACKAGES[taker])
    sub = sub_dom.create_subscription(msgs[taker].SERVE_REQ, "serve/req/0")
    pub = pub_dom.create_publisher(msgs[creator].SERVE_REQ, "serve/req/0", depth=4)
    rows = [msgs[creator].ReqRow(1000 + i, i % 3, r, 77 + i)
            for i, r in enumerate(_ragged_rows(3))]
    loan = pub.borrow_loaded_message()
    msgs[creator].pack_requests(loan, rows, stamp=3.0, max_new=9)
    pub.publish(loan)
    (ptr,) = sub.take()
    got = list(msgs[taker].iter_requests(ptr))
    assert int(ptr.get("max_new")) == 9
    ptr.release()
    assert [(g.rid, g.gen, g.tid) for g in got] == [(r.rid, r.gen, r.tid) for r in rows]
    for g, r in zip(got, rows):
        assert g.tokens.tobytes() == r.tokens.tobytes() and g.tokens.flags.writeable
    pub.reclaim()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_loan_publish_take_release_returns_arena_bytes(pkg):
    core = PACKAGES[pkg]
    dom = _domain(core)
    try:
        free0, live0 = dom.arena.free_bytes, dom.arena.live_bytes
        sub = dom.create_subscription(core.TOKEN_BATCH, "t")
        pub = dom.create_publisher(core.TOKEN_BATCH, "t", depth=8)
        for seed in range(3):
            loan = pub.borrow_loaded_message()
            for r in _ragged_rows(seed):
                loan.tokens.extend(r)
            pub.publish(loan)
        assert dom.arena.live_bytes > live0
        ptrs = sub.take()
        assert len(ptrs) == 3
        held = ptrs[0].clone()               # two references to one message
        for p in ptrs:
            p.release()
        assert pub.reclaim() == 2            # the cloned one is still held
        held.release()
        assert pub.reclaim() == 1
        assert (dom.arena.free_bytes, dom.arena.live_bytes) == (free0, live0)
    finally:
        dom.close()


def test_release_landing_mid_fold_is_kept(monkeypatch):
    """A subscriber's lock-free release that lands while the publisher folds
    the release bytes (after the fold read them, before it zeroes them) is
    kept for the next fold: the message's held bit clears, and the ring slot
    it occupies can be published onto again.  The port's fold zeroes only
    the bytes it read; the reference's zeroes them all and loses this
    release, and the publish onto its slot then blocks for good."""
    dom = _domain(port_core)
    try:
        sub = dom.create_subscription(port_core.TOKEN_BATCH, "t")
        pub = dom.create_publisher(port_core.TOKEN_BATCH, "t", depth=2)
        for _ in range(2):
            pub.publish(pub.borrow_loaded_message())
        first, second = sub.take()
        first.release()                          # a byte store, folded by the next publish
        fold_read = port_registry._rel_masks
        calls = []

        def racing(rel):
            out = fold_read(rel)
            if not calls:
                calls.append(1)
                second.release()                 # lands between the read and the zeroing
            return out

        monkeypatch.setattr(port_registry, "_rel_masks", racing)
        pub.publish(pub.borrow_loaded_message())  # onto the first message's slot: folds
        assert calls, "the publish did not fold"
        monkeypatch.setattr(port_registry, "_rel_masks", fold_read)
        pub.publish(pub.borrow_loaded_message())  # onto the second message's slot
        assert len(sub.take()) == 2
    finally:
        dom.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_executor_timer_and_subscription_order(pkg):
    """One executor over two topics and a timer: each topic's messages are
    dispatched once each in seq order, and the timer fires periodically."""
    core = PACKAGES[pkg]
    dom = _domain(core)
    try:
        pubs = [dom.create_publisher(core.BYTES_BLOB, f"ex/{i}", depth=16) for i in range(2)]
        subs = [dom.create_subscription(core.BYTES_BLOB, f"ex/{i}") for i in range(2)]
        got, ticks = [], []
        with core.EventExecutor() as ex:
            for i, s in enumerate(subs):
                ex.add_subscription(
                    s, lambda ptr, i=i: got.append((i, ptr.seq, int(np.asarray(ptr.data)[0]))))
            ex.add_timer(0.01, lambda: ticks.append(time.monotonic()))
            for n in range(6):
                for i, p in enumerate(pubs):
                    m = p.borrow_loaded_message()
                    m.data.extend(np.full(n + 1, 10 * i + n, np.uint8))
                    p.publish(m)
            ex.spin(until=lambda: len(got) >= 12 and len(ticks) >= 3, timeout=30)
        for i in range(2):
            mine = [(seq, v) for t, seq, v in got if t == i]
            assert [v for _, v in mine] == [10 * i + n for n in range(6)]
            assert [s for s, _ in mine] == sorted(s for s, _ in mine)
        assert len(ticks) >= 3 and ticks == sorted(ticks)
        for p in pubs:
            p.reclaim()
        assert dom.arena.live_bytes == 0
    finally:
        dom.close()


def test_metrics_export_crosses_packages():
    """A snapshot the port's exporter publishes is read by the reference's
    ``read_exports`` and the other way round (one shm segment format)."""
    name = f"tt-{secrets.token_hex(4)}"
    reg = port_metrics.MetricsRegistry()
    c = reg.counter("kernel.rmsnorm.launches")
    c.inc(57)
    exp = port_metrics.MetricsExporter(name, reg=reg)
    try:
        exp.publish()
        assert ref_metrics.read_exports(name) == {os.getpid(): {"kernel.rmsnorm.launches": 57}}
        assert port_metrics.read_exports(name) == ref_metrics.read_exports(name)
    finally:
        exp.close(unlink=True)
    assert port_metrics.read_exports(name) == {}


def test_port_planes_import_no_jax_or_reference_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['repro_torch.core.registry', 'repro_torch.core.executor', "
        "'repro_torch.serving.pool', 'repro_torch.launch.fleet', 'repro_torch.obs.trace']\n"
        "missing = [m for m in need if m not in sys.modules]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(missing, bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []", out.stdout
