"""The port's flow aggregator held against the reference's, and the fleet's
flow gates.

``repro_torch.obs.flows`` is a copy of ``repro.obs.flows``; the trace rings
are the reference's layout, so both aggregators read the same rings.  The
tests write rings through either package's pub/sub (and across a bridge
hop between the packages) and require equal flows, breakdowns and stats;
a writer SIGKILLed mid-flow leaves a truncated flow, read without a hang;
``launch.fleet`` on the CPU passes its flow gates with and without a
replica killed; and planted faults (an eos record dropped, a stage out of
order, a truncated flow never replayed) fail them."""

import os
import secrets
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro.obs.flows as ref_flows
import repro.obs.trace as ref_trace
import repro_torch.core as port_core
import repro_torch.obs.flows as port_flows
import repro_torch.obs.trace as port_trace
from _port_env import port_test_env  # noqa: F401  (autouse)
from repro_torch.core.transport import SubscriptionProbe
from repro_torch.launch import fleet

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"reference": (ref_core, ref_trace), "port": (port_core, port_trace)}
S = port_trace.Stage


@pytest.fixture()
def traced(monkeypatch):
    """Tracing on; every domain named through ``new`` has its writer rings
    closed and unlinked at the end."""
    monkeypatch.setenv("AGNOCAST_TRACE", "1")
    monkeypatch.setenv("AGNOCAST_TRACE_CAP", "4096")
    names = []

    def new(prefix="tfl"):
        names.append(f"{prefix}-{secrets.token_hex(4)}")
        return names[-1]

    yield new
    for name in names:
        for trace in (ref_trace, port_trace):
            tr = trace._tracers.pop(name, None)
            if tr is not None:
                tr.close()
        port_trace.purge(name)


def _flows_view(flows) -> list:
    return [(f.trace_id, f.records, f.serving, f.complete, f.truncated, f.monotonic(),
             f.breakdown(), f.stage_times(), sorted(f.pids)) for f in flows]


def _same_flows(name: str) -> list:
    """Both packages' aggregators over the rings of ``name``: equal flows,
    breakdowns and stats.  Returns the port's flows."""
    pa, ra = port_flows.FlowAggregator(name), ref_flows.FlowAggregator(name)
    try:
        got, want = pa.collect(), ra.collect()
        assert got and _flows_view(got) == _flows_view(want)
        assert pa.breakdown_stats() == ra.breakdown_stats()
        serving = [f for f in got if f.serving]
        assert pa.breakdown_stats(serving) == ra.breakdown_stats(serving)
        assert _flows_view(pa.message_flows()) == _flows_view(ra.message_flows())
        assert _flows_view(pa.serving_flows()) == _flows_view(ra.serving_flows())
        return got
    finally:
        pa.close()
        ra.close()


def _serving_records(tracer, tid: int, rid: int, chunks: int, eos: bool) -> None:
    tracer.emit(tid, 0, S.SERVE_ENQ, arg=rid)
    tracer.emit(tid, 0, S.SERVE_FLUSH, arg=rid)
    tracer.emit(tid, 1, S.SERVE_ENQ, arg=rid)
    for c in range(chunks):
        tracer.emit(tid, 2, S.SERVE_REASM, arg=c,
                    flags=port_trace.FLAG_EOS if eos and c == chunks - 1 else 0)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_aggregators_agree_over_pubsub_rings(traced, writer):
    """Rings written by one package's publisher, executor and subscriber (and
    serving records on the same ring): the two aggregators rebuild the same
    flows, complete and truncated alike."""
    core, trace = PKGS[writer]
    dom = core.Domain.create(traced(), arena_capacity=4 << 20)
    try:
        pub = dom.create_publisher(core.POINT_CLOUD2, "tfl/t", depth=8)
        sub = dom.create_subscription(core.POINT_CLOUD2, "tfl/t")
        got = []
        with core.EventExecutor(name="tfl") as ex:
            ex.add_subscription(sub, lambda ptr: got.append(int(np.asarray(ptr.data)[0])))
            for i in range(6):
                m = pub.borrow_loaded_message()
                m.data.extend(np.full(64, i, np.uint8))
                pub.publish(m)
                ex.spin(until=lambda n=i + 1: len(got) >= n, timeout=10.0)
        assert got == list(range(6))
        m = pub.borrow_loaded_message()          # published, never taken: truncated
        m.data.extend(np.zeros(8, np.uint8))
        pub.publish(m)
        tr = trace.tracer_for(dom.name)
        _serving_records(tr, 7001, 11, 3, eos=True)
        _serving_records(tr, 7002, 12, 2, eos=False)
        flows = _same_flows(dom.name)
        msg = [f for f in flows if not f.serving]
        assert sum(f.complete for f in msg) == 6 and sum(f.truncated for f in msg) == 1
        for f in msg:
            if f.complete:
                assert set(f.breakdown()) >= {"publish_to_wakeup", "take_to_callback", "e2e"}
        by_tid = {f.trace_id: f for f in flows}
        assert by_tid[7001].complete and by_tid[7002].truncated
    finally:
        dom.close()


def test_aggregators_agree_across_a_bridge_hop(traced):
    """A message routed from a port domain to a reference domain: each
    domain's rings give equal flows in both aggregators, and the two halves
    of every flow (one trace id) pair a bridge_out in the sender's rings
    with a bridge_in in the receiver's."""
    bus = port_core.Bus().start()
    da = port_core.Domain.create(traced(), arena_capacity=8 << 20)
    db = ref_core.Domain.create(traced(), arena_capacity=8 << 20)
    routers = []
    try:
        for core, dom in ((port_core, da), (ref_core, db)):
            r = core.Router(dom, data_plane="parts")
            r.add_remote("link", bus.path)
            r.add_route("tfl/", "link")
            r.activate(core.POINT_CLOUD2, "tfl/x")
            routers.append(r)
        probe = SubscriptionProbe(bus.path)
        for r in routers:
            probe.wait(r.bridges["link"].bus)
        probe.close()
        pub = da.create_publisher(port_core.POINT_CLOUD2, "tfl/x", depth=8)
        sub = db.create_subscription(ref_core.POINT_CLOUD2, "tfl/x")
        got = []
        for i in range(4):
            m = pub.borrow_loaded_message()
            m.data.extend(np.full(256, i, np.uint8))
            pub.reclaim()
            pub.publish_blocking(m, timeout=10.0)
            deadline = time.monotonic() + 20.0
            while len(got) <= i:
                assert time.monotonic() < deadline, f"message {i} never arrived"
                for r in routers:
                    r.spin_once(0.005)
                for ptr in sub.take():
                    got.append(int(np.asarray(ptr.data)[0]))
                    ptr.release()
        assert got == [0, 1, 2, 3]
        halves = {}
        for dom in (da, db):
            for f in _same_flows(dom.name):
                halves.setdefault(f.trace_id, []).append(f)
        crossed = [fs for fs in halves.values() if len(fs) == 2]
        assert len(crossed) == 4
        for a, b in crossed:
            out, inn = a.first(S.BRIDGE_OUT), b.first(S.BRIDGE_IN)
            assert out is not None and inn is not None and out[2] == inn[2] == 1
            assert a.first(S.PUBLISH, 0)[1] <= out[1] <= inn[1] <= b.first(S.RELEASE, 1)[1]
    finally:
        for r in routers:
            r.close()
        db.close()
        da.close()
        bus.stop()


_WRITER = """
import os, sys, time
sys.path.insert(0, {src!r})
from repro_torch.obs import trace as T
tr = T.tracer_for({name!r})
for st in (T.Stage.PUBLISH, T.Stage.NOTIFY, T.Stage.TAKE, T.Stage.CB_START, T.Stage.CB_END,
           T.Stage.RELEASE):
    tr.emit(41, 0, st)
tr.emit(42, 0, T.Stage.PUBLISH)
tr.emit(42, 0, T.Stage.NOTIFY)
tr.emit(43, 0, T.Stage.SERVE_ENQ, arg=5)
tr.emit(43, 0, T.Stage.SERVE_FLUSH, arg=5)
tr.emit(43, 1, T.Stage.SERVE_ENQ, arg=5)
tr.emit(43, 2, T.Stage.SERVE_REASM, arg=0)
print("ready", flush=True)
time.sleep(120)
"""


def test_a_writer_killed_mid_flow_leaves_truncated_flows(traced):
    """A process SIGKILLed with flows half written: its ring outlives it, and
    the aggregator reads the finished flow complete and the others truncated
    at once."""
    name = traced("tfl-kill")
    env = dict(os.environ, AGNOCAST_TRACE="1")
    proc = subprocess.Popen([sys.executable, "-c",
                             _WRITER.format(src=str(ROOT / "src"), name=name)],
                            stdout=subprocess.PIPE, env=env, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60.0)
        assert ready and proc.stdout.readline().strip() == "ready", "the writer never started"
        proc.send_signal(signal.SIGKILL)
        assert proc.wait(30.0) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30.0)
        proc.stdout.close()
    t0 = time.monotonic()
    flows = {f.trace_id: f for f in _same_flows(name)}
    assert time.monotonic() - t0 < 10.0
    assert set(flows) == {41, 42, 43}
    assert flows[41].complete and flows[42].truncated
    assert flows[43].serving and flows[43].truncated
    assert flows[42].pids == {proc.pid}


# ---------------------------------------------------------------------------
# the fleet's flow gates
# ---------------------------------------------------------------------------


def _pub_take_us_by_scan(dom_name: str, prompt_len_by_rid: dict) -> list:
    """The fleet's publish-to-take reading as it was computed before the
    flows: its own scan of every ring of the domain."""
    records = []
    for name in port_trace.ring_names(dom_name):
        reader = port_trace.TraceReader(name)
        records.extend(reader.records())
        reader.close()
    return fleet._pub_take_us(records, prompt_len_by_rid, os.getpid())


@pytest.mark.parametrize("kill_one", [False, True], ids=["no-fault", "kill-one"])
def test_fleet_passes_its_flow_gates_on_cpu(monkeypatch, kill_one):
    """``launch.fleet --size smoke --device cpu --check [--kill-one]``: the
    flow gates pass, every request has one complete serving flow, and the
    publish-to-take reading from the aggregator's records equals the one a
    second scan of the rings gives."""
    kept = []
    purge = fleet._trace.purge
    monkeypatch.setattr(fleet._trace, "purge", kept.append)
    try:
        out = fleet.main(["--size", "smoke", "--device", "cpu", "--check"]
                         + (["--kill-one"] if kill_one else []))
        plen = {fs[0]["rid"] & 0xFFFF_FFFF: len(out["prompts"][name])
                for name, fs in out["flows"]["by_rid"].items()}
        assert out["pub_take_us"] == _pub_take_us_by_scan(kept[0], plen)
    finally:
        for name in kept:
            purge(name)
    fl = out["flows"]
    assert fleet.flow_failures(fl, kill_one=kill_one) == []
    assert fl["complete"] == out["requests"] and not fl["orphans"]
    assert set(fl["stats"]) >= set(fleet.SERVE_STAGES) | {"e2e"}
    assert all(v["n"] == out["requests"] for k, v in fl["stats"].items() if k != "stream")
    if kill_one:
        assert out["killed"] is not None and fl["replayed"] and fl["truncated"] >= 1
    else:
        assert fl["truncated"] == 0 and fl["stage_sum_vs_head"] <= fleet.STAGE_SUM_TOL


def _flow(tid: int, rid: int, t0: int, *, chunks: int = 3, eos: bool = True,
          replica_at: int = 5_000) -> port_flows.Flow:
    recs = [(tid, t0, 0, S.SERVE_ENQ, 0, rid, 100), (tid, t0 + 1_000, 0, S.SERVE_FLUSH, 0, rid, 100),
            (tid, t0 + replica_at, 1, S.SERVE_ENQ, 0, rid, 200)]
    for c in range(chunks):
        last = c == chunks - 1
        recs.append((tid, t0 + 10_000 + 1_000 * c, 2, S.SERVE_REASM,
                     port_trace.FLAG_EOS if eos and last else 0, c, 100))
    recs.sort(key=lambda r: (r[1], r[2], r[3]))
    return port_flows.Flow(tid, recs)


def _report(flows, replayed=()):
    name_of = {rid: f"req-{rid}" for rid in (1, 2, 3)}
    starts = {f.records[0][5]: f.records[0][1] for f in flows}
    submitted = {rid: starts.get(rid, 0) / 1e9 - 1e-7 for rid in name_of}
    done = {rid: (starts.get(rid, 0) + 12_000) / 1e9 + 1e-7 for rid in name_of}
    return fleet.flow_report(flows, name_of, submitted, done, set(replayed))


def test_planted_faults_fail_the_flow_gates():
    sound = [_flow(10 + rid, rid, 1_000_000 * rid) for rid in (1, 2, 3)]
    assert fleet.flow_failures(_report(sound), kill_one=False) == []
    assert fleet.flow_failures(_report(sound), kill_one=True) == []

    no_eos = sound[:2] + [_flow(13, 3, 3_000_000, eos=False)]
    assert any("req-3" in f for f in fleet.flow_failures(_report(no_eos), kill_one=False))
    assert any("req-3" in f for f in fleet.flow_failures(_report(no_eos), kill_one=True))

    reordered = sound[:2] + [_flow(13, 3, 3_000_000, replica_at=500)]   # before the flush
    faults = fleet.flow_failures(_report(reordered), kill_one=False)
    assert any("req-3" in f and "negative" in f for f in faults), faults

    # kill-one: a truncated attempt is sound only for a replayed request
    replay = sound + [_flow(23, 3, 2_500_000, eos=False)]
    assert fleet.flow_failures(_report(replay, replayed=[3]), kill_one=True) == []
    assert any("never replayed" in f
               for f in fleet.flow_failures(_report(replay), kill_one=True))
    assert any("req-3" in f for f in fleet.flow_failures(_report(replay, [3]), kill_one=False))
    twice = sound + [_flow(23, 3, 2_500_000)]
    assert any("2 complete" in f for f in fleet.flow_failures(_report(twice, [3]), kill_one=True))

    # the stage sum against the head's own clock
    slow = _report(sound)
    slow["head_mean_s"] *= 1.5
    slow["stage_sum_vs_head"] = abs(slow["stage_sum_mean_s"] - slow["head_mean_s"]) / \
        slow["head_mean_s"]
    assert any("stage sum" in f for f in fleet.flow_failures(slow, kill_one=False))
