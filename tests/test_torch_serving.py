"""The port's serving plane held against the reference's.

``repro_torch.serving`` (hash ring, router, collector, pool, replica) is a
copy of ``repro.serving``; the port's ``InferenceServer`` gains the
reference's ``SERVE_REQ`` ingest and executor wiring, and a replica
process builds the port's server.  The same cases run through both
packages; one ``SERVE_REQ`` stream drives the port's server and the JAX
server to the same tokens and the same admit/drop decisions; and a fleet
of two spawned torch replicas on the CPU, one of them killed mid-run,
delivers every request exactly once with the tokens of one in-process
server.  Every wait has a deadline of 60 s or less."""

import secrets
import time

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.serving as ref_serving
import repro_torch.core as port_core
import repro_torch.serving as port_serving
from repro.configs.qwen2_1_5b import smoke as jax_smoke
from repro.models import Model as JaxModel
from repro.runtime import InferenceServer as JaxServer
from repro_torch.configs import get_smoke_config
from repro_torch.launch import fleet
from repro_torch.models import Model
from repro_torch.models.weights import params_from_numpy
from repro_torch.runtime import InferenceServer, Request
from _port_env import port_test_env  # noqa: F401  (autouse)

PKGS = {"reference": (ref_core, ref_serving), "port": (port_core, port_serving)}


@pytest.fixture(params=list(PKGS))
def plane(request):
    core, serving = PKGS[request.param]
    d = core.Domain.create(f"ts-{secrets.token_hex(4)}", arena_capacity=32 << 20)
    yield core, serving, d
    d.close()


@pytest.fixture()
def port_dom():
    d = port_core.Domain.create(f"ts-{secrets.token_hex(4)}", arena_capacity=32 << 20)
    yield d
    d.close()


# ---------------------------------------------------------------------------
# hash ring, collector, router: both packages, the same cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,vnodes", [(1, 64), (3, 64), (8, 16)])
def test_hash_ring_matches_reference(k, vnodes):
    ref, port = ref_serving.HashRing(range(k), vnodes=vnodes), \
        port_serving.HashRing(range(k), vnodes=vnodes)
    keys = list(range(2000)) + [f"rid-{i}" for i in range(200)]
    assert [port.lookup(x) for x in keys] == [ref.lookup(x) for x in keys]
    if k > 1:
        assert [port.candidates(x, 2) for x in keys[:300]] == \
            [ref.candidates(x, 2) for x in keys[:300]]
        ref.remove(1)
        port.remove(1)
        assert [port.lookup(x) for x in keys] == [ref.lookup(x) for x in keys]


def _row(serving, rid, gen, seq, toks, eos=False):
    return serving.ResRow(rid, gen, seq, np.asarray(toks, np.int32), eos)


def test_collector_reorders_within_window(plane):
    _, serving, dom = plane
    c = serving.ResultsCollector(dom)
    try:
        c.ingest(_row(serving, 7, 0, 2, [30]))
        c.ingest(_row(serving, 7, 0, 0, [10]))
        assert c.gaps == 1
        c.ingest(_row(serving, 7, 0, 3, [40], eos=True))
        c.ingest(_row(serving, 7, 0, 1, [20]))      # fills the gap: drains the window
        assert dict(c.pop_completed()) == {7: [10, 20, 30, 40]}
        assert c.stats()["open_streams"] == 0
    finally:
        c.close()


def test_collector_drops_duplicates(plane):
    _, serving, dom = plane
    c = serving.ResultsCollector(dom)
    try:
        for seq, tok in [(0, 1), (0, 1), (2, 3), (2, 3), (1, 2)]:
            c.ingest(_row(serving, 1, 0, seq, [tok]))
        c.ingest(_row(serving, 1, 0, 3, [4], eos=True))
        c.ingest(_row(serving, 1, 0, 1, [2]))          # after completion
        assert dict(c.pop_completed()) == {1: [1, 2, 3, 4]}
        assert c.duplicates == 3 and c.n_completed == 1
    finally:
        c.close()


def test_collector_generation_supersede(plane):
    _, serving, dom = plane
    done = []
    c = serving.ResultsCollector(dom, on_complete=lambda rid, t: done.append((rid, t)))
    try:
        c.ingest(_row(serving, 5, 0, 0, [1]))
        c.ingest(_row(serving, 5, 0, 1, [2]))
        c.ingest(_row(serving, 5, 1, 0, [10]))          # the replay supersedes
        c.ingest(_row(serving, 5, 0, 2, [3]))           # stale generation
        c.ingest(_row(serving, 5, 1, 1, [20], eos=True))
        assert c.superseded == 1 and c.stale_gen == 1
        assert done == [(5, [10, 20])]
    finally:
        c.close()


def _drain(serving, subs) -> dict:
    got = {}
    for k, sub in subs.items():
        for ptr in sub.take():
            for r in serving.iter_requests(ptr):
                got[r.rid] = (k, r.gen)
            ptr.release()
    return got


def test_router_remove_shard_replays_exactly_dead_rids(plane):
    _, serving, dom = plane
    router = serving.ShardRouter(dom, range(3), max_new=4)
    subs = {k: dom.create_subscription(serving.SERVE_REQ, router.topic(k)) for k in range(3)}
    rids = [router.submit([i]) for i in range(30)]
    router.flush()
    first = _drain(serving, subs)
    assert sorted(first) == sorted(rids)
    assert all(k == router.ring.lookup(rid) and gen == 0 for rid, (k, gen) in first.items())
    dead = {r for r in rids if router.inflight[r].shard == 1}
    assert set(router.remove_shard(1)) == dead
    router.flush()
    again = _drain(serving, subs)
    assert set(again) == dead
    assert all(k != 1 and gen == 1 for k, gen in again.values())
    assert all(router.inflight[r].gen == 0 for r in set(rids) - dead)
    router.close()


# ---------------------------------------------------------------------------
# SERVE_REQ into the port's server and the JAX server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_weights():
    jcfg, cfg = jax_smoke(), get_smoke_config("qwen2-1.5b")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _streams(srv) -> dict:
    """Route the server's streamed chunks into ``{(rid, gen): tokens}``."""
    out = {}
    srv.stream_sink = lambda rid, gen, seq, toks, eos: out.setdefault(
        (str(rid), gen), []).extend(int(t) for t in toks)
    return out


def test_serve_messages_drive_port_and_jax_servers_alike(port_dom, smoke_weights):
    """One SERVE_REQ stream, published by the port and taken by both
    packages' subscriptions: the same admitted counts for fresh, replayed
    (superseding a live copy), duplicate and stale generations, and the
    same tokens per (rid, generation)."""
    jcfg, jparams, cfg, params = smoke_weights
    kw = dict(slots=2, max_seq=64, page_tokens=16)
    jsrv = JaxServer(JaxModel(jcfg), **kw)
    jsrv.load(jparams)
    srv = InferenceServer(Model(cfg, device="cpu"), **kw)
    srv.load(params)
    jstreams, streams = _streams(jsrv), _streams(srv)
    ref_dom = ref_core.Domain.join(port_dom.name, arena_capacity=8 << 20)
    try:
        pub = port_dom.create_publisher(port_serving.SERVE_REQ, "serve/req/0", depth=8)
        port_sub = port_dom.create_subscription(port_serving.SERVE_REQ, "serve/req/0")
        ref_sub = ref_dom.create_subscription(ref_serving.SERVE_REQ, "serve/req/0")
        rng = np.random.default_rng(11)
        prompt = {rid: rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20)))
                  for rid in range(1, 6)}

        def send(rows):
            loan = pub.borrow_loaded_message()
            port_serving.pack_requests(
                loan, [port_serving.ReqRow(rid, gen, prompt[rid]) for rid, gen in rows],
                stamp=time.monotonic(), max_new=5)
            pub.publish(loan)
            (p,), (r,) = port_sub.take(), ref_sub.take()
            got = (srv.ingest_serve_message(p), jsrv.ingest_serve_message(r))
            p.release()
            r.release()
            pub.reclaim()
            return got

        assert send([(1, 0), (2, 0), (3, 0), (4, 0)]) == (4, 4)
        srv.step_rounds()
        jsrv.step_rounds()                       # rids 1 and 2 are active now
        # replay of active rid 1, duplicates of active 2 and queued 3, fresh 5
        assert send([(1, 1), (2, 0), (3, 0), (5, 0)]) == (2, 2)
        srv.serve()
        jsrv.serve()
        # after completion: duplicate of 1's replay, stale 4, rid 2 one generation up
        assert send([(1, 1), (4, 0), (2, 2)]) == (1, 1)
        srv.serve()
        jsrv.serve()
    finally:
        ref_dom.close()
    assert streams == jstreams
    assert {k for k in streams} == {("1", 0), ("1", 1), ("2", 0), ("2", 2), ("3", 0),
                                    ("4", 0), ("5", 0)}
    assert {rid: r.tokens for rid, r in srv.results.items()} == \
        {rid: r.tokens for rid, r in jsrv.results.items()}
    assert streams[("1", 1)] == srv.results["1"].tokens and len(srv.results) == 5
    st = srv.stats()
    assert st["live_publications"] == 0 and st["free_pages"] == srv.pool.num_pages


def test_serve_row_too_long_raises_before_the_gate(port_dom, smoke_weights):
    """A row the server cannot hold, in the middle of a three-row message,
    is answered with an empty final chunk and its generation is closed; the
    rows before and after it are admitted and served.  A replay of the same
    generation is dropped, and a higher generation whose prompt fits is
    admitted."""
    _, _, cfg, params = smoke_weights
    srv = InferenceServer(Model(cfg, device="cpu"), slots=2, max_seq=16, page_tokens=8)
    srv.load(params)
    chunks = []
    srv.stream_sink = lambda rid, gen, seq, toks, eos: chunks.append(
        (rid, gen, seq, list(toks), eos))
    pub = port_dom.create_publisher(port_serving.SERVE_REQ, "serve/req/0", depth=4)
    sub = port_dom.create_subscription(port_serving.SERVE_REQ, "serve/req/0")

    def send(rows):
        loan = pub.borrow_loaded_message()
        port_serving.pack_requests(
            loan, [port_serving.ReqRow(rid, gen, np.arange(n) % 7) for rid, gen, n in rows],
            stamp=1.0, max_new=2)
        pub.publish(loan)
        (ptr,) = sub.take()
        try:
            return srv.ingest_serve_message(ptr)
        finally:
            ptr.release()
            pub.reclaim()

    assert send([(8, 0, 5), (9, 0, 16), (10, 0, 15)]) == 2
    assert [q.rid for q in srv.queue] == ["8", "10"]
    assert chunks == [("9", 0, 0, [], True)] and srv.stats()["rejected"] == 1
    srv.serve()
    assert sorted(srv.results) == ["10", "8", "9"] and srv.results["9"].tokens == []
    assert len(srv.results["8"].tokens) == len(srv.results["10"].tokens) == 2
    assert send([(9, 0, 16)]) == 0                # a replay of the closed generation
    assert send([(9, 1, 15)]) == 1                # one generation up, and it fits
    srv.serve()
    assert len(srv.results["9"].tokens) == 2 and srv.stats()["rejected"] == 1


def test_ingest_message_token_batch(port_dom, smoke_weights):
    """``ingest_message``: each row of a TOKEN_BATCH is one request, copied
    out of the arena before the message is released."""
    _, _, cfg, params = smoke_weights
    srv = InferenceServer(Model(cfg, device="cpu"), slots=2, max_seq=64, page_tokens=16)
    srv.load(params)
    pub = port_dom.create_publisher(port_core.TOKEN_BATCH, "tokens", depth=4)
    sub = port_dom.create_subscription(port_core.TOKEN_BATCH, "tokens")
    rows = [np.arange(n, dtype=np.int32) % cfg.vocab_size for n in (3, 9, 64, 17)]
    loan = pub.borrow_loaded_message()
    for r in rows:
        loan.tokens.extend(r)
        loan.row_lengths.extend(np.array([len(r)], np.int32))
    pub.publish(loan)
    (ptr,) = sub.take()
    assert srv.ingest_message(ptr, max_new=3) == 3   # the 64-token row does not fit
    ptr.release()
    assert pub.reclaim() == 1                    # the arena bytes are free again
    assert [q.tokens.tolist() for q in srv.queue] == [rows[i].tolist() for i in (0, 1, 3)]
    res = srv.serve()
    assert sorted(res) == ["ingest-1", "ingest-2", "ingest-3", "ingest-4"]
    assert res["ingest-3"].tokens == [] and res["ingest-3"].prompt_len == 64
    assert all(len(res[f"ingest-{i}"].tokens) == 3 for i in (1, 2, 4))


# ---------------------------------------------------------------------------
# the port's servers on an executor, in one process
# ---------------------------------------------------------------------------


def test_serving_end_to_end_in_process(port_dom, smoke_weights):
    """Router -> two port ``InferenceServer`` shards on one EventExecutor
    (``attach_executor`` with the serve-row ingest) -> collector: every rid
    once, with the tokens one server gives the same prompts alone."""
    _, _, cfg, params = smoke_weights
    K, N, MAX_NEW = 2, 8, 5
    dom = port_dom
    router = port_serving.ShardRouter(dom, range(K), max_new=MAX_NEW)
    collector = port_serving.ResultsCollector(
        dom, on_complete=lambda rid, t: router.complete(rid), on_progress=router.touch)
    ex = port_core.EventExecutor(name="serve-test")
    res_pub = dom.create_publisher(port_serving.SERVE_RES, "serve/res", depth=32)
    servers = []
    for k in range(K):
        sub = dom.create_subscription(port_serving.SERVE_REQ, router.topic(k))
        srv = InferenceServer(Model(cfg, device="cpu"), slots=2, max_seq=64, page_tokens=16)
        srv.load(params)
        srv.keep_results = False
        rows = []

        def sink(rid, gen, seq, toks, eos, rows=rows):
            rows.append(port_serving.ResRow(int(rid), gen, seq, np.asarray(toks, np.int32), eos))

        def flush(rows=rows, k=k):
            if rows:
                loan = res_pub.borrow_loaded_message()
                port_serving.pack_results(loan, rows, shard=k, depth=0, stamp=time.monotonic())
                res_pub.publish_blocking(loan, timeout=10)
                rows.clear()

        srv.stream_sink = sink
        srv.attach_executor(ex, sub, max_new=MAX_NEW, round_period_s=0.001,
                            ingest=lambda ptr, srv=srv: srv.ingest_serve_message(ptr),
                            on_round_end=flush)
        servers.append(srv)
    collector.attach_executor(ex)
    rng = np.random.default_rng(3)
    prompts = {router.submit(p): p
               for p in [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 30)))
                         for _ in range(N)]}
    router.flush()
    ex.spin(until=lambda: collector.n_completed >= N, timeout=60)
    ex.shutdown()
    results = dict(collector.pop_completed())
    router.close()
    collector.close()
    alone = InferenceServer(Model(cfg, device="cpu"), slots=2, max_seq=64, page_tokens=16)
    alone.load(params)
    for rid, p in prompts.items():
        alone.submit(Request(rid=str(rid), tokens=p, max_new=MAX_NEW))
    want = alone.serve()
    assert sorted(results) == sorted(prompts)
    assert all(results[rid] == want[str(rid)].tokens for rid in prompts)
    assert collector.duplicates == 0 and not router.inflight
    assert all(not s.results and s.idle for s in servers)   # streamed, not kept


# ---------------------------------------------------------------------------
# spawned torch replicas
# ---------------------------------------------------------------------------


def test_fleet_of_two_cpu_replicas_one_killed_exactly_once():
    """``ReplicaPool`` spawns two torch replicas (smoke width, CPU); one is
    SIGKILLed after its first result chunk and its rids replay on the
    survivor.  Every request completes exactly once, its stream whole, with
    the tokens one in-process server gives; both replicas report their
    device through the metrics plane."""
    out = fleet.run(size="smoke", device="cpu", replicas=2, requests=6, max_new=4,
                    max_seq=64, kill_one=True, ready_timeout=60.0, timeout=60.0)
    assert fleet.exactly_once(out), out
    assert out["killed"] is not None and out["dead"] == [out["killed"]]
    assert out["replays"] > 0 and out["collector"]["superseded"] > 0
    want = fleet.serve_in_process(out["model_kwargs"], out["prompts"], max_new=4,
                                  slots=4, max_seq=64)
    assert out["tokens"] == want
    assert sorted(out["replica_metrics"]) == [0, 1]
    assert all(m["device"] == "cpu" for m in out["replica_metrics"].values())
    # every request message was taken, and the trace rings timed each one
    assert len(out["pub_take_us"]) >= out["requests"]
    assert all(b > 0 and us > 0 for b, us in out["pub_take_us"])
    assert [n for n, _ in out["ttft_ms"]] == sorted(len(p) for p in out["prompts"].values())


def test_backpressured_replica_keeps_its_lease(port_dom):
    """A consumer that takes a replica's result messages and holds them (as
    a head does while its executor is busy in another callback) fills the
    replica's results ring, and the replica waits in its publish for
    several lease timeouts.  The pool does not declare it dead: the wait
    keeps the lease fresh.  Once the messages are released the stream goes
    on to its final chunk, in order and without duplicates."""
    dom, lease, depth, max_new = port_dom, 2.0, 4, 40
    pool = port_serving.ReplicaPool(dom, [0], depth=depth, lease_timeout_s=lease)
    router = None
    held, seqs = [], []
    try:
        pool.wait_ready(timeout=60.0)
        res = dom.create_subscription(port_serving.SERVE_RES, pool.res_topic_for(0))
        router = port_serving.ShardRouter(dom, [0], max_new=max_new)
        rid = router.submit([1, 2, 3])
        assert router.flush(timeout=10.0) == 1

        def take(keep):
            for ptr in res.take():
                seqs.extend(r.seq for r in port_serving.iter_results(ptr) if r.rid == rid)
                if keep:
                    held.append(ptr)
                else:
                    ptr.release()

        deadline = time.monotonic() + 30.0
        while len(held) < depth:                    # every ring slot held by us
            assert time.monotonic() < deadline, seqs
            take(keep=True)
            time.sleep(0.002)
        until = time.monotonic() + 2.5 * lease      # the replica now waits
        while time.monotonic() < until:
            assert pool.poll() == []
            time.sleep(0.05)
        stalled_at = len(seqs)
        for ptr in held:
            ptr.release()
        held.clear()
        deadline = time.monotonic() + 30.0
        while not seqs or seqs[-1] != max_new - 1:
            assert time.monotonic() < deadline, seqs
            take(keep=False)
            time.sleep(0.002)
        assert stalled_at < len(seqs) and seqs == sorted(set(seqs))
        assert pool.poll() == []
    finally:
        for ptr in held:
            ptr.release()
        held.clear()
        if router is not None:
            router.close()
        pool.stop(timeout=10.0)


def test_fleet_serves_xlstm_replicas_on_cpu():
    """The xLSTM family behind the same fleet (the sLSTM scan's path on the
    card): two smoke-width replicas, tokens equal to one in-process server."""
    out = fleet.run(arch="xlstm-1.3b", size="smoke", device="cpu", replicas=2, requests=4,
                    max_new=3, max_seq=64, ready_timeout=60.0, timeout=60.0)
    assert fleet.exactly_once(out), out
    assert out["tokens"] == fleet.serve_in_process(out["model_kwargs"], out["prompts"],
                                                   max_new=3, slots=4, max_seq=64)


def test_replica_model_config_takes_only_its_keys():
    """A torch replica's ``model_kwargs`` name the arch, size, dtype and
    device; any other key raises instead of reshaping the model."""
    from repro_torch.serving.replica import model_config

    cfg, device = model_config(dict(arch="qwen2-1.5b", size="smoke", dtype="bfloat16",
                                    device="cpu"))
    assert device == "cpu" and cfg.param_dtype == cfg.compute_dtype == "bfloat16"
    assert cfg.num_layers == get_smoke_config("qwen2-1.5b").num_layers
    with pytest.raises(ValueError, match="num_layers"):
        model_config(dict(size="smoke", num_layers=1))


def test_replica_build_failure_raises_in_the_pool():
    """A torch replica asked for the card on a machine without one fails
    its build, never reports ready, and the pool raises: nothing falls back
    to the CPU or to an echo server."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here, so the build would succeed")
    dom = port_core.Domain.create(f"ts-{secrets.token_hex(4)}", arena_capacity=8 << 20)
    try:
        pool = port_serving.ReplicaPool(dom, [0], model="torch",
                                        model_kwargs=dict(size="smoke"))
        try:
            with pytest.raises(RuntimeError, match="exited"):
                pool.wait_ready(timeout=60.0)
        finally:
            pool.stop(timeout=10.0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fleet.run(size="smoke", replicas=1, requests=1)
    finally:
        dom.close()
