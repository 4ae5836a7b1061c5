"""Serving fleet: K torch replicas behind the zero-copy pub/sub planes.

    PYTHONPATH=src python -m repro_torch.launch.fleet [--arch qwen2-1.5b] [--size full]
        [--replicas 2] [--requests 16] [--kill-one] [--device cpu] [--check]

The port's counterpart of the reference's ``fig13_serving.run_once`` as an
entry point.  Clients publish each request as one unsized ``SERVE_REQ``
message through a ``ShardRouter``; K replica processes
(``repro_torch.serving.replica``, spawned by ``ReplicaPool``) take it
zero-copy from the router's shared-memory arena, serve it through the
port's ``InferenceServer`` (on the GPU through the Hopper kernels, or
their plain versions with ``--device cpu``) and stream token chunks back
to a ``ResultsCollector``.  ``--kill-one`` SIGKILLs one replica once every
request routed to it has streamed its first result chunk (it has taken
each of its request messages, so the trace rings time every one); the
router replays its rids on the survivors, one generation up.

A run reports each request's tokens, whether every rid completed exactly
once with a stream of ``max_new`` tokens, the collector's duplicate, gap
and superseded-chunk counts, aggregate tokens/s, client-side TTFT by
prompt length, publish-to-take latency of each request message by its
size, and each replica's kernel launches, device and peak device memory
(from its metrics export).

It also rebuilds every request's serving flow from the run's trace rings
(``repro_torch.obs.flows.FlowAggregator``): the head router's
``serve_enqueue`` and ``serve_flush`` (hop 0), the replica's
``serve_enqueue`` (hop 1) and the collector's ``serve_reassemble`` per
chunk (hop 2, the last one flagged eos).  Its stages, ``enqueue_to_flush``
(the head's buffer), ``flush_to_replica`` (the zero-copy hand-off and the
wait for the replica's next round), ``replica_to_first_chunk`` (admission
and prefill) and ``stream`` (decode), telescope to the flow's
end-to-end time, which the run holds against the head's own clock from
submit to completion.  The rings keep ``TRACE_CAP`` records each; the run
raises if one wrapped.

``--check`` also serves the same prompts with one in-process
``InferenceServer`` on the same weights and compares tokens, and applies
the flow gates (:func:`flow_failures`).

Without a card the run raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time


from repro_torch.core.arena import _new_shm
from repro_torch.core.executor import EventExecutor
from repro_torch.core.topic import Domain
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.flows import FlowAggregator
from repro_torch.serving import ReplicaPool, ResultsCollector, ShardRouter
from repro_torch.serving.replica import model_config

__all__ = ["run", "serve_in_process", "fleet_requests", "exactly_once", "flow_report",
           "flow_failures", "main"]

PROMPT_MIN, PROMPT_MAX = 16, 384
ROUND_PERIOD_S = 0.0005   # pause between a replica's rounds: each ends in a device sync
STALL_REPLAY_S = 30.0     # replay a rid with no chunk for this long
JANITOR_S = 0.05
# The head never waits long on a shard whose request ring is full: rows stay
# buffered and the janitor retries.  While the head waits in a flush it runs
# no collector callback, so the result messages it has taken stay held and a
# replica that publishes onto their ring slots waits too.
FLUSH_TIMEOUT_S = 0.05
# Request ring per shard, one message per request.  A ring keeps the last
# ``depth`` messages: one not yet taken when the ring wraps is dropped, and
# only the stall replay (STALL_REPLAY_S) would recover its rows.
REQ_DEPTH = 32
# Results ring per replica, one message per round: a message the head has
# not taken within RES_DEPTH rounds is dropped, and the gap it leaves in a
# stream waits for the stall replay.  64 is the registry's largest ring.
RES_DEPTH = 64
# Records each trace ring keeps (a power of two).  A ring keeps only its newest
# records, and a wrapped ring would show sound flows as truncated: a run of 16
# requests writes a few thousand records a process, and the run raises if any
# ring's write count passes this.
TRACE_CAP = 1 << 16
# The flows' mean stage sum against the head's mean submit-to-complete time
# (the reference's fig18 STAGE_SUM_TOL).
STAGE_SUM_TOL = 0.10
# The serving stages, in causal order; they telescope to "e2e".
SERVE_STAGES = ("enqueue_to_flush", "flush_to_replica", "replica_to_first_chunk", "stream")


def fleet_requests(cfg, n: int, *, max_new: int, max_seq: int, seed: int):
    """``n`` requests, prompt lengths drawn from ``default_rng(seed)`` in
    ``[PROMPT_MIN, min(PROMPT_MAX, max_seq - max_new - 1)]``."""
    from repro_torch.launch.serve import make_requests

    return make_requests(n, vocab=cfg.vocab_size, prompt_min=PROMPT_MIN,
                         prompt_max=min(PROMPT_MAX, max_seq - max_new - 1),
                         max_new=max_new, seed=seed)


def serve_in_process(model_kwargs: dict, prompts: dict, *, max_new: int, slots: int,
                     max_seq: int) -> dict:
    """``prompts`` (``{request id: tokens}``) through one in-process
    ``InferenceServer`` on the replicas' weights (``init(seed=0)``):
    ``{request id: tokens}``."""
    import torch

    from repro_torch.models import Model
    from repro_torch.runtime import InferenceServer, Request

    cfg, device = model_config(model_kwargs)
    model = Model(cfg, device=device)
    srv = InferenceServer(model, slots=slots, max_seq=max_seq)
    srv.load(model.init(0))
    for rid, toks in prompts.items():
        srv.submit(Request(rid=rid, tokens=toks, max_new=max_new))
    out = {rid: res.tokens for rid, res in srv.serve().items()}
    del srv, model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _request_bytes(n_tokens: int) -> int:
    """One ``SERVE_REQ`` row's ragged payload: its tokens, and its length,
    rid, generation and trace id."""
    return 4 * n_tokens + 4 + 8 + 4 + 8


def _pub_take_us(records, prompt_len_by_rid: dict, head_pid: int) -> list:
    """``[message bytes, publish-to-take µs]`` for every ``SERVE_REQ``
    message a replica took, from the run's trace records (``(trace_id, t_ns,
    hop, stage, flags, arg, pid)``): the head's ring holds each message's
    ``publish`` record, the taking replica's ring its ``take`` record under
    the same trace id, and between that message's ``callback_start`` and
    ``callback_end`` one ``serve_enqueue`` record per row (its rid)."""
    S = _trace.Stage
    published, taken, nbytes, rows = {}, {}, {}, {}
    for tid, t_ns, hop, stage, _, arg, rpid in sorted(records, key=lambda r: r[1]):
        if rpid == head_pid:
            if stage == S.PUBLISH and hop == 0:
                published[tid] = t_ns
        elif stage == S.TAKE:
            taken[tid] = t_ns
        elif stage == S.CB_START:
            rows[rpid] = []
        elif stage == S.SERVE_ENQ and hop == 1 and rpid in rows:
            rows[rpid].append(arg)
        elif stage == S.CB_END and rpid in rows:
            nbytes[tid] = sum(_request_bytes(prompt_len_by_rid.get(r, 0))
                              for r in rows.pop(rpid))
    return sorted([nbytes[tid], (taken[tid] - t) / 1e3]
                  for tid, t in published.items() if tid in taken and tid in nbytes)


def _rings_overflowed(dom_name: str) -> dict:
    """``{ring: (records written, capacity)}`` for each of the domain's
    trace rings whose writer wrote more records than the ring keeps."""
    over = {}
    for name in _trace.ring_names(dom_name):
        try:
            reader = _trace.TraceReader(name)
        except (FileNotFoundError, ValueError):
            continue
        written = reader._head()
        reader.close()
        if written > reader.cap:
            over[name] = (written, reader.cap)
    return over


def flow_report(flows, name_of: dict, submitted: dict, done: dict, replayed) -> dict:
    """The run's serving flows by request (``name_of`` maps the router's rid
    to the request's name; a flow is keyed by its hop-0 ``serve_enqueue``
    record's arg, the rid's low 32 bits), the counts of complete and
    truncated flows, ``breakdown_stats`` of the complete ones (seconds), and
    the mean stage sum over the requests never replayed against the head's
    mean time from before ``submit`` (``submitted``) to completion
    (``done``, seconds on the monotonic clock)."""
    S = _trace.Stage
    low = {rid & 0xFFFF_FFFF: rid for rid in name_of}
    by_rid, orphans = {}, []
    for f in flows:
        if not f.serving:
            continue
        enq = f.first(S.SERVE_ENQ, 0)
        if enq is None or enq[5] not in low:
            orphans.append(f.trace_id)
            continue
        by_rid.setdefault(low[enq[5]], []).append(f)
    serving = [f for fs in by_rid.values() for f in fs]
    complete = [f for f in serving if f.complete]
    sums, heads = [], []
    for rid, fs in by_rid.items():
        if rid in replayed or rid not in done or len(fs) != 1 or not fs[0].complete:
            continue
        bd = fs[0].breakdown()
        sums.append(sum(bd.get(k, 0.0) for k in SERVE_STAGES))
        heads.append(done[rid] - submitted[rid])
    sum_mean = sum(sums) / len(sums) if sums else float("nan")
    head_mean = sum(heads) / len(heads) if heads else float("nan")
    return {
        "by_rid": {name_of[rid]: [{"rid": rid, "trace_id": f.trace_id, "complete": f.complete,
                                   "monotonic": f.monotonic(), "stages": f.breakdown()}
                                  for f in by_rid.get(rid, [])]
                   for rid in name_of},
        "orphans": orphans,
        "complete": len(complete), "truncated": len(serving) - len(complete),
        # an aggregator given the flows reads no ring
        "stats": FlowAggregator("").breakdown_stats(complete) if complete else {},
        "replayed": sorted(name_of[rid] for rid in replayed if rid in name_of),
        "stage_sum_mean_s": sum_mean, "head_mean_s": head_mean,
        "stage_sum_vs_head": abs(sum_mean - head_mean) / head_mean if heads else float("nan"),
    }


def _flow_faults(name, f: dict) -> list[str]:
    """What is wrong with one complete flow: not monotonic, a stage missing
    or negative."""
    out = []
    if not f["monotonic"]:
        out.append(f"request {name}: flow {f['trace_id']:#x} not monotonic")
    st = f["stages"]
    missing = [k for k in ("enqueue_to_flush", "flush_to_replica", "replica_to_first_chunk",
                           "e2e") if k not in st]
    if missing:
        out.append(f"request {name}: flow {f['trace_id']:#x} lacks {missing}")
    negative = {k: v for k, v in st.items() if v < 0}
    if negative:
        out.append(f"request {name}: flow {f['trace_id']:#x} has negative stages {negative}")
    return out


def flow_failures(report: dict, *, kill_one: bool) -> list[str]:
    """The flow gates.  Without a fault every request has exactly one
    serving flow, complete and monotonic with every stage non-negative, and
    the mean stage sum is within ``STAGE_SUM_TOL`` of the head's mean.  With
    a replica killed every request has exactly one complete flow (as
    sound), and every truncated flow belongs to a request the router
    replayed (replay mints a fresh trace id)."""
    out = []
    if report["orphans"]:
        out.append(f"serving flows of no request: {len(report['orphans'])}")
    replayed = set(report["replayed"])
    for name, fs in report["by_rid"].items():
        done = [f for f in fs if f["complete"]]
        if kill_one:
            if len(done) != 1:
                out.append(f"request {name}: {len(done)} complete flows")
            if len(done) != len(fs) and name not in replayed:
                out.append(f"request {name}: {len(fs) - len(done)} truncated flows, never "
                           f"replayed")
        elif len(fs) != 1 or len(done) != 1:
            out.append(f"request {name}: {len(fs)} serving flows, {len(done)} complete")
        for f in done:
            out.extend(_flow_faults(name, f))
    if not kill_one and not report["stage_sum_vs_head"] <= STAGE_SUM_TOL:
        out.append(f"mean stage sum {report['stage_sum_mean_s']:.6f} s against the head's "
                   f"{report['head_mean_s']:.6f} s: off by {report['stage_sum_vs_head']:.3f}, "
                   f"above {STAGE_SUM_TOL}")
    return out


def _took_every_request(router: ShardRouter, shard: int) -> bool:
    """Whether every request routed to ``shard`` has streamed a chunk back.
    A replica streams a request's first chunk only after the callback that
    took its message has returned and released it, which writes the take
    record into the replica's trace ring.  Killed before that, the replica
    would leave a message untaken (or taken with no take record), and the
    router would replay its rows packed with the others in fewer messages:
    the trace rings would time fewer messages than there are requests."""
    return all(rec.progressed for rec in router.inflight.values() if rec.shard == shard)


def _unlink(names) -> None:
    for name in names:
        try:
            _new_shm(name, create=False, size=0).unlink()
        except FileNotFoundError:
            pass


def _export_names(dom_name: str) -> list[str]:
    pat = f"/dev/shm/agno-mx-{_metrics._domain_hash(dom_name)}-*"
    return [os.path.basename(p) for p in glob.glob(pat)]


def _arenas_publishing(dom: Domain, topic: str) -> list[str]:
    """The arenas of ``topic``'s publishers (a killed replica's arena
    outlives it; the head unlinks it after the run)."""
    tidx = dom.registry.topic_index(topic, create=False)
    return [name for _, name in dom.registry.publishers(tidx)]


def _death_evidence(dom: Domain, router: ShardRouter, pool: ReplicaPool, shard: int) -> dict:
    """Why the pool declared ``shard`` dead, read just after: the age of its
    request-topic lease (None once the registry swept a dead process's
    subscriber) and the fill of its request and results rings."""
    reg = dom.registry
    ages = reg.lease_ages(router.pubs[shard].tidx)
    res_tidx = reg.topic_index(pool.res_topic_for(shard), create=False)
    return {"shard": shard,
            "lease_age_s": min(ages.values()) if ages else None,
            "req_ring_used": reg.queue_depth(router.pubs[shard].tidx, router.pubs[shard].pidx),
            "res_ring_used": sum(reg.queue_depth(res_tidx, p) for p, _ in reg.publishers(res_tidx))}


def run(*, arch: str = "qwen2-1.5b", size: str = "full", replicas: int = 2,
        requests: int = 16, max_new: int = 32, slots: int = 4, max_seq: int = 512,
        seed: int = 0, kill_one: bool = False, device: str | None = None,
        ready_timeout: float = 300.0, timeout: float = 600.0) -> dict:
    """Serve ``requests`` requests from ``replicas`` replica processes; see
    the module docstring for what the returned dict holds."""
    from repro_torch.models.model import resolve_device

    dev = resolve_device(device)          # raises without a card unless "cpu"
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()                    # once here, not K times at once in the replicas
    model_kwargs = dict(arch=arch, size=size, device=dev.type)
    cfg, _ = model_config(model_kwargs)
    reqs = fleet_requests(cfg, requests, max_new=max_new, max_seq=max_seq, seed=seed)

    trace_env = {k: os.environ.get(k) for k in ("AGNOCAST_TRACE", "AGNOCAST_TRACE_CAP")}
    os.environ["AGNOCAST_TRACE"] = "1"    # the head and the replicas it spawns
    os.environ["AGNOCAST_TRACE_CAP"] = str(TRACE_CAP)
    dom = Domain.create(arena_capacity=64 << 20)
    pool = router = collector = ex = None
    orphans: list[str] = []
    try:
        t0 = time.monotonic()
        pool = ReplicaPool(dom, range(replicas), model="torch", model_kwargs=model_kwargs,
                           slots=slots, max_seq=max_seq, depth=RES_DEPTH,
                           round_period_s=ROUND_PERIOD_S)
        pool.wait_ready(timeout=ready_timeout)
        ready_s = time.monotonic() - t0
        collector = ResultsCollector(dom, shards=range(replicas))
        router = ShardRouter(dom, range(replicas), max_new=max_new, depth=REQ_DEPTH)

        name_of, plen_of, submitted, enqueued = {}, {}, {}, {}
        first, done, completions, replayed = {}, {}, {}, set()
        victim, killed, dead, evidence = [None], [], [], []

        def on_progress(rid):
            first.setdefault(rid, time.monotonic())
            router.touch(rid)
            rec = router.inflight.get(rid)
            if not killed and rec is not None and rec.shard == victim[0] and \
                    _took_every_request(router, victim[0]):
                killed.append(victim[0])
                orphans.extend(_arenas_publishing(dom, pool.res_topic_for(victim[0])))
                pool.kill(victim[0])

        def on_complete(rid, tokens):
            now = time.monotonic()
            first.setdefault(rid, now)
            done[rid] = (now, list(tokens))
            completions[rid] = completions.get(rid, 0) + 1
            router.complete(rid)

        collector.on_progress, collector.on_complete = on_progress, on_complete
        ex = EventExecutor(name="fleet-head")
        collector.attach_executor(ex)

        def janitor():
            for shard in pool.poll():
                dead.append(shard)
                evidence.append(_death_evidence(dom, router, pool, shard))
                replayed.update(router.remove_shard(shard))
            for rid in router.stalled(STALL_REPLAY_S):
                router.replay(rid)
                replayed.add(rid)
            router.flush(timeout=FLUSH_TIMEOUT_S)

        ex.add_timer(JANITOR_S, janitor)
        t_submit = time.monotonic()
        for r in reqs:                    # one unsized SERVE_REQ message per request
            before = time.monotonic()
            rid = router.submit(r.tokens)
            name_of[rid], plen_of[rid & 0xFFFF_FFFF] = r.rid, len(r.tokens)
            submitted[rid], enqueued[rid] = time.monotonic(), before
            router.flush(timeout=FLUSH_TIMEOUT_S)
        if kill_one and replicas > 1:
            per_shard = {}
            for rec in router.inflight.values():
                per_shard[rec.shard] = per_shard.get(rec.shard, 0) + 1
            victim[0] = 1 if per_shard.get(1) else max(per_shard, key=per_shard.get)
        ex.spin(until=lambda: len(done) >= len(reqs), timeout=timeout)
        t_end = max((t for t, _ in done.values()), default=time.monotonic())
        if len(done) < len(reqs):
            raise RuntimeError(f"fleet stalled: {len(done)}/{len(reqs)} done; "
                               f"collector {collector.stats()}, router {router.stats()}")
        replays = router.replays
        coll = collector.stats()
    finally:
        if ex is not None:
            ex.shutdown()
        for part in (router, collector):
            if part is not None:
                part.close()
        if pool is not None:
            pool.stop()
        for k, v in trace_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        exports = _metrics.read_exports(dom.name)
        overflowed = _rings_overflowed(dom.name)
        if overflowed:
            raise RuntimeError(f"trace rings wrapped (records written, kept): {overflowed}")
        agg = FlowAggregator(dom.name)
        flows = agg.collect()
        agg.close()
        pub_take = _pub_take_us([r for f in flows for r in f.records], plen_of, os.getpid())
        flows = flow_report(flows, name_of, enqueued, {rid: t for rid, (t, _) in done.items()},
                            replayed)
    finally:
        _unlink(_export_names(dom.name) + orphans)
        _trace.purge(dom.name)
        dom.close()

    tokens = {name_of[rid]: toks for rid, (_, toks) in done.items()}
    generated = sum(len(t) for t in tokens.values())
    wall = t_end - t_submit
    replica_metrics = {}
    for snap in exports.values():
        if "replica.shard" not in snap:
            continue
        kernels = {k[len("kernel."):-len(".launches")]: v for k, v in snap.items()
                   if k.startswith("kernel.") and k.endswith(".launches")}
        replica_metrics[int(snap["replica.shard"])] = {
            "device": snap.get("replica.device"), "launches": kernels,
            "peak_mem_bytes": snap.get("replica.peak_mem_bytes")}
    return {
        "arch": arch, "size": size, "device": dev.type, "model_kwargs": model_kwargs,
        "replicas": replicas,
        "requests": len(reqs), "max_new": max_new, "slots": slots, "max_seq": max_seq,
        "round_period_s": ROUND_PERIOD_S, "ready_s": ready_s,
        "prompts": {r.rid: r.tokens for r in reqs},
        "tokens": tokens,
        "missing": sorted(r.rid for r in reqs if r.rid not in tokens),
        "completions": {name_of[rid]: n for rid, n in completions.items()},
        "bad_streams": sorted(n for n, t in tokens.items() if len(t) != max_new),
        "collector": coll, "replays": replays, "killed": killed[0] if killed else None,
        "dead": dead, "death_evidence": evidence,
        "wall_s": wall, "generated_tokens": generated,
        "tokens_per_s": generated / wall if wall > 0 else float("nan"),
        "ttft_ms": sorted((plen_of[rid & 0xFFFF_FFFF], 1e3 * (first[rid] - submitted[rid]))
                          for rid in done),
        "pub_take_us": pub_take,
        "flows": flows,
        "replica_metrics": replica_metrics,
    }


def exactly_once(out: dict) -> bool:
    """Every request completed exactly once with a stream of ``max_new``
    tokens, and the collector dropped no chunk of an accepted stream."""
    return (not out["missing"] and not out["bad_streams"]
            and set(out["completions"].values()) == {1}
            and out["collector"]["dropped_window"] == 0
            and out["collector"]["open_streams"] == 0)


def main(argv=None) -> dict:
    from repro_torch.launch.serve import SERVED_ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=SERVED_ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--size", choices=("smoke", "100m", "full"), default="full")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--kill-one", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="compare tokens with one in-process server")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    out = run(arch=args.arch, size=args.size, replicas=args.replicas,
              requests=args.requests, kill_one=args.kill_one, device=args.device)
    print(f"[fleet] {args.arch} ({args.size}) on {out['device']}, {args.replicas} replicas: "
          f"{len(out['tokens'])}/{out['requests']} done, {out['tokens_per_s']:.1f} tok/s, "
          f"replays {out['replays']}, killed {out['killed']}, collector {out['collector']}")
    print(f"[fleet] declared dead: {out['death_evidence']}")
    print("[fleet] client TTFT ms by prompt length: "
          + json.dumps([[n, round(ms, 3)] for n, ms in out["ttft_ms"]]))
    print("[fleet] publish-to-take us by message bytes: "
          + json.dumps([[b, round(us, 1)] for b, us in out["pub_take_us"]]))
    fl = out["flows"]
    print(f"[fleet] serving flows: {fl['complete']} complete, {fl['truncated']} truncated, "
          f"replayed requests {fl['replayed']}; stage sum mean "
          f"{1e3 * fl['stage_sum_mean_s']:.3f} ms against the head's "
          f"{1e3 * fl['head_mean_s']:.3f} ms")
    print("[fleet] serving stages p50/p99/max ms: " + ", ".join(
        f"{k} {1e3 * v['p50']:.3f}/{1e3 * v['p99']:.3f}/{1e3 * v['max']:.3f}"
        for k, v in fl["stats"].items()))
    for shard, m in sorted(out["replica_metrics"].items()):
        print(f"[fleet] replica {shard}: {m}")
    if not exactly_once(out):
        raise RuntimeError(f"not exactly once: missing {out['missing']}, bad streams "
                           f"{out['bad_streams']}, completions {out['completions']}")
    if args.check:
        want = serve_in_process(out["model_kwargs"], out["prompts"], max_new=out["max_new"],
                                slots=out["slots"], max_seq=out["max_seq"])
        bad = sorted(rid for rid in want if want[rid] != out["tokens"].get(rid))
        print(f"[fleet] tokens equal to one in-process server: {len(want) - len(bad)}"
              f"/{len(want)}")
        if bad:
            raise RuntimeError(f"tokens differ from the in-process server for {bad}")
        faults = flow_failures(out["flows"], kill_one=out["killed"] is not None)
        if faults:
            raise RuntimeError("flow gates failed: " + "; ".join(faults))
        print("[fleet] flow gates passed")
    return out


if __name__ == "__main__":
    main()
