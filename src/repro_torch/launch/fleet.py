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
size (from the trace rings of ``repro_torch.obs.trace``), and each
replica's kernel launches, device and peak device memory (from its
metrics export).  ``--check`` also serves the same prompts with one
in-process ``InferenceServer`` on the same weights and compares tokens.

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
from repro_torch.serving import ReplicaPool, ResultsCollector, ShardRouter
from repro_torch.serving.replica import model_config

__all__ = ["run", "serve_in_process", "fleet_requests", "exactly_once", "main"]

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


def _pub_take_us(dom_name: str, prompt_len_by_rid: dict) -> list:
    """``[message bytes, publish-to-take µs]`` for every ``SERVE_REQ``
    message a replica took, from the trace rings: the head's ring holds
    each message's ``publish`` record, the taking replica's ring its
    ``take`` record under the same trace id, and between that message's
    ``callback_start`` and ``callback_end`` one ``serve_enqueue`` record
    per row (its rid)."""
    pid = os.getpid()
    records = []
    for name in _trace.ring_names(dom_name):
        try:
            reader = _trace.TraceReader(name)
        except (FileNotFoundError, ValueError):
            continue
        records.extend(reader.records())
        reader.close()
    S = _trace.Stage
    published, taken, nbytes, rows = {}, {}, {}, {}
    for tid, t_ns, hop, stage, _, arg, rpid in sorted(records, key=lambda r: r[1]):
        if rpid == pid:
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

    trace_env = os.environ.get("AGNOCAST_TRACE")
    os.environ["AGNOCAST_TRACE"] = "1"    # the head and the replicas it spawns
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

        name_of, plen_of, submitted = {}, {}, {}
        first, done, completions = {}, {}, {}
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
                router.remove_shard(shard)
            for rid in router.stalled(STALL_REPLAY_S):
                router.replay(rid)
            router.flush(timeout=FLUSH_TIMEOUT_S)

        ex.add_timer(JANITOR_S, janitor)
        t_submit = time.monotonic()
        for r in reqs:                    # one unsized SERVE_REQ message per request
            rid = router.submit(r.tokens)
            name_of[rid], plen_of[rid & 0xFFFF_FFFF] = r.rid, len(r.tokens)
            submitted[rid] = time.monotonic()
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
        if trace_env is None:
            os.environ.pop("AGNOCAST_TRACE", None)
        else:
            os.environ["AGNOCAST_TRACE"] = trace_env
    try:
        exports = _metrics.read_exports(dom.name)
        pub_take = _pub_take_us(dom.name, plen_of)
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
    return out


if __name__ == "__main__":
    main()
