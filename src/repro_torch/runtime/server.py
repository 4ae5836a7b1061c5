"""Serving runtime: continuous batching with the device-arena KV hand-off.

Counterpart of ``repro/runtime/server.py``.  Prefill "publishes" the KV
pages it wrote for a request and the decode loop "subscribes"; pages
return to the free list only when refcount == 0 AND unreceived == 0
(``DevicePagePool``), so a cancelled request's pages are reclaimed by the
janitor (``expire_consumer``).

The decode cache is batched over slots and lives on the model's device:
K/V ``(L, B_slots, S_max, KV, hd)`` for the dense family, per-block
recurrent states for xLSTM (which holds no pages; the page bookkeeping
runs all the same, as in the reference).  Where the reference jits its
steps and donates the cache (``jax.jit(..., donate_argnums=(1,))``), the
port keeps ONE preallocated cache and updates it in place: each decode
step writes its new k/v or states and bumps ``len`` inside it, and
admission copies a prompt's cache into its slot with
``Model.splice_cache``, which holds everything family-specific.

Request ingest rides the port's copy of the shm planes
(``repro_torch.core``, ``repro_torch.serving``), as in the reference:
``ingest_message`` takes a ``TOKEN_BATCH`` message, ``ingest_serve_message``
a ``SERVE_REQ`` message whose rows carry router-assigned ``(rid,
generation)`` pairs under the one ``GenerationGate`` replay rule, and
``attach_executor`` runs the server on an ``EventExecutor``.  A message's
token rows are read zero-copy out of the publisher's arena and each row is
copied once into host memory before the message is released; prefill then
moves it to the model's device.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.device_arena import DevicePagePool
from repro_torch.models import Model
from repro_torch.serving.messages import GenerationGate, iter_requests

__all__ = ["Request", "Result", "InferenceServer", "attach_serving_executor"]


@dataclass
class Request:
    rid: str
    tokens: np.ndarray                  # prompt (unsized)
    max_new: int = 16
    stamp: float = field(default_factory=time.monotonic)


@dataclass
class Result:
    rid: str
    tokens: list[int]
    prompt_len: int
    ttft: float                          # time to first token
    latency: float


class InferenceServer:
    def __init__(self, model: Model, *, slots: int = 4, max_seq: int = 512,
                 page_tokens: int = 64):
        self.model = model
        self.device = model.device
        self.slots = slots
        self.max_seq = max_seq
        self.pool = DevicePagePool(
            num_pages=slots * (max_seq // page_tokens), page_tokens=page_tokens)
        self.queue: deque[Request] = deque()
        self.results: dict[str, Result] = {}
        self._active: dict[int, dict] = {}  # slot -> request state
        self._free_slots = list(range(slots - 1, -1, -1))
        self._cache = None
        self._params = None
        self.steps = 0
        self.decode_seconds = 0.0     # host time in decode rounds, device included
        self.rejected = 0             # message rows answered empty (prompt too long)
        self._ingest_seq = 0  # server-wide: message seqs are per-publisher
        # -- sharded-serving surface (repro_torch.serving) ---------------------
        self.stream_sink = None       # callable(rid, gen, seq, tokens, eos)
        self.keep_results = True      # replicas stream instead of accumulating
        self._gate = GenerationGate()  # the shared SERVE_REQ replay rule

    # -- setup ---------------------------------------------------------------

    def load(self, params: dict) -> None:
        self._params = params
        self._cache = self.model.init_cache(self.slots, self.max_seq)

    # -- request surface --------------------------------------------------------

    def submit(self, req: Request) -> None:
        self._check_prompt(req.rid, len(req.tokens))
        self.queue.append(req)

    def cancel(self, rid: str) -> bool:
        """Consumer vanishes mid-decode: the janitor path frees its pages."""
        self._gate.drop(rid)
        for slot, st in list(self._active.items()):
            if st["req"].rid == rid:
                self.pool.expire_consumer(f"decode/{rid}")
                self._retire(slot, finished=False)
                return True
        return False

    # -- the loop ---------------------------------------------------------------

    def _admit(self) -> None:
        while self.queue and self._free_slots:
            req = self.queue.popleft()
            slot = self._free_slots.pop()
            n = len(req.tokens)
            prompt = torch.as_tensor(np.asarray(req.tokens, np.int64),
                                     device=self.device)[None, :]
            t0 = time.monotonic()
            logits, cache1 = self.model.prefill(self._params, {"tokens": prompt})
            first = int(logits[0, -1].argmax())
            # prefill publishes this request's pages; decode subscribes.
            npages = self.pool.pages_for_tokens(n + req.max_new)
            pages = self.pool.alloc(npages)
            key = f"kv/{req.rid}"
            self.pool.publish(key, pages, consumers=[f"decode/{req.rid}"])
            self.pool.take(key, f"decode/{req.rid}")   # zero-copy receive
            # splice the request's cache into its slot of the batched cache
            self.model.splice_cache(self._cache, cache1, slot, n)
            st = {
                "req": req, "key": key, "generated": [first],
                "t0": t0, "ttft": time.monotonic() - t0,
                "gen": self._gate.current(req.rid), "chunk_seq": 0,
            }
            self._active[slot] = st
            self._emit(st, [first], False)

    def _emit(self, st: dict, tokens: list[int], eos: bool) -> None:
        """Stream one per-rid chunk to the sink: monotone chunk seq per
        (rid, generation)."""
        if self.stream_sink is None:
            return
        self.stream_sink(st["req"].rid, st["gen"], st["chunk_seq"], tokens, eos)
        st["chunk_seq"] += 1

    def _retire(self, slot: int, *, finished: bool = True) -> None:
        st = self._active.pop(slot)
        rid = st["req"].rid
        if finished:
            self.pool.release(st["key"], f"decode/{rid}")
            self._gate.finish(rid)  # late replays of <= gen ignored
            if self.keep_results:
                self.results[rid] = Result(
                    rid=rid, tokens=st["generated"],
                    prompt_len=len(st["req"].tokens), ttft=st["ttft"],
                    latency=time.monotonic() - st["req"].stamp)
        # zero the slot length so decode ignores it
        self._cache["len"][slot] = 0
        self._free_slots.append(slot)

    def _decode_round(self) -> None:
        if not self._active:
            return
        t0 = time.monotonic()
        toks = np.zeros((self.slots, 1), np.int64)
        for slot, st in self._active.items():
            toks[slot, 0] = st["generated"][-1]
        logits, self._cache = self.model.decode_step(
            self._params, self._cache, torch.from_numpy(toks).to(self.device))
        nxt = logits[:, -1].argmax(dim=-1).cpu().numpy()
        self.decode_seconds += time.monotonic() - t0
        self.steps += 1
        for slot in list(self._active):
            st = self._active[slot]
            tok = int(nxt[slot])
            st["generated"].append(tok)
            done = (len(st["generated"]) >= st["req"].max_new
                    or len(st["req"].tokens) + len(st["generated"])
                    >= self.max_seq - 1)
            self._emit(st, [tok], done)
            if done:
                self._retire(slot)

    def serve(self, *, max_rounds: int = 10_000) -> dict[str, Result]:
        """Run until queue and slots drain; returns results by request id."""
        rounds = 0
        while (self.queue or self._active) and rounds < max_rounds:
            self._admit()
            self._decode_round()
            rounds += 1
        return self.results

    # -- event-driven ingest (the executor-layer wiring) -------------------------

    def _fits(self, n: int) -> bool:
        return 0 < n < self.max_seq

    def _check_prompt(self, rid: str, n: int) -> None:
        if not self._fits(n):
            raise ValueError(f"request {rid!r}: prompt of {n} tokens; "
                             f"need 1..{self.max_seq - 1} for max_seq={self.max_seq}")

    def _reject(self, rid: str, gen: int, n: int) -> None:
        """Answer a message row this server cannot hold (a prompt of ``n``
        tokens, not ``1..max_seq - 1``) with an empty, final stream, so its
        client completes and the rest of the message is admitted as usual."""
        self.rejected += 1
        if self.stream_sink is not None:
            self.stream_sink(rid, gen, 0, [], True)
        if self.keep_results:
            self.results[rid] = Result(rid=rid, tokens=[], prompt_len=n,
                                       ttft=0.0, latency=0.0)

    def ingest_message(self, ptr, *, max_new: int = 16) -> int:
        """Decode-side ingest of one ``TOKEN_BATCH`` message: each ragged row
        becomes one :class:`Request`.  The flat token field is read zero-copy
        out of the publisher's arena; only the per-request prompt slice is
        copied (it must outlive the released ``MessagePtr``).  A row too
        long for ``max_seq`` is answered empty (``_reject``)."""
        lens = np.asarray(ptr.row_lengths, np.int64)
        flat = np.asarray(ptr.tokens, np.int32)
        stamp = float(ptr.get("stamp"))
        off = admitted = 0
        for n in lens:
            n = int(n)
            # rid from a server-wide counter: registry seqs restart at 1 for
            # every publisher, so seq-derived rids collide across clients
            self._ingest_seq += 1
            rid = f"ingest-{self._ingest_seq}"
            off += n
            if not self._fits(n):
                self._reject(rid, 0, n)
                continue
            req = Request(rid=rid, tokens=flat[off - n:off].copy(), max_new=max_new)
            if stamp > 0:
                req.stamp = stamp
            self.submit(req)
            admitted += 1
        return admitted

    def ingest_serve_message(self, ptr, *, max_new: int = 16) -> int:
        """Shard-plane ingest (:mod:`repro_torch.serving`): each ragged row
        carries an explicit router-assigned ``(rid, generation)``.  A row whose
        generation supersedes a queued/active copy of the same rid replaces
        it (replay after replica loss or a lost result); a stale or
        duplicate generation — including one already *completed* — is
        dropped, so each rid decodes exactly once per generation.  An
        admitted row this server cannot hold (a prompt not shorter than
        ``max_seq``) is answered empty (``_reject``) and its generation
        closed; the message's other rows are admitted as usual."""
        stamp = float(ptr.get("stamp"))
        mnew = int(ptr.get("max_new")) or max_new
        admitted = 0
        for row in iter_requests(ptr):  # copies each row's tokens out
            rid = str(row.rid)
            if not self._admit_generation(rid, row.gen):
                continue
            if not self._fits(len(row.tokens)):
                self._gate.finish(rid)   # replays of this generation are dropped
                self._reject(rid, row.gen, len(row.tokens))
                continue
            req = Request(rid=rid, tokens=row.tokens, max_new=mnew)
            if stamp > 0:
                req.stamp = stamp
            self.submit(req)
            admitted += 1
        return admitted

    def _admit_generation(self, rid: str, gen: int) -> bool:
        """The shared replay rule (:class:`repro_torch.serving.messages.
        GenerationGate`): True iff this (rid, gen) should be admitted,
        superseding (cancelling) any older live copy."""

        def supersede(r):
            self.cancel(r)  # an active copy: the janitor frees its pages
            self.queue = deque(q for q in self.queue if q.rid != r)

        return self._gate.admit(rid, gen, supersede=supersede)

    def step_rounds(self) -> None:
        """One admission + decode round (the executor timer's callback)."""
        self._admit()
        self._decode_round()

    def attach_executor(self, executor, sub, *, group=None, max_new: int = 16,
                        round_period_s: float = 0.0005, ingest=None,
                        on_round_end=None):
        """Run this server on an :class:`~repro_torch.core.executor.EventExecutor`
        (see :func:`attach_serving_executor` for the semantics)."""
        return attach_serving_executor(
            self, executor, sub, group=group, max_new=max_new,
            round_period_s=round_period_s, ingest=ingest,
            on_round_end=on_round_end)

    @property
    def idle(self) -> bool:
        """True when no request is queued or mid-decode."""
        return not self.queue and not self._active

    # -- introspection ------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "free_pages": self.pool.free_pages,
            "live_publications": self.pool.live_publications,
            "active": len(self._active),
            "queued": len(self.queue),
            "decode_steps": self.steps,
            "decode_seconds": self.decode_seconds,
            "rejected": self.rejected,
        }


def attach_serving_executor(server, executor, sub, *, group=None,
                            max_new: int = 16, round_period_s: float = 0.0005,
                            ingest=None, on_round_end=None):
    """Wire a continuous-batching server onto an ``EventExecutor``.

    Request messages arriving on ``sub`` are admitted by the subscription
    callback; a oneshot round timer is armed only while work is pending (an
    idle server sleeps on epoll instead of ticking at 1/period).  Everything
    shares one mutually-exclusive callback group so server state is never
    mutated concurrently.

    * ``ingest`` — alternative message decoder (e.g. the bound
      ``server.ingest_serve_message`` for rows with router-assigned rids);
      defaults to ``server.ingest_message``.
    * ``on_round_end`` — called after every decode round, in the same
      group: the replica's hook to flush its streamed token chunks as one
      results-topic publish per round.
    * ``round_period_s`` — the continuous-batching tick.  A round of the
      port's server ends in the device sync of its token readback, so the
      tick is only the pause between rounds, not a model of device latency
      as in the reference.

    ``server`` is duck-typed (``queue`` / ``_active`` / ``step_rounds`` /
    ``ingest_message``); the one implementation lives in
    :mod:`repro_torch.serving.attach`.  Returns the subscription handle."""
    from repro_torch.serving.attach import attach_server_executor

    return attach_server_executor(
        server, executor, sub, group=group, max_new=max_new,
        round_period_s=round_period_s, ingest=ingest,
        on_round_end=on_round_end)
