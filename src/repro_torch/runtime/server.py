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

Not here yet: ``ingest_message``, ``ingest_serve_message`` and
``attach_executor`` need the shm message and executor planes, which the
port has not copied yet (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.device_arena import DevicePagePool
from repro_torch.models import Model
from repro_torch.serving.messages import GenerationGate

__all__ = ["Request", "Result", "InferenceServer"]


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
        self.stream_sink = None       # callable(rid, gen, seq, tokens, eos)
        self._gate = GenerationGate()

    # -- setup ---------------------------------------------------------------

    def load(self, params: dict) -> None:
        self._params = params
        self._cache = self.model.init_cache(self.slots, self.max_seq)

    # -- request surface --------------------------------------------------------

    def submit(self, req: Request) -> None:
        if not 0 < len(req.tokens) < self.max_seq:
            raise ValueError(f"request {req.rid!r}: prompt of {len(req.tokens)} tokens; "
                             f"need 1..{self.max_seq - 1} for max_seq={self.max_seq}")
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

    def step_rounds(self) -> None:
        """One admission + decode round."""
        self._admit()
        self._decode_round()

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
        }
