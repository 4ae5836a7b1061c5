"""Staged input pipeline over the agnocast zero-copy plane.

Topology (per host)::

    reader ──"docs"──▶ packer ──"batches"──▶ feeder(trainer)

Each edge is a pub/sub topic. In ``ZeroCopyPipeline`` the stages are
separate OS processes (fault isolation, the paper's requirement) and the
edges are agnocast topics: a batch hand-off is a constant-size descriptor,
never a payload copy, regardless of batch bytes — the paper's property
applied to the training data plane. ``InProcessPipeline`` runs the same
stage code single-process for tests and smoke runs.

Crash behaviour: if a stage dies, the registry janitor (kernel-module
analogue) releases its refs; the driver detects the missing heartbeat and
respawns the stage, which resumes from its (deterministic) cursor — the
data plane analogue of checkpoint/restart.

The port's copy of ``repro/data/pipeline.py``: only the import paths
differ, so the two packages give the same documents and batches from the same seed.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import TOKEN_BATCH, Domain
from repro_torch.data.packing import Packer, unpack_batch
from repro_torch.data.synthetic import SyntheticCorpus

__all__ = ["BatchSpec", "InProcessPipeline", "ZeroCopyPipeline",
           "ZeroCopyFeeder", "PipelineStageStats"]


@dataclass(frozen=True)
class BatchSpec:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    host: int = 0
    num_hosts: int = 1


@dataclass
class PipelineStageStats:
    produced: int = 0
    bytes_out: int = 0
    t_busy: float = 0.0
    respawns: int = 0
    last_stamp: float = field(default_factory=time.monotonic)


# ---------------------------------------------------------------------------
# In-process pipeline (tests / smoke)
# ---------------------------------------------------------------------------


class InProcessPipeline:
    """Same stage logic, one process: reader -> packer -> dense batches."""

    def __init__(self, spec: BatchSpec, start_doc: int = 0):
        self.spec = spec
        self.corpus = SyntheticCorpus(spec.vocab_size, seed=spec.seed)
        self._docs = self.corpus.shard_iter(spec.host, spec.num_hosts, start=start_doc)
        self._packer = Packer(spec.batch, spec.seq_len)
        self.cursor = start_doc  # documents consumed (for checkpointing)

    def __iter__(self):
        return self

    def __next__(self):
        while not self._packer.ready():
            _, doc = next(self._docs)
            self.cursor += 1
            self._packer.feed(doc)
        flat, rows = self._packer.emit()
        return unpack_batch(flat, rows, self.spec.seq_len)

    def state(self) -> dict:
        # cursor alone is not enough: the packer may hold the tail of a
        # partially-consumed document — restart must not skip or replay it.
        return {"cursor": self.cursor,
                "buf": self._packer._buf.tolist()}

    @classmethod
    def restore(cls, spec: BatchSpec, state: dict) -> "InProcessPipeline":
        p = cls(spec, start_doc=int(state["cursor"]))
        p._packer._buf = np.asarray(state.get("buf", []), np.int32)
        return p


# ---------------------------------------------------------------------------
# Multi-process zero-copy pipeline
# ---------------------------------------------------------------------------


def _packer_stage(domain_name: str, spec: BatchSpec, topic_out: str,
                  stop_evt, arena_mb: int) -> None:
    """Reader+packer process: generates docs, packs, publishes TOKEN_BATCH."""
    dom = Domain.join(domain_name, arena_capacity=arena_mb << 20)
    pub = dom.create_publisher(TOKEN_BATCH, topic_out, depth=8)
    corpus = SyntheticCorpus(spec.vocab_size, seed=spec.seed)
    docs = corpus.shard_iter(spec.host, spec.num_hosts)
    packer = Packer(spec.batch, spec.seq_len)
    step = 0
    while not stop_evt.is_set():
        while not packer.ready():
            _, doc = next(docs)
            packer.feed(doc)
        flat, rows = packer.emit()
        msg = pub.borrow_loaded_message()
        msg.tokens.extend(flat)          # unsized writes, arena-backed
        msg.row_lengths.extend(rows)
        msg.set("stamp", time.monotonic())
        msg.set("step", step)
        msg.set("epoch", 0)
        # backpressure: block on the slot-freed FIFO (event-driven, no
        # sleep-polling) until queue room appears or we are told to stop
        pub.publish_blocking(msg, should_stop=stop_evt.is_set)
        step += 1
    dom.close()


class ZeroCopyFeeder:
    """Trainer-side subscriber: takes TOKEN_BATCH messages zero-copy and
    yields dense (B, S) numpy batches (the only copy is ragged->dense
    reshaping into the device staging buffer, which a real TPU host must do
    anyway for the host-to-device DMA)."""

    def __init__(self, dom: Domain, topic: str, spec: BatchSpec):
        self.spec = spec
        self.sub = dom.create_subscription(TOKEN_BATCH, topic)
        self.hand_off_latency: list[float] = []

    def next_batch(self, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            msgs = self.sub.take()
            if msgs:
                ptr = msgs[0]
                flat = ptr.msg.tokens          # zero-copy read-only views
                rows = ptr.msg.row_lengths
                self.hand_off_latency.append(time.monotonic() - float(ptr.msg.get("stamp")))
                batch = unpack_batch(flat, rows, self.spec.seq_len)
                for extra in msgs[1:]:
                    extra.release()
                ptr.release()
                return batch
            self.sub.wait(0.05)
        raise TimeoutError("data plane produced no batch in time")


class ZeroCopyPipeline:
    """Driver: spawns the packer stage as a separate process, exposes a
    feeder, respawns the stage if it dies (fault isolation demo)."""

    def __init__(self, spec: BatchSpec, *, domain: Domain | None = None,
                 arena_mb: int = 256):
        self.spec = spec
        self._own_domain = domain is None
        self.dom = domain or Domain.create(arena_capacity=4 << 20)
        self.arena_mb = arena_mb
        # spawn by default: the parent typically has live JAX threads and
        # fork() from a multithreaded process risks deadlock.
        self._ctx = mp.get_context("fork" if os.environ.get("AGNO_FORK") else "spawn")
        self._stop = self._ctx.Event()
        self.stats = PipelineStageStats()
        self._proc: mp.Process | None = None
        self.feeder = ZeroCopyFeeder(self.dom, "train/batches", spec)
        self._spawn()

    def _spawn(self) -> None:
        self._proc = self._ctx.Process(
            target=_packer_stage,
            args=(self.dom.name, self.spec, "train/batches", self._stop, self.arena_mb),
            daemon=True,
        )
        self._proc.start()

    def ensure_alive(self) -> bool:
        """Heartbeat check + respawn: returns True if a respawn happened."""
        if self._proc is not None and self._proc.is_alive():
            return False
        self.dom.sweep()  # janitor: roll back anything the dead stage held
        self.stats.respawns += 1
        self._spawn()
        return True

    def next_batch(self, timeout: float = 30.0):
        # heartbeat first: a dead stage is respawned before we wait on it
        # (buffered messages from the dead publisher are swept, not served —
        # their arena has no owner left to reclaim them)
        self.ensure_alive()
        try:
            b = self.feeder.next_batch(timeout=min(timeout, 5.0))
        except TimeoutError:
            self.ensure_alive()
            b = self.feeder.next_batch(timeout=timeout)
        self.stats.produced += 1
        self.stats.bytes_out += int(b["tokens"].nbytes)
        return b

    def kill_stage(self) -> None:
        """Fault-injection hook used by tests and the fault-tolerance demo."""
        if self._proc is not None and self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5)

    def close(self) -> None:
        self._stop.set()
        if self._proc is not None:
            self._proc.join(timeout=2)
            if self._proc.is_alive():
                self._proc.terminate()
        if self._own_domain:
            self.dom.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
