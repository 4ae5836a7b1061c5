"""A lossless, resumable variant of the zero-copy training pipeline.

The copied ``ZeroCopyPipeline`` (``pipeline.py``) publishes on a
keep-last topic of depth 8: a batch nobody has taken yet is overwritten
when the packer laps it, so a trainer slower than the packer trains on a
timing-dependent subset of the stream, and a respawned stage starts again
from the first document.  Training needs every batch, in order, and a
restart from its data cursor.  ``OrderedZeroCopyPipeline`` keeps the same
process, topic, message type and respawn, and adds two things:

* credits: the stage takes one from a shared semaphore before each
  publish and the trainer returns one for each batch it has taken and
  released; with ``depth - 1`` credits in all, the ring always has a slot
  whose occupant was released, so no untaken batch is ever overwritten;
* a cursor: each batch carries its index in the deterministic stream
  (``step``); the stage packs and discards the batches below its start
  (the trainer's cursor, at a restart or a respawn), and ``next_batch``
  returns batch ``cursor`` and advances it, releasing any batch below it
  unread and raising on a gap.
"""

from __future__ import annotations

import time

from repro_torch.core import TOKEN_BATCH, Domain
from repro_torch.data.packing import Packer, unpack_batch
from repro_torch.data.pipeline import BatchSpec, ZeroCopyPipeline
from repro_torch.data.synthetic import SyntheticCorpus

__all__ = ["OrderedZeroCopyPipeline"]

DEPTH = 8                                   # the topic's ring, as the copied stage's


def _ordered_stage(domain_name: str, spec: BatchSpec, topic_out: str, stop_evt,
                   arena_mb: int, start: int, credits) -> None:
    """The copied packer stage, with a credit taken before each publish and
    the batches below ``start`` packed but not published."""
    dom = Domain.join(domain_name, arena_capacity=arena_mb << 20)
    pub = dom.create_publisher(TOKEN_BATCH, topic_out, depth=DEPTH)
    docs = SyntheticCorpus(spec.vocab_size, seed=spec.seed).shard_iter(spec.host,
                                                                       spec.num_hosts)
    packer = Packer(spec.batch, spec.seq_len)
    step = 0
    while not stop_evt.is_set():
        while not packer.ready():
            packer.feed(next(docs)[1])
        flat, rows = packer.emit()
        if step < start:
            step += 1
            continue
        while not credits.acquire(timeout=0.05):
            if stop_evt.is_set():
                dom.close()
                return
        msg = pub.borrow_loaded_message()
        msg.tokens.extend(flat)
        msg.row_lengths.extend(rows)
        msg.set("stamp", time.monotonic())
        msg.set("step", step)
        msg.set("epoch", 0)
        pub.publish_blocking(msg, should_stop=stop_evt.is_set)
        step += 1
    dom.close()


class OrderedZeroCopyPipeline(ZeroCopyPipeline):
    """``ZeroCopyPipeline`` that delivers batch ``cursor``, ``cursor + 1``,
    ... of the deterministic stream, each once, whatever the trainer's pace,
    from any starting cursor."""

    def __init__(self, spec: BatchSpec, *, cursor: int = 0, **kw):
        self.cursor = cursor
        self._credits = None
        super().__init__(spec, **kw)

    def _spawn(self) -> None:
        # a fresh stage: the dead one's batches are swept, so credits start over
        self._credits = self._ctx.Semaphore(DEPTH - 1)
        self._proc = self._ctx.Process(
            target=_ordered_stage,
            args=(self.dom.name, self.spec, "train/batches", self._stop, self.arena_mb,
                  self.cursor, self._credits),
            daemon=True,
        )
        self._proc.start()

    def next_batch(self, timeout: float = 60.0) -> dict:
        sub = self.feeder.sub
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.ensure_alive()              # a dead stage is respawned from the cursor
            msgs = sub.take(limit=1)
            if not msgs:
                sub.wait(0.05)
                continue
            ptr = msgs[0]
            index = int(ptr.msg.get("step"))
            batch = None
            if index == self.cursor:
                batch = unpack_batch(ptr.msg.tokens, ptr.msg.row_lengths, self.spec.seq_len)
            ptr.release()
            self._credits.release()
            if index > self.cursor:
                raise RuntimeError(f"data plane skipped from batch {self.cursor} to {index}")
            if batch is None:
                continue
            self.cursor += 1
            self.stats.produced += 1
            self.stats.bytes_out += int(batch["tokens"].nbytes)
            return batch
        raise TimeoutError("data plane produced no batch in time")
