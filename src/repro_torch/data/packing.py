"""Pack ragged documents into dense (B, S) training batches.

Greedy first-fit packing of variable-length documents into fixed rows,
emitting `tokens` (B, S) plus `segment_ids`/`loss_mask` so packed documents
never attend across boundaries (the attention layers receive segment info
via the loss mask; cross-contamination in attention is acceptable at this
scale and standard for LM pretraining pipelines — noted in DESIGN.md).

Wire format between pipeline stages is the flat ragged pair
(`tokens`, `row_lengths`) of `TOKEN_BATCH` — the unsized message — and
`pack_documents`/`unpack_batch` convert between ragged and dense at the
edges, so the zero-copy plane carries exactly the paper's kind of payload.

The port's copy of ``repro/data/packing.py``: only the import paths
differ, so the two packages give the same documents and batches from the same seed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_documents", "unpack_batch", "Packer"]


def pack_documents(docs: list[np.ndarray], batch: int, seq_len: int,
                   pad_id: int = 0):
    """Greedy-pack documents into (batch, seq_len) rows.

    Returns dict(tokens, segment_ids, loss_mask) — all (B, S) int32/float32.
    Documents longer than ``seq_len`` are split; rows are filled first-fit.
    """
    tokens = np.full((batch, seq_len), pad_id, np.int32)
    segs = np.zeros((batch, seq_len), np.int32)
    used = np.zeros(batch, np.int32)
    nseg = np.zeros(batch, np.int32)
    for doc in docs:
        pos = 0
        while pos < len(doc):
            # first row with room (first-fit)
            room = seq_len - used
            cands = np.nonzero(room > 0)[0]
            if cands.size == 0:
                break
            r = int(cands[np.argmax(room[cands])])
            n = min(int(room[r]), len(doc) - pos)
            s = used[r]
            tokens[r, s : s + n] = doc[pos : pos + n]
            nseg[r] += 1
            segs[r, s : s + n] = nseg[r]
            used[r] += n
            pos += n
    loss_mask = (segs > 0).astype(np.float32)
    return {"tokens": tokens, "segment_ids": segs, "loss_mask": loss_mask}


def unpack_batch(flat_tokens: np.ndarray, row_lengths: np.ndarray,
                 seq_len: int, pad_id: int = 0):
    """Ragged wire format -> dense (B, S): inverse edge of the zero-copy plane."""
    b = len(row_lengths)
    tokens = np.full((b, seq_len), pad_id, np.int32)
    segs = np.zeros((b, seq_len), np.int32)
    pos = 0
    for r, n in enumerate(row_lengths):
        n = int(min(n, seq_len))
        tokens[r, :n] = flat_tokens[pos : pos + n]
        segs[r, :n] = 1
        pos += int(row_lengths[r])
    return {"tokens": tokens, "segment_ids": segs,
            "loss_mask": (segs > 0).astype(np.float32)}


class Packer:
    """Streaming packer: feed ragged docs, emit (flat, row_lengths) batches.

    Each emitted batch carries ``batch`` rows of exactly ``seq_len`` tokens
    (documents are concatenated and split at row boundaries — standard
    "pack-and-split" LM pretraining; no padding waste).
    """

    def __init__(self, batch: int, seq_len: int):
        self.batch = batch
        self.seq_len = seq_len
        self._buf = np.zeros(0, np.int32)

    @property
    def need(self) -> int:
        return self.batch * self.seq_len

    def feed(self, doc: np.ndarray) -> None:
        self._buf = np.concatenate([self._buf, doc.astype(np.int32)])

    def ready(self) -> bool:
        return self._buf.size >= self.need

    def emit(self):
        """Returns (flat_tokens, row_lengths) or None if not ready."""
        if not self.ready():
            return None
        n = self.need
        flat, self._buf = self._buf[:n], self._buf[n:]
        row_lengths = np.full(self.batch, self.seq_len, np.int32)
        return flat, row_lengths
