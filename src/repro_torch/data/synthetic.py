"""Deterministic synthetic document stream.

Documents are *unsized*: lengths are drawn from a log-normal (clipped), the
shape that makes fixed-slot transports (TZC/LOT/IceOryx-static) awkward and
that the agnocast plane handles natively. The stream is seeded and sharded
by (host, num_hosts) so every host in a multi-pod job sees a disjoint,
reproducible sub-stream — restart-safe: the stream can be fast-forwarded to
any step without replaying data.

The port's copy of ``repro/data/synthetic.py``: only the import paths
differ, so the two packages give the same documents and batches from the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticCorpus"]


@dataclass
class SyntheticCorpus:
    """Reproducible stream of variable-length token documents.

    ``doc(i)`` is a pure function of (seed, i): any host can regenerate any
    document, which is what makes checkpoint/restart of the data plane a
    cursor save rather than a buffer dump.
    """

    vocab_size: int
    seed: int = 0
    mean_len: float = 512.0
    sigma: float = 0.8
    min_len: int = 16
    max_len: int = 8192

    def doc_length(self, index: int) -> int:
        rng = np.random.default_rng((self.seed, 0xD0C, index))
        ln = rng.lognormal(mean=np.log(self.mean_len), sigma=self.sigma)
        return int(np.clip(ln, self.min_len, self.max_len))

    def doc(self, index: int) -> np.ndarray:
        """Tokens of document ``index`` (int32, shape (len,))."""
        rng = np.random.default_rng((self.seed, 0x70C5, index))
        n = self.doc_length(index)
        # skewed unigram distribution (zipf-ish) so losses are non-trivial
        z = rng.zipf(1.3, size=n).astype(np.int64)
        return ((z - 1) % self.vocab_size).astype(np.int32)

    def shard_iter(self, host: int, num_hosts: int, start: int = 0):
        """Infinite iterator over this host's documents, resumable at
        ``start`` (documents host receives: host, host+num_hosts, ...)."""
        i = host + start * num_hosts
        while True:
            yield i, self.doc(i)
            i += num_hosts
