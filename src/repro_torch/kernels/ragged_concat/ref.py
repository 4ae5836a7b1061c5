"""Plain PyTorch version of ragged concatenation (the Autoware *concatenate*
node).

Mirrors ``repro/kernels/ragged_concat/ref.py``: N variable-length sources
(padded to Lmax) are packed into one contiguous, zero-filled buffer at the
exclusive prefix sums of their lengths; rows at or past capacity are
dropped."""

from __future__ import annotations

import torch

__all__ = ["ragged_concat_ref", "exclusive_offsets"]


def exclusive_offsets(lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(offsets (N,) int32, total () int32) of ``lengths``."""
    csum = torch.cumsum(lengths.to(torch.int32), 0, dtype=torch.int32)
    offsets = torch.cat([csum.new_zeros(1), csum[:-1]])
    total = csum[-1] if len(csum) else csum.new_zeros(())
    return offsets, total


def ragged_concat_ref(src: torch.Tensor, lengths: torch.Tensor, capacity: int):
    """src: (N, Lmax, C); lengths: (N,) -> (out (capacity, C), offsets, total)."""
    n, lmax, c = src.shape
    offsets, total = exclusive_offsets(lengths)
    out = torch.zeros((capacity, c), dtype=src.dtype, device=src.device)
    rows = torch.arange(lmax, device=src.device)
    for i in range(n):
        valid = rows < lengths[i]
        dest = offsets[i] + rows
        keep = valid & (dest < capacity)
        out[dest[keep]] = src[i][keep]
    return out, offsets, total
