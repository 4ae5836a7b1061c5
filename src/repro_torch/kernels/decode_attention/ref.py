"""Plain PyTorch version of single-token decode attention with per-request
lengths.

Mirrors ``repro/kernels/decode_attention/ref.py`` with two edges pinned to
the TPU kernel's behaviour instead of the JAX oracle's: a row of length 0
gives 0 (the oracle would spread uniform weights over the masked cache),
and a length above S counts as S."""

from __future__ import annotations

import torch

_NEG = -2.0e38


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, KV, S, hd); lengths: (B,) -> (B, H, hd)."""
    b, h, hd = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.float(), k_cache.float()) * scale
    n = lengths.to(torch.int64).clamp(0, s)
    valid = torch.arange(s, device=q.device)[None, :] < n[:, None]
    logits = torch.where(valid[:, None, None], logits, torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(v_cache.dtype).float(), v_cache.float())
    o = o * (n > 0).to(o.dtype)[:, None, None, None]
    return o.reshape(b, h, hd).to(q.dtype)
