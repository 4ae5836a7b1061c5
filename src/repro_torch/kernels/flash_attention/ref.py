"""Plain PyTorch version of the flash attention kernel (GQA, causal).

Mirrors ``repro/kernels/flash_attention/ref.py``, including its top-left
causal mask (query i sees keys 0..i)."""

from __future__ import annotations

import torch

_NEG = -2.0e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd); GQA via H % KV == 0.

    Returns (B, H, Sq, hd). fp32 softmax, output in q.dtype.
    """
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, kvh, g, sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        pos_q = torch.arange(sq, device=q.device)
        pos_k = torch.arange(sk, device=q.device)
        mask = pos_q[:, None] >= pos_k[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, h, sq, hd).to(q.dtype)
