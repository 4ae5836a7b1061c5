"""Plain PyTorch version of the flash attention kernel (GQA, causal), and
of its backward.

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


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            scale: float | None = None):
    """The closed-form gradient of :func:`flash_attention_ref`, in f32.

    ``o`` is the forward's output and ``do`` its grad, (B, H, Sq, hd).  With
    p the softmax of the scaled, masked scores: dv = p~^T do (p~: p rounded
    to v's type, as the forward's P.V takes it), dp = do v^T, ds = p (dp -
    delta) with delta = rowsum(do * o), dq = scale ds k, dk = scale ds^T q;
    dk and dv of a KV head summed over its G query heads.  Returns (dq, dk,
    dv) in the inputs' type."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, kvh, g, sq, hd).float()
    dog = do.reshape(b, kvh, g, sq, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    if causal:
        pos_q = torch.arange(sq, device=q.device)
        pos_k = torch.arange(sk, device=q.device)
        s = torch.where(pos_q[:, None] >= pos_k[None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    delta = (do.float() * o.float()).sum(dim=-1).reshape(b, kvh, g, sq, 1)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p.to(v.dtype).float(), dog)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vf) - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    return dq.reshape(b, h, sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
