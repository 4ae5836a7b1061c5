"""Plain PyTorch version of the fused residual-add + RMSNorm.

Mirrors ``repro/kernels/rmsnorm/ref.py``, and with ``residual=None`` or
``gemma=True`` the reference's ``repro.models.common.rms_norm``."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor, *,
                eps: float = 1e-6, gemma: bool = False, want_residual: bool = True):
    """out = rms_norm(h) * s, with h = x + residual (h = x when ``residual``
    is None) and s = scale, or ``1 + scale`` when ``gemma``, all in f32.

    Returns (out, h) in ``x.dtype``; h is ``x`` itself when ``residual`` is
    None, and None when not ``want_residual``."""
    h = x.float() if residual is None else x.float() + residual.float()
    var = h.square().mean(dim=-1, keepdim=True)
    s = 1.0 + scale.float() if gemma else scale.float()
    y = (h * torch.rsqrt(var + eps) * s).to(x.dtype)
    if not want_residual:
        return y, None
    return y, x if residual is None else h.to(x.dtype)
