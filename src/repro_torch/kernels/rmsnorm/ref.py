"""Plain PyTorch version of the fused residual-add + RMSNorm.

Mirrors ``repro/kernels/rmsnorm/ref.py``."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6):
    """out = rms_norm(x + residual) * scale; also returns the new residual."""
    h = x.float() + residual.float()
    var = h.square().mean(dim=-1, keepdim=True)
    y = h * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype), h.to(x.dtype)
