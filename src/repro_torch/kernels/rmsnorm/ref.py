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


def rmsnorm_bwd_ref(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor,
                    dy: torch.Tensor, dh: torch.Tensor | None, *, eps: float = 1e-6,
                    gemma: bool = False):
    """The closed-form gradient of :func:`rmsnorm_ref`, in f32.

    With h = x + residual, rstd = rsqrt(mean(h^2) + eps), x^ = h * rstd,
    s = scale (``1 + scale`` when ``gemma``) and dy the grad of the normed
    output, dh that of the residual output (or None):
    ``dx = dh + rstd * (s dy - x^ mean(s dy x^))``, the grad of both x and
    residual, and ``dscale = sum over rows of dy x^``.  Returns (dx in
    ``x.dtype``, dscale (D,) f32)."""
    d = x.shape[-1]
    h = (x.float() if residual is None else x.float() + residual.float()).reshape(-1, d)
    rstd = torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + eps)
    xhat = h * rstd
    dyf = dy.float().reshape(-1, d)
    g = dyf * (1.0 + scale.float() if gemma else scale.float())
    dx = rstd * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    if dh is not None:
        dx = dx + dh.float().reshape(-1, d)
    return dx.reshape(x.shape).to(x.dtype), (dyf * xhat).sum(dim=0)
