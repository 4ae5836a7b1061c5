"""Public wrapper for the fused residual-add + RMSNorm kernel.

Counterpart of ``repro/kernels/rmsnorm/ops.py``.  CPU tensors take the
plain version; CUDA tensors launch the Triton kernel (one launch counted
in ``fused_rmsnorm.launches``) or raise.
"""

from __future__ import annotations

import torch

from .._device import KERNEL_DTYPES, device_kind
from .kernel import launch
from .ref import rmsnorm_ref

__all__ = ["fused_rmsnorm", "rmsnorm_ref"]


def fused_rmsnorm(x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6):
    """x/residual: (..., D); scale (D,). Returns (normed, new_residual).

    ``new_residual = x + residual`` and ``normed = rms_norm(new_residual) *
    scale``, both in ``x.dtype`` with f32 accumulation."""
    if x.shape != residual.shape:
        raise ValueError(f"x {tuple(x.shape)} and residual {tuple(residual.shape)} differ")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} must be ({d},)")
    if x.dtype != residual.dtype or x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x/residual dtypes {x.dtype}/{residual.dtype}: need one of "
                        f"{KERNEL_DTYPES}")
    if device_kind(x, residual, scale) == "cpu":
        return rmsnorm_ref(x, residual, scale, eps=eps)
    if not (x.is_contiguous() and residual.is_contiguous() and scale.is_contiguous()):
        raise ValueError("fused_rmsnorm on CUDA needs contiguous x, residual and scale")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale dtype {scale.dtype}: the kernel takes float32")
    x2, r2 = x.view(-1, d), residual.view(-1, d)
    y, h = torch.empty_like(x2), torch.empty_like(x2)
    if x2.shape[0]:
        with torch.cuda.device(x.device):   # launch on the tensors' card
            launch(x2, r2, scale, y, h, eps)
        fused_rmsnorm.launches += 1
    return y.view(x.shape), h.view(x.shape)


fused_rmsnorm.launches = 0
