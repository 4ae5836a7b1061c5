"""Fused residual-add + RMSNorm, a Triton kernel for Hopper.

Replaces the Pallas TPU kernel ``rmsnorm_kernel`` / ``_kernel`` in
``repro/kernels/rmsnorm/kernel.py``.

What bounds it on the H100: bytes.  Per element it reads x and r and
writes y and h (plus one read of the D-wide scale per row) and does a
handful of flops, far below the ~295 flops/byte at which the card turns
compute-bound.  The design moves exactly those 2-read / 2-write bytes:
one program per row holds the whole row (D = 1536 on the main path, one
power-of-two block) in registers, adds, reduces the sum of squares once in
f32 and writes both outputs, so h is never re-read from device memory.
Triton serves this as well as CUDA C++ would: there is no matrix product,
and a block-per-row program makes the same coalesced loads and stores.
The TPU kernel's row tiles of 256 existed to fill VMEM; on the GPU a row
per program gives R programs, which at decode (R = 4 slots) is launch-bound
whatever the tiling.

``triton`` is imported at the first launch, never at module import: the
CPU-only test environment has no triton.  Unless ``TRITON_CACHE_DIR`` is
set, Triton's compiled kernels go to ``build/triton/`` beside the CUDA
libraries, inside the checkout.
"""

from __future__ import annotations

import functools
import os

import torch

from .._build import BUILD_DIR


@functools.cache
def _jit():
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_fwd(x_ptr, r_ptr, s_ptr, y_ptr, h_ptr, D, eps,
                    BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        off = row * D + cols
        x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        r = tl.load(r_ptr + off, mask=mask, other=0.0).to(tl.float32)
        h = x + r
        var = tl.sum(h * h, axis=0) / D
        rstd = 1.0 / tl.sqrt(var + eps)
        s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = h * rstd * s
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)
        tl.store(h_ptr + off, h.to(h_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_fwd


def launch(x2: torch.Tensor, r2: torch.Tensor, scale: torch.Tensor,
           y2: torch.Tensor, h2: torch.Tensor, eps: float) -> None:
    """x2, r2, y2, h2: contiguous (R, D) CUDA tensors; scale: (D,)."""
    triton, kern = _jit()
    rows, d = x2.shape
    block = triton.next_power_of_2(d)
    kern[(rows,)](x2, r2, scale, y2, h2, d, eps, BLOCK_D=block,
                  num_warps=4 if block <= 2048 else 8)
