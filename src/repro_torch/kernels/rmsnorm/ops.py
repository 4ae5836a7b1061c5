"""Public wrapper for the fused residual-add + RMSNorm kernel (``csrc/rmsnorm.cu``).

Counterpart of ``repro/kernels/rmsnorm/ops.py``, widened to every RMSNorm
of the served models: with or without a residual add in front, with the
scale or Gemma's ``(1 + scale)``, writing the new residual or not.  CPU
tensors take the plain version; CUDA tensors launch the CUDA kernel (one
launch counted in ``fused_rmsnorm.launches``) or raise.

Training: when grad is enabled and an input requires it, a CUDA call goes
through ``_RMSNormFn``, a ``torch.autograd.Function`` whose backward is
the K1-bwd kernel (``rmsnorm_bwd``, one launch counted in
``rmsnorm_bwd.launches``); CPU calls take the plain version, which
autograd differentiates.  Under ``no_grad`` (serving) the call launches
the forward kernel directly, with nothing saved.

On the decode path a call moves a few tens of KB, so the wrapper's own host
time, not the kernel's, is what a call costs.  It binds the C function
once, allocates its outputs with ``torch.empty_like`` (a third of
``torch.empty``'s argument parsing), compares devices as integers, reads
the stream handle without building a ``Stream`` and switches devices only
when the tensors are not on the current one (``kernels/_device.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._device import KERNEL_DTYPES, check_launch, device_kind, on_device, stream_of
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["fused_rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_blocks", "rmsnorm_bwd_ref",
           "rmsnorm_ref"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    lib.rmsnorm_fwd.argtypes = [_P, _P, _P, _P, _P, _L, _I, _L, _L, ctypes.c_float, _I, _I, _P]
    lib.rmsnorm_fwd.restype = _I
    lib.rmsnorm_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _L, ctypes.c_float,
                                _I, _I, _I, _P]
    lib.rmsnorm_bwd.restype = _I
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _row_stride(t: torch.Tensor, d: int, name: str) -> int:
    """Elements between consecutive rows of ``t`` read as (-1, d); raises
    unless its leading dims merge into one evenly strided dim of rows."""
    if t.is_contiguous():
        return d
    row = expect = None
    for size, st in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
        if size == 1:
            continue
        if row is None:
            row = st
        elif st != expect:
            row = -1
            break
        expect = st * size
    if (t.stride(-1) != 1 and d > 1) or row == -1:
        raise ValueError(f"fused_rmsnorm on CUDA: {name} {tuple(t.shape)} with strides "
                         f"{t.stride()} is not evenly strided rows of {d} elements")
    return d if row is None else row


def fused_rmsnorm(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor, *,
                  eps: float = 1e-6, gemma: bool = False, want_residual: bool = True):
    """x/residual: (..., D); scale (D,) f32.  Returns (normed, new_residual).

    ``new_residual = x + residual`` and ``normed = rms_norm(new_residual) *
    s`` with ``s = scale`` (``1 + scale`` when ``gemma``), both in
    ``x.dtype`` with f32 accumulation.  ``residual=None`` norms ``x`` alone
    and gives ``x`` back as ``new_residual``; ``want_residual=False`` gives
    None there and, on the card, stores no residual.  On CUDA the rows of
    ``x`` and ``residual`` may be strided (a (B, 1, D) slice of a (B, S, D)
    tensor); the outputs are contiguous."""
    d = x.shape[-1]
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and residual {tuple(residual.shape)} differ")
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} must be ({d},)")
    if x.dtype not in KERNEL_DTYPES or residual is not None and residual.dtype != x.dtype:
        raise TypeError(f"x/residual dtypes {x.dtype}/"
                        f"{None if residual is None else residual.dtype}: need one of "
                        f"{KERNEL_DTYPES}, the same for both")
    dev = x.get_device()                 # -1 off CUDA; cheaper than comparing .device
    if dev < 0 or scale.get_device() != dev or \
            residual is not None and residual.get_device() != dev:
        inputs = (x, scale) if residual is None else (x, residual, scale)
        if device_kind(*inputs) == "cpu":    # raises for mixed or other devices
            return rmsnorm_ref(x, residual, scale, eps=eps, gemma=gemma,
                               want_residual=want_residual)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or
                                    residual is not None and residual.requires_grad):
        out = _RMSNormFn.apply(x, residual, scale, eps, gemma, want_residual)
        if residual is not None and want_residual:
            return out
        return out, x if want_residual else None
    return _launch_fwd(x, residual, scale, eps, gemma, want_residual)


def _check_scale(scale: torch.Tensor) -> None:
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise TypeError(f"scale ({scale.dtype}, strides {scale.stride()}): the kernel takes "
                        "a contiguous float32 scale")


def _launch_fwd(x, residual, scale, eps, gemma, want_residual):
    """The forward kernel on CUDA tensors: (y, new_residual) as
    :func:`fused_rmsnorm` returns them."""
    d = x.shape[-1]
    _check_scale(scale)
    sx = _row_stride(x, d, "x")
    sr = 0 if residual is None else _row_stride(residual, d, "residual")
    # contiguous for every x _row_stride accepts (dense rows, or rows with gaps)
    y = torch.empty_like(x)
    h = torch.empty_like(x) if residual is not None and want_residual else None
    rows = x.numel() // d if d else 0
    if rows:
        lib = _lib()
        r_ptr = None if residual is None else residual.data_ptr()
        h_ptr = None if h is None else h.data_ptr()
        with on_device(x):   # launch on the tensors' card
            code = lib.rmsnorm_fwd(x.data_ptr(), r_ptr, scale.data_ptr(), y.data_ptr(), h_ptr,
                                   rows, d, sx, sr, eps, int(gemma),
                                   int(x.dtype == torch.bfloat16), stream_of(x))
        check_launch(lib, code, "fused_rmsnorm")
        fused_rmsnorm.launches += 1
    if residual is None:
        return y, x if want_residual else None
    return y, h


fused_rmsnorm.launches = 0


class _RMSNormFn(torch.autograd.Function):
    """K1 with K1-bwd as its gradient.  Returns y, or (y, h) when a residual
    is added and wanted.  Saves x, the residual and the scale (not h):
    the backward forms h again in f32, as the plain version does."""

    @staticmethod
    def forward(ctx, x, residual, scale, eps, gemma, want_residual):
        y, h = _launch_fwd(x, residual, scale, eps, gemma, want_residual)
        ctx.save_for_backward(x, residual, scale)
        ctx.eps, ctx.gemma = eps, gemma
        return (y, h) if residual is not None and want_residual else y

    @staticmethod
    def backward(ctx, dy, dh=None):
        x, residual, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, residual, scale, dy, dh, eps=ctx.eps, gemma=ctx.gemma)
        return (dx, None if residual is None else dx,
                dscale if ctx.needs_input_grad[2] else None, None, None, None)


def rmsnorm_bwd_blocks(rows: int, d: int, sms: int) -> int:
    """Blocks of one K1-bwd launch: 8 rows at a time a block (a warp each)
    for D <= 256, else one; at most 4 a streaming multiprocessor.  Each
    block writes one partial row of dscale, summed in block order, so the
    result depends only on the shapes and the card."""
    rpb = 8 if d <= 256 else 1
    return max(1, min(-(-rows // rpb), 4 * sms))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rmsnorm_bwd(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor,
                dy: torch.Tensor, dh: torch.Tensor | None, *, eps: float = 1e-6,
                gemma: bool = False):
    """Gradient of :func:`fused_rmsnorm` at (x, residual, scale): dy the grad
    of the normed output, dh that of the residual output (or None).
    Returns (dx, dscale): dx in ``x.dtype``, the grad of x and of residual
    alike; dscale (D,) f32.  CPU tensors take :func:`rmsnorm_bwd_ref`; CUDA
    tensors launch K1-bwd (one launch counted in ``rmsnorm_bwd.launches``)
    or raise.  D up to 8192."""
    d = x.shape[-1]
    if dy.shape != x.shape or dh is not None and dh.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} / dh "
                         f"{None if dh is None else tuple(dh.shape)} must be x's "
                         f"{tuple(x.shape)}")
    inputs = [t for t in (x, residual, scale, dy, dh) if t is not None]
    if device_kind(*inputs) == "cpu":
        return rmsnorm_bwd_ref(x, residual, scale, dy, dh, eps=eps, gemma=gemma)
    _check_scale(scale)
    if d > 8192:
        raise ValueError(f"rmsnorm_bwd on CUDA: D = {d} above the kernel's 8192")
    dy = dy.to(x.dtype).contiguous()
    dh = None if dh is None else dh.to(x.dtype).contiguous()
    sx = _row_stride(x, d, "x")
    sr = 0 if residual is None else _row_stride(residual, d, "residual")
    rows = x.numel() // d if d else 0
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # the dscale kernel writes every element; with no rows nothing launches
    dscale = (torch.empty if rows else torch.zeros)(d, dtype=torch.float32, device=x.device)
    if rows:
        nb = rmsnorm_bwd_blocks(rows, d, _sm_count(x.get_device()))
        part = torch.empty((nb, d), dtype=torch.float32, device=x.device)
        lib = _lib()
        with on_device(x):
            code = lib.rmsnorm_bwd(x.data_ptr(), None if residual is None else residual.data_ptr(),
                                   scale.data_ptr(), dy.data_ptr(),
                                   None if dh is None else dh.data_ptr(), dx.data_ptr(),
                                   part.data_ptr(), dscale.data_ptr(), rows, d, sx, sr, eps,
                                   int(gemma), int(x.dtype == torch.bfloat16), nb, stream_of(x))
        check_launch(lib, code, "rmsnorm_bwd")
        rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_bwd.launches = 0
