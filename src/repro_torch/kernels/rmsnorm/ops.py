"""Public wrapper for the fused residual-add + RMSNorm kernel (``csrc/rmsnorm.cu``).

Counterpart of ``repro/kernels/rmsnorm/ops.py``, widened to every RMSNorm
of the served models: with or without a residual add in front, with the
scale or Gemma's ``(1 + scale)``, writing the new residual or not.  CPU
tensors take the plain version; CUDA tensors launch the CUDA kernel (one
launch counted in ``fused_rmsnorm.launches``) or raise.

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
from .ref import rmsnorm_ref

__all__ = ["fused_rmsnorm", "rmsnorm_ref"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    lib.rmsnorm_fwd.argtypes = [_P, _P, _P, _P, _P, _L, _I, _L, _L, ctypes.c_float, _I, _I, _P]
    lib.rmsnorm_fwd.restype = _I
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
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise TypeError(f"scale ({scale.dtype}, strides {scale.stride()}): the kernel takes "
                        "a contiguous float32 scale")
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
