"""Public wrapper for the ragged concat kernel (``csrc/ragged_concat.cu``).

Counterpart of ``repro/kernels/ragged_concat/ops.py``.  CPU tensors take
the plain version; CUDA tensors launch the CUDA kernel or raise.  On the
card a call is one launch (counted in ``ragged_concat.launches``), also
for N = 0 or capacity 0: the kernel computes the offsets and the total
itself, so no prefix sum, fill or concatenation runs beside it, and no
call reads ``total`` back to the host.  Lengths must be >= 0.

On ``meta`` tensors (the dry run) the wrapper returns outputs of the
kernel's shapes and launches nothing; :func:`ragged_concat_cost` gives the
(FLOPs, bytes) a call is counted at: on the card from the lengths, read
back once a counted call (a sync, only while a cost counter is active);
on ``meta`` every row full.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._device import check_launch, device_kind, kernel_call, on_device, stream_of
from .ref import ragged_concat_ref

__all__ = ["ragged_concat", "ragged_concat_cost", "ragged_concat_ref", "KERNEL_DTYPES"]

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.uint8)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("ragged_concat")
    fn = lib.ragged_concat_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _L, _P]
        fn.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def ragged_concat_cost(n: int, c: int, esize: int, copied: int, capacity: int,
                       len_bytes: int = 4) -> tuple[int, int]:
    """(FLOPs, bytes) of one K4 call: the ``copied`` valid rows of ``c``
    elements of ``esize`` bytes read once, the (capacity, C) output written
    once, the N lengths read and the N int32 offsets written; no
    arithmetic."""
    return 0, esize * c * (copied + capacity) + (len_bytes + 4) * n


def _copied_rows(lengths: torch.Tensor, lmax: int, capacity: int) -> int:
    """Rows a call copies: each length clipped to [0, Lmax], at most the
    capacity in all (every row full on ``meta``)."""
    if lengths.is_meta:
        return min(lengths.shape[0] * lmax, capacity)
    return min(int(lengths.clamp(0, lmax).sum()), capacity)


def ragged_concat(src: torch.Tensor, lengths: torch.Tensor, *, capacity: int):
    """Pack N ragged sources into one contiguous (capacity, C) buffer.

    src: (N, Lmax, C); lengths: (N,).  Returns (out, offsets (N,) int32,
    total () int32)."""
    if src.ndim != 3 or lengths.shape != src.shape[:1]:
        raise ValueError(f"need src (N, Lmax, C) and lengths (N,); got {tuple(src.shape)}, "
                         f"{tuple(lengths.shape)}")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} < 0")
    if src.dtype not in KERNEL_DTYPES:
        raise TypeError(f"src dtype {src.dtype}: need one of {KERNEL_DTYPES}")
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lengths dtype {lengths.dtype}: need an integer type")
    if device_kind(src, lengths) == "cpu":
        return ragged_concat_ref(src, lengths, capacity)
    n, lmax, c = src.shape
    with kernel_call("ragged_concat", lambda: ragged_concat_cost(
            n, c, src.element_size(), _copied_rows(lengths, lmax, capacity), capacity,
            lengths.element_size()), peak=torch.float32):
        lengths = lengths.contiguous()
        # offsets (1,) = [0] at N = 0, as the plain version and the reference give
        offsets = torch.empty((max(n, 1),), dtype=torch.int32, device=src.device)
        total = torch.empty((), dtype=torch.int32, device=src.device)
        out = torch.empty((capacity, c), dtype=src.dtype, device=src.device)
        if not src.is_meta:
            _launch(src, lengths, offsets, total, out, capacity)
    return out, offsets, total


def _launch(src, lengths, offsets, total, out, capacity):
    """The launch, after the checks of what the card reads."""
    n, lmax, c = src.shape
    if not src.is_contiguous():
        raise ValueError("ragged_concat on CUDA needs a contiguous src")
    if c * src.element_size() >= 2 ** 31:
        raise ValueError(f"rows of {c * src.element_size()} bytes: the kernel takes < 2 GiB")
    lib = _lib()
    with on_device(src):   # launch on the tensors' card
        code = lib.ragged_concat_fwd(src.data_ptr(), lengths.data_ptr(),
                                     int(lengths.dtype == torch.int64), offsets.data_ptr(),
                                     total.data_ptr(), out.data_ptr(), n, lmax,
                                     c * src.element_size(), capacity, stream_of(src))
    check_launch(lib, code, "ragged_concat")
    ragged_concat.launches += 1


ragged_concat.launches = 0
