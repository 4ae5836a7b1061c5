"""Public wrapper for the decode attention kernel (``csrc/decode_attention.cu``).

Counterpart of ``repro/kernels/decode_attention/ops.py``.  CPU tensors take
the plain version; CUDA tensors launch the kernel once (counted in
``decode_attention.launches``) or raise.  The caches are read through their
strides: the model passes one layer of its (B, Smax, KV, hd) cache as a
``transpose(1, 2)`` view, and q, the caches and their strides must be
16-byte aligned (the kernel loads 16 bytes a lane).

The sequence is split among blocks of :func:`decode_split_plan` positions;
the splits of one request merge inside the same launch through a ticket
counter per (request, KV head, row group).  Up to 8 query heads per KV head
run in one block; more (at most 16) run as :func:`decode_row_groups`, each
its own block.  The counters live in one int32 buffer per
(device, stream), zeroed when it is allocated; every call leaves them 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._device import (KERNEL_DTYPES, check_aligned, check_launch, device_kind,
                       on_device, stream_of)
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref", "decode_row_groups",
           "decode_split_plan", "KERNEL_HEAD_DIMS", "KERNEL_MAX_GROUP"]

KERNEL_HEAD_DIMS = (64, 80, 128, 256)
KERNEL_MAX_GROUP = 16
_BLOCK_ROWS = 8                 # query rows one block runs (kMaxG in the source)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}     # (device, stream) -> int32 counters


def decode_row_groups(g: int) -> tuple[int, int]:
    """(row groups, rows per group) for ``g`` query heads per KV head:
    ``ceil(g / 8)`` groups of ``ceil(g / groups)`` rows, the last holding
    the rest (``row_groups``/``group_rows`` in ``csrc/decode_attention.cu``).
    Group ``r`` of KV head ``h`` owns query heads ``h * g + r * rows`` up to
    ``min(rows, g - r * rows)`` of them."""
    groups = -(-g // _BLOCK_ROWS)
    return groups, -(-g // groups)


def decode_split_plan(s: int, b: int, kv: int, sms: int, row_groups: int = 1
                      ) -> tuple[int, int]:
    """(positions per block, splits) for a cache of ``s`` positions.

    The grid is (splits, kv * row_groups, b).  Aim at ``ceil(sms / (b * kv
    * row_groups))`` splits, about one block per SM, and round each split
    up to a multiple of 32 positions (one block iteration of the kernel
    reads 16-64)."""
    want = -(-sms // (b * kv * row_groups))
    per = 32 * -(-s // (32 * want))
    return per, -(-s // per)


def _row_slots(g: int) -> int:
    """Row slots the kernel runs for ``g`` query rows of a row group: 1, 2,
    4, 6 and 8 are built, and an odd ``g`` runs in the next even build
    (``row_slots`` in ``csrc/decode_attention.cu``); the scratch is sized
    by it."""
    return g if g == 1 else g + g % 2


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 7 + [_L] * 10 + [ctypes.c_float, _P]
        fn.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, hd); caches (B, KV, S, hd); lengths (B,) -> (B, H, hd).

    Row b attends to cache positions ``[0, min(lengths[b], S))``; a row of
    length 0 gives 0."""
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need q (B,H,hd), caches (B,KV,S,hd); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, hd = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != hd or kvh < 1 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches {tuple(k_cache.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 ({b},); got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q/cache dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: need "
                        f"one of {KERNEL_DTYPES}")
    if device_kind(q, k_cache, v_cache, lengths) == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the CUDA kernel takes {KERNEL_HEAD_DIMS}")
    if h // kvh > KERNEL_MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per KV head: the kernel takes at most "
                         f"{KERNEL_MAX_GROUP}")
    if s < 1:
        raise ValueError("empty cache (S = 0)")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("the head dim of q and the caches must be contiguous (stride 1)")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    scale = hd ** -0.5 if scale is None else scale
    check_aligned("decode_attention", q=q, k_cache=k_cache, v_cache=v_cache)
    lib = _lib()
    dev = q.device
    groups, group_rows = decode_row_groups(h // kvh)
    per, ns = decode_split_plan(s, b, kvh, _sm_count(dev.index), groups)
    out = torch.empty((b, h, hd), dtype=q.dtype, device=dev)
    rows = b * kvh * groups * ns * _row_slots(group_rows)
    part = torch.empty((hd + 2) * rows, dtype=torch.float32, device=dev)
    pacc, pm, pl = part.split([rows * hd, rows, rows])    # acc first: 16-byte aligned
    stream = stream_of(q)
    tickets = _tickets(dev, stream, b * kvh * groups)
    with on_device(q):   # launch on the tensors' card
        code = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), tickets.data_ptr(),
            0 if q.dtype == torch.float32 else 1, b, h, kvh, s, hd, per,
            q.stride(0), q.stride(1), k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2), out.stride(0),
            out.stride(1), float(scale), stream)
    check_launch(lib, code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
