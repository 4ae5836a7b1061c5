"""Public wrapper for the flash attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention/ops.py``.  CPU tensors take
the plain version; CUDA tensors launch the CUDA kernel (one launch counted
in ``flash_attention.launches``) or raise.  The kernel reads q/k/v through
their strides, so the model passes ``x.transpose(1, 2)`` views of its
(B, S, H, hd) activations and nothing is copied or padded.  bf16 runs on
the tensor cores, f32 on the CUDA cores (TF32 would miss the f32 bound).
The bf16 kernel copies 16 bytes a lane and folds a positive scale into
one multiply-add, so for bf16 each data pointer and every stride (in
bytes, but the head dim's) must be a multiple of 16 and the scale
positive; other calls raise.  The f32 kernel reads scalars and takes any
stride and any scale.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._device import (KERNEL_DTYPES, check_aligned, check_launch, device_kind,
                       on_device, stream_of)
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "KERNEL_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (64, 80, 128, 256)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       *([_L] * 12), _I, ctypes.c_float, _P]
        fn.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd) -> (B, H, Sq, hd).

    GQA via H % KV == 0; top-left causal mask.  On CUDA the result is a
    (B, H, Sq, hd) view of a (B, Sq, H, hd) buffer, the model's layout.
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,H,Sq,hd), k/v (B,KV,Sk,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kvh < 1 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        f"{KERNEL_DTYPES}")
    if device_kind(q, k, v) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the CUDA kernel takes {KERNEL_HEAD_DIMS}")
    if sq < 1 or sk < 1:
        raise ValueError(f"empty sequence: Sq={sq}, Sk={sk}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous (stride 1)")
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if q.dtype == torch.bfloat16:
        if not scale > 0:
            raise ValueError(f"scale {scale}: the bf16 kernel takes a positive scale")
        check_aligned("flash_attention", q=q, k=k, v=v, out=out)
    lib = _lib()
    with on_device(q):   # launch on the tensors' card
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if q.dtype == torch.float32 else 1, b, h, kvh, sq, sk, hd,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
            int(causal), float(scale), stream_of(q))
    check_launch(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
