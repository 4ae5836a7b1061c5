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

Training: when grad is enabled and q, k or v requires it, a CUDA call goes
through ``_FlashFn``, a ``torch.autograd.Function``: its forward also
stores each row's logsumexp, and its backward is the K2-bwd kernel
(``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd``, one call
counted in ``flash_attention_bwd.launches``).  CPU calls take the plain
version, which autograd differentiates; under ``no_grad`` (serving) the
forward kernel is launched directly with no logsumexp stored.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._device import (KERNEL_DTYPES, check_aligned, check_launch, device_kind,
                       on_device, stream_of)
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_ref", "KERNEL_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (64, 80, 128, 256)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashFn.apply(q, k, v, causal, scale)
    return _launch_fwd(q, k, v, causal, scale, None)


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                scale: float | None, lse: torch.Tensor | None) -> torch.Tensor:
    """The forward kernel on CUDA tensors (checked by the caller for shape,
    dtype and device); writes each row's logsumexp into ``lse`` (B, H, Sq)
    f32 when it is given."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
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
            None if lse is None else lse.data_ptr(),
            0 if q.dtype == torch.float32 else 1, b, h, kvh, sq, sk, hd,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
            int(causal), float(scale), stream_of(q))
    check_launch(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class _FlashFn(torch.autograd.Function):
    """K2 with K2-bwd as its gradient: the forward keeps q, k, v, the output
    and each row's logsumexp (B, H, Sq) f32 for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = _launch_fwd(q, k, v, causal, scale, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [*([_P] * 10), *([_I] * 7), *([_L] * 24), _I, ctypes.c_float, _P]
        fn.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor | None, *, causal: bool = True,
                        scale: float | None = None):
    """Gradient of :func:`flash_attention` at (q, k, v): ``o`` its output,
    ``do`` the output's grad, ``lse`` (B, H, Sq) f32 the rows' logsumexp
    from the forward (unused, and may be None, on the CPU).  Returns (dq,
    dk, dv) in the inputs' type; on CUDA laid out as (B, S, heads, hd)
    buffers seen as (B, heads, S, hd), the model's layout.  CPU tensors
    take :func:`flash_attention_bwd_ref`; CUDA tensors launch K2-bwd (one
    call, three kernels, counted in ``flash_attention_bwd.launches``) or
    raise."""
    if device_kind(q, k, v, o, do) == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, causal=causal, scale=scale)
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the CUDA kernel takes {KERNEL_HEAD_DIMS}")
    if o.shape != q.shape or do.shape != q.shape or lse is None or \
            lse.shape != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"o/do must be q's {tuple(q.shape)} and lse a contiguous f32 "
                         f"({b}, {h}, {sq}); got o {tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"lse {None if lse is None else (tuple(lse.shape), lse.dtype)}")
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if any(t.stride(-1) != 1 for t in (q, k, v, o)):
        raise ValueError("the head dim of q, k, v and o must be contiguous (stride 1)")
    scale = hd ** -0.5 if scale is None else scale
    dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, kvh, hd), dtype=k.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((b, sk, kvh, hd), dtype=v.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _lib_bwd()
    strides = [st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]]
    with on_device(q):
        code = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            0 if q.dtype == torch.float32 else 1, b, h, kvh, sq, sk, hd, *strides,
            int(causal), float(scale), stream_of(q))
    check_launch(lib, code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
