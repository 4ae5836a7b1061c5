"""The dispatch rule every ``ops`` wrapper follows.

A wrapper takes its plain version only because the tensors it was given
lie on the CPU.  For CUDA tensors it launches its kernel or raises; any
other device raises.  Whether the process could see a GPU is never asked.
"""

from __future__ import annotations

import contextlib

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def device_kind(*tensors: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: the one device all ``tensors`` lie on."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    kind = devs.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}: expected cpu or cuda")
    return kind


def check_aligned(what: str, **tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless each tensor's data pointer and the byte
    stride of each of its dims longer than 1, but the last (contiguous,
    checked by the caller), are multiples of 16: the kernels move 16 bytes
    a lane with ``cp.async`` or vector loads."""
    for name, t in tensors.items():
        size = t.element_size()
        bad = [d for d in range(t.ndim - 1) if t.shape[d] > 1 and (t.stride(d) * size) % 16]
        if t.data_ptr() % 16 or bad:
            raise ValueError(f"{what}: {name} must be 16-byte aligned (data_ptr "
                             f"{t.data_ptr() % 16} bytes past 16, strides {t.stride()} of "
                             f"{size}-byte elements, unaligned dims {bad})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle.

    Read straight from PyTorch's C layer (as its own code generator does):
    ``torch.cuda.current_stream`` builds a ``Stream`` object per call, a
    host cost each kernel launch paid."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


_CURRENT = contextlib.nullcontext()


def on_device(t: torch.Tensor):
    """A context in which ``t``'s card is the current device, for a launch:
    nothing to enter when it already is, as on one card; a
    ``torch.cuda.device`` switch otherwise."""
    index = t.get_device()
    return _CURRENT if index == torch.cuda.current_device() else torch.cuda.device(index)


def check_launch(lib, code: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error (or -1: bad arguments)."""
    if code == 0:
        return
    if code < 0:
        raise ValueError(f"{what}: the kernel refused its arguments (code {code})")
    msg = lib.kernel_error_string(code).decode()
    raise RuntimeError(f"{what}: CUDA launch failed: {msg} (code {code})")
