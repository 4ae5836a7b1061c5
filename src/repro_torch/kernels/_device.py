"""The dispatch rule every ``ops`` wrapper follows.

A wrapper takes its plain version only because the tensors it was given
lie on the CPU.  For CUDA tensors it launches its kernel or raises; any
other device raises.  Whether the process could see a GPU is never asked.
"""

from __future__ import annotations

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


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(lib, code: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error (or -1: bad arguments)."""
    if code == 0:
        return
    if code < 0:
        raise ValueError(f"{what}: the kernel refused its arguments (code {code})")
    msg = lib.kernel_error_string(code).decode()
    raise RuntimeError(f"{what}: CUDA launch failed: {msg} (code {code})")
