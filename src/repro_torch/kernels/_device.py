"""The dispatch rule every ``ops`` wrapper follows, and its cost record.

A wrapper takes its plain version only because the tensors it was given
lie on the CPU.  For CUDA tensors it launches its kernel or raises; for
``meta`` tensors it returns outputs of the kernel's shapes and dtypes and
launches nothing (the dry run's path); any other device raises.  Whether
the process could see a GPU is never asked.

Where a wrapper launches its kernel, or stands in for it on ``meta``, it
opens a :class:`kernel_call`: while a cost counter
(``repro_torch.launch.cost_analysis``) is active, that records the
kernel's ``cost`` (FLOPs, bytes) once and hides the aten ops the wrapper
runs around the launch (allocations, copies, the K5-bwd ``dw_hh``
product), so a count reads the same formula on the card and on ``meta``.
With no counter active it costs one list test.
"""

from __future__ import annotations

import contextlib

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def device_kind(*tensors: torch.Tensor) -> str:
    """``"cpu"``, ``"cuda"`` or ``"meta"``: the one device all ``tensors``
    lie on."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    kind = devs.pop().type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device type {kind!r}: expected cpu, cuda or meta")
    return kind


# the active cost counters, innermost last (``cost_analysis.count`` pushes one)
COUNTERS: list = []


class kernel_call:
    """``with kernel_call(name, cost, *args, peak=dtype):`` around a kernel's
    launch, or its ``meta`` stand-in.  With a counter active, ``cost(*args)``
    -> (flops, bytes) is recorded as one call of ``name`` (its FLOPs at the
    peak rate of ``peak``: ``torch.bfloat16`` the tensor cores', else the
    f32 CUDA cores'), and the aten ops inside the block (the cost's own
    included) are not counted."""

    __slots__ = ("counter", "name", "cost", "args", "peak")

    def __init__(self, name: str, cost, *args, peak: torch.dtype):
        self.counter = COUNTERS[-1] if COUNTERS else None
        if self.counter is not None:
            self.name, self.cost, self.args, self.peak = name, cost, args, peak

    def __enter__(self):
        if self.counter is not None:
            self.counter.hidden += 1
            self.counter.record_kernel(self.name, *self.cost(*self.args), self.peak)

    def __exit__(self, *exc):
        if self.counter is not None:
            self.counter.hidden -= 1


class uncounted:
    """``with uncounted():`` hides the aten ops inside the block from an
    active counter, recording nothing for them: for a host read the card
    needs and ``meta`` replaces by a rule (the MoE dropless path's group
    sizes)."""

    __slots__ = ("counter",)

    def __enter__(self):
        self.counter = COUNTERS[-1] if COUNTERS else None
        if self.counter is not None:
            self.counter.hidden += 1

    def __exit__(self, *exc):
        if self.counter is not None:
            self.counter.hidden -= 1


def empty_like(t: torch.Tensor) -> torch.Tensor:
    """``torch.empty_like(t)``, with the card's strides on ``meta`` too: the
    card keeps a dense tensor's strides, those of its size-1 dims included
    (a (1, 1, D) row of a (1, S, D) tensor keeps its stride S D), where
    ``meta`` makes them up anew, and a later op can then take another path
    on each (``matmul`` chose ``bmm`` on the card and ``mm`` on ``meta`` for
    such a row), so a count would differ."""
    if t.is_meta and _dense(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
    return torch.empty_like(t)


def _dense(t: torch.Tensor) -> bool:
    """Non-overlapping and dense: the strides of its dims longer than 1,
    sorted, are those of a contiguous tensor of their sizes."""
    expect = 1
    for stride, size in sorted((st, n) for n, st in zip(t.shape, t.stride()) if n != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _unaligned_dims(t: torch.Tensor) -> list[int]:
    size = t.element_size()
    return [d for d in range(t.ndim - 1) if t.shape[d] > 1 and (t.stride(d) * size) % 16]


def is_aligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s data pointer and the byte stride of each of its dims
    longer than 1, but the last, are multiples of 16."""
    return t.data_ptr() % 16 == 0 and not _unaligned_dims(t)


def check_aligned(what: str, **tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless each tensor is :func:`is_aligned` (the
    last dim is contiguous, checked by the caller): the kernels move 16
    bytes a lane with ``cp.async`` or vector loads."""
    for name, t in tensors.items():
        size = t.element_size()
        bad = _unaligned_dims(t)
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
