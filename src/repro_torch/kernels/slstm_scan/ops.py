"""Public wrapper for the sLSTM scan kernel (``csrc/slstm_scan.cu``).

Counterpart of ``repro/kernels/slstm_scan/ops.py``.  CPU tensors take the
plain version; CUDA tensors launch the cooperative CUDA kernel (one launch
per call, whatever S, counted in ``slstm_scan.launches``) or raise.  Any
S >= 1 is taken as it is: no padding, no ``valid_len``.  The outputs are
new tensors, never the inputs: the kernel's blocks read ``h0`` across
their grid barrier, so a caller that keeps the state in a cache copies
the returned state into it after the call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._device import KERNEL_DTYPES, check_launch, device_kind, stream_of
from .ref import slstm_scan_ref

__all__ = ["slstm_scan", "slstm_scan_ref", "slstm_scan_plan", "grid_sync_loop"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("slstm_scan")
    fn = lib.slstm_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 13 + [_I] * 6 + [_P]
        fn.restype = _I
        lib.slstm_scan_plan.argtypes = [_I] * 5 + [ctypes.POINTER(_I)] * 2
        lib.slstm_scan_plan.restype = _I
        lib.slstm_grid_sync_loop.argtypes = [_I, _I, _P]
        lib.slstm_grid_sync_loop.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _refused(code: int, what: str, b: int, d: int, h: int) -> None:
    if code == -2:
        raise RuntimeError(f"{what}: no cooperative grid for B={b} D={d} H={h} can be "
                           f"resident on this card (shared memory or block count)")


def slstm_scan_plan(b: int, d: int, h: int, *, x_dtype=torch.bfloat16,
                    w_dtype=torch.bfloat16) -> tuple[int, int]:
    """(hidden indices per block, blocks) of the grid the kernel would use."""
    lib = _lib()
    j, grid = _I(), _I()
    code = lib.slstm_scan_plan(int(x_dtype == torch.bfloat16), int(w_dtype == torch.bfloat16),
                               b, d, h, ctypes.byref(j), ctypes.byref(grid))
    _refused(code, "slstm_scan_plan", b, d, h)
    check_launch(lib, code, "slstm_scan_plan")
    return j.value, grid.value


def grid_sync_loop(grid: int, steps: int, device: torch.device) -> None:
    """``steps`` grid barriers over ``grid`` cooperative blocks: the serial
    chain's floor for a grid of that size (timing only; not a kernel of the
    path, and not counted)."""
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.slstm_grid_sync_loop(grid, steps, torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, code, "grid_sync_loop")


def slstm_scan(xg: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor):
    """sLSTM recurrence over (B, S, 4D) pre-projected gates, resuming from
    (h0, c0, n0, m0) (B, D) f32.  w_hh: (H, dh, 4dh); b_ih: (4D,) f32.
    Returns (hs (B, S, D) f32, (h, c, n, m) each (B, D) f32)."""
    if xg.ndim != 3 or w_hh.ndim != 3:
        raise ValueError(f"need xg (B,S,4D), w_hh (H,dh,4dh); got {tuple(xg.shape)}, "
                         f"{tuple(w_hh.shape)}")
    b, s, d4 = xg.shape
    d = d4 // 4
    nh = w_hh.shape[0]
    if d4 % 4 or nh < 1 or d % nh or w_hh.shape[1:] != (d // nh, 4 * (d // nh)):
        raise ValueError(f"w_hh {tuple(w_hh.shape)} does not fit xg {tuple(xg.shape)}")
    if b_ih.shape != (d4,):
        raise ValueError(f"b_ih {tuple(b_ih.shape)} must be ({d4},)")
    for name, t in zip("hcnm", (h0, c0, n0, m0)):
        if t.shape != (b, d):
            raise ValueError(f"{name}0 {tuple(t.shape)} must be ({b}, {d})")
    if xg.dtype not in KERNEL_DTYPES or w_hh.dtype not in KERNEL_DTYPES:
        raise TypeError(f"xg/w_hh dtypes {xg.dtype}/{w_hh.dtype}: need one of {KERNEL_DTYPES}")
    if device_kind(xg, w_hh, b_ih, h0, c0, n0, m0) == "cpu":
        return slstm_scan_ref(xg, w_hh, b_ih, h0, c0, n0, m0)
    if s < 1:
        raise ValueError("the CUDA kernel takes S >= 1")
    if any(t.dtype != torch.float32 for t in (b_ih, h0, c0, n0, m0)):
        raise TypeError("b_ih and the states must be float32 for the CUDA kernel")
    if not all(t.is_contiguous() for t in (xg, w_hh, b_ih, h0, c0, n0, m0)):
        raise ValueError("slstm_scan on CUDA needs contiguous inputs")
    hs = torch.empty((b, s, d), dtype=torch.float32, device=xg.device)
    out = torch.empty((4, b, d), dtype=torch.float32, device=xg.device)
    hbuf = torch.empty((2, b, d), dtype=torch.float32, device=xg.device)
    lib = _lib()
    with torch.cuda.device(xg.device):   # launch on the tensors' card
        code = lib.slstm_scan_fwd(
            xg.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            n0.data_ptr(), m0.data_ptr(), hs.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(), hbuf.data_ptr(),
            int(xg.dtype == torch.bfloat16), int(w_hh.dtype == torch.bfloat16), b, s, d, nh,
            stream_of(xg))
    _refused(code, "slstm_scan", b, d, nh)
    check_launch(lib, code, "slstm_scan")
    slstm_scan.launches += 1
    return hs, tuple(out.unbind(0))


slstm_scan.launches = 0
