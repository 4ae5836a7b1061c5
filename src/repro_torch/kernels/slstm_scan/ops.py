"""Public wrapper for the sLSTM scan kernels (``csrc/slstm_scan.cu``).

Counterpart of ``repro/kernels/slstm_scan/ops.py``.  CPU tensors take the
plain version; CUDA tensors launch one CUDA kernel per call, whatever S
(counted in ``slstm_scan.launches``), or raise.  Where a thread-block
cluster's shared memory holds one head's ``w_hh`` (bf16 at full width),
the call is one cluster per head (``slstm_scan_cluster``); else (f32 at
full width) one cooperative grid (``slstm_scan_grid``).  The choice
follows the dtypes and the shape alone: :func:`cluster_plan` states the
rule, and :func:`slstm_scan_plan` reports what the library chose.  Any
S >= 1 is taken as it is: no padding, no ``valid_len``.  The outputs are
new tensors, never the inputs: other blocks read ``h0`` across their
barriers, so a caller that keeps the state in a cache copies the returned
state into it after the call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .._device import KERNEL_DTYPES, check_launch, device_kind, on_device, stream_of
from .ref import slstm_scan_ref

__all__ = ["slstm_scan", "slstm_scan_ref", "slstm_scan_plan", "cluster_plan", "Plan",
           "grid_sync_loop", "cluster_sync_loop"]

_P, _I = ctypes.c_void_p, ctypes.c_int

CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_ROWS = 2                 # batch rows per pass of the cluster kernel's product


class Plan(NamedTuple):
    """What a call launches: ``variant`` "cluster" or "grid", ``j`` hidden
    indices per block, ``blocks``, ``cluster`` blocks per cluster (0 for the
    grid), ``smem`` dynamic shared memory per block in bytes, and
    ``active`` clusters (grid: blocks) the card holds at once."""
    variant: str
    j: int
    blocks: int
    cluster: int
    smem: int
    active: int


def cluster_smem(b: int, dh: int, j: int, cs: int, x_bytes: int, w_bytes: int) -> int:
    """Dynamic shared memory of one block of a cluster of ``cs`` blocks
    (``cluster_smem`` in the CUDA source): two barriers, the w slice, the h
    double buffer (rows of cs J), the xg double buffer, the gates' two
    k-halves, (c, n, m) and the bias."""
    w, bp = 4 * j, (1 if b == 1 else -(-b // CLUSTER_ROWS) * CLUSTER_ROWS)
    return 16 + (dh * w * w_bytes + 15) // 16 * 16 + 8 * bp * cs * j + \
        2 * bp * w * x_bytes + 4 * (2 * bp * w + 3 * bp * j + w)


def cluster_plan(b: int, d: int, h: int, x_bytes: int, w_bytes: int,
                 smem_budget: int) -> tuple[int, int, int] | None:
    """(cluster size, J, shared memory) of the cluster kernel: the smallest
    cluster of 1, 2, 4, 8 or 16 blocks whose blocks each hold J = dh / cs
    hidden indices (rounded up to 8) within ``smem_budget`` bytes, or None
    when none does (the grid kernel's case).  The rule of ``make_plan`` in
    the CUDA source."""
    dh = d // h
    for cs in CLUSTER_SIZES:
        j = (-(-dh // cs) + 7) // 8 * 8
        smem = cluster_smem(b, dh, j, cs, x_bytes, w_bytes)
        if smem <= smem_budget:
            return cs, j, smem
    return None


def _lib() -> ctypes.CDLL:
    lib = _build.load("slstm_scan")
    fn = lib.slstm_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 13 + [_I] * 6 + [_P]
        fn.restype = _I
        lib.slstm_scan_plan.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
        lib.slstm_scan_plan.restype = _I
        lib.slstm_grid_sync_loop.argtypes = [_I, _I, _P]
        lib.slstm_grid_sync_loop.restype = _I
        lib.slstm_cluster_sync_loop.argtypes = [_I] * 4 + [_P]
        lib.slstm_cluster_sync_loop.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _refused(code: int, what: str, b: int, d: int, h: int) -> None:
    if code == -2:
        raise RuntimeError(f"{what}: no cooperative grid for B={b} D={d} H={h} can be "
                           f"resident on this card (shared memory or block count)")
    if code == -3:
        raise RuntimeError(f"{what}: the thread-block cluster for B={b} D={d} H={h} cannot "
                           f"be scheduled on this card (no GPC holds it)")


@functools.lru_cache(maxsize=None)
def _plan(device: int, x_bf16: bool, w_bf16: bool, b: int, d: int, h: int) -> Plan:
    lib = _lib()
    out = (_I * 6)()
    with torch.cuda.device(device):
        code = lib.slstm_scan_plan(int(x_bf16), int(w_bf16), b, d, h, out)
    _refused(code, "slstm_scan_plan", b, d, h)
    check_launch(lib, code, "slstm_scan_plan")
    return Plan("cluster" if out[0] == 0 else "grid", *out[1:])


def slstm_scan_plan(b: int, d: int, h: int, *, x_dtype=torch.bfloat16,
                    w_dtype=torch.bfloat16, device=None) -> Plan:
    """The kernel, grid or cluster a call at this shape would launch."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else \
        torch.device(device)
    return _plan(dev.index if dev.index is not None else torch.cuda.current_device(),
                 x_dtype == torch.bfloat16, w_dtype == torch.bfloat16, b, d, h)


def grid_sync_loop(grid: int, steps: int, device: torch.device) -> None:
    """``steps`` grid barriers over ``grid`` cooperative blocks: the grid
    kernel's serial floor (timing only; not a kernel of the path, and not
    counted)."""
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.slstm_grid_sync_loop(grid, steps, torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, code, "grid_sync_loop")


def cluster_sync_loop(cluster: int, clusters: int, floats: int, steps: int,
                      device: torch.device) -> None:
    """``steps`` rounds of the cluster kernel's exchange (``floats`` f32 from
    every block to each of its ``cluster`` peers' shared memory) and cluster
    barrier, over ``clusters`` clusters: the cluster kernel's serial floor
    (timing only; not counted)."""
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.slstm_cluster_sync_loop(cluster, clusters, floats, steps,
                                           torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, code, "cluster_sync_loop")


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
    lib = _lib()
    with on_device(xg):   # launch on the tensors' card
        plan = slstm_scan_plan(b, d, nh, x_dtype=xg.dtype, w_dtype=w_hh.dtype,
                               device=xg.device)
        hbuf = torch.empty((2, b, d), dtype=torch.float32, device=xg.device) \
            if plan.variant == "grid" else None
        code = lib.slstm_scan_fwd(
            xg.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            n0.data_ptr(), m0.data_ptr(), hs.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
            None if hbuf is None else hbuf.data_ptr(),
            int(xg.dtype == torch.bfloat16), int(w_hh.dtype == torch.bfloat16), b, s, d, nh,
            stream_of(xg))
    _refused(code, "slstm_scan", b, d, nh)
    check_launch(lib, code, "slstm_scan")
    slstm_scan.launches += 1
    return hs, tuple(out.unbind(0))


slstm_scan.launches = 0
