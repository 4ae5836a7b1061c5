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

Under grad, with an input that requires it, a CUDA call goes through
``_SlstmScanFn``: K5 in "save" mode (the same launch also writes every
step's c, n and m) with K5-bwd (``csrc/slstm_scan_bwd.cu``, one
cooperative grid, counted in ``slstm_scan_bwd.launches``) as its
gradient.  Outside grad nothing changes: the serving path launches K5
as before, and its outputs are the same bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .._device import KERNEL_DTYPES, check_launch, device_kind, on_device, stream_of
from .ref import slstm_scan_bwd_ref, slstm_scan_ref

__all__ = ["slstm_scan", "slstm_scan_ref", "slstm_scan_plan", "cluster_plan", "Plan",
           "grid_sync_loop", "cluster_sync_loop", "slstm_scan_bwd", "slstm_scan_bwd_ref",
           "slstm_scan_bwd_plan", "BwdPlan"]

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
        fn.argtypes = [_P] * 16 + [_I] * 6 + [_P]
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


def _check(xg, w_hh, b_ih, h0, c0, n0, m0) -> tuple[int, int, int, int, int]:
    """(B, S, D, H, dh) of a call, or raise for inputs that do not fit."""
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
    return b, s, d, nh, d // nh


def _check_cuda(what: str, s: int, xg, w_hh, b_ih, h0, c0, n0, m0) -> None:
    if s < 1:
        raise ValueError(f"{what}: the CUDA kernel takes S >= 1")
    if any(t.dtype != torch.float32 for t in (b_ih, h0, c0, n0, m0)):
        raise TypeError(f"{what}: b_ih and the states must be float32 for the CUDA kernel")
    if not all(t.is_contiguous() for t in (xg, w_hh, b_ih, h0, c0, n0, m0)):
        raise ValueError(f"{what} on CUDA needs contiguous inputs")


def slstm_scan(xg: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor):
    """sLSTM recurrence over (B, S, 4D) pre-projected gates, resuming from
    (h0, c0, n0, m0) (B, D) f32.  w_hh: (H, dh, 4dh); b_ih: (4D,) f32.
    Returns (hs (B, S, D) f32, (h, c, n, m) each (B, D) f32)."""
    args = (xg, w_hh, b_ih, h0, c0, n0, m0)
    _check(*args)
    if device_kind(*args) == "cpu":
        return slstm_scan_ref(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        hs, *st = _SlstmScanFn.apply(*args)
        return hs, tuple(st)
    hs, st, _ = _launch_fwd(*args, False)
    return hs, st


def _launch_fwd(xg, w_hh, b_ih, h0, c0, n0, m0, save: bool):
    """K5 on CUDA tensors whose shapes ``_check`` passed: (hs, (h, c, n, m),
    (cs, ns, ms) or None); with ``save`` the same launch writes every
    step's c, n and m ((B, S, D) f32 each) for the backward."""
    b, s, d4 = xg.shape
    d, nh = d4 // 4, w_hh.shape[0]
    _check_cuda("slstm_scan", s, xg, w_hh, b_ih, h0, c0, n0, m0)
    hs = torch.empty((b, s, d), dtype=torch.float32, device=xg.device)
    out = torch.empty((4, b, d), dtype=torch.float32, device=xg.device)
    saved = torch.empty((3, b, s, d), dtype=torch.float32, device=xg.device) if save else None
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
            *((None,) * 3 if saved is None else (t.data_ptr() for t in saved)),
            None if hbuf is None else hbuf.data_ptr(),
            int(xg.dtype == torch.bfloat16), int(w_hh.dtype == torch.bfloat16), b, s, d, nh,
            stream_of(xg))
    _refused(code, "slstm_scan", b, d, nh)
    check_launch(lib, code, "slstm_scan")
    slstm_scan.launches += 1
    return hs, tuple(out.unbind(0)), None if saved is None else tuple(saved.unbind(0))


slstm_scan.launches = 0


class _SlstmScanFn(torch.autograd.Function):
    """K5 with K5-bwd as its gradient: the forward runs K5 in save mode and
    keeps its inputs, hs and every step's (c, n, m) for the backward."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_ih, h0, c0, n0, m0):
        hs, st, (cs, ns, ms) = _launch_fwd(xg, w_hh, b_ih, h0, c0, n0, m0, True)
        ctx.save_for_backward(xg, w_hh, b_ih, h0, c0, n0, m0, hs, cs, ns, ms)
        ctx.set_materialize_grads(False)      # an unused output's grad stays None: zero
        return (hs, *st)

    @staticmethod
    def backward(ctx, dhs, dh, dc, dn, dm):
        grads = slstm_scan_bwd(*ctx.saved_tensors, dhs, dh, dc, dn, dm)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


class BwdPlan(NamedTuple):
    """What a K5-bwd call launches: one cooperative grid of ``blocks``
    blocks of ``j`` hidden indices, ``smem`` dynamic shared memory per
    block in bytes, ``active`` blocks the card holds at once."""
    j: int
    blocks: int
    smem: int
    active: int


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("slstm_scan_bwd")
    fn = lib.slstm_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 22 + [_I] * 6 + [_P]
        fn.restype = _I
        lib.slstm_scan_bwd_plan.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
        lib.slstm_scan_bwd_plan.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_plan(device: int, x_bf16: bool, w_bf16: bool, b: int, d: int, h: int) -> BwdPlan:
    lib = _lib_bwd()
    out = (_I * 4)()
    with torch.cuda.device(device):
        code = lib.slstm_scan_bwd_plan(int(x_bf16), int(w_bf16), b, d, h, out)
    _refused(code, "slstm_scan_bwd_plan", b, d, h)
    check_launch(lib, code, "slstm_scan_bwd_plan")
    return BwdPlan(*out)


def slstm_scan_bwd_plan(b: int, d: int, h: int, *, x_dtype=torch.bfloat16,
                        w_dtype=torch.bfloat16, device=None) -> BwdPlan:
    """The cooperative grid a K5-bwd call at this shape would launch."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else \
        torch.device(device)
    return _bwd_plan(dev.index if dev.index is not None else torch.cuda.current_device(),
                     x_dtype == torch.bfloat16, w_dtype == torch.bfloat16, b, d, h)


def slstm_scan_bwd(xg, w_hh, b_ih, h0, c0, n0, m0, hs, cs, ns, ms, dhs, dh_T=None, dc_T=None,
                   dn_T=None, dm_T=None):
    """Gradient of :func:`slstm_scan` at (xg, w_hh, b_ih, h0, c0, n0, m0):
    ``hs`` and ``cs``/``ns``/``ms`` (every step's c, n, m; (B, S, D) f32)
    from the forward in save mode, ``dhs`` the grad of hs and ``dh_T`` ...
    ``dm_T`` those of the final state (each may be None: zero).  Returns
    (dxg in xg's dtype, dw_hh in w_hh's dtype, db_ih f32, dh0, dc0, dn0, dm0
    f32).  CPU tensors take :func:`slstm_scan_bwd_ref`; CUDA tensors launch
    K5-bwd (one cooperative grid: the reverse scan, writing every step's
    f32 gate gradient dg and the initial state's gradients; counted in
    ``slstm_scan_bwd.launches``) or raise; dw_hh and db_ih are then sums
    over dg taken with ``torch.einsum`` and ``sum`` (plain products outside
    the recurrence).  The head dim D / H must be a multiple of 4."""
    b, s, d, nh, dh = _check(xg, w_hh, b_ih, h0, c0, n0, m0)
    finals = (dh_T, dc_T, dn_T, dm_T)
    for name, t in zip(("hs", "cs", "ns", "ms", "dhs"), (hs, cs, ns, ms, dhs)):
        if t is not None and t.shape != (b, s, d):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({b}, {s}, {d})")
    for name, t in zip(("dh_T", "dc_T", "dn_T", "dm_T"), finals):
        if t is not None and t.shape != (b, d):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({b}, {d})")
    given = [t for t in (xg, w_hh, b_ih, h0, c0, n0, m0, hs, cs, ns, ms, dhs, *finals)
             if t is not None]
    if device_kind(*given) == "cpu":
        return slstm_scan_bwd_ref(xg, w_hh, b_ih, h0, c0, n0, m0, hs, cs, ns, ms, dhs, *finals)
    _check_cuda("slstm_scan_bwd", s, xg, w_hh, b_ih, h0, c0, n0, m0)
    if dh % 4:
        raise ValueError(f"slstm_scan_bwd: head dim {dh} (D={d}, H={nh}) must be a multiple "
                         "of 4 on CUDA")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in (hs, cs, ns, ms)):
        raise ValueError("slstm_scan_bwd: hs, cs, ns, ms must be contiguous float32")
    dhs = torch.zeros_like(hs) if dhs is None else dhs.float().contiguous()
    finals = [None if t is None else t.float().contiguous() for t in finals]
    dg = torch.empty((b, s, 4 * d), dtype=torch.float32, device=xg.device)
    dst = torch.empty((4, b, d), dtype=torch.float32, device=xg.device)
    lib = _lib_bwd()
    with on_device(xg):
        plan = slstm_scan_bwd_plan(b, d, nh, x_dtype=xg.dtype, w_dtype=w_hh.dtype,
                                   device=xg.device)
        pbuf = torch.empty((2, plan.blocks, b, dh), dtype=torch.float32, device=xg.device)
        code = lib.slstm_scan_bwd(
            *(t.data_ptr() for t in (xg, w_hh, b_ih, h0, c0, n0, m0, hs, cs, ns, ms, dhs)),
            *(None if t is None else t.data_ptr() for t in finals),
            dg.data_ptr(), *(t.data_ptr() for t in dst), pbuf.data_ptr(),
            int(xg.dtype == torch.bfloat16), int(w_hh.dtype == torch.bfloat16), b, s, d, nh,
            stream_of(xg))
    _refused(code, "slstm_scan_bwd", b, d, nh)
    check_launch(lib, code, "slstm_scan_bwd")
    slstm_scan_bwd.launches += 1
    hprev = torch.cat([h0[:, None], hs[:, :-1]], dim=1).view(b, s, nh, dh)
    dw = torch.einsum("bshd,bshk->hdk", hprev, dg.view(b, s, nh, 4 * dh))
    dxg = dg if xg.dtype == torch.float32 else dg.to(xg.dtype)
    return (dxg, dw.to(w_hh.dtype), dg.sum((0, 1)), *dst.unbind(0))


slstm_scan_bwd.launches = 0
