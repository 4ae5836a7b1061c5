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
step's gates, c, n and m) with K5-bwd (``csrc/slstm_scan_bwd.cu``, counted
in ``slstm_scan_bwd.launches``) as its gradient: one cluster per head and
group of batch rows where a cluster's shared memory holds the head's
``w_hh``, else one cooperative grid, chosen as the forward chooses
(:func:`bwd_cluster_plan` states the rule, :func:`slstm_scan_bwd_plan`
reports what the library chose).  Outside grad nothing changes: the
serving path launches K5 as before, and its outputs are the same bit for
bit.
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
           "slstm_scan_bwd_plan", "bwd_cluster_plan", "bwd_cluster_smem"]

_P, _I = ctypes.c_void_p, ctypes.c_int

CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_ROWS = 2                 # batch rows per pass of the cluster kernel's product


class Plan(NamedTuple):
    """What a call launches: ``variant`` "cluster" or "grid", ``j`` hidden
    indices per block, ``blocks``, ``cluster`` blocks per cluster (0 for the
    grid), ``smem`` dynamic shared memory per block in bytes, ``active``
    clusters (grid: blocks) the card holds at once, and ``rows`` batch rows
    per cluster (the grid, and K5: all B)."""
    variant: str
    j: int
    blocks: int
    cluster: int
    smem: int
    active: int
    rows: int


def _smallest_cluster(j_of, smem, budget: int) -> tuple[int, int, int] | None:
    """(cs, J, smem(cs, J)) for the smallest cluster of ``CLUSTER_SIZES``
    blocks, each holding J = ``j_of(cs)`` hidden indices, whose ``smem(cs,
    J)`` fits ``budget`` bytes; None when none does.  The rule of both
    kernels' ``make_plan``."""
    for cs in CLUSTER_SIZES:
        j = j_of(cs)
        need = smem(cs, j)
        if need <= budget:
            return cs, j, need
    return None


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
    when none does (the grid kernel's case)."""
    dh = d // h
    return _smallest_cluster(lambda cs: (-(-dh // cs) + 7) // 8 * 8,
                             lambda cs, j: cluster_smem(b, dh, j, cs, x_bytes, w_bytes),
                             smem_budget)


def _pow2_at_least(n: int) -> int:
    """The smallest power of two >= n, and at least 8 (``pow2_at_least``
    in ``slstm_scan_bwd.cu``: K5-bwd's J, so its steps divide by shifts)."""
    p = 8
    while p < n:
        p *= 2
    return p


def _pass_rows(rows: int) -> int:
    """Rows of one pass of K5-bwd's product: the smallest power of two that
    covers ``rows``, at most 8 (``pass_rows`` in the CUDA source)."""
    rb = 1
    while rb < rows and rb < 8:
        rb *= 2
    return rb


def bwd_cluster_smem(rows: int, dh: int, j: int, cs: int, w_bytes: int) -> int:
    """Dynamic shared memory of one block of K5-bwd's cluster kernel
    (``cluster_smem`` in ``slstm_scan_bwd.cu``): two barriers, the w slice
    (dh x 4J in w_hh's dtype), then f32: the partials' double buffer (2 x
    cs x rows x J), the stage's double buffer (2 x 8 x rows x J), c, n, m
    and the carried dc, dn, dm (rows x J each), the gates' gradients'
    double buffer (2 x Rp x 4J) and the product's two half sums (2 x Rp x
    cs J), Rp the rows padded to the product's pass."""
    rb = _pass_rows(rows)
    rp, rj = -(-rows // rb) * rb, rows * j
    return 16 + (dh * 4 * j * w_bytes + 15) // 16 * 16 + \
        4 * (2 * cs * rj + 16 * rj + 6 * rj + 2 * rp * 4 * j + 2 * rp * cs * j)


def bwd_cluster_plan(b: int, d: int, h: int, w_bytes: int, smem_budget: int,
                     active: int) -> tuple[int, int, int, int, int] | None:
    """(cluster size, J, rows per cluster, blocks, shared memory) of
    K5-bwd's cluster kernel, or None when no cluster holds the head's
    ``w_hh`` (the grid kernel's case).  The cluster is the smallest of 1,
    2, 4, 8 or 16 blocks whose blocks each hold J = dh / cs hidden indices
    (rounded up to a power of two, at least 8) with one row within
    ``smem_budget`` bytes; the batch is split into as few groups as let a
    group's rows fit, or, if more, as many groups as ``active`` clusters of
    that shape (what the card reports it holds at once) give each head.
    The rule of ``make_plan`` in the CUDA source."""
    dh = d // h
    first = _smallest_cluster(lambda cs: _pow2_at_least(-(-dh // cs)),
                              lambda cs, j: bwd_cluster_smem(1, dh, j, cs, w_bytes),
                              smem_budget)
    if first is None:
        return None
    cs, j, _ = first
    rmax = 1
    while rmax < b and bwd_cluster_smem(rmax + 1, dh, j, cs, w_bytes) <= smem_budget:
        rmax += 1
    rows = -(-b // -(-b // rmax))
    groups = -(-b // rows)
    fill = min(b, active // h)
    if fill > groups:
        rows = -(-b // fill)
        groups = -(-b // rows)
    return cs, j, rows, h * groups * cs, bwd_cluster_smem(rows, dh, j, cs, w_bytes)


def _lib() -> ctypes.CDLL:
    lib = _build.load("slstm_scan")
    fn = lib.slstm_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 17 + [_I] * 6 + [_P]
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
    return Plan("cluster" if out[0] == 0 else "grid", *out[1:], b)


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
    (gates, cs, ns, ms) or None); with ``save`` the same launch writes every
    step's gates ((B, S, 4D) f32, as the gate math received them) and c, n
    and m ((B, S, D) f32 each) for the backward."""
    b, s, d4 = xg.shape
    d, nh = d4 // 4, w_hh.shape[0]
    _check_cuda("slstm_scan", s, xg, w_hh, b_ih, h0, c0, n0, m0)
    hs = torch.empty((b, s, d), dtype=torch.float32, device=xg.device)
    out = torch.empty((4, b, d), dtype=torch.float32, device=xg.device)
    saved = None
    if save:
        saved = (torch.empty((b, s, d4), dtype=torch.float32, device=xg.device),
                 *torch.empty((3, b, s, d), dtype=torch.float32, device=xg.device).unbind(0))
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
            *((None,) * 4 if saved is None else (t.data_ptr() for t in saved)),
            None if hbuf is None else hbuf.data_ptr(),
            int(xg.dtype == torch.bfloat16), int(w_hh.dtype == torch.bfloat16), b, s, d, nh,
            stream_of(xg))
    _refused(code, "slstm_scan", b, d, nh)
    check_launch(lib, code, "slstm_scan")
    slstm_scan.launches += 1
    return hs, tuple(out.unbind(0)), saved


slstm_scan.launches = 0


class _SlstmScanFn(torch.autograd.Function):
    """K5 with K5-bwd as its gradient: the forward runs K5 in save mode and
    keeps w_hh, the initial state, hs and every step's gates and (c, n, m)
    for the backward; not xg, of which the backward needs only the dtype."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_ih, h0, c0, n0, m0):
        hs, st, saved = _launch_fwd(xg, w_hh, b_ih, h0, c0, n0, m0, True)
        ctx.save_for_backward(w_hh, h0, c0, n0, m0, hs, *saved)
        ctx.x_dtype = xg.dtype
        ctx.set_materialize_grads(False)      # an unused output's grad stays None: zero
        return (hs, *st)

    @staticmethod
    def backward(ctx, dhs, dh, dc, dn, dm):
        grads = slstm_scan_bwd(*ctx.saved_tensors, dhs, dh, dc, dn, dm, x_dtype=ctx.x_dtype)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("slstm_scan_bwd")
    fn = lib.slstm_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 20 + [_I] * 5 + [_P]
        fn.restype = _I
        lib.slstm_scan_bwd_plan.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
        lib.slstm_scan_bwd_plan.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_plan(device: int, w_bf16: bool, b: int, d: int, h: int) -> Plan:
    lib = _lib_bwd()
    out = (_I * 7)()
    with torch.cuda.device(device):
        code = lib.slstm_scan_bwd_plan(int(w_bf16), b, d, h, out)
    _refused(code, "slstm_scan_bwd_plan", b, d, h)
    check_launch(lib, code, "slstm_scan_bwd_plan")
    variant, j, blocks, cluster, rows, smem, active = out
    return Plan("cluster" if variant == 0 else "grid", j, blocks, cluster, smem, active, rows)


def slstm_scan_bwd_plan(b: int, d: int, h: int, *, w_dtype=torch.bfloat16,
                        device=None) -> Plan:
    """The cluster or grid kernel a K5-bwd call at this shape would launch
    (it depends on w_hh's dtype alone: the kernel reads no xg)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else \
        torch.device(device)
    return _bwd_plan(dev.index if dev.index is not None else torch.cuda.current_device(),
                     w_dtype == torch.bfloat16, b, d, h)


def _check_bwd(w_hh, h0, c0, n0, m0, hs, gates, cs, ns, ms, dhs, finals,
               x_dtype) -> tuple[int, int, int, int, int]:
    """(B, S, D, H, dh) of a backward call, or raise for inputs that do not
    fit."""
    if w_hh.ndim != 3 or hs.ndim != 3:
        raise ValueError(f"need w_hh (H,dh,4dh), hs (B,S,D); got {tuple(w_hh.shape)}, "
                         f"{tuple(hs.shape)}")
    b, s, d = hs.shape
    nh = w_hh.shape[0]
    if nh < 1 or d % nh or w_hh.shape[1:] != (d // nh, 4 * (d // nh)):
        raise ValueError(f"w_hh {tuple(w_hh.shape)} does not fit hs {tuple(hs.shape)}")
    for name, t in zip("hcnm", (h0, c0, n0, m0)):
        if t.shape != (b, d):
            raise ValueError(f"{name}0 {tuple(t.shape)} must be ({b}, {d})")
    if gates.shape != (b, s, 4 * d):
        raise ValueError(f"gates {tuple(gates.shape)} must be ({b}, {s}, {4 * d})")
    for name, t in zip(("cs", "ns", "ms", "dhs"), (cs, ns, ms, dhs)):
        if t is not None and t.shape != (b, s, d):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({b}, {s}, {d})")
    for name, t in zip(("dh_T", "dc_T", "dn_T", "dm_T"), finals):
        if t is not None and t.shape != (b, d):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({b}, {d})")
    if x_dtype not in KERNEL_DTYPES or w_hh.dtype not in KERNEL_DTYPES:
        raise TypeError(f"xg/w_hh dtypes {x_dtype}/{w_hh.dtype}: need one of {KERNEL_DTYPES}")
    return b, s, d, nh, d // nh


def slstm_scan_bwd(w_hh, h0, c0, n0, m0, hs, gates, cs, ns, ms, dhs, dh_T=None, dc_T=None,
                   dn_T=None, dm_T=None, *, x_dtype):
    """Gradient of :func:`slstm_scan` at (xg, w_hh, b_ih, h0, c0, n0, m0),
    from what the forward saves in save mode: ``hs`` and every step's
    ``gates`` ((B, S, 4D) f32) and ``cs``/``ns``/``ms`` ((B, S, D) f32);
    ``dhs`` the grad of hs and ``dh_T`` ... ``dm_T`` those of the final
    state (each may be None: zero); ``x_dtype`` xg's dtype.  Returns (dxg
    in ``x_dtype``, dw_hh in w_hh's dtype, db_ih f32, dh0, dc0, dn0, dm0
    f32).  CPU tensors take :func:`slstm_scan_bwd_ref`; CUDA tensors launch
    K5-bwd (the reverse scan, writing every step's f32 gate gradient dg,
    rounded to bf16 as dxg too when xg is bf16, and the initial state's
    gradients; counted in ``slstm_scan_bwd.launches``) or raise; dw_hh and
    db_ih are then sums over dg taken with ``torch.einsum`` and ``sum``
    (plain products outside the recurrence)."""
    finals = (dh_T, dc_T, dn_T, dm_T)
    b, s, d, nh, dh = _check_bwd(w_hh, h0, c0, n0, m0, hs, gates, cs, ns, ms, dhs, finals,
                                 x_dtype)
    given = [t for t in (w_hh, h0, c0, n0, m0, hs, gates, cs, ns, ms, dhs, *finals)
             if t is not None]
    if device_kind(*given) == "cpu":
        return slstm_scan_bwd_ref(w_hh, h0, c0, n0, m0, hs, gates, cs, ns, ms, dhs, *finals,
                                  x_dtype=x_dtype)
    if s < 1:
        raise ValueError("slstm_scan_bwd: the CUDA kernel takes S >= 1")
    if not w_hh.is_contiguous() or any(t.dtype != torch.float32 or not t.is_contiguous()
                                       for t in (c0, n0, m0, hs, gates, cs, ns, ms)):
        raise ValueError("slstm_scan_bwd: w_hh must be contiguous, and the states, hs, the "
                         "gates, cs, ns, ms contiguous float32")
    dhs = torch.zeros_like(hs) if dhs is None else dhs.float().contiguous()
    finals = [None if t is None else t.float().contiguous() for t in finals]
    dg = torch.empty((b, s, 4 * d), dtype=torch.float32, device=hs.device)
    dxg = dg if x_dtype == torch.float32 else torch.empty_like(dg, dtype=x_dtype)
    dst = torch.empty((4, b, d), dtype=torch.float32, device=hs.device)
    lib = _lib_bwd()
    with on_device(hs):
        plan = slstm_scan_bwd_plan(b, d, nh, w_dtype=w_hh.dtype, device=hs.device)
        pbuf = torch.empty((2, plan.blocks, b, dh), dtype=torch.float32, device=hs.device) \
            if plan.variant == "grid" else None
        code = lib.slstm_scan_bwd(
            *(t.data_ptr() for t in (w_hh, c0, n0, m0, gates, cs, ns, ms, dhs)),
            *(None if t is None else t.data_ptr() for t in finals),
            dg.data_ptr(), *(t.data_ptr() for t in dst),
            None if dxg is dg else dxg.data_ptr(), None if pbuf is None else pbuf.data_ptr(),
            int(w_hh.dtype == torch.bfloat16), b, s, d, nh, stream_of(hs))
    _refused(code, "slstm_scan_bwd", b, d, nh)
    check_launch(lib, code, "slstm_scan_bwd")
    slstm_scan_bwd.launches += 1
    hprev = torch.cat([h0[:, None], hs[:, :-1]], dim=1).view(b, s, nh, dh)
    dw = torch.einsum("bshd,bshk->hdk", hprev, dg.view(b, s, nh, 4 * dh))
    return (dxg, dw.to(w_hh.dtype), dg.sum((0, 1)), *dst.unbind(0))


slstm_scan_bwd.launches = 0
