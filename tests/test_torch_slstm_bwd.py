"""The sLSTM scan's backward (K5-bwd): its plain version
``slstm_scan_bwd_ref`` (what ``ops.slstm_scan_bwd`` runs for CPU tensors,
and what the card holds the kernel against), fed the gates the forward
saves, against autograd of the port's ``slstm_scan_ref`` and against
``jax.vjp`` of the reference's oracle
``repro.kernels.slstm_scan.ref.slstm_scan_ref`` (the reference's Pallas
kernel has no VJP), on the same numpy inputs, at the shapes of
``tests/test_torch_slstm_scan.py``; the saved gates against the gates
formed again from hs; a planted fault that the bound must catch;
``_SlstmScanFn`` (K5 with K5-bwd) on CPU tensors, which saves no xg; and
the arithmetic of the kernel's cluster plan at xlstm-1.3b's and the 100m
reduction's widths.

Tolerances start from ``tests/test_slstm_kernel.py``'s: 1e-5 for f32 and
5e-2 for bf16.  The gradients are carried back through up to 64 steps, in
f32 on both sides (bf16 inputs are widened, as the forward does), so the
f32 outputs (db_ih and the initial state's gradients) keep 1e-5 whether
the inputs are f32 or bf16-rounded; dxg and dw_hh come back in the
inputs' dtype, so with bf16 inputs they are held at 5e-2.  Against
autograd of the port's own plain forward (the same torch ops, another
order of the recurrent products) the same bounds hold.  The CUDA kernel
itself runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm_scan import slstm_scan_ref as jax_scan_ref
from repro_torch.kernels.slstm_scan import ops
from repro_torch.kernels.slstm_scan import ref as scan_ref
from repro_torch.kernels.slstm_scan.ops import (_SlstmScanFn, bwd_cluster_plan,
                                                bwd_cluster_smem, cluster_plan, slstm_scan_bwd)
from repro_torch.kernels.slstm_scan.ref import slstm_scan_bwd_ref, slstm_scan_ref
from _port_env import port_test_env  # noqa: F401  (autouse)

SHAPES = [(1, 16, 32, 2), (3, 40, 64, 4), (2, 33, 48, 4), (4, 64, 64, 1)]   # B, S, D, H
NAMES = ("dxg", "dw_hh", "db_ih", "dh0", "dc0", "dn0", "dm0")


def _numpy_inputs(seed, b, s, d, h, state, bf16):
    """xg, w_hh, b_ih, h0, c0, n0, m0 and the cotangents of hs and of the
    final (h, c, n, m), as f32 numpy arrays; xg and w_hh rounded to bf16's
    values when ``bf16``."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    xg = f32(rng.normal(size=(b, s, 4 * d)))
    whh = f32(rng.normal(size=(h, d // h, 4 * (d // h))) * 0.2)
    if bf16:
        xg, whh = (torch.from_numpy(a).bfloat16().float().numpy() for a in (xg, whh))
    bias = f32(rng.normal(size=(4 * d,)) * 0.1)
    if state:
        st = [f32(rng.normal(size=(b, d)) * 0.5), f32(rng.normal(size=(b, d))),
              f32(rng.uniform(0.5, 2.0, size=(b, d))), f32(rng.normal(size=(b, d)))]
    else:
        z = np.zeros((b, d), np.float32)
        st = [z, z, z, np.full((b, d), -np.inf, np.float32)]
    dhs = f32(rng.normal(size=(b, s, d)))
    dfinal = [f32(rng.normal(size=(b, d))) for _ in range(4)]
    return [xg, whh, bias, *st], dhs, dfinal


def _bwd(fn, args, hs, saved, *cot):
    """``fn`` (the backward wrapper or its plain version) at the forward's
    inputs ``args`` (xg, w_hh, b_ih, h0, c0, n0, m0), from its hs and its
    saved gates and states."""
    xg, w, _, *state = args
    return fn(w, *state, hs, *saved, *cot, x_dtype=xg.dtype)


@functools.cache
def _jax_grad():
    @jax.jit
    def grad(args, cot):
        _, vjp = jax.vjp(jax_scan_ref, *args)
        return vjp(cot)
    return grad


def _case(seed, b, s, d, h, state, bf16, finals):
    """(the plain backward's grads, autograd's, jax.vjp's), each a list of
    the seven in ``NAMES`` order."""
    args, dhs, dfinal = _numpy_inputs(seed, b, s, d, h, state, bf16)
    if not finals:
        dfinal = [np.zeros_like(t) for t in dfinal]
    wdt = torch.bfloat16 if bf16 else torch.float32
    t_args = [torch.from_numpy(a) for a in args]
    t_args[0], t_args[1] = t_args[0].to(wdt), t_args[1].to(wdt)
    leaves = [t.clone().requires_grad_() for t in t_args]
    hs, fin, saved = slstm_scan_ref(*leaves, save_states=True)
    t_dhs, t_fin = torch.from_numpy(dhs), [torch.from_numpy(t) for t in dfinal]
    out = (hs * t_dhs).sum() + sum((a * c).sum() for a, c in zip(fin, t_fin))
    auto = list(torch.autograd.grad(out, leaves))
    plain = _bwd(slstm_scan_bwd_ref, t_args, hs.detach(), [t.detach() for t in saved], t_dhs,
                 *(t_fin if finals else (None,) * 4))
    jgot = _jax_grad()(tuple(jnp.asarray(a) for a in args),
                       (jnp.asarray(dhs), tuple(jnp.asarray(t) for t in dfinal)))
    return list(plain), auto, [np.asarray(g, np.float32) for g in jgot]


def _tol(name: str, bf16: bool) -> float:
    return 5e-2 if bf16 and name in ("dxg", "dw_hh") else 1e-5


def _assert_close(got, want, name, bf16, what):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               atol=_tol(name, bf16), rtol=_tol(name, bf16),
                               err_msg=f"{name} against {what}")


@pytest.mark.parametrize("finals", [False, True], ids=["hs", "hs+final"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("B,S,D,H", SHAPES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_bwd_ref_matches_autograd_and_jax_vjp(dt, B, S, D, H, state, finals):
    bf16 = dt == "bfloat16"
    plain, auto, jgrads = _case(B * 1000 + S, B, S, D, H, state, bf16, finals)
    assert plain[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert plain[1].dtype == plain[0].dtype and plain[2].dtype == torch.float32
    for name, p, a, j in zip(NAMES, plain, auto, jgrads):
        assert torch.isfinite(p.float()).all(), name
        _assert_close(p, a.float().numpy(), name, bf16, "autograd of slstm_scan_ref")
        _assert_close(p, j, name, bf16, "jax.vjp of the reference's oracle")
    if not state:      # m0 = -inf: f' = 0 on the first step, so c0, n0 and m0 get 0
        for name, p in zip(NAMES[4:], plain[4:]):
            assert torch.count_nonzero(p) == 0, name


@pytest.mark.parametrize("B,S,D,H", SHAPES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_saved_gates_are_the_gates_formed_from_hs(dt, B, S, D, H):
    """The gates ``slstm_scan_ref(save_states=True)`` returns (what the
    backward reads in place of forming them again) equal (xg_t + h_{t-1}
    . w_hh) + b formed afresh from hs and the initial h, within f32's 1e-5;
    its hs and final state are those of the call without saving, bit for
    bit."""
    args, _, _ = _numpy_inputs(B * 7 + S, B, S, D, H, True, dt == "bfloat16")
    t_args = [torch.from_numpy(a) for a in args]
    if dt == "bfloat16":
        t_args[0], t_args[1] = t_args[0].bfloat16(), t_args[1].bfloat16()
    xg, w, bias, h0 = t_args[:4]
    hs, fin, (gates, *_) = slstm_scan_ref(*t_args, save_states=True)
    hs0, fin0 = slstm_scan_ref(*t_args)
    assert torch.equal(hs, hs0) and all(map(torch.equal, fin, fin0))
    assert gates.shape == (B, S, 4 * D) and gates.dtype == torch.float32
    dh = D // H
    hprev = torch.cat([h0[:, None], hs[:, :-1]], dim=1).reshape(B, S, H, dh)
    rec = torch.einsum("bshd,hdk->bshk", hprev, w.float()).reshape(B, S, 4 * D)
    torch.testing.assert_close(gates, (xg.float() + rec) + bias, atol=1e-5, rtol=1e-5)


FAULTS = {
    "dropped f' on the carried dc": ("dc, dn, dm = dc * fp, dn * fp, da",
                                     "dc, dn, dm = dc, dn * fp, da"),
    "dropped dm carry": ("dmt = dm - dgia - dxa", "dmt = -dgia - dxa"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_bwd_bound_fails_a_planted_fault(fault):
    """The plain backward with one derivative rule broken (its source
    edited in a copy) misses the f32 bound against the sound plain
    backward (which autograd matches within it, above): the bound catches
    such a fault, in dxg among others."""
    old, new = FAULTS[fault]
    src = inspect.getsource(slstm_scan_bwd_ref)
    assert src.count(old) == 1
    space = dict(vars(scan_ref))
    exec(src.replace(old, new), space)         # noqa: S102
    faulty = space["slstm_scan_bwd_ref"]
    args, dhs, dfinal = _numpy_inputs(3040, 3, 40, 64, 4, True, False)
    t_args = [torch.from_numpy(a) for a in args]
    hs, _, saved = slstm_scan_ref(*t_args, save_states=True)
    t_fin = [torch.from_numpy(t) for t in dfinal]
    good = _bwd(slstm_scan_bwd_ref, t_args, hs, saved, torch.from_numpy(dhs), *t_fin)
    bad = _bwd(faulty, t_args, hs, saved, torch.from_numpy(dhs), *t_fin)
    off = [not torch.allclose(a, c, atol=1e-5, rtol=1e-5) for a, c in zip(bad, good)]
    assert any(off), f"{fault}: every gradient stays within the bound"
    assert off[0], f"{fault}: dxg stays within the bound"


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_scan_function_matches_autograd_on_cpu(dt, monkeypatch):
    """``_SlstmScanFn`` on CPU tensors, its forward launch replaced by the
    plain version in save mode (its backward takes the plain backward by
    itself): the same outputs and, for every input, the same gradients as
    autograd through ``slstm_scan_ref``, with cotangents on hs and on the
    final state."""
    calls = []

    def plain_launch(xg, w_hh, b_ih, h0, c0, n0, m0, save):
        calls.append(save)
        return slstm_scan_ref(xg, w_hh, b_ih, h0, c0, n0, m0, save_states=True)

    monkeypatch.setattr(ops, "_launch_fwd", plain_launch)
    args, dhs, dfinal = _numpy_inputs(21, 2, 9, 32, 2, True, dt == torch.bfloat16)
    t_args = [torch.from_numpy(a) for a in args]
    t_args[0], t_args[1] = t_args[0].to(dt), t_args[1].to(dt)
    cot = [torch.from_numpy(dhs)] + [torch.from_numpy(t) for t in dfinal]
    leaves = [t.clone().requires_grad_() for t in t_args]
    hs, fin = slstm_scan_ref(*leaves)
    want = torch.autograd.grad(sum((o * c).sum() for o, c in zip((hs, *fin), cot)), leaves)
    leaves = [t.clone().requires_grad_() for t in t_args]
    out = _SlstmScanFn.apply(*leaves)
    assert calls == [True] and torch.equal(out[0], hs.detach())
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), leaves)
    for name, a, c in zip(NAMES, got, want):
        assert a.dtype == c.dtype, name
        torch.testing.assert_close(a.float(), c.float(), atol=_tol(name, dt != torch.float32),
                                   rtol=_tol(name, dt != torch.float32), msg=name)


def test_scan_function_saves_no_xg(monkeypatch):
    """``_SlstmScanFn`` on CPU tensors (its forward launch replaced by the
    plain version in save mode) keeps w_hh, the initial state, hs, and the
    saved gates, c, n, m for the backward: ten tensors, none of them xg or
    b_ih; the backward gets xg's dtype (bf16 here) for dxg."""
    monkeypatch.setattr(ops, "_launch_fwd",
                        lambda *a: slstm_scan_ref(*a[:7], save_states=True))
    args, dhs, _ = _numpy_inputs(8, 2, 5, 32, 2, True, True)
    t_args = [torch.from_numpy(a) for a in args]
    t_args[0], t_args[1] = t_args[0].bfloat16(), t_args[1].bfloat16()
    leaves = [t.clone().requires_grad_() for t in t_args]
    out = _SlstmScanFn.apply(*leaves)
    saved = out[0].grad_fn.saved_tensors
    assert len(saved) == 10
    assert not any(t.data_ptr() in (leaves[0].data_ptr(), leaves[2].data_ptr()) for t in saved)
    assert saved[0].data_ptr() == leaves[1].data_ptr()          # w_hh
    assert saved[6].shape == (2, 5, 4 * 32) and saved[6].dtype == torch.float32   # the gates
    dxg, = torch.autograd.grad((out[0] * torch.from_numpy(dhs)).sum(), leaves[:1])
    assert dxg.dtype == torch.bfloat16


def test_bwd_wrapper_dispatch_and_checks():
    """CPU tensors take the plain backward (no launch counted); None
    cotangents mean zero; shapes that do not fit raise."""
    args, dhs, _ = _numpy_inputs(5, 2, 6, 32, 2, False, False)
    t_args = [torch.from_numpy(a) for a in args]
    hs, _, saved = slstm_scan_ref(*t_args, save_states=True)
    before = slstm_scan_bwd.launches
    got = _bwd(slstm_scan_bwd, t_args, hs, saved, torch.from_numpy(dhs))
    assert slstm_scan_bwd.launches == before
    want = _bwd(slstm_scan_bwd_ref, t_args, hs, saved, torch.from_numpy(dhs),
                *(torch.zeros(2, 32) for _ in range(4)))
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    with pytest.raises(ValueError, match="cs"):
        _bwd(slstm_scan_bwd, t_args, hs, [saved[0], saved[1][:, :3], *saved[2:]],
             torch.from_numpy(dhs))
    with pytest.raises(ValueError, match="gates"):
        _bwd(slstm_scan_bwd, t_args, hs, [saved[0][..., :32], *saved[1:]], torch.from_numpy(dhs))
    with pytest.raises(ValueError, match="dh_T"):
        _bwd(slstm_scan_bwd, t_args, hs, saved, torch.from_numpy(dhs), torch.zeros(2, 8))
    with pytest.raises(TypeError, match="dtypes"):
        slstm_scan_bwd(t_args[1], *t_args[3:], hs, *saved, None, x_dtype=torch.float16)
    on_meta = _bwd(slstm_scan_bwd, [t.to("meta") for t in t_args], hs.to("meta"),
                   [t.to("meta") for t in saved], None)     # meta: shapes, no launch
    assert [(g.device.type, g.shape, g.dtype) for g in on_meta] == \
        [("meta", g.shape, g.dtype) for g in got]
    assert slstm_scan_bwd.launches == before
    with pytest.raises(ValueError, match="different devices"):
        _bwd(slstm_scan_bwd, t_args, hs.to("meta"), saved, None)


# H100's opt-in shared memory a block (227 KB), and the clusters of 16
# blocks it holds at once at xlstm-1.3b's width (cudaOccupancyMaxActiveClusters
# on an NVIDIA H100 80GB HBM3: 7; the card tests hold the plan to the card's
# own figure)
H100_SMEM = 232_448


@pytest.mark.parametrize("b,d,h,wb,active,want", [
    # xlstm-1.3b, bf16: 16 blocks of J = 32 hold a head's w_hh (128 KiB each);
    # 7 clusters leave one group a head, so all 8 rows go to one cluster (at
    # most 8 rows fit a block's shared memory)
    (8, 2048, 4, 2, 7, (16, 32, 8, 64, 227_344)),
    (1, 2048, 4, 2, 7, (16, 32, 1, 64, 143_120)),
    # a card that held 8 such clusters: two groups of 4 rows, 128 blocks
    (8, 2048, 4, 2, 8, (16, 32, 4, 128, 179_216)),
    # the 100m reduction (D 512, H 8, dh 64): one block a cluster holds a
    # head; as many groups as the card's clusters give each head, one row each
    (4, 512, 8, 2, 132, (1, 64, 1, 32, 41_488)),
    (4, 512, 8, 4, 132, (1, 64, 1, 32, 74_256)),
    (4, 512, 8, 2, 16, (1, 64, 2, 16, 50_192)),
    # f32 at full width: 4 MiB of w_hh a head, past 16 blocks: the grid kernel
    (8, 2048, 4, 4, 7, None),
    # 16 rows: two groups of 8, the most that fit
    (16, 2048, 4, 2, 7, (16, 32, 8, 128, 227_344)),
])
def test_bwd_cluster_plan_arithmetic(b, d, h, wb, active, want):
    """K5-bwd's cluster plan (cluster size, J, rows per cluster, blocks,
    shared memory) at xlstm-1.3b's and the 100m width, without a card: the
    smallest cluster whose blocks hold the head's w_hh with one row, then
    the batch split over as many groups as the card's clusters give each
    head; and the shared memory is the sum of its parts."""
    assert bwd_cluster_plan(b, d, h, wb, H100_SMEM, active) == want
    if want is not None:
        cs, j, rows, _, smem = want
        dh, rp = d // h, rows                  # 1, 2, 4 or 8: no padding
        parts = [16, dh * 4 * j * wb, 4 * 2 * cs * rows * j, 4 * 16 * rows * j,
                 4 * 6 * rows * j, 4 * 2 * rp * 4 * j, 4 * 2 * rp * cs * j]
        assert smem == sum(parts) == bwd_cluster_smem(rows, dh, j, cs, wb) <= H100_SMEM
        assert cs * j >= dh and (cs == 1 or (cs // 2) * j < dh)


def test_forward_cluster_plan_unchanged():
    """The forward's plan after its rule moved into the helper both plans
    share: one cluster of 16 blocks of J = 32 a head at full width in bf16
    (137,616 bytes a block at B 1, as the card reported it), none in f32."""
    assert cluster_plan(1, 2048, 4, 2, 2, H100_SMEM) == (16, 32, 137_616)
    assert cluster_plan(8, 2048, 4, 2, 2, H100_SMEM)[:2] == (16, 32)
    assert cluster_plan(8, 2048, 4, 4, 4, H100_SMEM) is None
    assert cluster_plan(3, 24, 2, 2, 2, H100_SMEM)[:2] == (1, 16)
