"""The sLSTM scan's backward (K5-bwd): its plain version
``slstm_scan_bwd_ref`` (what ``ops.slstm_scan_bwd`` runs for CPU tensors,
and what the card holds the kernel against) against autograd of the
port's ``slstm_scan_ref`` and against ``jax.vjp`` of the reference's oracle
``repro.kernels.slstm_scan.ref.slstm_scan_ref`` (the reference's Pallas
kernel has no VJP), on the same numpy inputs, at the shapes of
``tests/test_torch_slstm_scan.py``; a planted fault that the bound must
catch; and ``_SlstmScanFn`` (K5 with K5-bwd) on CPU tensors.

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
from repro_torch.kernels.slstm_scan.ops import _SlstmScanFn, slstm_scan_bwd
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
    plain = slstm_scan_bwd_ref(*t_args, hs.detach(), *(t.detach() for t in saved), t_dhs,
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
    good = slstm_scan_bwd_ref(*t_args, hs, *saved, torch.from_numpy(dhs), *t_fin)
    bad = faulty(*t_args, hs, *saved, torch.from_numpy(dhs), *t_fin)
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


def test_bwd_wrapper_dispatch_and_checks():
    """CPU tensors take the plain backward (no launch counted); None
    cotangents mean zero; shapes that do not fit raise."""
    args, dhs, _ = _numpy_inputs(5, 2, 6, 32, 2, False, False)
    t_args = [torch.from_numpy(a) for a in args]
    hs, _, saved = slstm_scan_ref(*t_args, save_states=True)
    before = slstm_scan_bwd.launches
    got = slstm_scan_bwd(*t_args, hs, *saved, torch.from_numpy(dhs))
    assert slstm_scan_bwd.launches == before
    want = slstm_scan_bwd_ref(*t_args, hs, *saved, torch.from_numpy(dhs),
                              *(torch.zeros(2, 32) for _ in range(4)))
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    with pytest.raises(ValueError, match="hs"):
        slstm_scan_bwd(*t_args, hs[:, :3], *saved, torch.from_numpy(dhs))
    with pytest.raises(ValueError, match="dh_T"):
        slstm_scan_bwd(*t_args, hs, *saved, torch.from_numpy(dhs), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        slstm_scan_bwd(*(t.to("meta") for t in t_args), *(t.to("meta") for t in (hs, *saved)),
                       None)
