"""The port's sLSTM scan (K5): its plain version (what ``ops.slstm_scan``
runs for CPU tensors) held against the JAX reference's Pallas kernel
(interpret mode) and its ``slstm_scan_ref`` oracle on the same numpy
inputs, over the shapes of ``tests/test_slstm_kernel.py``; the
resume-from-state contract; the one-step case against the reference
model's ``_slstm_step``; and the wrapper's dispatch and input checks.

Tolerances are those of ``tests/test_slstm_kernel.py``: 1e-5 for f32,
5e-2 for bf16.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm_scan import slstm_scan as jax_scan
from repro.kernels.slstm_scan import slstm_scan_ref as jax_scan_ref
from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.xlstm import _slstm_step as jax_slstm_step
from repro_torch.kernels.slstm_scan.ops import (cluster_plan, cluster_smem, slstm_scan,
                                                slstm_scan_ref)
from _port_env import port_test_env  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt: str) -> float:
    return 5e-2 if dt == "bfloat16" else 1e-5


def _inputs(rng, b, s, d, h, dt, *, state=False):
    """(jax args, torch args) from the same f32 numpy arrays; both
    frameworks round f32 to bf16 the same way."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    xg = f32(rng.normal(size=(b, s, 4 * d)))
    whh = f32(rng.normal(size=(h, d // h, 4 * (d // h))) * 0.2)
    bias = f32(rng.normal(size=(4 * d,)) * 0.1)
    if state:
        st = [f32(rng.normal(size=(b, d)) * 0.5), f32(rng.normal(size=(b, d))),
              f32(rng.uniform(0.5, 2.0, size=(b, d))), f32(rng.normal(size=(b, d)))]
    else:
        z = np.zeros((b, d), np.float32)
        st = [z, z, z, np.full((b, d), -np.inf, np.float32)]
    jd, td = DTYPES[dt]
    jargs = [jnp.asarray(xg, jd), jnp.asarray(whh, jd), jnp.asarray(bias)] + \
        [jnp.asarray(a) for a in st]
    targs = [torch.from_numpy(xg).to(td), torch.from_numpy(whh).to(td),
             torch.from_numpy(bias)] + [torch.from_numpy(a) for a in st]
    return jargs, targs


def _close(got: torch.Tensor, want, tol: float, msg: str = "") -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,S,D,H,bb,sc", [
    (1, 16, 32, 2, 1, 16),     # single tile
    (3, 40, 64, 4, 2, 16),     # batch + seq padding in the reference
    (2, 33, 48, 4, 2, 32),     # odd seq
    (4, 64, 64, 1, 4, 16),     # single head
])
def test_slstm_scan_plain_matches_jax(B, S, D, H, bb, sc, dt):
    jargs, targs = _inputs(np.random.default_rng(B * 1000 + S), B, S, D, H, dt)
    before = slstm_scan.launches
    hs, st = slstm_scan(*targs)
    assert slstm_scan.launches == before               # the plain version is no launch
    ref_hs, ref_st = slstm_scan_ref(*targs)
    assert torch.equal(hs, ref_hs) and hs.dtype == torch.float32
    assert hs.shape == (B, S, D) and all(t.shape == (B, D) for t in st)
    tol = _tol(dt)
    for jhs, jst in (jax_scan(*jargs, block_batch=bb, seq_chunk=sc), jax_scan_ref(*jargs)):
        _close(hs, jhs, tol, "hs")
        for a, c, name in zip(st, jst, "hcnm"):
            _close(a, c, tol, name)


def test_slstm_scan_resumes_from_state():
    """[0:16] then [16:24] from the carried state == one pass, and both
    equal the reference's own resume."""
    jargs, targs = _inputs(np.random.default_rng(7), 2, 24, 32, 2, "float32")
    xg = targs[0]
    hs_full, st_full = slstm_scan(*targs)
    _, st_a = slstm_scan(xg[:, :16], *targs[1:])
    hs_b, st_b = slstm_scan(xg[:, 16:], targs[1], targs[2], *st_a)
    _close(hs_b, hs_full[:, 16:].numpy(), 1e-5)
    for a, c in zip(st_b, st_full):
        _close(a, c.numpy(), 1e-5)
    jx = jargs[0]
    _, jst_a = jax_scan(jx[:, :16], *jargs[1:], seq_chunk=8)
    jhs_b, jst_b = jax_scan(jx[:, 16:], jargs[1], jargs[2], *jst_a, seq_chunk=8)
    _close(hs_b, jhs_b, 1e-5)
    for a, c in zip(st_b, jst_b):
        _close(a, c, 1e-5)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_slstm_scan_one_step_equals_reference_step(dt):
    """S = 1 from a given state (the decode path) is the reference model's
    ``_slstm_step``."""
    b, d, h = 3, 32, 4
    jargs, targs = _inputs(np.random.default_rng(11), b, 1, d, h, dt, state=True)
    hs, st = slstm_scan(*targs)
    cfg = JaxModelConfig(name="t", family="xlstm", num_layers=2, d_model=d, num_heads=h,
                         num_kv_heads=h, d_ff=0, vocab_size=8)
    p = {"w_hh": jargs[1], "b_ih": jargs[2]}
    want = jax_slstm_step(p, jargs[0][:, 0], tuple(jargs[3:]), cfg)
    _close(hs[:, 0], want[0], _tol(dt))
    for a, c, name in zip(st, want, "hcnm"):
        _close(a, c, _tol(dt), name)


def test_slstm_scan_first_step_from_minus_inf():
    """m0 = -inf gives f' = 0 on the first step: finite outputs, and the
    first h is sigmoid(o) tanh(z) (c = i' tanh z, n = i' with i' = 1)."""
    _, targs = _inputs(np.random.default_rng(5), 2, 3, 16, 2, "float32")
    hs, (h, c, n, m) = slstm_scan(*targs)
    assert torch.isfinite(hs).all() and torch.isfinite(m).all()
    xg, whh, bias = targs[:3]
    g = (xg[:, 0] + bias).reshape(2, 2, 4, 8)            # h0 = 0: no recurrent term
    want = torch.sigmoid(g[:, :, 3]) * torch.tanh(g[:, :, 2])
    torch.testing.assert_close(hs[:, 0], want.reshape(2, 16), atol=1e-6, rtol=1e-6)


def test_slstm_scan_wrapper_checks():
    _, targs = _inputs(np.random.default_rng(1), 1, 4, 16, 2, "float32")
    with pytest.raises(ValueError, match="unsupported device"):
        slstm_scan(*(t.to("meta") for t in targs))
    with pytest.raises(ValueError, match="does not fit"):
        slstm_scan(targs[0], targs[1][:, :, :8], *targs[2:])
    with pytest.raises(ValueError, match="b_ih"):
        slstm_scan(targs[0], targs[1], targs[2][:8], *targs[3:])
    with pytest.raises(ValueError, match="h0"):
        slstm_scan(*targs[:3], targs[3][:, :8], *targs[4:])
    with pytest.raises(TypeError):
        slstm_scan(targs[0].double(), *targs[1:])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_slstm_scan_plain_matches_jax_decode_batch(dt):
    """The decode path's shape: B = 8 rows, one step, from a carried state."""
    jargs, targs = _inputs(np.random.default_rng(8), 8, 1, 64, 4, dt, state=True)
    hs, st = slstm_scan(*targs)
    for jhs, jst in (jax_scan(*jargs), jax_scan_ref(*jargs)):
        _close(hs, jhs, _tol(dt), "hs")
        for a, c, name in zip(st, jst, "hcnm"):
            _close(a, c, _tol(dt), name)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_slstm_scan_plain_one_step_chain_matches_jax(dt):
    """Four S = 1 calls, each resuming from the last one's state (four
    decode rounds), equal one S = 4 call, here and in the JAX kernel."""
    jargs, targs = _inputs(np.random.default_rng(9), 3, 4, 32, 2, dt, state=True)
    hs_full, st_full = slstm_scan(*targs)
    st, jst = tuple(targs[3:]), tuple(jargs[3:])
    for t in range(4):
        hs, st = slstm_scan(targs[0][:, t:t + 1], targs[1], targs[2], *st)
        jhs, jst = jax_scan(jargs[0][:, t:t + 1], jargs[1], jargs[2], *jst)
        _close(hs[:, 0], hs_full[:, t].numpy(), 1e-5, f"step {t}")
        _close(hs[:, 0], np.asarray(jhs, np.float32)[:, 0], _tol(dt), f"jax step {t}")
    for a, c, j in zip(st, st_full, jst):
        _close(a, c.numpy(), 1e-5)
        _close(a, j, _tol(dt))


H100_SMEM = 232_448          # opt-in shared memory per block on an H100 (227 KB)


@pytest.mark.parametrize("b", [1, 4, 8])
def test_cluster_plan_full_width(b):
    """bf16 at full width (D = 2048, H = 4): one cluster of 16 blocks per
    head, J = 32; f32 (4 MiB of w_hh per head) fits no cluster."""
    cs, j, smem = cluster_plan(b, 2048, 4, 2, 2, H100_SMEM)
    assert (cs, j) == (16, 32) and 131_072 < smem <= H100_SMEM
    assert cluster_plan(b, 2048, 4, 4, 4, H100_SMEM) is None
    assert cluster_plan(b, 2048, 4, 2, 4, H100_SMEM) is None


@pytest.mark.parametrize("cs,d,h", [(1, 24, 2), (2, 400, 2), (4, 560, 2), (8, 800, 2),
                                    (16, 1000, 2), (1, 64, 4), (1, 32, 2)])
def test_cluster_plan_test_shapes(cs, d, h):
    """The smallest cluster whose blocks hold the head's w_hh (bf16, B = 3),
    at the card tests' shapes; J is a multiple of 8 and covers dh."""
    got = cluster_plan(3, d, h, 2, 2, H100_SMEM)
    assert got is not None and got[0] == cs
    j, dh = got[1], d // h
    assert j % 8 == 0 and cs * j >= dh and j - 8 < -(-dh // cs)
    if cs > 1:       # the next smaller cluster does not fit
        smaller = (-(-dh // (cs // 2)) + 7) // 8 * 8
        assert cluster_smem(3, dh, smaller, cs // 2, 2, 2) > H100_SMEM
