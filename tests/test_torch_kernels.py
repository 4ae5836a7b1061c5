"""The port's kernels' plain versions (what ``ops`` runs for CPU tensors)
held against the JAX reference's Pallas kernels (interpret mode) and its
``ref.py`` oracles, on the same numpy inputs, over the shapes of
``tests/test_kernels.py``; plus the wrappers' dispatch and input checks.

Tolerances are those of ``tests/test_kernels.py``: 3e-5 for f32, 2e-2 for
bf16.  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ops import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ops import flash_attention_ref as jax_flash_ref
from repro.kernels.rmsnorm.ops import fused_rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm.ops import rmsnorm_ref as jax_rmsnorm_ref
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_ref
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref
from _port_env import port_test_env  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt: str) -> float:
    return 2e-2 if dt == "bfloat16" else 3e-5


def _both(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    return jnp.asarray(a, DTYPES[dt][0]), torch.from_numpy(a).to(DTYPES[dt][1])


def _close(got: torch.Tensor, want, dt: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=_tol(dt), rtol=_tol(dt))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize(
    "b,h,kv,sq,sk,hd,causal",
    [
        (2, 4, 2, 64, 64, 32, True),     # GQA causal
        (1, 8, 1, 96, 96, 64, True),     # MQA causal
        (2, 4, 4, 33, 47, 16, False),    # MHA non-causal ragged tiles
        (1, 2, 2, 128, 256, 128, False), # long kv, MXU-aligned head
        (1, 16, 2, 8, 8, 8, True),       # tiny
        (1, 4, 2, 20, 47, 16, True),     # causal Sq != Sk: top-left mask
        (1, 8, 1, 65, 65, 256, True),    # gemma-2b's heads: G = 8 over KV = 1 at hd 256
        (2, 8, 1, 20, 47, 256, False),   # the same, non-causal ragged tiles
    ],
)
def test_flash_attention_plain_matches_jax(b, h, kv, sq, sk, hd, causal, dt):
    rng = np.random.default_rng(sq * 1000 + sk + hd)
    # the model's (B, S, H, hd) layout; the port reads it as a transposed view
    qn = rng.standard_normal((b, sq, h, hd), np.float32)
    kn = rng.standard_normal((b, sk, kv, hd), np.float32)
    vn = rng.standard_normal((b, sk, kv, hd), np.float32)
    jq, tq = _both(qn.transpose(0, 2, 1, 3), dt)
    jk, tk = _both(kn.transpose(0, 2, 1, 3), dt)
    jv, tv = _both(vn.transpose(0, 2, 1, 3), dt)
    _, tq_s = _both(qn, dt)
    _, tk_s = _both(kn, dt)
    _, tv_s = _both(vn, dt)
    out = flash_attention(tq_s.transpose(1, 2), tk_s.transpose(1, 2), tv_s.transpose(1, 2),
                          causal=causal)
    assert torch.equal(out, flash_attention_ref(tq, tk, tv, causal=causal))
    _close(out, jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32), dt)
    _close(out, jax_flash_ref(jq, jk, jv, causal=causal), dt)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _decode_inputs(b, h, kv, s, hd, lens, dt, seed):
    rng = np.random.default_rng(seed)
    qn = rng.standard_normal((b, h, hd), np.float32)
    # one layer of the model's (B, Smax, KV, hd) cache, read as (B, KV, S, hd)
    kn = rng.standard_normal((b, s, kv, hd), np.float32)
    vn = rng.standard_normal((b, s, kv, hd), np.float32)
    jq, tq = _both(qn, dt)
    jk, _ = _both(kn.transpose(0, 2, 1, 3), dt)
    jv, _ = _both(vn.transpose(0, 2, 1, 3), dt)
    tk = torch.from_numpy(kn).to(DTYPES[dt][1]).transpose(1, 2)
    tv = torch.from_numpy(vn).to(DTYPES[dt][1]).transpose(1, 2)
    return (jq, jk, jv, jnp.asarray(lens, jnp.int32)), \
        (tq, tk, tv, torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize(
    "b,h,kv,s,hd",
    [(3, 8, 2, 512, 64), (1, 4, 4, 128, 32), (2, 8, 1, 1024, 128),
     (2, 8, 1, 300, 256)],            # gemma-2b's heads: G = 8 over KV = 1 at hd 256
)
def test_decode_attention_plain_matches_jax(b, h, kv, s, hd, dt):
    lens = np.linspace(1, s, b).astype(np.int32)
    jargs, targs = _decode_inputs(b, h, kv, s, hd, lens, dt, seed=s + hd)
    out = decode_attention(*targs)
    assert torch.equal(out, decode_attention_ref(*targs))
    _close(out, jax_decode(*jargs, block_s=128), dt)
    _close(out, jax_decode_ref(*jargs), dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_attention_length_zero_gives_zero(dt):
    """A length-0 row gives 0, as the TPU kernel does (its ``l`` clamp); the
    JAX oracle would spread uniform weights there, so it is held only on
    the rows with keys."""
    lens = [0, 5, 64, 0]
    jargs, targs = _decode_inputs(4, 4, 2, 64, 16, lens, dt, seed=3)
    out = decode_attention(*targs)
    pallas = np.asarray(jax_decode(*jargs, block_s=32), np.float32)
    assert np.all(pallas[[0, 3]] == 0)
    assert torch.all(out[[0, 3]] == 0)
    _close(out, pallas, dt)
    _close(out[1:3], np.asarray(jax_decode_ref(*jargs), np.float32)[1:3], dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_attention_length_above_cache(dt):
    """A length above S (an idle slot's, which grows every round) counts as
    S, as in the TPU kernel and the JAX oracle."""
    lens = [64 + 9, 3, 1000]
    jargs, targs = _decode_inputs(3, 4, 2, 64, 16, lens, dt, seed=4)
    out = decode_attention(*targs)
    full = decode_attention(*targs[:3], torch.tensor([64, 3, 64], dtype=torch.int32))
    assert torch.equal(out, full)
    _close(out, jax_decode(*jargs, block_s=32), dt)
    _close(out, jax_decode_ref(*jargs), dt)


# ---------------------------------------------------------------------------
# fused rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("want", [True, False], ids=["residual-out", "no-residual-out"])
@pytest.mark.parametrize("residual,gemma", [(True, False), (True, True), (False, False),
                                            (False, True)],
                         ids=["add", "add-gemma", "norm", "norm-gemma"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 37, 64), (1, 256, 128), (5, 3, 32), (4, 1, 1536),
                                   (3, 5, 48), (3, 5, 52), (3, 5, 2048),
                                   (2, 9, 4, 128)])      # qk_norm: (B, S, heads, head_dim)
def test_rmsnorm_plain_matches_jax(shape, dt, residual, gemma, want):
    """Every mode the models call: the add + norm (the Pallas kernel's
    function), the norm alone and Gemma's ``1 + scale`` (the reference's
    ``rms_norm`` on the f32 sum), with and without the residual output.
    D = 52 is no multiple of the kernel's 16-byte vector."""
    rng = np.random.default_rng(sum(shape))
    jx, tx = _both(rng.standard_normal(shape, np.float32), dt)
    jr, tr = _both(rng.standard_normal(shape, np.float32), dt)
    sc = rng.standard_normal(shape[-1:], np.float32)
    r = tr if residual else None
    kw = dict(eps=1e-6, gemma=gemma, want_residual=want)
    y, h = fused_rmsnorm(tx, r, torch.from_numpy(sc), **kw)
    yr, hr = rmsnorm_ref(tx, r, torch.from_numpy(sc), **kw)
    assert torch.equal(y, yr) and y.dtype == DTYPES[dt][1] and y.shape == shape
    if not want:
        assert h is None and hr is None
    elif not residual:
        assert h is tx and hr is tx
    else:
        assert torch.equal(h, hr) and h.dtype == DTYPES[dt][1]
    jh = jx.astype(jnp.float32) + jr.astype(jnp.float32) if residual else jx
    _close(y, jax_rms_norm(jh, jnp.asarray(sc), 1e-6, gemma=gemma).astype(DTYPES[dt][0]), dt)
    if not residual or gemma:
        return
    for jy, jhk in (jax_rmsnorm(jx, jr, jnp.asarray(sc), block_rows=16),
                    jax_rmsnorm_ref(jx, jr, jnp.asarray(sc))):
        _close(y, jy, dt)
        if want:
            _close(h, jhk, dt)


def test_rmsnorm_norm_only_equals_model_rms_norm():
    """The plain version's norm alone is the port's ``models.common.rms_norm``
    bit for bit, with and without ``gemma``, which it replaces on the paths."""
    from repro_torch.models.common import rms_norm

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 6, 96), np.float32))
    sc = torch.from_numpy(np.random.default_rng(2).standard_normal((96,), np.float32))
    for dt in (torch.float32, torch.bfloat16):
        for gemma in (False, True):
            y, _ = rmsnorm_ref(x.to(dt), None, sc, gemma=gemma)
            assert torch.equal(y, rms_norm(x.to(dt), sc, 1e-6, gemma=gemma))


# ---------------------------------------------------------------------------
# the wrappers: dispatch by device, input checks, launch counters
# ---------------------------------------------------------------------------


def _wrapper_calls(device):
    q = torch.zeros(1, 2, 4, 64, device=device)
    kv = torch.zeros(1, 1, 4, 64, device=device)
    x = torch.zeros(3, 64, device=device)
    sc = torch.ones(64, device=device)
    dq = torch.zeros(1, 2, 64, device=device)
    lens = torch.ones(1, dtype=torch.int32, device=device)
    return {
        "flash_attention": lambda: flash_attention(q, kv, kv),
        "decode_attention": lambda: decode_attention(dq, kv, kv, lens),
        "rmsnorm": lambda: fused_rmsnorm(x, x, sc),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention", "rmsnorm"])
def test_wrapper_takes_plain_version_only_on_cpu(name):
    wrappers = {"flash_attention": flash_attention, "decode_attention": decode_attention,
                "rmsnorm": fused_rmsnorm}
    before = wrappers[name].launches
    _wrapper_calls("cpu")[name]()
    assert wrappers[name].launches == before          # the plain version is no launch
    with pytest.raises(ValueError, match="unsupported device"):
        _wrapper_calls("meta")[name]()               # neither cpu nor cuda: raise


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 3, 4, 16)
    kv = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention(q, kv, kv)                     # 3 heads over 2 kv heads
    with pytest.raises(TypeError):
        flash_attention(kv.double(), kv.double(), kv.double())
    dq = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(dq, kv, kv, torch.ones(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="differ"):
        fused_rmsnorm(torch.zeros(2, 8), torch.zeros(3, 8), torch.ones(8))
    with pytest.raises(ValueError, match="scale"):
        fused_rmsnorm(torch.zeros(2, 8), torch.zeros(2, 8), torch.ones(4))
    with pytest.raises(ValueError, match="scale"):
        fused_rmsnorm(torch.zeros(2, 8), None, torch.ones(4))
    with pytest.raises(TypeError, match="the same for both"):
        fused_rmsnorm(torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.bfloat16), torch.ones(8))
    with pytest.raises(TypeError):
        fused_rmsnorm(torch.zeros(2, 8, dtype=torch.float16), None, torch.ones(8))


def test_kernel_build_layout():
    """Each CUDA source builds into its own library under the ignored
    ``build/`` directory, named by a hash of the source and flags; each
    names the Pallas TPU kernel it replaces (a backward, which no TPU
    kernel has, the kernel it differentiates) and what bounds it."""
    assert _build.sources() == ["decode_attention", "flash_attention", "flash_attention_bwd",
                                "ragged_concat", "rmsnorm", "slstm_scan", "slstm_scan_bwd"]
    for name in _build.sources():
        src = (_build.CSRC / f"{name}.cu").read_text()
        note = "Backward of" if name.endswith("_bwd") else "Replaces the Pallas TPU kernel"
        assert note in src and "What bounds it" in src
        assert '#include "common.cuh"' in src
        lib = _build._target(name)
        assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    root = Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR.relative_to(root).parts[0] == "build"
    assert "build/" in (root / ".gitignore").read_text().split()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_kernel_build_hash_covers_shared_header(tmp_path, monkeypatch):
    """An edit to the shared header renames (so rebuilds) every library."""
    for p in _build.CSRC.glob("*.cu*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in _build.sources()}
    (tmp_path / "common.cuh").write_text((tmp_path / "common.cuh").read_text() + "\n// x\n")
    after = {n: _build._target(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)
