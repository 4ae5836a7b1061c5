"""The tiling of K2-bwd (``csrc/flash_attention_bwd.cu``), modelled in plain
torch and held against the plain backward and the JAX reference's gradient.

On the card, bf16 at head dims 64, 80 and 128 runs two tensor-core kernels
after the delta pass: one block per (64-key tile, KV head, batch) walks the
G query heads and, for each, the 64-query tiles from the causal diagonal
on, in passes of 32 query columns (64 at hd 64), adding P~^T dO into dV and
dS~^T Q into dK; one block per (64-query tile, head, batch) walks the key
tiles its rows see and adds dS~ K into dQ, forming S and dP again (no
atomics).  P and dS are rounded to bf16 where the kernels round them (P
before dV's product, as the forward's P.V; dS before dQ's, and for dK's,
which sums G Sq terms, split into a rounded term and its rounded
remainder).  The
model below follows that order step by step, so a fault in the walk (a
query tile skipped that sees the key tile, a pass that misses columns, a
wrong edge mask) shows here on the CPU.  It is held against
``flash_attention_bwd_ref`` and against ``jax.vjp`` of
``repro.kernels.flash_attention.ref.flash_attention_ref`` on the same
numpy inputs, at the tolerances of ``tests/test_kernels.py``: 3e-5 for f32
(the CUDA-core kernels, which round nothing) and 2e-2 for bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention.ops import BWD_MMA_HEAD_DIMS, KERNEL_HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

TILE = 64                        # query and key rows of a tile, 16 a warp
H100_SMEM_PER_BLOCK = 232_448    # bytes a block may opt into
H100_SMEM_PER_SM = 233_472
LOG2E = 1.4426950408889634
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tile_pitch(hd: int) -> int:
    """Elements per row of a tile (``MmaPlan::kPitch``): the head dim's
    16-byte chunks rounded up to a power of two (hd 80: rows of 128)."""
    return 8 * (1 << max(0, (hd // 8 - 1).bit_length()))


def query_pass(hd: int) -> int:
    """Query columns a pass of the dK/dV kernel takes (``MmaPlan::kQN``):
    32 above hd 64, where dK's and dV's accumulators fill a lane."""
    return 32 if hd > 64 else TILE


def mma_smem(hd: int) -> int:
    """Dynamic shared memory of either tensor-core kernel (``MmaPlan::
    kSmem``): 6 tiles of 64 rows, then 2 stages of 64 lse and 64 delta."""
    return 6 * TILE * tile_pitch(hd) * 2 + 2 * 2 * TILE * 4


def cuda_core_smem(hd: int) -> int:
    """Shared memory of the CUDA-core kernels (``BwdPlan::kSmem``): K and V
    tiles of 32 keys (16 at hd 256), Q and dO tiles of 16 queries, each
    row padded by one float, P and dS tiles, lse and delta."""
    bk, bq = (16 if hd > 128 else 32), 16
    return (2 * bk * (hd + 1) + 2 * bq * (hd + 1) + 2 * bq * (bk + 1) + 2 * bq) * 4


def dkdv_query_tiles(k0: int, sq: int, causal: bool) -> list[int]:
    """The query tiles the block of key tile ``k0`` walks for each head:
    from the diagonal on (top-left causal: rows below k0 see none of its
    keys), or all of them."""
    return list(range(k0 if causal else 0, sq, TILE))


def _round(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return x.to(dt).float()


def _two_terms(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x as the dK product takes it: rounded, plus the remainder rounded."""
    big = _round(x, dt)
    return big + _round(x - big, dt)


def tiled_flash_bwd(q, k, v, o, do, *, causal, visits=None, dk_terms=2):
    """K2-bwd's order of work.  q, o, do (B, H, Sq, hd); k, v (B, KV, Sk,
    hd).  Returns (dq, dk, dv) in the inputs' type.  bf16 rounds as the
    tensor-core kernels do (at every head dim: the model is of that plan):
    P~ for dV, dS~ for dQ, and dS as two bf16 terms for dK; f32 rounds
    nothing, as the CUDA-core kernels.  ``visits``, if
    given, collects (b, KV head, key tile, head, query tile) of the dK/dV
    walk; ``dk_terms=1`` rounds dS once for dK too (what the kernels do
    not do)."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    dt = q.dtype
    bf16 = dt == torch.bfloat16
    rnd = (lambda x: _round(x, dt)) if bf16 else (lambda x: x)
    rnd2 = (lambda x: _two_terms(x, dt) if dk_terms == 2 else _round(x, dt)) if bf16 else \
        (lambda x: x)
    scale = hd ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    # the forward's logsumexp of the scaled, masked scores, and delta
    s_all = torch.einsum("bhqd,bhkd->bhqk", qf, kf.repeat_interleave(g, 1)) * scale
    if causal:
        s_all = s_all.masked_fill(torch.ones(sq, sk, dtype=torch.bool).triu(1), float("-inf"))
    lse = torch.logsumexp(s_all, -1)
    delta = (dof * o.float()).sum(-1)

    def probs(s, qpos, kpos, l_rows):
        """P from raw scores (rows x cols) as the kernel forms it, masked."""
        p = torch.exp2(s * (scale * LOG2E) - l_rows * LOG2E)
        ok = (qpos < sq) & (kpos < sk)
        if causal:
            ok = ok & (kpos <= qpos)
        return torch.where(ok, p, torch.zeros_like(p))

    dq = torch.zeros(b, h, sq, hd)
    dk = torch.zeros(b, kvh, sk, hd)
    dv = torch.zeros(b, kvh, sk, hd)
    qn = query_pass(hd)
    for bi in range(b):
        for kh in range(kvh):
            for k0 in range(0, sk, TILE):                 # dK/dV: one block a key tile
                keys = torch.arange(k0, min(k0 + TILE, sk))
                kt, vt = kf[bi, kh, keys], vf[bi, kh, keys]
                acc_k, acc_v = torch.zeros(len(keys), hd), torch.zeros(len(keys), hd)
                for gi in range(g):
                    hh = kh * g + gi
                    for q0 in dkdv_query_tiles(k0, sq, causal):
                        if visits is not None:
                            visits.append((bi, kh, k0, hh, q0))
                        for c0 in range(q0, min(q0 + TILE, sq), qn):   # passes of qn columns
                            rows = torch.arange(c0, min(c0 + qn, sq))
                            st = kt @ qf[bi, hh, rows].T                # S^T: keys x queries
                            pt = probs(st, rows[None, :], keys[:, None], lse[bi, hh, rows][None])
                            acc_v += rnd(pt) @ dof[bi, hh, rows]
                            dpt = vt @ dof[bi, hh, rows].T
                            dst = pt * (dpt - delta[bi, hh, rows][None])
                            acc_k += rnd2(dst) @ qf[bi, hh, rows]
                dk[bi, kh, keys] = acc_k * scale
                dv[bi, kh, keys] = acc_v
        for hh in range(h):                               # dQ: one block a query tile
            kh = hh // g
            for q0 in range(0, sq, TILE):
                rows = torch.arange(q0, min(q0 + TILE, sq))
                kend = min(sk, q0 + TILE) if causal else sk
                acc = torch.zeros(len(rows), hd)
                for k0 in range(0, kend, TILE):
                    keys = torch.arange(k0, min(k0 + TILE, sk))
                    kt, vt = kf[bi, kh, keys], vf[bi, kh, keys]
                    s = qf[bi, hh, rows] @ kt.T
                    p = probs(s, rows[:, None], keys[None, :], lse[bi, hh, rows][:, None])
                    ds = p * (dof[bi, hh, rows] @ vt.T - delta[bi, hh, rows][:, None])
                    acc += rnd(ds) @ kt
                dq[bi, hh, rows] = acc * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


# (B, H, KV, Sq, Sk, hd, causal): Sq and Sk of 1, 63, 64, 65 and 130, equal
# and unequal both ways, G = H / KV of 1, 6 and 16; hd 128 takes passes of 32
BWD_CASES = [
    (1, 2, 2, 1, 1, 16, True),          # a single query and key, G 1
    (1, 6, 1, 63, 130, 16, True),       # Sq < Sk: key tiles no query sees, G 6
    (1, 16, 1, 65, 64, 16, False),      # a row past the first tile, exactly one key tile, G 16
    (1, 6, 1, 130, 65, 16, True),       # Sq > Sk: rows past Sk see every key
    (2, 2, 1, 64, 130, 16, False),      # non-causal, Sq < Sk, two batches
    (1, 2, 1, 130, 130, 128, True),     # hd 128: two passes of 32 query columns a tile
]


def _inputs(b, h, kv, sq, sk, hd, dt, seed):
    rng = np.random.default_rng(seed)
    qn = rng.standard_normal((b, h, sq, hd), np.float32)
    kn = rng.standard_normal((b, kv, sk, hd), np.float32)
    vn = rng.standard_normal((b, kv, sk, hd), np.float32)
    don = rng.standard_normal((b, h, sq, hd), np.float32)
    return qn, kn, vn, don


def _close(got: torch.Tensor, want, dt: str, what: str) -> None:
    tol = 2e-2 if dt == "bfloat16" else 3e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", BWD_CASES)
def test_tiled_flash_bwd_matches_plain_and_jax(b, h, kv, sq, sk, hd, causal, dt):
    jdt, tdt = DTYPES[dt]
    qn, kn, vn, don = _inputs(b, h, kv, sq, sk, hd, dt, sq * 1000 + sk + h)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (qn, kn, vn, don))
    to = flash_attention_ref(tq, tk, tv, causal=causal)
    got = tiled_flash_bwd(tq, tk, tv, to, tdo, causal=causal)
    want = flash_attention_bwd_ref(tq, tk, tv, to, tdo, causal=causal)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (qn, kn, vn, don))
    jgrads = jax.jit(lambda a, c, e, d: jax.vjp(
        lambda a, c, e: jax_flash_ref(a, c, e, causal=causal), a, c, e)[1](d))(jq, jk, jv, jdo)
    for name, a, w, j in zip(("dq", "dk", "dv"), got, want, jgrads):
        _close(a, w.float(), dt, f"{name} against flash_attention_bwd_ref")
        _close(a, np.asarray(j.astype(jnp.float32)), dt, f"{name} against jax.vjp")


def _ratio(got, want) -> float:
    """The largest |got - want| over the bf16 bound's atol + rtol |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / (2e-2 + 2e-2 * np.abs(want))).max())


def test_dk_takes_ds_in_two_terms():
    """dK sums G Sq terms of dS^T Q a key, unweighted.  With 15 keys and no
    mask P is large: a dS rounded once to bf16 misses the 2e-2 bound
    against the exact gradient here, as JAX's own bf16 backward does (its
    transposed products round the f32 cotangents to bf16), while the
    kernels' two-term dS (rounded, plus its rounded remainder) keeps dK
    within it."""
    b, h, kv, sq, sk, hd = 2, 8, 1, 384, 15, 128
    qn, kn, vn, don = _inputs(b, h, kv, sq, sk, hd, "bfloat16", 7)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn, don))
    to = flash_attention_ref(tq, tk, tv, causal=False)
    want = flash_attention_bwd_ref(tq, tk, tv, to, tdo, causal=False)[1].float().numpy()
    two = tiled_flash_bwd(tq, tk, tv, to, tdo, causal=False)[1].float().numpy()
    once = tiled_flash_bwd(tq, tk, tv, to, tdo, causal=False, dk_terms=1)[1].float().numpy()
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn, don))
    jdk = jax.jit(lambda a, c, e, d: jax.vjp(
        lambda a, c, e: jax_flash_ref(a, c, e, causal=False), a, c, e)[1](d))(jq, jk, jv, jdo)[1]
    assert _ratio(two, want) <= 1 < min(_ratio(once, want), _ratio(jdk.astype(jnp.float32), want))


def test_dkdv_walk_visits_exactly_the_query_tiles_that_see_each_key_tile():
    """For every key tile, KV head and batch, the dK/dV block walks each of
    the G heads' query tiles that hold a query seeing one of its keys, and
    no other: all of them without the mask; from the diagonal on with the
    top-left causal mask (none when Sq <= the tile's first key)."""
    for sq, sk in ((130, 130), (63, 200), (200, 63), (1, 1), (64, 65)):
        for causal in (True, False):
            q = torch.zeros(1, 4, sq, 16)
            kv = torch.zeros(1, 2, sk, 16)
            visits = []
            tiled_flash_bwd(q, kv, kv, q, q, causal=causal, visits=visits)
            want = []
            for kh in range(2):
                for k0 in range(0, sk, TILE):
                    for hh in (2 * kh, 2 * kh + 1):
                        for q0 in range(0, sq, TILE):
                            rows = range(q0, min(q0 + TILE, sq))
                            keys = range(k0, min(k0 + TILE, sk))
                            if any(not causal or key <= row for row in rows for key in keys):
                                want.append((0, kh, k0, hh, q0))
            assert visits == want, (sq, sk, causal)
    # a pass of each query tile covers every row once
    for hd in KERNEL_HEAD_DIMS:
        assert TILE % query_pass(hd) == 0 and query_pass(hd) % 16 == 0


def test_bwd_plans_fit_a_block():
    """Every instantiation's shared memory fits what a block may have on the
    H100 (227 KB): the tensor-core plan at hd 64, 80 and 128 (50,176 B at
    64; 99,328 at 80, in its rows of 128 columns, and at 128), two blocks a
    SM; the CUDA-core kernels at every head dim (f32, and bf16 at 256).  A
    warp's dK and dV accumulators (16 rows x hd f32 each: hd / 2 a lane
    each) and one pass's S^T and dP^T stay within 192 of a lane's 255
    registers."""
    assert BWD_MMA_HEAD_DIMS == (64, 80, 128)
    for hd in BWD_MMA_HEAD_DIMS:
        smem = mma_smem(hd)
        assert smem <= H100_SMEM_PER_BLOCK and 2 * (smem + 1024) <= H100_SMEM_PER_SM, hd
        acc = 2 * (16 * hd // 32)                 # dK and dV, f32 a lane
        scores = 2 * (16 * query_pass(hd) // 32)  # S^T and dP^T of one pass
        assert acc + scores <= 192, hd
    assert [mma_smem(hd) for hd in BWD_MMA_HEAD_DIMS] == [50_176, 99_328, 99_328]
    for hd in KERNEL_HEAD_DIMS:
        assert cuda_core_smem(hd) <= H100_SMEM_PER_BLOCK, hd
    assert [tile_pitch(hd) for hd in BWD_MMA_HEAD_DIMS] == [64, 128, 128]
