"""The tiling of the port's attention kernels, modelled in plain torch and
held against the plain versions and the JAX reference.

The CUDA kernels (``csrc/flash_attention.cu``, ``csrc/decode_attention.cu``)
run only on the card.  What they do differently from a one-shot softmax is
the order of the work: key tiles with an online softmax, tiles past the
causal diagonal skipped, even and odd tiles taken by two warp sets whose
states merge at the end, or at head_dim 256 one set over every tile with
O's columns split over two groups of warps (K2);
the cache split into blocks of ``decode_split_plan`` positions, a partial
(m, l, acc) per split and a merge, for each row group of at most 8 query
heads of a KV head (K3).  The models below follow that order
step by step, in f32, with p rounded to v's dtype before P.V as K2 does, so
a fault in the order (a skipped tile that holds a visible key, a
wrong merge, a length edge) shows here on the CPU.  Each is held against
``flash_attention_ref`` / ``decode_attention_ref`` and, on the same numpy
inputs, against the JAX Pallas kernels in interpret mode and the JAX
oracles, at the tolerances of ``tests/test_kernels.py``: 3e-5 for f32 and
2e-2 for bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ops import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ops import flash_attention_ref as jax_flash_ref
from repro_torch.kernels._device import check_aligned
from repro_torch.kernels.decode_attention.ops import KERNEL_HEAD_DIMS as DECODE_HEAD_DIMS
from repro_torch.kernels.decode_attention.ops import (KERNEL_MAX_GROUP, _row_slots,
                                                      decode_attention_ref, decode_row_groups,
                                                      decode_split_plan)
from repro_torch.kernels.flash_attention.ops import KERNEL_HEAD_DIMS as FLASH_HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import flash_attention_ref
from _port_env import port_test_env  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NEG = -2.0e38
Q_ROWS, K_TILE = 64, 64          # the bf16 K2 kernel's query rows per block, keys per tile
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232_448    # bytes a block may opt into


def tile_pitch(hd: int) -> int:
    """Elements per row of K2's bf16 tiles (``MmaPlan::kPitch``): the head
    dim's 16-byte chunks rounded up to a power of two, so the swizzle
    ``chunk ^ (row % 8)`` stays in the row (hd 80: 10 chunks in rows of 16)."""
    return 8 * (1 << max(0, (hd // 8 - 1).bit_length()))


def mma_plan(hd: int) -> tuple[int, int, int]:
    """K2's bf16 plan (``MmaPlan`` in ``csrc/flash_attention.cu``): warp sets
    over the key tiles, groups of warps sharing O's columns, and the
    dynamic shared memory (Q, then each set's two stages of K and V, in
    rows of ``tile_pitch``)."""
    sets = 1 if hd > 128 else 2
    return sets, 3 - sets, (Q_ROWS + sets * 4 * K_TILE) * tile_pitch(hd) * 2


def _tol(dt: str) -> float:
    return 2e-2 if dt == "bfloat16" else 3e-5


def _close(got: torch.Tensor, want, dt: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=_tol(dt), rtol=_tol(dt))


# ---------------------------------------------------------------------------
# K2: key tiles, online softmax, diagonal skip, two warp sets
# ---------------------------------------------------------------------------


def _online(state, s, v, vdt):
    """One online-softmax step of (m, l, acc) over scores ``s`` (rows, keys)."""
    m, l, acc = state
    m_new = torch.maximum(m, s.max(dim=-1).values)
    p = torch.where(s > 0.5 * NEG, torch.exp(s - m_new[:, None]), torch.zeros_like(s))
    alpha = torch.exp(m - m_new)
    return (m_new, l * alpha + p.sum(-1),
            acc * alpha[:, None] + p.to(vdt).float() @ v.float())


def _merge(a, b):
    (ma, la, aa), (mb, lb, ab) = a, b
    m = torch.maximum(ma, mb)
    ea, eb = torch.exp(ma - m), torch.exp(mb - m)
    return m, la * ea + lb * eb, aa * ea[:, None] + ab * eb[:, None]


def tiled_flash(q, k, v, *, causal, tiles_seen=None):
    """The kernel's order of work for one (batch, head) at a time: blocks of
    ``Q_ROWS`` query rows; for each, key tiles of ``K_TILE`` up to the
    block's diagonal (top-left causal).  With two warp sets (hd <= 128)
    tile j goes to set j % 2 with its own (m, l, acc) and the two sets'
    states merge at the end; with one (hd 256) every tile goes to both
    groups of warps, each of which computes the rows' whole S and keeps
    (m, l, acc) over its own half of O's columns."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    n_sets, n_cols, _ = mma_plan(hd)
    oc = hd // n_cols
    scale = hd ** -0.5
    out = torch.zeros(b, h, sq, hd)
    for bi in range(b):
        for hi in range(h):
            qh, kk, vv = q[bi, hi].float(), k[bi, hi // g], v[bi, hi // g]
            for q0 in range(0, sq, Q_ROWS):
                rows = torch.arange(q0, min(q0 + Q_ROWS, sq))
                kend = min(sk, sq, q0 + Q_ROWS) if causal else sk
                for c in range(n_cols):
                    cols = slice(c * oc, (c + 1) * oc)
                    sets = [(torch.full((len(rows),), NEG), torch.zeros(len(rows)),
                             torch.zeros(len(rows), oc)) for _ in range(n_sets)]
                    for j, k0 in enumerate(range(0, kend, K_TILE)):
                        if tiles_seen is not None and c == 0:
                            tiles_seen.append((q0, k0, j % n_sets))
                        keys = torch.arange(k0, min(k0 + K_TILE, sk))
                        s = (qh[rows] @ kk[keys].float().T) * scale
                        if causal:
                            s = torch.where(keys[None, :] <= rows[:, None], s,
                                            torch.full_like(s, NEG))
                        sets[j % n_sets] = _online(sets[j % n_sets], s, vv[keys, cols],
                                                   v.dtype)
                    m, l, acc = sets[0] if n_sets == 1 else _merge(*sets)
                    out[bi, hi, rows, cols] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype)


FLASH_CASES = [
    (1, 4, 2, 65, 65, 16, True),       # one row and one key past the first tiles
    (2, 6, 2, 33, 130, 32, True),      # Sq < Sk, top-left causal
    (1, 4, 1, 130, 33, 16, True),      # Sq > Sk: rows past Sk see every key
    (1, 2, 1, 200, 200, 16, True),     # four key tiles: both sets take two
    (1, 8, 2, 63, 129, 16, False),     # non-causal, ragged tiles
    (1, 2, 2, 1, 1, 8, True),          # a single query and key
    (1, 8, 1, 130, 130, 256, True),    # hd 256 (gemma-2b's G = 8, KV = 1): one set, split O
    (2, 8, 1, 65, 200, 256, False),    # the same, non-causal, ragged tiles
    (1, 64, 4, 65, 65, 16, True),      # qwen3-moe's G = 16 over KV = 4
    (1, 32, 32, 65, 65, 80, True),     # hd 80 (zamba2-2.7b's G = 1 over KV = 32)
    (2, 4, 2, 63, 129, 80, False),     # hd 80, non-causal, ragged tiles
]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", FLASH_CASES)
def test_tiled_flash_matches_plain_and_jax(b, h, kv, sq, sk, hd, causal, dt):
    rng = np.random.default_rng(sq * 1000 + sk + hd)
    qn = rng.standard_normal((b, h, sq, hd), np.float32)
    kn = rng.standard_normal((b, kv, sk, hd), np.float32)
    vn = rng.standard_normal((b, kv, sk, hd), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(DTYPES[dt][1]) for a in (qn, kn, vn))
    jq, jk, jv = (jnp.asarray(a, DTYPES[dt][0]) for a in (qn, kn, vn))
    out = tiled_flash(tq, tk, tv, causal=causal)
    _close(out, flash_attention_ref(tq, tk, tv, causal=causal).float(), dt)
    _close(out, jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32), dt)
    _close(out, jax_flash_ref(jq, jk, jv, causal=causal), dt)


def test_tiled_flash_skips_exactly_the_tiles_past_the_diagonal():
    """Causal, S = 384: the block of rows q0..q0+63 walks key tiles
    0..q0/64 and no further; non-causal walks every tile."""
    for hd, n_sets in ((8, 2), (256, 1)):
        q = torch.zeros(1, 1, 384, hd)
        kv = torch.zeros(1, 1, 384, hd)
        seen = []
        tiled_flash(q, kv, kv, causal=True, tiles_seen=seen)
        want = [(q0, k0, (k0 // 64) % n_sets) for q0 in range(0, 384, 64)
                for k0 in range(0, q0 + 64, 64)]
        assert seen == want and len(seen) == 21
        seen = []
        tiled_flash(q, kv, kv, causal=False, tiles_seen=seen)
        assert len(seen) == 6 * 6


def test_mma_plans_fit_a_block():
    """Every head dim K2 builds has a bf16 plan within the 227 KB of shared
    memory a block may have on the H100: two sets at hd 64, 80 and 128
    (147,456 B at 128, and at 80 in its rows of 128), one set with O's
    columns split over two groups at hd 256 (163,840 B; two sets would need
    294,912).  Each warp keeps at most 128 columns of O (64 f32
    accumulators a lane)."""
    assert FLASH_HEAD_DIMS == (64, 80, 128, 256)
    for hd in FLASH_HEAD_DIMS:
        sets, cols, smem = mma_plan(hd)
        assert smem <= H100_SMEM_PER_BLOCK and hd // cols <= 128, hd
        assert hd % 16 == 0 and (hd // cols) % 16 == 0, hd   # whole k-steps, n-tile pairs
    assert mma_plan(128) == (2, 1, 147_456) and mma_plan(256) == (1, 2, 163_840)
    assert mma_plan(80) == (2, 1, 147_456)
    assert [tile_pitch(hd) for hd in FLASH_HEAD_DIMS] == [64, 128, 128, 256]
    assert (Q_ROWS + 2 * 4 * K_TILE) * 256 * 2 > H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("hd", FLASH_HEAD_DIMS)
def test_tile_copies_and_swizzle_stay_in_each_row(hd):
    """K2's bf16 tiles (``load_tile`` and ``swz``): the copy rounds of the Q
    tile (256 threads) and of a set's K or V tile (128 threads, or 256 with
    one set) write each of a row's hd/8 chunks exactly once, the last round
    cut short where the chunks do not fill it (hd 80's Q tile: 640 chunks,
    2.5 rounds); the swizzled chunk ``c ^ (row % 8)`` stays inside the
    row's ``tile_pitch`` and is one to one; every chunk an ``ldmatrix`` of
    Q.K^T or P.V reads (k-steps of 16 columns, n-tile pairs of O) is a
    written one."""
    ch, pitch_ch = hd // 8, tile_pitch(hd) // 8
    sets = mma_plan(hd)[0]
    for rows, threads in ((Q_ROWS, 256), (K_TILE, 256 // sets)):
        n = rows * ch
        written = [tid + it * threads for it in range(-(-n // threads))
                   for tid in range(threads) if tid + it * threads < n]
        assert sorted(written) == list(range(n)), (rows, threads)
    for row in range(K_TILE):
        phys = [c ^ (row % 8) for c in range(ch)]
        assert len(set(phys)) == ch and max(phys) < pitch_ch, row
    read = {2 * ks + half for ks in range(hd // 16) for half in (0, 1)}
    assert read == set(range(ch))


# ---------------------------------------------------------------------------
# K3: splits of decode_split_plan positions, partials, merge
# ---------------------------------------------------------------------------


def split_decode(q, k_cache, v_cache, lengths, *, sms=H100_SMS, owners=None):
    """The kernel's order of work: the G query heads of a KV head cut into
    row groups (``decode_row_groups``), the cache into splits of P
    positions (``decode_split_plan``, counting every row group's blocks);
    each split of a request's valid prefix makes a partial (m, l, acc) for
    its row group with an online softmax over runs of 32 positions; the
    used splits merge; a request of length 0 gives zeros.  ``owners``, if
    given, collects (request, KV head, row group, query heads) per unit."""
    b, h, hd = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    groups, rows = decode_row_groups(g)
    per, ns = decode_split_plan(s, b, kvh, sms, groups)
    scale = hd ** -0.5
    out = torch.zeros(b, h, hd)
    units = [(kh, rg) for kh in range(kvh) for rg in range(groups)]   # the grid's y axis
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), s)
        for kh, rg in units:
            head0 = kh * g + rg * rows
            heads = list(range(head0, head0 + min(rows, g - rg * rows)))
            if owners is not None:
                owners.append((bi, kh, rg, heads))
            qg = q[bi, heads].float()
            parts = []
            for split in range(ns):
                s0 = split * per
                if s0 >= n:
                    break                           # splits past the length exit
                state = (torch.full((len(heads),), NEG), torch.zeros(len(heads)),
                         torch.zeros(len(heads), hd))
                for r0 in range(s0, min(s0 + per, n), 32):
                    pos = torch.arange(r0, min(r0 + 32, s0 + per, n))
                    sc = (qg @ k_cache[bi, kh, pos].float().T) * scale
                    m, l, acc = state
                    m_new = torch.maximum(m, sc.max(-1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    state = (m_new, l * alpha + p.sum(-1),
                             acc * alpha[:, None] + p @ v_cache[bi, kh, pos].float())
                parts.append(state)
            if not parts:
                continue                            # length 0: split 0 writes zeros
            merged = parts[0]
            for part in parts[1:]:
                merged = _merge(merged, part)
            m, l, acc = merged
            out[bi, heads] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype)


def _decode_inputs(b, h, kv, s, hd, lens, dt, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, h, hd), np.float32),
              rng.standard_normal((b, kv, s, hd), np.float32),
              rng.standard_normal((b, kv, s, hd), np.float32))
    jargs = tuple(jnp.asarray(a, DTYPES[dt][0]) for a in arrays) + \
        (jnp.asarray(lens, jnp.int32),)
    targs = tuple(torch.from_numpy(a).to(DTYPES[dt][1]) for a in arrays) + \
        (torch.tensor(lens, dtype=torch.int32),)
    return jargs, targs


DECODE_CASES = [
    # (b, h, kv, s, hd, sms, lens): split edges of P = 32 on a 132-SM card
    (4, 12, 2, 512, 16, H100_SMS, [397, 250, 130, 17]),      # the serving path's lengths
    (4, 6, 2, 128, 16, H100_SMS, [0, 1, 31, 32]),
    (4, 6, 2, 128, 16, H100_SMS, [33, 127, 128, 200]),
    (2, 8, 1, 300, 32, 8, [299, 65]),                        # few SMs: P = 160, 2 splits
    (1, 4, 4, 16, 8, H100_SMS, [16]),                        # one split
    (4, 8, 1, 512, 256, H100_SMS, [397, 250, 130, 17]),      # gemma-2b: G = 8 at hd 256
    (4, 64, 4, 512, 128, H100_SMS, [397, 250, 130, 17]),     # qwen3-moe: G = 16, two groups
    (2, 36, 4, 96, 16, H100_SMS, [0, 95]),                   # G = 9: groups of 5 and 4
    (4, 32, 32, 512, 80, H100_SMS, [397, 250, 130, 17]),     # zamba2-2.7b: G = 1 at hd 80
    (2, 8, 4, 64, 80, 8, [63, 33]),                          # hd 80, G = 2, P = 32 splits
]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,s,hd,sms,lens", DECODE_CASES)
def test_split_decode_matches_plain_and_jax(b, h, kv, s, hd, sms, lens, dt):
    jargs, targs = _decode_inputs(b, h, kv, s, hd, lens, dt, seed=s + hd + sum(lens))
    out = split_decode(*targs, sms=sms)
    _close(out, decode_attention_ref(*targs).float(), dt)
    zero = [i for i, n in enumerate(lens) if n <= 0]
    keys = [i for i, n in enumerate(lens) if n > 0]
    assert torch.all(out[zero] == 0)
    pallas = np.asarray(jax_decode(*jargs, block_s=min(128, s)), np.float32)
    _close(out, pallas, dt)
    # the JAX oracle spreads uniform weights over a length-0 row: rows with keys only
    _close(out[keys], np.asarray(jax_decode_ref(*jargs), np.float32)[keys], dt)


def test_decode_split_plan_rule():
    """P is a multiple of 32 that covers S in about ceil(SMs / (B*KV))
    splits; at the serving path's B=4 KV=2 S=512 on 132 SMs that is P = 32
    and 16 splits (128 blocks), of which 54 hold valid positions at lengths
    397/250/130/17."""
    assert decode_split_plan(512, 4, 2, H100_SMS) == (32, 16)
    assert decode_split_plan(512, 4, 32, H100_SMS) == (256, 2)     # zamba2-2.7b's decode
    per = 32
    assert 2 * sum(-(-n // per) for n in (397, 250, 130, 17)) == 54
    for s in (1, 16, 31, 32, 33, 100, 512, 700, 2048, 32768):
        for b, kv in ((1, 1), (4, 2), (3, 1), (8, 8), (64, 4)):
            for sms in (8, 132):
                per, ns = decode_split_plan(s, b, kv, sms)
                assert per % 32 == 0 and per >= 32
                assert per * ns >= s > per * (ns - 1)
                assert ns <= max(1, -(-sms // (b * kv)))          # about one block per SM


def test_decode_row_groups_own_each_query_row_once():
    """Every G the kernel takes (1-16): ceil(G / 8) row groups of at most 8
    rows each, a built row-slot count (1, 2, 4, 6, 8) per group, and the
    groups of each KV head owning its G query heads exactly once; a G up
    to 8 is one group (the blocks of a kernel without row groups)."""
    assert KERNEL_MAX_GROUP == 16
    for g in range(1, KERNEL_MAX_GROUP + 1):
        groups, rows = decode_row_groups(g)
        assert groups == -(-g // 8) and rows <= 8 and _row_slots(rows) in (1, 2, 4, 6, 8)
        assert (groups, rows) == ((1, g) if g <= 8 else (2, -(-g // 2)))
        kv = 3
        owners = []
        split_decode(torch.zeros(2, g * kv, 8), torch.zeros(2, kv, 32, 8),
                     torch.zeros(2, kv, 32, 8), torch.tensor([5, 0], dtype=torch.int32),
                     owners=owners)
        assert len(owners) == 2 * kv * groups
        for bi in range(2):
            mine = [heads for b_, _, _, heads in owners if b_ == bi]
            assert sorted(h for heads in mine for h in heads) == list(range(g * kv))
            assert all(0 < len(heads) <= rows for heads in mine)
        for _, kh, _, heads in owners:
            assert all(h // g == kh for h in heads)          # a group reads its KV head


def test_decode_split_plan_counts_row_groups():
    """With row groups the plan counts B * KV * RG blocks per split: at
    qwen3-moe's decode (B = 4, KV = 4, G = 16: two groups) over a 512
    cache that is P = 128 and 4 splits, 128 blocks on 132 SMs; counting
    only B * KV would give 8 splits of 64 and 256 blocks."""
    groups, _ = decode_row_groups(16)
    assert decode_split_plan(512, 4, 4, H100_SMS, groups) == (128, 4)
    assert decode_split_plan(512, 4, 4, H100_SMS) == (64, 8)
    for s in (16, 100, 512, 2048):
        for b, kv in ((1, 4), (4, 4), (8, 1)):
            per, ns = decode_split_plan(s, b, kv, H100_SMS, groups)
            assert per % 32 == 0 and per * ns >= s > per * (ns - 1)
            assert ns <= max(1, -(-H100_SMS // (b * kv * groups)))   # about one block per SM


def decode_lane_map(hd: int, elem_bytes: int) -> tuple[int, int, int]:
    """K3's lanes for one cache row (``decode_fwd``): the row's CH 16-byte
    chunks of E = 16 / elem_bytes elements, LPR lanes a row (CH rounded up
    to a power of two, at most a warp), C chunks a lane (chunk c of lane i
    at element (c * LPR + i) * E; a lane whose element is past the row is
    spare) and RPW rows a warp load instruction."""
    e = 16 // elem_bytes
    ch = hd // e
    lpr = min(1 << (ch - 1).bit_length(), 32)
    return lpr, -(-ch // lpr), 32 // lpr


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd", DECODE_HEAD_DIMS)
def test_decode_lanes_cover_each_row_once(hd, elem_bytes):
    """Every built head dim in both types: the live lanes of one row slot
    read each column of the row exactly once, the row slots fill the warp,
    a row's lanes are a power of two (the xor-shuffle sums and the row-slot
    merge need one) within one warp.  f32 at hd 256 is the one case with
    two chunks a lane; hd 80 the one with spare lanes (bf16: 10 of 16 live,
    f32: 20 of 32), which load nothing and add zeros."""
    lpr, c, rpw = decode_lane_map(hd, elem_bytes)
    e = 16 // elem_bytes
    assert rpw * lpr == 32 and lpr <= 32 and lpr & (lpr - 1) == 0
    starts = [(ci * lpr + lane) * e for lane in range(lpr) for ci in range(c)]
    live = [s for s in starts if s < hd]
    cols = sorted(s + i for s in live for i in range(e))
    assert cols == list(range(hd))
    assert (c == 2) == (hd == 256 and elem_bytes == 4)
    assert (len(live) < len(starts)) == (hd == 80)
    if hd == 80:
        assert (len(live), lpr) == ((10, 16) if elem_bytes == 2 else (20, 32))


def test_check_aligned_names_the_unaligned_view():
    """The kernels' 16-byte rule, checked on CPU tensors: pointer and every
    stride but the contiguous last one; a dim of length 1 may have any
    stride."""
    base = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    check_aligned("t", ok=base.transpose(1, 2),
                  one=torch.zeros(2, 65, dtype=torch.bfloat16)[:1, :64])   # stride 130 B, length 1
    with pytest.raises(ValueError, match="aligned"):
        check_aligned("t", x=torch.zeros(1 + 2 * 8 * 4 * 64, dtype=torch.bfloat16)[1:]
                      .view(2, 8, 4, 64))
    with pytest.raises(ValueError, match="aligned"):
        check_aligned("t", x=torch.zeros(2, 8, 4, 65, dtype=torch.bfloat16)[..., :64])
    check_aligned("t", x=torch.zeros(2, 8, 4, 68, dtype=torch.float32)[..., :64])
