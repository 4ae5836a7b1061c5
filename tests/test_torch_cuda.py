"""The port's kernels on the card against their plain versions (needs an
NVIDIA GPU; skips without one).

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 3e-5 for f32, 2e-2 for
bf16; the sLSTM scan computes in f32 from either input type, so it is held
at 3e-5 in both; the ragged concat moves bytes and must be exact.  f32
products run in full f32 (TF32 off)."""

import pytest
import torch
from _attention_edges import (CROSS_DECODE, CROSS_FLASH, DECODE_GROUPS, DECODE_SHAPES,
                              DECODE_SHAPES_GEMMA, DECODE_SHAPES_MOE, DECODE_SHAPES_ZAMBA2,
                              GEMMA_G, GEMMA_KV, MOE_G, MOE_HD, TRAIN_FLASH, ZAMBA_G, ZAMBA_HD,
                              decode_edge_lens, flash_edge_cases, flash_edge_cases_gemma,
                              flash_edge_cases_moe, flash_edge_cases_zamba2)

from repro_torch.configs import model_100m
from repro_torch.kernels.decode_attention.ops import (decode_attention, decode_attention_ref,
                                                      decode_row_groups, decode_split_plan)
from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.ragged_concat.ops import ragged_concat, ragged_concat_ref
from repro_torch.kernels.rmsnorm.ops import (fused_rmsnorm, rmsnorm_bwd, rmsnorm_bwd_ref,
                                             rmsnorm_ref)
from repro_torch.kernels.slstm_scan.ops import (_launch_fwd, bwd_cluster_plan, cluster_plan,
                                                slstm_scan, slstm_scan_bwd, slstm_scan_bwd_plan,
                                                slstm_scan_bwd_ref, slstm_scan_plan,
                                                slstm_scan_ref)
from repro_torch.models import Model

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


def _tol(dt):
    return 2e-2 if dt == torch.bfloat16 else 3e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, dt, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dt)


def _record_routes(monkeypatch) -> list:
    """Wrap the MoE layer's routing step: every call appends its (probs,
    top experts) to the returned list."""
    from repro_torch.models import mlp

    log, route = [], mlp._route

    def recorded(x2d, router, k, e_valid):
        probs, top_p, top_e = route(x2d, router, k, e_valid)
        log.append((probs, top_e))
        return probs, top_p, top_e

    monkeypatch.setattr(mlp, "_route", recorded)
    return log


def _routes_agree(fast: list, plain: list, k: int, tie: float = 1e-5) -> bool:
    """Whether both paths picked the same experts for every token of every
    layer.  Where they did not, each token that differs in the first such
    layer must be a near tie in the plain path (its k-th and (k+1)-th
    probabilities within ``tie``): a rounding difference at a tie, not a
    fault.  Later layers take that layer's output, so they are not held."""
    assert len(fast) == len(plain)
    for (_, ef), (pp, ep) in zip(fast, plain):
        differ = (ef.sort(-1).values != ep.sort(-1).values).any(-1)
        if differ.any():
            top = pp[differ].topk(k + 1, dim=-1).values
            gaps = top[:, k - 1] - top[:, k]
            assert bool((gaps <= tie).all()), f"routes differ beyond a near tie: gaps {gaps}"
            return False
    return True


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", [
    (1, 12, 2, 384, 384, 128, True), (2, 8, 2, 50, 130, 64, True), (1, 4, 4, 33, 47, 64, False),
    (1, 8, 1, 384, 384, 256, True), (1, 8, 1, 100, 100, 256, True),   # gemma-2b prefill
    (1, 32, 32, 384, 384, 80, True), (1, 32, 32, 100, 100, 80, True),  # zamba2-2.7b prefill
    (1, 32, 32, 16, 16, 80, True),
])
def test_flash_attention_kernel_matches_plain(dev, b, h, kv, sq, sk, hd, causal, dt):
    q = _randn(dev, b, sq, h, hd, dt=dt, seed=1).transpose(1, 2)
    k = _randn(dev, b, sk, kv, hd, dt=dt, seed=2).transpose(1, 2)
    v = _randn(dev, b, sk, kv, hd, dt=dt, seed=3).transpose(1, 2)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == n + 1
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
                               atol=_tol(dt), rtol=_tol(dt))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("lens", [[397, 250, 130, 17], [0, 1, 512, 700]])
def test_decode_attention_kernel_matches_plain(dev, lens, dt):
    q = _randn(dev, 4, 12, 128, dt=dt, seed=4)
    kc = _randn(dev, 4, 512, 2, 128, dt=dt, seed=5).transpose(1, 2)
    vc = _randn(dev, 4, 512, 2, 128, dt=dt, seed=6).transpose(1, 2)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = decode_attention(q, kc, vc, lt)
    torch.testing.assert_close(out.float(), decode_attention_ref(q, kc, vc, lt).float(),
                               atol=_tol(dt), rtol=_tol(dt))
    assert torch.all(out[lt == 0] == 0)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_tile_edges(dev, hd, causal, dt):
    """Sq and Sk over the 64-row tile edges, equal and unequal both ways,
    with G = H / KV cycling through 1, 4, 6 and 8; at hd 256 (one warp set,
    O split over two groups) also every edge at gemma-2b's G = 8, KV = 1,
    at hd 128 every edge at qwen3-moe's G = 16, KV = 4, and at hd 80 (tile
    rows padded to 128 columns) every edge at zamba2-2.7b's G = 1, KV = 32."""
    cases = flash_edge_cases() + (flash_edge_cases_gemma() if hd == 256 else []) + \
        (flash_edge_cases_moe() if hd == MOE_HD else []) + \
        (flash_edge_cases_zamba2() if hd == ZAMBA_HD else [])
    for i, (sq, sk, g, b, kv) in enumerate(cases):
        q = _randn(dev, b, sq, g * kv, hd, dt=dt, seed=20 + i).transpose(1, 2)
        k = _randn(dev, b, sk, kv, hd, dt=dt, seed=40 + i).transpose(1, 2)
        v = _randn(dev, b, sk, kv, hd, dt=dt, seed=60 + i).transpose(1, 2)
        out = flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(
            out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
            atol=_tol(dt), rtol=_tol(dt), msg=lambda m: f"Sq={sq} Sk={sk} G={g}: {m}")


def _decode_case(dev, b, h, kv, s, hd, dt, seed):
    q = _randn(dev, b, h, hd, dt=dt, seed=seed)
    kc = _randn(dev, b, s, kv, hd, dt=dt, seed=seed + 1).transpose(1, 2)
    vc = _randn(dev, b, s, kv, hd, dt=dt, seed=seed + 2).transpose(1, 2)
    return q, kc, vc


def _check_decode(q, kc, vc, lens, dt, what):
    lt = torch.tensor(lens, dtype=torch.int32, device=q.device)
    n = decode_attention.launches
    out = decode_attention(q, kc, vc, lt)
    assert decode_attention.launches == n + 1
    torch.testing.assert_close(out.float(), decode_attention_ref(q, kc, vc, lt).float(),
                               atol=_tol(dt), rtol=_tol(dt), msg=lambda m: f"{what}: {m}")
    assert torch.all(out[lt == 0] == 0), what


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("g", DECODE_GROUPS)
@pytest.mark.parametrize("b,kv,s", DECODE_SHAPES)
def test_decode_attention_kernel_split_edges(dev, b, kv, s, g, hd, dt):
    """Lengths at the split edges (0, 1, P-1, P, P+1, S-1, S, > S), all
    full, on shapes that give one split (S = 16, 32) and many (16, 64);
    odd G (3, 7) runs padded to the next even build; G = 9 and 16 run as
    two row groups (9: of 5 and 4 rows)."""
    per, ns = decode_split_plan(s, b, kv, torch.cuda.get_device_properties(dev)
                                .multi_processor_count, decode_row_groups(g)[0])
    q, kc, vc = _decode_case(dev, b, g * kv, kv, s, hd, dt, seed=80 + s + g)
    for lens in decode_edge_lens(per, s, b):
        _check_decode(q, kc, vc, lens, dt, f"P={per} NS={ns} lens={lens}")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,kv,s", DECODE_SHAPES_GEMMA)
def test_decode_attention_kernel_split_edges_gemma(dev, b, kv, s, dt):
    """gemma-2b's decode attention: G = 8 over KV = 1 at hd 256 (bf16: a
    lane's one 16-byte chunk a row, the row over all 32 lanes; f32: two
    chunks a lane), lengths at the split edges."""
    per, ns = decode_split_plan(s, b, kv, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)
    q, kc, vc = _decode_case(dev, b, GEMMA_G * kv, kv, s, 256, dt, seed=100 + s)
    for lens in decode_edge_lens(per, s, b) + [[397, 250, 130, 17][:b]]:
        _check_decode(q, kc, vc, lens, dt, f"hd 256 P={per} NS={ns} lens={lens}")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,kv,s", DECODE_SHAPES_MOE)
def test_decode_attention_kernel_split_edges_moe(dev, b, kv, s, dt):
    """qwen3-moe's decode attention: G = 16 over KV = 4 at hd 128, two row
    groups of 8 query heads, each its own block with its own partials and
    ticket counter; lengths at the split edges and the path's."""
    groups, _ = decode_row_groups(MOE_G)
    per, ns = decode_split_plan(s, b, kv, torch.cuda.get_device_properties(dev)
                                .multi_processor_count, groups)
    q, kc, vc = _decode_case(dev, b, MOE_G * kv, kv, s, MOE_HD, dt, seed=120 + s)
    for lens in decode_edge_lens(per, s, b) + [[397, 250, 130, 17][:b]]:
        _check_decode(q, kc, vc, lens, dt, f"G=16 KV=4 P={per} NS={ns} lens={lens}")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,kv,s", DECODE_SHAPES_ZAMBA2)
def test_decode_attention_kernel_split_edges_zamba2(dev, b, kv, s, dt):
    """zamba2-2.7b's decode attention: G = 1 over KV = 32 at hd 80 (bf16: 10
    of a row's 16 lanes load; f32: 20 of 32), lengths at the split edges
    and the path's."""
    per, ns = decode_split_plan(s, b, kv, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)
    q, kc, vc = _decode_case(dev, b, ZAMBA_G * kv, kv, s, ZAMBA_HD, dt, seed=140 + s)
    for lens in decode_edge_lens(per, s, b) + [[397, 250, 130, 17][:b]]:
        _check_decode(q, kc, vc, lens, dt, f"hd 80 KV=32 P={per} NS={ns} lens={lens}")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,h,kv,sq,sk,hd", CROSS_FLASH)
def test_flash_attention_kernel_cross_shapes(dev, b, h, kv, sq, sk, hd, dt):
    """Whisper's encoder and both families' prefill cross-attention:
    non-causal, Sq != Sk, over 1500 frames (hd 64, 12 heads over 12) or
    4096 vision tokens (hd 128, 64 over 8); K/V as the model holds them,
    (B, Sk, KV, hd) viewed as (B, KV, Sk, hd)."""
    q = _randn(dev, b, sq, h, hd, dt=dt, seed=160 + sq).transpose(1, 2)
    k = _randn(dev, b, sk, kv, hd, dt=dt, seed=161 + sk).transpose(1, 2)
    v = _randn(dev, b, sk, kv, hd, dt=dt, seed=162 + sk).transpose(1, 2)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == n + 1
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, causal=False).float(),
                               atol=_tol(dt), rtol=_tol(dt))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,h,kv,s,hd", CROSS_DECODE)
def test_decode_attention_kernel_cross_shapes(dev, b, h, kv, s, hd, dt):
    """Decode's cross-attention: one query a request over the whole K/V
    (every length S), 3 splits of 512 at S = 1500 and 5 of 832 at 4096;
    three calls in a row on one stream, then the split edges, so a ticket
    counter left non-zero shows."""
    per, ns = decode_split_plan(s, b, kv, torch.cuda.get_device_properties(dev)
                                .multi_processor_count, decode_row_groups(h // kv)[0])
    q, kc, vc = _decode_case(dev, b, h, kv, s, hd, dt, seed=170 + s)
    for lens in [[s] * b] * 3 + decode_edge_lens(per, s, b):
        _check_decode(q, kc, vc, lens, dt, f"S={s} P={per} NS={ns} lens={lens}")


@pytest.mark.parametrize("arch,variants", [
    ("whisper-small", {}), ("llama-3.2-vision-90b", {}),
    ("llama-3.2-vision-90b", dict(head_dim=128, num_heads=16, num_kv_heads=2))],
    ids=["whisper-100m", "mllama-100m", "mllama-hd128-g8"])
def test_cross_families_kernel_path_matches_plain_path(dev, arch, variants):
    """f32, the 100m reductions of whisper-small (2 encoder layers over 128
    frames, 8 decoder layers) and llama-3.2-vision-90b (8 layers, a cross
    layer every 2, 64 vision tokens; also at its hd 128 and G = 8) with the
    mLLaMA gates non-zero: prefill and 4 decode steps through the kernels
    agree with the plain path, the cross K/V too, and each call launches
    the kernels the model's plan says.  1e-4, as for the dense model."""
    from repro_torch.models.mllama_model import layout

    cfg = model_100m(arch).scaled(**variants)
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    extra = {}
    if cfg.family == "mllama":
        ng = layout(cfg)[0]
        params["cross_layers"]["gate_attn"].copy_(torch.full((ng,), 0.7))
        params["cross_layers"]["gate_mlp"].copy_(torch.full((ng,), -0.5))
        extra["vision"] = torch.randn(2, cfg.vision_tokens, cfg.d_model, device=dev,
                                      generator=gen)
    else:
        extra["frames"] = torch.randn(2, cfg.encoder_positions, cfg.d_model, device=dev,
                                      generator=gen)
    n0 = {w: w.launches for w in (fused_rmsnorm, flash_attention, decode_attention)}
    toks = torch.randint(0, cfg.vocab_size, (2, 77), device=dev, generator=gen)
    lk, ck = fast.prefill(params, {"tokens": toks, **extra}, max_seq=128)
    lp, cp = plain.prefill(params, {"tokens": toks, **extra}, max_seq=128)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for _ in range(4):
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        lk, ck = fast.decode_step(params, ck, nxt)
        lp, cp = plain.decode_step(params, cp, nxt)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for k in ("k", "v", "ck", "cv"):
        torch.testing.assert_close(ck[k], cp[k], atol=1e-4, rtol=1e-4, msg=k)
    layers = cfg.num_layers
    launches = {w: w.launches - n0[w] for w in n0}
    if cfg.family == "whisper":
        assert launches == {fused_rmsnorm: 0, flash_attention: cfg.encoder_layers + 2 * layers,
                            decode_attention: 4 * 2 * layers}
    else:
        assert launches == {fused_rmsnorm: 5 * (2 * layers + 1), flash_attention: layers,
                            decode_attention: 4 * layers}


def test_wrappers_reject_bad_inputs(dev):
    """On the card a G above 16 query heads per KV head (17) raises instead
    of launching or falling back to the plain version; 16 launches."""
    for dt in DTYPES:
        q, kc, vc = _decode_case(dev, 2, 17 * 2, 2, 64, 128, dt, seed=7)
        lt = torch.tensor([5, 64], dtype=torch.int32, device=dev)
        n = decode_attention.launches
        with pytest.raises(ValueError, match="at most 16"):
            decode_attention(q, kc, vc, lt)
        assert decode_attention.launches == n
        _check_decode(q[:, :32], kc, vc, [5, 64], dt, "G=16")


def test_attention_kernels_reject_unbuilt_head_dim(dev):
    """A head dim outside the built set (96) raises on the card instead of
    launching or falling back to the plain version."""
    for dt in DTYPES:
        q = _randn(dev, 1, 4, 2, 96, dt=dt, seed=3).transpose(1, 2)
        kv = _randn(dev, 1, 4, 2, 96, dt=dt, seed=4).transpose(1, 2)
        n = flash_attention.launches
        with pytest.raises(ValueError, match="head_dim 96"):
            flash_attention(q, kv, kv)
        lt = torch.tensor([3], dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="head_dim 96"):
            decode_attention(q[:, :, 0], kv, kv, lt)
        assert flash_attention.launches == n


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_attention_kernel_repeated_calls(dev, dt):
    """Three calls in a row on one stream with other lengths: a ticket
    counter not set back to 0 would merge too early or never."""
    q, kc, vc = _decode_case(dev, 4, 12, 2, 512, 128, dt, seed=90)
    for lens in ([397, 250, 130, 17], [512, 33, 0, 700], [64, 65, 1, 300]):
        _check_decode(q, kc, vc, lens, dt, f"lens={lens}")


def test_attention_kernels_reject_unaligned_views(dev):
    """The kernels copy 16 bytes a lane: a view whose pointer or stride is
    not 16-byte aligned raises ValueError instead of launching."""
    dt = torch.bfloat16
    ok = _randn(dev, 1, 8, 2, 64, dt=dt, seed=1).transpose(1, 2)
    shifted = torch.zeros(1 + 8 * 2 * 64, dtype=dt, device=dev)[1:].view(1, 8, 2, 64)
    wide = torch.zeros(1, 8, 2, 65, dtype=dt, device=dev)[..., :64]     # row stride 130 B
    for bad in (shifted.transpose(1, 2), wide.transpose(1, 2)):
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(bad, ok, ok)
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(ok, ok, bad)
    q = _randn(dev, 1, 2, 64, dt=dt, seed=2)
    lt = torch.tensor([5], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        decode_attention(q, shifted.transpose(1, 2), ok, lt)
    with pytest.raises(ValueError, match="aligned"):
        decode_attention(torch.zeros(1, 2, 65, dtype=dt, device=dev)[..., :64], ok, ok, lt)


def test_flash_attention_f32_takes_unaligned_views(dev):
    """The f32 kernel reads scalars: views whose pointer or stride is not
    16-byte aligned, and a negative scale, still match the plain version."""
    dt = torch.float32
    q = _randn(dev, 1 + 2 * 21 * 8 * 64, dt=dt, seed=11)[1:].view(2, 21, 8, 64).transpose(1, 2)
    k = _randn(dev, 2, 33, 2, 65, dt=dt, seed=12)[..., :64].transpose(1, 2)   # 260 B rows
    v = _randn(dev, 2, 33, 2, 64, dt=dt, seed=13).transpose(1, 2)
    for causal, scale in ((True, None), (False, -0.3)):
        out = flash_attention(q, k, v, causal=causal, scale=scale)
        torch.testing.assert_close(
            out, flash_attention_ref(q, k, v, causal=causal, scale=scale),
            atol=_tol(dt), rtol=_tol(dt))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", [48, 52, 128, 1536, 2048, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 4, 37, 384])
@pytest.mark.parametrize("residual,gemma,want", [
    (True, False, True), (False, False, True), (False, True, False), (True, True, True),
    (True, False, False),
], ids=["add", "norm", "norm-gemma-no-out", "add-gemma", "add-no-out"])
def test_rmsnorm_kernel_matches_plain(dev, residual, gemma, want, rows, d, dt):
    """Every mode the models call (the add + norm; the norm alone, as the
    blocks' inner norms and layer 0's ln1; Gemma's ``1 + scale``; no
    residual output, as the final and the mLSTM inner norms) at the paths'
    widths (1536 qwen2, 2048 xlstm and gemma, 4096 the mLSTM's inner norm
    and the 8B models, 8192 mLLaMA at the kernel's widest, 128 qk_norm's
    rows of head_dim) and the smoke configs' (48); D = 52 is no multiple
    of the 16-byte vector and takes the scalar instantiation.  One launch
    per call."""
    x = _randn(dev, rows, d, dt=dt, seed=7)
    r = _randn(dev, rows, d, dt=dt, seed=8) if residual else None
    sc = _randn(dev, d, dt=torch.float32, seed=9)
    n = fused_rmsnorm.launches
    y, h = fused_rmsnorm(x, r, sc, gemma=gemma, want_residual=want)
    assert fused_rmsnorm.launches == n + 1
    yr, hr = rmsnorm_ref(x, r, sc, gemma=gemma, want_residual=want)
    torch.testing.assert_close(y.float(), yr.float(), atol=_tol(dt), rtol=_tol(dt))
    if not want:
        assert h is None and hr is None
    elif not residual:
        assert h is x
    else:
        torch.testing.assert_close(h.float(), hr.float(), atol=_tol(dt), rtol=_tol(dt))


def test_device_helpers_follow_the_current_stream(dev):
    """``stream_of`` reads the raw handle of the current stream (a side
    stream too), and ``on_device`` leaves the device current."""
    from repro_torch.kernels._device import on_device, stream_of

    t = torch.zeros(4, device=dev)
    assert stream_of(t) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert stream_of(t) == side.cuda_stream
        with on_device(t):
            assert torch.cuda.current_device() == t.device.index
        x, r = _randn(dev, 4, 2048, dt=torch.bfloat16, seed=23), t.new_zeros(4, 2048)
        y, _ = fused_rmsnorm(x, r.bfloat16(), torch.ones(2048, device=dev))
    side.synchronize()
    torch.testing.assert_close(y.float(), rmsnorm_ref(x, None, torch.ones(2048, device=dev))[0]
                               .float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dt", DTYPES)
def test_rmsnorm_kernel_strided_and_unaligned(dev, dt):
    """Views the model hands over: prefill's last position of (B, S, D)
    (rows strided by S * D, normed in place of a copy); a view offset by one
    element (unaligned: the scalar instantiation); a scale that is a row of
    a stacked (ng, nm, d) leaf with 4 * d not a multiple of 16."""
    base = _randn(dev, 3, 17, 1536, dt=dt, seed=17)
    res = _randn(dev, 3, 17, 1536, dt=dt, seed=18)
    sc = _randn(dev, 1536, dt=torch.float32, seed=19)
    x, r = base[:, -1:], res[:, -1:]
    y, h = fused_rmsnorm(x, r, sc)
    yr, hr = rmsnorm_ref(x.contiguous(), r.contiguous(), sc)
    assert y.shape == h.shape == (3, 1, 1536) and y.is_contiguous()
    torch.testing.assert_close(y.float(), yr.float(), atol=_tol(dt), rtol=_tol(dt))
    torch.testing.assert_close(h.float(), hr.float(), atol=_tol(dt), rtol=_tol(dt))
    flat = _randn(dev, 4 * 2048 + 1, dt=dt, seed=20)
    xu = flat[1:].view(4, 2048)
    y, h = fused_rmsnorm(xu, xu.flip(0), sc.repeat(2)[:2048])
    yr, hr = rmsnorm_ref(xu, xu.flip(0), sc.repeat(2)[:2048])
    torch.testing.assert_close(y.float(), yr.float(), atol=_tol(dt), rtol=_tol(dt))
    torch.testing.assert_close(h.float(), hr.float(), atol=_tol(dt), rtol=_tol(dt))
    stacked = _randn(dev, 2, 3, 50, dt=torch.float32, seed=21)
    x50 = _randn(dev, 4, 50, dt=dt, seed=22)
    y, _ = fused_rmsnorm(x50, None, stacked[1, 2])
    yr, _ = rmsnorm_ref(x50, None, stacked[1, 2])
    torch.testing.assert_close(y.float(), yr.float(), atol=_tol(dt), rtol=_tol(dt))
    with pytest.raises(ValueError, match="evenly strided"):
        fused_rmsnorm(base[:, ::2], None, sc)          # rows of two strides


@pytest.mark.parametrize("variants", [
    {}, dict(qk_norm=True, gemma_norm=True, embed_scale=True, mlp_act="geglu",
             tie_embeddings=False),
    dict(arch="llama3-8b"), dict(arch="qwen3-8b"),
    dict(arch="gemma-2b", head_dim=256, num_heads=8, num_kv_heads=1),
    dict(arch="qwen2-moe-a2.7b"),
    dict(arch="qwen3-moe-235b-a22b", head_dim=128, num_heads=64, num_kv_heads=4),
], ids=["qwen2", "dense-variants", "llama3-8b", "qwen3-8b", "gemma-2b-hd256",
        "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b-g16"])
def test_model_kernel_path_matches_plain_path(dev, variants, monkeypatch):
    """f32, 2 layers of the 100m config (head_dim 64; gemma-2b's case at its
    full 8 heads over 1 KV head of 256, qwen3-moe's at its full 64 heads
    over 4 of 128): prefill and 4 decode steps through the kernels agree
    with the plain path.  1e-4, looser than the per-kernel 3e-5, because
    each layer adds the kernels' own summation-order differences to logits
    of scale ~1-10.  The variant case sends gemma's ``1 + scale`` norm
    through the fused kernel too, and qwen3's ``qk_norm`` adds 2L
    norm-only launches a call.  MoE routing is discontinuous: a call whose
    routes differ between the paths is held to the route rule instead of
    the logits (:func:`_routes_agree`), at most once, and the kernel path
    then continues from the plain path's cache."""
    variants = dict(variants)
    cfg = model_100m(variants.pop("arch", "qwen2-1.5b")).scaled(num_layers=2, **variants)
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(0)
    routes = _record_routes(monkeypatch)
    flips = 0

    def both(call_fast, call_plain):
        nonlocal flips
        routes.clear()
        lk, ck = call_fast()
        fast_routes = routes[:]
        routes.clear()
        lp, cp = call_plain()
        if _routes_agree(fast_routes, routes[:], cfg.top_k):
            torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        else:
            flips += 1
            for key in ("k", "v", "len"):
                ck[key].copy_(cp[key])
        return lp, ck, cp

    norms0 = fused_rmsnorm.launches
    toks = torch.randint(0, cfg.vocab_size, (1, 77), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    lp, ck, cp = both(lambda: fast.prefill(params, {"tokens": toks}, max_seq=128),
                      lambda: plain.prefill(params, {"tokens": toks}, max_seq=128))
    for _ in range(4):
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        lp, ck, cp = both(lambda: fast.decode_step(params, ck, nxt),
                          lambda: plain.decode_step(params, cp, nxt))
    assert flips <= 1
    assert bool(routes) == (cfg.family == "moe")
    assert torch.equal(ck["len"], cp["len"])
    # ln1, ln2 and the final norm, each fused with its residual add: 2L + 1
    # per call, and with qk_norm the q and k norms of each layer: 2L more
    per_call = 2 * cfg.num_layers + 1 + (2 * cfg.num_layers if cfg.qk_norm else 0)
    assert fused_rmsnorm.launches - norms0 == 5 * per_call              # prefill + 4 steps


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,s,d,h", [(1, 384, 2048, 4), (4, 1, 2048, 4), (3, 40, 64, 4),
                                     (2, 33, 48, 4), (4, 64, 64, 1)])
def test_slstm_scan_kernel_matches_plain(dev, b, s, d, h, dt):
    dh = d // h
    xg = _randn(dev, b, s, 4 * d, dt=dt, seed=10)
    w = (_randn(dev, h, dh, 4 * dh, dt=torch.float32, seed=11) * dh ** -0.5).to(dt)
    bias = _randn(dev, 4 * d, dt=torch.float32, seed=12) * 0.1
    z = torch.zeros(b, d, device=dev)
    m0 = torch.full((b, d), float("-inf"), device=dev)
    n = slstm_scan.launches
    hs, st = slstm_scan(xg, w, bias, z, z, z, m0)
    assert slstm_scan.launches == n + 1                 # one launch, whatever S
    hr, sr = slstm_scan_ref(xg, w, bias, z, z, z, m0)
    torch.testing.assert_close(hs, hr, atol=3e-5, rtol=3e-5)
    for a, c in zip(st, sr):
        torch.testing.assert_close(a, c, atol=3e-5, rtol=3e-5)
    # resume from the carried state: the decode path's S = 1 calls
    x2 = _randn(dev, b, 3, 4 * d, dt=dt, seed=13)
    h2, s2 = slstm_scan(x2, w, bias, *st)
    hr2, sr2 = slstm_scan_ref(x2, w, bias, *st)
    torch.testing.assert_close(h2, hr2, atol=3e-5, rtol=3e-5)
    for a, c in zip(s2, sr2):
        torch.testing.assert_close(a, c, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int32, torch.uint8])
@pytest.mark.parametrize("lens,c,cap", [([500_000, 3_011, 2_987], 4, 507_000),
                                        ([500_000, 3_011, 2_987], 4, 400_000),
                                        ([3, 0, 16, 5], 1, 30), ([6, 3], 3, 12)])
def test_ragged_concat_kernel_matches_plain(dev, lens, c, cap, dt):
    src = (_randn(dev, len(lens), max(lens), c, dt=torch.float32, seed=14) * 100).to(dt)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    n = ragged_concat.launches
    out, offs, total = ragged_concat(src, lt, capacity=cap)
    assert ragged_concat.launches == n + 1
    ref, roffs, rtotal = ragged_concat_ref(src, lt, cap)
    assert torch.equal(out, ref) and torch.equal(offs, roffs)
    assert int(total) == int(rtotal) == sum(lens)


def _slstm_inputs(dev, b, s, d, h, dt, seed):
    dh = d // h
    xg = _randn(dev, b, s, 4 * d, dt=dt, seed=seed)
    w = (_randn(dev, h, dh, 4 * dh, dt=torch.float32, seed=seed + 1) * dh ** -0.5).to(dt)
    bias = _randn(dev, 4 * d, dt=torch.float32, seed=seed + 2) * 0.1
    z = torch.zeros(b, d, device=dev)
    return xg, w, bias, z, z, z, torch.full((b, d), float("-inf"), device=dev)


def _slstm_close(got, want):
    (hs, st), (hr, sr) = got, want
    torch.testing.assert_close(hs, hr, atol=3e-5, rtol=3e-5)
    for a, c in zip(st, sr):
        torch.testing.assert_close(a, c, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("s", [1, 2, 17, 384])
@pytest.mark.parametrize("b", range(1, 9))
def test_slstm_scan_kernel_batch_and_steps(dev, b, s, dt):
    """Full width (D = 2048, H = 4): bf16 takes the cluster kernel, f32 the
    grid kernel, at every batch the path can give (1..8 rows)."""
    args = _slstm_inputs(dev, b, s, 2048, 4, dt, seed=20 + b)
    n = slstm_scan.launches
    got = slstm_scan(*args)
    assert slstm_scan.launches == n + 1
    _slstm_close(got, slstm_scan_ref(*args))


# (D, H) whose head width dh puts the smallest cluster that holds w_hh (bf16,
# B = 3) at each size; none of these dh is a multiple of the block's J
CLUSTER_SHAPES = {1: (24, 2), 2: (400, 2), 4: (560, 2), 8: (800, 2), 16: (1000, 2)}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("cs", sorted(CLUSTER_SHAPES))
def test_slstm_scan_kernel_cluster_sizes(dev, cs, dt):
    d, h = CLUSTER_SHAPES[cs]
    budget = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    plan = slstm_scan_plan(3, d, h, x_dtype=dt, w_dtype=dt)
    size = 2 if dt == torch.bfloat16 else 4
    want = cluster_plan(3, d, h, size, size, budget)
    if want is None:                    # f32 past 16 blocks' shared memory
        assert dt == torch.float32 and plan.variant == "grid"
    else:
        assert plan.variant == "cluster" and plan.blocks == h * plan.cluster
        assert (plan.cluster, plan.j, plan.smem) == want
    if dt == torch.bfloat16:
        assert plan.cluster == cs and (d // h) % plan.j != 0
    args = _slstm_inputs(dev, 3, 17, d, h, dt, seed=30 + cs)
    _slstm_close(slstm_scan(*args), slstm_scan_ref(*args))


def test_slstm_scan_plan_variants(dev):
    """At full width bf16 takes one cluster of 16 blocks per head, and f32
    (4 MiB of w_hh per head) the cooperative grid kernel."""
    budget = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for b in (1, 4, 8):
        p = slstm_scan_plan(b, 2048, 4)
        assert (p.variant, p.cluster, p.j, p.blocks) == ("cluster", 16, 32, 64)
        assert p.active >= 1 and (p.cluster, p.j, p.smem) == cluster_plan(b, 2048, 4, 2, 2,
                                                                          budget)
        f = slstm_scan_plan(b, 2048, 4, x_dtype=torch.float32, w_dtype=torch.float32)
        assert f.variant == "grid" and f.cluster == 0
        assert cluster_plan(b, 2048, 4, 4, 4, budget) is None


@pytest.mark.parametrize("dt", DTYPES)
def test_slstm_scan_kernel_repeated_calls(dev, dt):
    """Three calls in a row on one stream, with other inputs each, before
    any is read back."""
    calls = [_slstm_inputs(dev, b, s, 2048, 4, dt, seed=40 + b) for b, s in
             ((1, 100), (4, 1), (2, 17))]
    outs = [slstm_scan(*a) for a in calls]
    for a, o in zip(calls, outs):
        _slstm_close(o, slstm_scan_ref(*a))


def _slstm_bwd_case(dev, b, s, d, h, dt, seed, state=False, finals=True):
    """K5 in save mode on fresh inputs, then K5-bwd and the plain backward
    on its saved gates and states with random cotangents: (kernel grads,
    plain grads, the call's positional arguments; xg's dtype is ``dt``)."""
    args = list(_slstm_inputs(dev, b, s, d, h, dt, seed))
    if state:
        args[3:] = [_randn(dev, b, d, dt=torch.float32, seed=seed + 3 + i) for i in range(4)]
        args[5] = args[5].abs() + 0.5
    hs, _, saved = _launch_fwd(*args, True)
    cot = [_randn(dev, b, s, d, dt=torch.float32, seed=seed + 7)] + \
        [_randn(dev, b, d, dt=torch.float32, seed=seed + 8 + i) if finals else None
         for i in range(4)]
    call = (args[1], *args[3:], hs, *saved, *cot)
    n = slstm_scan_bwd.launches
    got = slstm_scan_bwd(*call, x_dtype=dt)
    assert slstm_scan_bwd.launches == n + 1
    return got, slstm_scan_bwd_ref(*call, x_dtype=dt), call


def _slstm_bwd_close(got, want):
    """f32 outputs within 3e-5 of their largest value (at least 1): the
    sums over B S rows (dw_hh, db_ih) carry f32 rounding in another order;
    bf16 outputs (dxg, dw_hh of bf16 inputs) at 2e-2."""
    for a, c in zip(got, want):
        assert a.dtype == c.dtype and a.shape == c.shape and torch.isfinite(a).all()
        if a.dtype == torch.bfloat16:
            torch.testing.assert_close(a, c, atol=2e-2, rtol=2e-2)
        else:
            scale = max(1.0, float(c.abs().max()) if c.numel() else 0.0)
            assert float((a - c).abs().max()) <= 3e-5 * scale


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("b,s,d,h", [(1, 1, 2048, 4), (3, 1, 2048, 4), (5, 17, 2048, 4),
                                     (8, 384, 2048, 4), (3, 100, 512, 8), (7, 33, 48, 4),
                                     (2, 40, 64, 1), (3, 20, 12, 2)])
def test_slstm_scan_bwd_kernel_matches_plain(dev, b, s, d, h, state, dt):
    """K5-bwd against its plain backward: S = 1, B not a multiple of the
    product's pass of rows, full width (bf16: the cluster kernel; f32: the
    grid kernel), the 100m width and narrow heads (dh 12, 64, and 6, not a
    multiple of 4; the cluster kernel in both dtypes), from the zero state
    (m0 = -inf: finite gradients, dc0, dn0 and dm0 exactly 0) and from a
    random state."""
    plan = slstm_scan_bwd_plan(b, d, h, w_dtype=dt)
    assert plan.variant == ("grid" if (d, dt) == (2048, torch.float32) else "cluster")
    got, want, _ = _slstm_bwd_case(dev, b, s, d, h, dt, seed=50 + b + s, state=state)
    _slstm_bwd_close(got, want)
    if not state:
        assert all(torch.count_nonzero(g) == 0 for g in got[4:])


@pytest.mark.parametrize("dt", DTYPES)
def test_slstm_scan_bwd_kernel_repeated_calls(dev, dt):
    """Calls in a row on one stream with other shapes, and cotangents on
    the final state absent (None: zero) or given; each call again equals
    the first bit for bit."""
    cases = [_slstm_bwd_case(dev, b, s, 2048, 4, dt, seed=60 + b, finals=f)
             for b, s, f in ((1, 100, True), (4, 1, False), (2, 17, True))]
    for got, want, call in cases:
        _slstm_bwd_close(got, want)
        assert all(map(torch.equal, got, slstm_scan_bwd(*call, x_dtype=dt)))


def test_slstm_scan_bwd_plan_variants(dev):
    """K5-bwd's plan: at full width bf16 takes clusters of 16 blocks of J =
    32, as many groups of rows as the card's clusters give each head, and
    f32 (4 MiB of w_hh a head) the cooperative grid; at the 100m width both
    dtypes take clusters of one block.  The cluster plans are the rule of
    ``bwd_cluster_plan`` with the card's own count of clusters."""
    budget = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for b, d, h in ((1, 2048, 4), (4, 2048, 4), (8, 2048, 4), (4, 512, 8), (8, 512, 8)):
        for dt in DTYPES:
            p = slstm_scan_bwd_plan(b, d, h, w_dtype=dt)
            want = bwd_cluster_plan(b, d, h, dt.itemsize, budget, p.active)
            if (d, dt) == (2048, torch.float32):
                assert p.variant == "grid" and p.cluster == 0 and want is None
                continue
            assert p.variant == "cluster" and p.active >= 1
            assert (p.cluster, p.j, p.rows, p.blocks, p.smem) == want
            assert (p.cluster, p.j) == ((16, 32) if d == 2048 else (1, 64))


@pytest.mark.parametrize("dt", DTYPES)
def test_slstm_scan_save_mode_is_bit_for_bit(dev, dt):
    """K5 in save mode gives the serving launch's hs and final state bit for
    bit, its saved last step is the final (c, n, m), and its saved gates
    are (xg + h_{t-1} . w_hh) + b formed from its own hs, within f32's
    3e-5 (the product's sums in another order)."""
    args = _slstm_inputs(dev, 4, 37, 2048, 4, dt, seed=70)
    hs0, st0, none = _launch_fwd(*args, False)
    hs1, st1, saved = _launch_fwd(*args, True)
    assert none is None and torch.equal(hs0, hs1) and all(map(torch.equal, st0, st1))
    assert all(torch.equal(v[:, -1], f) for v, f in zip(saved[1:], st1[1:]))
    xg, w, bias, h0 = args[:4]
    hprev = torch.cat([h0[:, None], hs1[:, :-1]], dim=1).view(4, 37, 4, 512)
    rec = torch.einsum("bshd,hdk->bshk", hprev, w.float()).reshape(4, 37, 4 * 2048)
    torch.testing.assert_close(saved[0], (xg.float() + rec) + bias, atol=3e-5, rtol=3e-5)


def test_slstm_scan_function_launches_both_kernels(dev):
    """Under grad the wrapper takes ``_SlstmScanFn``: one K5 launch forward,
    one K5-bwd launch backward, gradients equal autograd of the plain
    version on the same inputs within 1e-3: the kernel's forward (its gate
    math's hardware exp/log) differs from the plain forward by up to 3e-5,
    and 16 steps of the gradient carry that difference."""
    args = [t.clone().requires_grad_(i < 3) for i, t in
            enumerate(_slstm_inputs(dev, 2, 16, 64, 2, torch.float32, seed=80))]
    n, nb = slstm_scan.launches, slstm_scan_bwd.launches
    hs, _ = slstm_scan(*args)
    got = torch.autograd.grad(hs.square().sum(), args[:3])
    assert (slstm_scan.launches, slstm_scan_bwd.launches) == (n + 1, nb + 1)
    hr, _ = slstm_scan_ref(*args)
    want = torch.autograd.grad(hr.square().sum(), args[:3])
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dt", [torch.float32, torch.uint8])
@pytest.mark.parametrize("lens,lmax,c,cap", [
    ([], 4, 4, 8),                      # N = 0: all zeros, total 0
    ([7], 9, 4, 12),                    # N = 1
    ([0, 0, 0], 5, 4, 6),               # all-zero lengths
    ([5, 3], 5, 4, 0),                  # capacity 0: offsets and total only
    ([9, 4, 6], 9, 4, 11),              # capacity below the total
    ([9, 4, 6], 9, 3, 30),              # 3-element rows (3 bytes in uint8)
    ("many", 20, 4, 60_000),            # 5000 sources: more than one scan pass
])
def test_ragged_concat_kernel_edges(dev, lens, lmax, c, cap, dt):
    if lens == "many":
        g = torch.Generator().manual_seed(15)
        lens = torch.randint(0, 21, (5000,), generator=g).tolist()
    src = (_randn(dev, len(lens), lmax, c, dt=torch.float32, seed=16) * 100).to(dt)
    for ldt in (torch.int32, torch.int64):
        lt = torch.tensor(lens, dtype=ldt, device=dev)
        n = ragged_concat.launches
        out, offs, total = ragged_concat(src, lt, capacity=cap)
        assert ragged_concat.launches == n + 1
        ref, roffs, rtotal = ragged_concat_ref(src, lt, cap)
        assert torch.equal(out, ref) and torch.equal(offs, roffs.to(torch.int32))
        assert offs.dtype == total.dtype == torch.int32
        assert int(total) == int(rtotal) == sum(lens)


def test_ragged_concat_one_kernel_per_call(dev):
    """A call is one kernel launch in the profile: no prefix sum, fill or
    concatenation beside it."""
    from torch.profiler import ProfilerActivity, profile

    lens = [500_000, 3_011, 2_987]
    src = _randn(dev, 3, max(lens), 4, dt=torch.float32, seed=17)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    ragged_concat(src, lt, capacity=sum(lens) + 1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ragged_concat(src, lt, capacity=sum(lens) + 1000)
        torch.cuda.synchronize()
    acts = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    # the profiler may deliver fewer activities than were launched, never more
    assert 0 < sum(e.count for e in acts) <= 5, [(e.key, e.count) for e in acts]
    assert all("ragged_concat" in e.key for e in acts), [e.key for e in acts]


@pytest.mark.parametrize("every", [8, 4])
def test_xlstm_kernel_path_matches_plain_path(dev, every):
    """f32, the 100m reduction of xlstm-1.3b (8 blocks) and a variant with
    two sLSTM blocks: prefill and 4 decode steps through the sLSTM scan and
    fused norm kernels agree with the plain path.  1e-4, as for the dense
    model: each block adds the kernels' summation-order differences."""
    cfg = model_100m("xlstm-1.3b").scaled(slstm_every=every)
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(0)
    scans0, norms0 = slstm_scan.launches, fused_rmsnorm.launches
    toks = torch.randint(0, cfg.vocab_size, (1, 77), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    lk, ck = fast.prefill(params, {"tokens": toks})
    lp, cp = plain.prefill(params, {"tokens": toks})
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for _ in range(4):
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        lk, ck = fast.decode_step(params, ck, nxt)
        lp, cp = plain.decode_step(params, cp, nxt)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for part in ("mlstm", "slstm"):
        for k, v in ck[part].items():
            torch.testing.assert_close(v, cp[part][k], atol=1e-4, rtol=1e-4, msg=k)
    groups = cfg.num_layers // every
    assert slstm_scan.launches - scans0 == 5 * groups      # prefill + 4 steps
    # every block's pre-norm and inner norm, each sLSTM block's ln_s2, the final norm
    assert fused_rmsnorm.launches - norms0 == 5 * (2 * cfg.num_layers + groups + 1)


@pytest.mark.parametrize("variants", [{}, dict(head_dim=80, num_heads=32, num_kv_heads=32)],
                         ids=["100m-hd64", "hd80-g1"])
def test_zamba2_kernel_path_matches_plain_path(dev, variants):
    """f32, the 100m reduction of zamba2-2.7b (6 Mamba2 blocks, one shared
    attention block invoked once; with hd 80 at zamba2-2.7b's G = 1):
    prefill of a prompt longer than two SSD chunks and 4 decode steps
    through the kernels agree with the plain path, states included.  1e-4,
    as for the dense model."""
    cfg = model_100m("zamba2-2.7b").scaled(ssm_chunk=32, **variants)
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(0)
    n0 = {w: w.launches for w in (fused_rmsnorm, flash_attention, decode_attention)}
    toks = torch.randint(0, cfg.vocab_size, (1, 77), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    lk, ck = fast.prefill(params, {"tokens": toks}, max_seq=128)
    lp, cp = plain.prefill(params, {"tokens": toks}, max_seq=128)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for _ in range(4):
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        lk, ck = fast.decode_step(params, ck, nxt)
        lp, cp = plain.decode_step(params, cp, nxt)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for k, v in ck["mamba"].items():
        torch.testing.assert_close(v, cp["mamba"][k], atol=1e-4, rtol=1e-4, msg=k)
    ng = cfg.num_layers // cfg.attn_every
    assert flash_attention.launches - n0[flash_attention] == ng
    assert decode_attention.launches - n0[decode_attention] == 4 * ng
    # ln_m and the inner norm of every block, ln1 and ln2 of every group, the final norm
    assert fused_rmsnorm.launches - n0[fused_rmsnorm] == 5 * (2 * cfg.num_layers + 2 * ng + 1)


# -- training: the backward kernels and the loss's gradients -------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", [48, 52, 128, 256, 512, 1536, 2048, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 37, 384, 3000])
@pytest.mark.parametrize("residual,gemma,want", [
    (True, False, True), (True, True, True), (True, False, False), (False, False, False),
    (False, True, True)], ids=["add", "add-gemma", "add-no-out", "norm", "norm-gemma"])
def test_rmsnorm_bwd_kernel_matches_plain(dev, residual, gemma, want, rows, d, dt):
    """K1-bwd against ``rmsnorm_bwd_ref`` in every mode the forward takes,
    up to D = 8192 (one warp a row up to 256, a block a row above): dx at
    the dtype's tolerance; dscale, a sum over up to 3000 rows, at 10x the
    f32 one; and a second call bit for bit the same (no atomics)."""
    x = _randn(dev, rows, d, dt=dt, seed=1)
    r = _randn(dev, rows, d, dt=dt, seed=2) if residual else None
    scale = _randn(dev, d, dt=torch.float32, seed=3)
    dy = _randn(dev, rows, d, dt=dt, seed=4)
    dh = _randn(dev, rows, d, dt=dt, seed=5) if residual and want else None
    dx, ds = rmsnorm_bwd(x, r, scale, dy, dh, gemma=gemma)
    rx, rs = rmsnorm_bwd_ref(x, r, scale, dy, dh, gemma=gemma)
    torch.testing.assert_close(dx.float(), rx.float(), atol=_tol(dt), rtol=_tol(dt))
    tol = 10 * _tol(torch.float32) if dt == torch.float32 else _tol(dt)
    torch.testing.assert_close(ds, rs, atol=tol, rtol=tol)
    dx2, ds2 = rmsnorm_bwd(x, r, scale, dy, dh, gemma=gemma)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("dt", DTYPES)
def test_rmsnorm_bwd_kernel_strided_rows(dev, dt):
    """The forward's strided rows (prefill's last position of (B, S, D))
    through the autograd Function: the gradient lands in the strided
    input's rows and nowhere else."""
    base = _randn(dev, 4, 40, 1536, dt=dt, seed=6).requires_grad_()
    res = _randn(dev, 4, 40, 1536, dt=dt, seed=7).requires_grad_()
    scale = _randn(dev, 1536, dt=torch.float32, seed=8).requires_grad_()
    w = _randn(dev, 4, 1, 1536, dt=dt, seed=9)
    y, h = fused_rmsnorm(base[:, -1:], res[:, -1:], scale)
    got = torch.autograd.grad((y.float() * w.float()).sum() + h.float().sum(), [base, res, scale])
    y, h = rmsnorm_ref(base[:, -1:], res[:, -1:], scale)
    want = torch.autograd.grad((y.float() * w.float()).sum() + h.float().sum(),
                               [base, res, scale])
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=10 * _tol(dt), rtol=10 * _tol(dt))
    assert got[0][:, :-1].abs().max() == 0


def _flash_bwd_case(dev, b, h, kv, sq, sk, hd, causal, dt, seed):
    q = _randn(dev, b, sq, h, hd, dt=dt, seed=seed).transpose(1, 2).requires_grad_()
    k = _randn(dev, b, sk, kv, hd, dt=dt, seed=seed + 1).transpose(1, 2).requires_grad_()
    v = _randn(dev, b, sk, kv, hd, dt=dt, seed=seed + 2).transpose(1, 2).requires_grad_()
    o = flash_attention(q, k, v, causal=causal)
    do = _randn(dev, b, h, sq, hd, dt=dt, seed=seed + 3)
    got = torch.autograd.grad(o, [q, k, v], do)
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do,
                                   causal=causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), w.float(), atol=_tol(dt), rtol=_tol(dt),
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernel_tile_edges(dev, hd, causal, dt):
    """K2-bwd through the autograd Function (the forward storing each row's
    logsumexp) against ``flash_attention_bwd_ref``: Sq and Sk over the
    tiles' edges, equal and unequal both ways, G 1-8 (16 at hd 128)."""
    cases = flash_edge_cases() + ([(100, 77, 16, 1, 4)] if hd == 128 else [])
    for i, (sq, sk, g, b, kv) in enumerate(cases):
        _flash_bwd_case(dev, b, g * kv, kv, sq, sk, hd, causal, dt, seed=10 + i)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,h,kv,sq,sk,hd", CROSS_FLASH)
def test_flash_attention_bwd_kernel_cross_shapes(dev, b, h, kv, sq, sk, hd, dt):
    """K2-bwd non-causal with Sq != Sk at the cross-attention families'
    shapes (whisper's 1500 frames, mLLaMA's 4096 vision tokens)."""
    _flash_bwd_case(dev, b, h, kv, sq, sk, hd, False, dt, seed=30)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal", TRAIN_FLASH)
def test_flash_attention_bwd_kernel_training_shapes(dev, b, h, kv, sq, sk, hd, causal, dt):
    """K2-bwd at the training paths' shapes: qwen2-1.5b at B 8 x S 1024 and
    the 100m reductions' self, encoder and cross attention at hd 64."""
    _flash_bwd_case(dev, b, h, kv, sq, sk, hd, causal, dt, seed=50)


MMA_BWD_EDGES = [63, 64, 65, 127, 129]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 6, 8, 16])
def test_flash_attention_bwd_kernel_64_tile_edges(dev, g, causal, hd, dt):
    """K2-bwd at the edges of its 64-row query and key tiles (bf16 runs on
    the tensor cores at hd 64, 80 and 128): Sq and Sk of 63, 64, 65, 127
    and 129, equal and unequal both ways, G query heads over 1 or 2 KV
    heads, q/k/v as (B, S, H, hd) buffers seen through their strides."""
    for i, sq in enumerate(MMA_BWD_EDGES):
        for j, sk in enumerate(MMA_BWD_EDGES):
            kv = 1 + (i + j) % 2
            _flash_bwd_case(dev, 2, g * kv, kv, sq, sk, hd, causal, dt, seed=60 + 5 * i + j)


@pytest.mark.parametrize("sq", [384, 1024])
def test_flash_attention_bwd_kernel_dk_over_many_queries(dev, sq):
    """bf16 dK where each key's sum runs over G Sq = 3072-8192 query terms
    with large P (15 keys, non-causal): dS enters dK's product as two bf16
    terms (once rounded, it missed the bound at these shapes), several
    seeds."""
    for seed in range(4):
        _flash_bwd_case(dev, 2, 8, 1, sq, 15, 128, False, torch.bfloat16, seed=110 + 4 * seed)


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernel_repeated_calls(dev, hd, causal):
    """No atomics: a bf16 K2-bwd call made twice gives dq, dk and dv bit for
    bit the same (GQA, ragged tiles)."""
    from repro_torch.kernels.flash_attention.ops import _launch_fwd

    dt = torch.bfloat16
    q = _randn(dev, 2, 200, 12, hd, dt=dt, seed=90).transpose(1, 2)
    k, v = (_randn(dev, 2, 130, 2, hd, dt=dt, seed=s).transpose(1, 2) for s in (91, 92))
    lse = torch.empty((2, 12, 200), device=dev)
    o = _launch_fwd(q, k, v, causal, None, lse)
    do = _randn(dev, 2, 12, 200, hd, dt=dt, seed=93)
    first = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", [1536, 1535, 52])
def test_rmsnorm_bwd_kernel_scalar_beside_vector(dev, d, dt):
    """K1-bwd's scalar instantiation (a D that is no multiple of the 16-byte
    vector, or rows at an unaligned stride) beside the vector one: both
    against the plain backward, and the unaligned rows against the same
    values in contiguous rows."""
    rows = 300
    buf = _randn(dev, rows, d + 1, dt=dt, seed=94)
    x = buf[:, :d]                                  # row stride d + 1: unaligned
    r = _randn(dev, rows, d, dt=dt, seed=95)
    scale = _randn(dev, d, dt=torch.float32, seed=96)
    dy, dh = (_randn(dev, rows, d, dt=dt, seed=s) for s in (97, 98))
    strided = rmsnorm_bwd(x, r, scale, dy, dh)
    dense = rmsnorm_bwd(x.contiguous(), r, scale, dy, dh)
    want = rmsnorm_bwd_ref(x, r, scale, dy, dh)
    for got in (strided, dense):
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=_tol(dt), rtol=_tol(dt))
        tol = 10 * _tol(torch.float32) if dt == torch.float32 else _tol(dt)
        torch.testing.assert_close(got[1], want[1], atol=tol, rtol=tol)
    torch.testing.assert_close(strided[0].float(), dense[0].float(), atol=_tol(dt),
                               rtol=_tol(dt))


def test_flash_attention_lse_leaves_the_output_unchanged(dev):
    """The forward's logsumexp output is extra: with it or without, the
    same output bit for bit, and the logsumexp of the scaled scores."""
    from repro_torch.kernels.flash_attention.ops import _launch_fwd

    for dt in DTYPES:
        for hd in (64, 80, 128, 256):
            q = _randn(dev, 2, 70, 8, hd, dt=dt, seed=40).transpose(1, 2)
            k, v = (_randn(dev, 2, 70, 2, hd, dt=dt, seed=s).transpose(1, 2) for s in (41, 42))
            lse = torch.empty((2, 8, 70), device=dev)
            assert torch.equal(_launch_fwd(q, k, v, True, None, lse),
                               _launch_fwd(q, k, v, True, None, None))
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                             k.float().repeat_interleave(4, 1)) * hd ** -0.5
            s = s.masked_fill(torch.ones(70, 70, dtype=torch.bool, device=dev).triu(1),
                              float("-inf"))
            torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b", "zamba2-2.7b",
                                  "whisper-small", "llama-3.2-vision-90b"])
def test_loss_grads_kernel_path_match_plain_path(dev, arch, monkeypatch):
    """f32, the 100m reductions cut to few layers (hd 64, zamba2 one group
    of 6 at hd 64): ``Model.loss`` and every gradient leaf through the
    forward and backward kernels against ``plain=True``, each leaf within
    1e-4 of its largest magnitude, under the config's remat (``block``);
    the MoE routes must agree between the paths.  xLSTM is refused on the
    card (K5 has no backward kernel)."""
    from _grad_parity import port_loss_and_grads

    cfg = model_100m(arch)
    cfg = cfg.scaled(num_layers={"zamba2": 6, "mllama": 4}.get(cfg.family, 2))
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 96), device=dev, generator=gen)}
    if cfg.family == "whisper":
        batch["frames"] = torch.randn(2, cfg.encoder_positions, cfg.d_model, device=dev,
                                      generator=gen)
    if cfg.family == "mllama":
        params["cross_layers"]["gate_attn"].fill_(0.7)
        params["cross_layers"]["gate_mlp"].fill_(-0.5)
        batch["vision"] = torch.randn(2, cfg.vision_tokens, cfg.d_model, device=dev,
                                      generator=gen)
    routes = _record_routes(monkeypatch)
    n0 = {w: w.launches for w in (fused_rmsnorm, rmsnorm_bwd, flash_attention,
                                  flash_attention_bwd)}
    lk, gk = port_loss_and_grads(fast, params, batch)
    fast_routes = routes[:]
    routes.clear()
    lp, gp = port_loss_and_grads(plain, params, batch)
    if cfg.family == "moe":
        assert _routes_agree(fast_routes, routes[:], cfg.top_k)
    torch.testing.assert_close(lk, lp, atol=1e-5, rtol=1e-5)
    for path, g in gp.items():
        err = (gk[path] - g).abs().max() / g.abs().max().clamp(min=1e-30)
        assert err <= 1e-4, (path, float(err))
    # whisper norms with LayerNorm (plain torch): no K1 on its path
    k1 = (fused_rmsnorm, rmsnorm_bwd)
    assert all(w.launches > n0[w] for w in n0 if cfg.family != "whisper" or w not in k1)
