"""The port's cost counter (``repro_torch.launch.cost_analysis``), held to
known-exact cases as ``tests/test_hlo_analysis.py`` holds the reference's
HLO analysis, then to the reference's own count of each family's smoke
steps; each kernel wrapper's ``meta`` branch and ``cost``."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import Model as JaxModel
from repro.models import Workload as JaxWorkload
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import ops as k3
from repro_torch.kernels.flash_attention import ops as k2
from repro_torch.kernels.ragged_concat import ops as k4
from repro_torch.kernels.rmsnorm import ops as k1
from repro_torch.kernels.slstm_scan import ops as k5
from repro_torch.launch.cost_analysis import COLLECTIVES, count
from repro_torch.launch.mesh import HW
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Model, Workload
from repro_torch.models import transformer
from _port_env import port_test_env  # noqa: F401  (autouse)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# known-exact cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers", [3, 11])
def test_loop_flops_exact(layers):
    """L matmuls in a Python loop: L x 2 x 128^3, each counted."""
    def f(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    c = count(f, _meta(128, 128), _meta(layers, 128, 128))
    assert c.flops == layers * 2 * 128 ** 3
    assert c.ops["aten.mm"]["calls"] == layers


def test_nested_loop_flops_exact():
    """G groups of K matmuls: G x K x 2 x 64^3."""
    def f(x, ws):
        for group in ws:
            for w in group:
                x = x @ w
        return x

    g, k = 4, 3
    c = count(f, _meta(64, 64), _meta(g, k, 64, 64))
    assert c.flops == g * k * 2 * 64 ** 3


def test_unrolled_matches_looped():
    """A loop over views of one stacked tensor and the same products
    written out over separate tensors give the same FLOPs and bytes: views
    are free."""
    def looped(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    def unrolled(x, w0, w1, w2):
        x = torch.tanh(x @ w0)
        x = torch.tanh(x @ w1)
        return torch.tanh(x @ w2)

    x = _meta(64, 64)
    cl = count(looped, x, _meta(3, 64, 64))
    cu = count(unrolled, x, *(_meta(64, 64) for _ in range(3)))
    assert (cl.flops, cl.bytes) == (cu.flops, cu.bytes)


@pytest.mark.parametrize("capacity", [1024, 2048])
def test_cache_write_charged_the_window(capacity):
    """The decode step's in-place append (``k_cache[rows, pos] = k``) is
    charged the rows it writes, whatever the cache's capacity."""
    b, kv, hd = 4, 2, 64
    cache = _meta(b, capacity, kv, hd, dtype=torch.bfloat16)

    def append(cache, new, pos):
        cache[torch.arange(b, device=cache.device), pos] = new
        return cache

    c = count(append, cache, _meta(b, kv, hd, dtype=torch.bfloat16),
              _meta(b, dtype=torch.long))
    window = b * kv * hd * 2
    # the row ids made (arange), the two index vectors and the new rows
    # read, the window written
    assert c.bytes == 8 * b + 16 * b + 2 * window, c.ops
    assert c.memory["alias_bytes"] == c.memory["output_bytes"] == cache.numel() * 2


def test_decode_step_charged_the_window_when_the_capacity_doubles():
    """A whole decode step of the smoke model on ``meta``: doubling the
    cache's capacity adds exactly what the decode-attention kernel's cost
    adds (its reads of the valid positions, the whole cache on ``meta``),
    and nothing for the cache writes."""
    cfg = get_smoke_config("qwen2-1.5b")
    model = Model(cfg, device="meta")
    params = model.abstract_params()
    b, kv, hd, h = 2, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    counts = {}
    for cap in (256, 512):
        cache = model.abstract_cache(b, cap)
        counts[cap] = count(make_decode_step(model), params, cache,
                            _meta(b, 1, dtype=torch.int32))
    grow = counts[512].bytes - counts[256].bytes
    per_layer = [k3.decode_attention_cost(b, h, kv, hd, b * cap, 4)[1] for cap in (256, 512)]
    assert grow == cfg.num_layers * (per_layer[1] - per_layer[0])
    assert counts[512].flops - counts[256].flops == cfg.num_layers * (
        k3.decode_attention_cost(b, h, kv, hd, b * 256, 4)[0])


def test_collectives_are_zero():
    cfg = get_smoke_config("qwen2-1.5b")
    model = Model(cfg, device="meta")
    c = count(make_prefill_step(model, Workload("w", 32, 2, "prefill")),
              model.abstract_params(), {"tokens": _meta(2, 32, dtype=torch.int32)})
    assert c.collective_wire_bytes == 0
    assert c.collectives == {k: {"count": 0, "wire_bytes": 0.0} for k in COLLECTIVES}
    assert c.flops > 0 and c.bytes > 0


def test_a_count_lets_go_of_its_arguments_and_results():
    """Once ``count`` returns, the step's inputs and outputs live only as
    long as the caller holds them: the storages' finalizers hold the
    counter weakly (a strong hold kept a counted train step's whole state
    on the card until the process ended)."""
    import gc
    import weakref

    x = torch.ones(64, 64)
    out = []
    c = count(lambda t: out.append(t @ t) or out[-1], x)
    assert c.memory["argument_bytes"] == x.untyped_storage().nbytes()
    refs = [weakref.ref(x), weakref.ref(out[0])]
    del x, out
    gc.collect()
    assert [r() for r in refs] == [None, None]


# ---------------------------------------------------------------------------
# the kernel wrappers on meta
# ---------------------------------------------------------------------------


def _wrapper_cases():
    """name: (inputs(device) -> args, call(*args) -> outputs, launch counter,
    cost (flops, bytes))."""
    bf, f32 = torch.bfloat16, torch.float32
    b, h, kv, s, hd = 2, 4, 2, 16, 64
    d, nh = 32, 2
    dh = d // nh

    def t(dev, *shape, dtype=f32):
        g = torch.Generator().manual_seed(sum(shape))
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    def lens(dev, n):
        return torch.tensor([s, 5, 3][:n], dtype=torch.int32, device=dev)

    def scan(dev):
        return (t(dev, b, s, 4 * d, dtype=bf), t(dev, nh, dh, 4 * dh, dtype=bf),
                t(dev, 4 * d), t(dev, b, d), t(dev, b, d), t(dev, b, d).abs() + 1,
                t(dev, b, d) * 0)

    def scan_bwd(dev):
        _, w, _, h0, c0, n0, m0 = scan(dev)
        return (w, h0, c0, n0, m0, t(dev, b, s, d), t(dev, b, s, 4 * d), t(dev, b, s, d),
                t(dev, b, s, d).abs() + 1, t(dev, b, s, d), t(dev, b, s, d))

    return {
        "fused_rmsnorm": (lambda dev: (t(dev, 6, d, dtype=bf), t(dev, 6, d, dtype=bf),
                                       t(dev, d)),
                          k1.fused_rmsnorm, k1.fused_rmsnorm, k1.fused_rmsnorm_cost(6, d, 2)),
        "rmsnorm_bwd": (lambda dev: (t(dev, 6, d, dtype=bf), t(dev, 6, d, dtype=bf), t(dev, d),
                                     t(dev, 6, d, dtype=bf), None),
                        k1.rmsnorm_bwd, k1.rmsnorm_bwd, k1.rmsnorm_bwd_cost(6, d, 2, True, False)),
        "flash_attention": (lambda dev: (t(dev, b, h, s, hd, dtype=bf),
                                         t(dev, b, kv, s, hd, dtype=bf),
                                         t(dev, b, kv, s, hd, dtype=bf)),
                            k2.flash_attention, k2.flash_attention,
                            k2.flash_attention_cost(b, h, kv, s, s, hd, 2)),
        "flash_attention_bwd": (lambda dev: (t(dev, b, h, s, hd), t(dev, b, kv, s, hd),
                                             t(dev, b, kv, s, hd), t(dev, b, h, s, hd),
                                             t(dev, b, h, s, hd), t(dev, b, h, s)),
                                k2.flash_attention_bwd, k2.flash_attention_bwd,
                                k2.flash_attention_bwd_cost(b, h, kv, s, s, hd, 4)),
        "decode_attention": (lambda dev: (t(dev, b, h, hd, dtype=bf),
                                          t(dev, b, kv, s, hd, dtype=bf),
                                          t(dev, b, kv, s, hd, dtype=bf), lens(dev, b)),
                             k3.decode_attention, k3.decode_attention,
                             k3.decode_attention_cost(b, h, kv, hd, b * s, 2)),
        "ragged_concat": (lambda dev: (t(dev, 3, 8, 4), lens(dev, 3)),
                          lambda src, n: k4.ragged_concat(src, n, capacity=20),
                          k4.ragged_concat, k4.ragged_concat_cost(3, 4, 4, 20, 20)),
        "slstm_scan": (scan, k5.slstm_scan, k5.slstm_scan, k5.slstm_scan_cost(b, s, d, nh, 2, 2)),
        "slstm_scan_bwd": (scan_bwd, lambda *a: k5.slstm_scan_bwd(*a, x_dtype=bf),
                           k5.slstm_scan_bwd, k5.slstm_scan_bwd_cost(b, s, d, nh, 2, 2)),
    }


def _shapes(out) -> list:
    return [(tuple(x.shape), x.dtype, x.device.type) for x in jax.tree.leaves(out)
            if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("name", sorted(_wrapper_cases()))
def test_wrapper_on_meta_gives_the_kernels_shapes_and_cost(name):
    """On ``meta`` each wrapper returns what its plain version returns on the
    CPU, shape for shape and dtype for dtype, counts as exactly one call of
    its kernel at its ``cost`` (no other op), and launches nothing."""
    inputs, call, wrapper, (flops, nbytes) = _wrapper_cases()[name]
    want = [(shape, dt, "meta") for shape, dt, _ in _shapes(call(*inputs("cpu")))]
    before = wrapper.launches
    args = inputs("meta")
    c = count(call, *args)
    assert _shapes(call(*args)) == want
    assert c.ops == {f"kernel.{name}": {"calls": 1, "flops": float(flops),
                                         "bytes": float(nbytes)}}
    assert (c.flops, c.bytes) == (flops, nbytes)
    assert wrapper.launches == before


def test_autograd_functions_count_both_kernels_on_meta():
    """Under grad, K1, K2 and K5 on ``meta`` go through their autograd
    Functions: a backward counts each backward kernel once, with K2's
    forward counted with its logsumexp and K5's in save mode."""
    b, h, s, hd, d = 2, 4, 16, 64, 32

    def step(x, sc, q, kv, xg, w, bias, st):
        y, _ = k1.fused_rmsnorm(x, None, sc, want_residual=False)
        o = k2.flash_attention(q, kv, kv)
        hs, _ = k5.slstm_scan(xg, w, bias, st, st, st, st)
        loss = y.float().sum() + o.float().sum() + hs.sum()
        return torch.autograd.grad(loss, [x, sc, q, kv, xg, w])

    args = [_meta(6, d, dtype=torch.bfloat16), _meta(d), _meta(b, h, s, hd, dtype=torch.bfloat16),
            _meta(b, 2, s, hd, dtype=torch.bfloat16), _meta(b, s, 4 * d, dtype=torch.bfloat16),
            _meta(2, 16, 64, dtype=torch.bfloat16), _meta(4 * d), _meta(b, d)]
    c = count(step, *(a.requires_grad_() if i < 7 else a for i, a in enumerate(args)))
    assert c.kernels() == {"fused_rmsnorm": 1, "rmsnorm_bwd": 1, "flash_attention": 1,
                           "flash_attention_bwd": 1, "slstm_scan": 1, "slstm_scan_bwd": 1}
    assert c.ops["kernel.flash_attention"]["bytes"] == \
        k2.flash_attention_cost(b, h, 2, s, s, hd, 2, lse=True)[1]
    assert c.ops["kernel.slstm_scan"]["bytes"] == k5.slstm_scan_cost(b, s, d, 2, 2, 2, True)[1]


def _bound_ms(cost, peak_flops):
    flops, nbytes = cost
    return 1e3 * max(nbytes / HW.HBM_BW, flops / peak_flops)


@pytest.mark.parametrize("name,cost,peak,want", [
    # PERF.md's kernel tables (chip_smoke.py phase 3 computes them from these)
    ("K1 R=384 D=1536", k1.fused_rmsnorm_cost(384, 1536, 2), "bf16", 0.00141),
    ("K2 S=384", k2.flash_attention_cost(1, 12, 2, 384, 384, 128, 2), "bf16", 0.00082),
    ("K3 lens 397/250/130/17", k3.decode_attention_cost(4, 12, 2, 128, 794, 2), "bf16", 0.00025),
    ("K4", k4.ragged_concat_cost(3, 4, 4, 505_998, 506_998), "f32", 0.00484),
    ("K5 S=384", k5.slstm_scan_cost(1, 384, 2048, 4, 2, 2), "f32", 0.04808),
    ("K1-bwd R=8192 D=1536", k1.rmsnorm_bwd_cost(8192, 1536, 2), "bf16", 0.03756),
    ("K2-bwd B=8 S=1024", k2.flash_attention_bwd_cost(8, 12, 2, 1024, 1024, 128, 2), "bf16",
     0.06520),
    ("K5-bwd B=8 S=1024 D=2048 H=4", k5.slstm_scan_bwd_cost(8, 1024, 2048, 4, 2, 2), "f32",
     2.05133),
])
def test_cost_reproduces_the_recorded_bounds(name, cost, peak, want):
    peak_flops = HW.PEAK_BF16_FLOPS if peak == "bf16" else HW.PEAK_F32_FLOPS
    assert round(_bound_ms(cost, peak_flops), 5) == want, name


# ---------------------------------------------------------------------------
# against the reference's HLO count
# ---------------------------------------------------------------------------

# One arch per family, smoke config; prefill B 2 x S 64, decode B 2 over a
# cache of 256 (the reference's rounding of S + 1).
FAMILY_ARCHS = ["qwen2-1.5b", "qwen2-moe-a2.7b", "xlstm-1.3b", "zamba2-2.7b", "whisper-small",
                "llama-3.2-vision-90b"]
B, S = 2, 64
# The plain path's FLOPs against the reference's compiled step: the
# reference's decode scores the new token apart from the cache (one more
# ``bkgd,bkd->bkg`` dot a layer, 2 B H hd FLOPs: 0.1% of a smoke decode
# step) where the port appends it first; prefill agrees exactly.  A layer
# counted twice moves the count by 1/L >= 1/3.
REL_TOL = 2e-3


@functools.cache
def _reference_flops(arch: str, kind: str) -> float:
    model = JaxModel(jax_smoke_config(arch))
    wl = JaxWorkload("w", S, B, kind)
    params, specs = model.abstract_params(), model.input_specs(wl)
    if kind == "prefill":
        lowered = jax.jit(jax_prefill_step(model, wl)).lower(params, specs)
    else:
        lowered = jax.jit(jax_decode_step(model)).lower(params, specs["cache"], specs["tokens"])
    return analyze_hlo(lowered.compile().as_text()).flops


def _port_flops(arch: str, kind: str) -> float:
    model = Model(get_smoke_config(arch), device="meta", plain=True)
    wl = Workload("w", S, B, kind)
    params, specs = model.abstract_params(), model.input_specs(wl)
    if kind == "prefill":
        return count(make_prefill_step(model, wl), params, specs).flops
    return count(make_decode_step(model), params, specs["cache"], specs["tokens"]).flops


def _ragged_dot_extra(arch: str, kind: str) -> float:
    """What the reference's HLO counts for ``lax.ragged_dot`` beyond the
    routed rows: on a backend without grouped GEMMs it lowers to a dense
    product of every routed row with each of the E + 1 groups (the
    overflow group included; ``repro/models/mlp.py:132-133``), E more than
    the T k rows the port's rule counts."""
    cfg = get_smoke_config(arch)
    if cfg.family != "moe":
        return 0.0
    rows = B * (S if kind == "prefill" else 1) * cfg.top_k
    routed = 3 * 2 * rows * cfg.d_model * cfg.d_ff
    return cfg.num_experts * routed * cfg.num_layers


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_plain_meta_flops_hold_against_the_reference_hlo(arch):
    for kind in ("prefill", "decode"):
        want = _reference_flops(arch, kind)
        got = _port_flops(arch, kind) + _ragged_dot_extra(arch, kind)
        np.testing.assert_allclose(got, want, rtol=REL_TOL, err_msg=f"{arch} {kind}")


def test_reference_check_fails_a_planted_fault(monkeypatch):
    """Layer 0 run twice in the port's count breaks the bound."""
    body = transformer.layer_body

    def twice(p, x, m, *args, **kwargs):
        out = body(p, x, m, *args, **kwargs)
        return body(p, x, m, *args, **kwargs) if m is None else out

    monkeypatch.setattr(transformer, "layer_body", twice)
    for kind in ("prefill", "decode"):
        got, want = _port_flops("qwen2-1.5b", kind), _reference_flops("qwen2-1.5b", kind)
        assert abs(got / want - 1) > 10 * REL_TOL, kind
