"""The port's mLLaMA family held against the JAX reference on the same inputs:
the whole model on the same weights (carried across with
``params_from_numpy``) and the same vision input, drawn from a seed with
numpy — prefill logits, every cache leaf and decode steps; bf16 logits
within a bound; the fusion plan and the attention kernels each call goes
through; the entry points.

The cross layers' gates initialise to zero in both packages, and ``tanh(0)
= 0``: with them, every cross-attention and cross MLP adds exactly nothing
and a fault in the cross path cannot show.  Every test here therefore sets
the gates from the seed in the numpy tree, so both packages get the same
non-zero gates.

The configs are the mllama smoke config (d_model 64, 4 heads over 2 KV
heads of 16, 4 layers in 2 groups of [1 self + 1 cross], 8 vision tokens)
and a narrow case at llama-3.2-vision-90b's head dim of 128 and grouping
(8 heads over 1 KV head, ``cross_attn_every`` 2, 4 layers, 12 vision
tokens), both in f32.

Tolerance: 3e-5 (the repo's f32 tolerance) on logits of scale O(1); greedy
tokens and lengths must be equal.  The reference's server cannot serve
this family (its prefill needs the vision input, which no request
carries), so the port's server refuses it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.train import model_100m as jax_model_100m
from repro.models import mllama_model as jmm
from repro_torch.configs import get_config, get_smoke_config, model_100m
from repro_torch.kernels.rmsnorm.ops import _row_stride
from repro_torch.models import Model
from repro_torch.models import mllama_model as mm
from repro_torch.models import transformer as tt
from repro_torch.models.weights import params_from_numpy
from repro_torch.runtime import InferenceServer

from test_torch_whisper import _count_attention
from _port_env import port_test_env  # noqa: F401  (autouse)

TOL = 3e-5
ARCH = "llama-3.2-vision-90b"
# llama-3.2-vision-90b's head dim of 128 and 8 query heads per KV head at a
# narrow width
NARROW_HD128 = dict(d_model=128, num_heads=8, num_kv_heads=1, head_dim=128, d_ff=256,
                    num_layers=4, cross_attn_every=2, vision_tokens=12)
CASES = {"smoke": {}, "narrow-hd128": NARROW_HD128}


def _perturb(tree, rng):
    """Norm scales and gates initialise to constants; give them seeded
    values (gates of either sign, |gate| in 0.3-1.0) so that one applied
    wrongly, or a cross path that adds nothing, shows."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "scale":
            out[k] = v + rng.normal(0, 0.2, v.shape).astype(v.dtype)
        elif k.startswith("gate_"):
            g = rng.uniform(0.3, 1.0, v.shape) * rng.choice([-1.0, 1.0], v.shape)
            out[k] = g.astype(v.dtype)
        else:
            out[k] = _perturb(v, rng)
    return out


def _pair(overrides: dict, seed: int = 0, dtypes: dict | None = None):
    jcfg = jax_get_smoke_config(ARCH).scaled(**overrides, **(dtypes or {}))
    cfg = get_smoke_config(ARCH).scaled(**overrides, **(dtypes or {}))
    tree = _perturb(jax.tree.map(np.asarray, jmm.init_params(jcfg, jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed + 3))
    assert np.all(tree["cross_layers"]["gate_attn"] != 0)
    return jcfg, tree, cfg, params_from_numpy(tree, cfg, "cpu")


def _batches(cfg, b: int, s: int, seed: int):
    """The same prompt and vision input for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    vision = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32), "vision": jnp.asarray(vision)},
            {"tokens": torch.as_tensor(toks), "vision": torch.from_numpy(vision)})


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jcfg, tree, cfg, params = _pair(CASES[request.param])
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params


@pytest.fixture(scope="module")
def jax_decode():
    return jax.jit(jmm.decode_step, static_argnums=3)


def _close(got: torch.Tensor, want, what: str = "") -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


def _assert_cache_close(tc: dict, jc: dict) -> None:
    assert sorted(tc) == sorted(jc) == ["ck", "cv", "k", "len", "v"]
    for k, v in tc.items():
        w = np.asarray(jc[k])
        assert tuple(v.shape) == w.shape, k
        _close(v, w.astype(np.float32), k)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s", [(2, 13), (1, 1)])
def test_prefill_cache_and_decode_match_jax(pair, jax_decode, b, s):
    """Prefill logits and every cache leaf (self K/V per group and layer,
    the vision K/V per group, lengths), then three greedy decode steps and
    the cache again, with non-zero gates."""
    jcfg, jparams, cfg, params = pair
    m = Model(cfg, device="cpu")
    jb, tb = _batches(cfg, b, s, seed=s)
    jl, jc = jmm.prefill(jparams, jb, jcfg, max_seq=32)
    tl, tc = m.prefill(params, tb, max_seq=32)
    assert tl.shape == (b, 1, cfg.vocab_size)
    _close(tl, jl, "prefill logits")
    _assert_cache_close(tc, jc)
    for _ in range(3):
        nxt = np.asarray(jl[:, -1]).argmax(-1)[:, None]
        assert np.array_equal(nxt, tl[:, -1].argmax(-1, keepdim=True).numpy())
        jl, jc = jax_decode(jparams, jc, jnp.asarray(nxt, jnp.int32), jcfg)
        tl, tc = m.decode_step(params, tc, torch.as_tensor(nxt))
        _close(tl, jl, "decode logits")
    _assert_cache_close(tc, jc)
    assert tc["len"].tolist() == [s + 3] * b


def test_gates_reach_the_logits(pair):
    """The check above can see the cross path: with the gates zeroed (as at
    init) the port's logits move by far more than the tolerance."""
    jcfg, jparams, cfg, params = pair
    m = Model(cfg, device="cpu")
    _, tb = _batches(cfg, 2, 13, seed=13)
    gated = m.prefill(params, tb)[0]
    zeroed = {**params, "cross_layers": {**params["cross_layers"],
                                         "gate_attn": torch.zeros_like(
                                             params["cross_layers"]["gate_attn"]),
                                         "gate_mlp": torch.zeros_like(
                                             params["cross_layers"]["gate_mlp"])}}
    assert float((m.prefill(zeroed, tb)[0] - gated).abs().max()) > 1e3 * TOL


# bf16 model parity.  Prefill and two decode steps of the smoke config on one
# set of bf16 weights (gates from the seed), run three ways: the JAX model
# in bf16, the port in bf16, and the JAX model in f32 on the same
# (bf16-rounded) weights, whose greedy token feeds every decode step.  The
# two bf16 runs round in different places (the port's fused norm, torch's
# GEMMs), so they may differ by rounding and no more.  BF16_ATOL is set
# from readings of ``bf16_gaps`` over seeds 0-4 (PERF.md, Findings):
# the two packages' largest logit difference is at most 0.043 (logits of
# scale 1.7-2.9), and a planted fault that skips the ``tanh`` of the gates
# (``test_bf16_bound_fails_a_planted_fault``) at least 0.15 in every step.
# The port must also sit as close to the f32 model as the reference's own
# bf16 run does, within BF16_F32_FACTOR (readings up to 1.87x).
BF16_ATOL = 0.08
BF16_F32_FACTOR = 2.0
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _as_f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def bf16_gaps(jax_decode, seed: int = 0) -> list[dict]:
    """Per step (prefill, then two decode steps): the largest absolute logit
    difference of the port's bf16 run from the reference's bf16 run and of
    each from the reference's f32 run."""
    jcfg16, tree, cfg, params = _pair({}, seed=seed, dtypes=BF16)
    jcfg32 = jax_get_smoke_config(ARCH)
    p16 = jax.tree.map(jnp.asarray, tree)
    p32 = jax.tree.map(lambda a: jnp.asarray(_as_f32(a)), tree)
    m = Model(cfg, device="cpu")
    jb, tb = _batches(cfg, 2, 13, seed=seed + 5)
    j16, c16 = jmm.prefill(p16, jb, jcfg16, max_seq=32)
    j32, c32 = jmm.prefill(p32, jb, jcfg32, max_seq=32)
    t16, tc = m.prefill(params, tb, max_seq=32)
    steps = []
    for _ in range(3):
        assert t16.dtype == torch.bfloat16
        a, b, f = _as_f32(j16), t16.float().numpy(), _as_f32(j32)
        steps.append({"port_vs_jax_bf16": float(np.abs(b - a).max()),
                      "port_vs_f32": float(np.abs(b - f).max()),
                      "jax_bf16_vs_f32": float(np.abs(a - f).max()),
                      "logit_scale": float(np.abs(f).max())})
        nxt = f[:, -1].argmax(-1)[:, None]
        j16, c16 = jax_decode(p16, c16, jnp.asarray(nxt, jnp.int32), jcfg16)
        j32, c32 = jax_decode(p32, c32, jnp.asarray(nxt, jnp.int32), jcfg32)
        t16, tc = m.decode_step(params, tc, torch.as_tensor(nxt))
    return steps


def plant_skip_tanh_fault(monkeypatch) -> None:
    """A fault for the bound to catch: the cross layers scale by the raw
    gates, not their ``tanh``, in prefill and decode alike."""
    monkeypatch.setattr(mm, "_gate", lambda g, dtype: g.to(dtype))


def test_bf16_logits_match_jax_within_bound(jax_decode):
    for i, g in enumerate(bf16_gaps(jax_decode)):
        assert g["port_vs_jax_bf16"] <= BF16_ATOL, (i, g)
        assert g["port_vs_f32"] <= BF16_F32_FACTOR * g["jax_bf16_vs_f32"], (i, g)


def test_bf16_bound_fails_a_planted_fault(jax_decode, monkeypatch):
    plant_skip_tanh_fault(monkeypatch)
    gaps = bf16_gaps(jax_decode)
    assert max(g["port_vs_jax_bf16"] for g in gaps) > BF16_ATOL, gaps


# ---------------------------------------------------------------------------
# the kernels each call goes through
# ---------------------------------------------------------------------------


def _norm_calls(cfg) -> int:
    """K1 calls per prefill or decode step: ln1 and ln2 of every self and
    cross layer, and the final norm."""
    return 2 * cfg.num_layers + 1


@pytest.mark.parametrize("depth", [None, 10], ids=["smoke", "10-layers"])
def test_every_norm_goes_through_fused_rmsnorm(depth, monkeypatch):
    """The fusion plan, pinned on the CPU: one prefill and one decode step
    each call ``fused_rmsnorm`` 2L + 1 times, 21 at the 10 layers (2 groups
    of [4 self + 1 cross]) the card runs of llama-3.2-vision-90b (run here
    at the smoke width); the norm alone only for the first layer's ``ln1``;
    no other RMSNorm runs."""
    cfg = get_smoke_config(ARCH)
    if depth:
        cfg = cfg.scaled(num_layers=depth, cross_attn_every=get_config(ARCH).cross_attn_every)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    calls = []
    fused = mm.fused_rmsnorm

    def counted(x, residual, scale, **kw):
        # every input is rows the kernel reads on the card (raises otherwise)
        for t in (x, residual) if residual is not None else (x,):
            _row_stride(t, t.shape[-1], "input")
        calls.append(residual is not None)
        return fused(x, residual, scale, **kw)

    monkeypatch.setattr(mm, "fused_rmsnorm", counted)
    monkeypatch.setattr(tt, "fused_rmsnorm", counted)
    _, tb = _batches(cfg, 2, 9, seed=0)
    logits, cache = m.prefill(params, tb)
    assert len(calls) == _norm_calls(cfg)
    assert calls.count(False) == 1
    m.decode_step(params, cache, logits[:, -1].argmax(-1, keepdim=True))
    assert len(calls) == 2 * _norm_calls(cfg)
    assert not hasattr(mm, "rms_norm")
    assert _norm_calls(get_config(ARCH).scaled(num_layers=10)) == 21
    assert _norm_calls(get_config(ARCH)) == 201


@pytest.mark.parametrize("depth", [None, 10], ids=["smoke", "10-layers"])
def test_attention_goes_through_the_kernels(depth, monkeypatch):
    """Each prefill calls the flash-attention wrapper once a layer (10 at 10
    layers: 8 self, causal over the prompt; 2 cross, non-causal from the
    prompt to the vision tokens); each decode step calls the
    decode-attention wrapper once a layer (10), the self K/V at ``len +
    1`` and the cross K/V at all of its vision tokens."""
    cfg = get_smoke_config(ARCH)
    if depth:
        cfg = cfg.scaled(num_layers=depth, cross_attn_every=get_config(ARCH).cross_attn_every)
    ng, ns = mm.layout(cfg)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    calls = _count_attention(monkeypatch)
    _, tb = _batches(cfg, 2, 9, seed=0)
    t = cfg.vision_tokens
    logits, cache = m.prefill(params, tb, max_seq=16)
    assert calls["flash"] == ([(True, 9, 9)] * ns + [(False, 9, t)]) * ng
    m.decode_step(params, cache, logits[:, -1].argmax(-1, keepdim=True))
    assert calls["decode"] == ([(16, [10, 10])] * ns + [(t, [t, t])]) * ng
    if depth:
        assert (len(calls["flash"]), len(calls["decode"])) == (10, 10)


# ---------------------------------------------------------------------------
# configs, parameters, entry points
# ---------------------------------------------------------------------------


def _fields(c) -> dict:
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


def test_config_mirrors_reference():
    assert _fields(get_config(ARCH)) == _fields(jax_get_config(ARCH))
    assert _fields(get_smoke_config(ARCH)) == _fields(jax_get_smoke_config(ARCH))
    assert _fields(model_100m(ARCH)) == _fields(jax_model_100m(ARCH))
    full = get_config(ARCH)
    assert mm.layout(full) == (20, 4) and full.head_dim == 128
    assert mm.layout(model_100m(ARCH)) == (4, 1)     # 8 layers, cross_attn_every 2


def test_layout_refuses_a_depth_that_is_not_whole_groups():
    cfg = get_smoke_config(ARCH)
    assert mm.layout(cfg.scaled(num_layers=10, cross_attn_every=5)) == (2, 4)
    with pytest.raises(ValueError, match="cross_attn_every=5"):
        mm.layout(cfg.scaled(num_layers=12, cross_attn_every=5))
    with pytest.raises(ValueError, match="cross_attn_every=1"):
        mm.layout(cfg.scaled(cross_attn_every=1))


@pytest.mark.parametrize("layers", [100, 10])
def test_param_shapes_match_reference_at_full_width(layers):
    """The full config's tree, leaf for leaf, without allocating it: 10
    layers (the card's cut) hold 10.66 B parameters."""
    cfg, jcfg = (c.scaled(num_layers=layers) for c in (get_config(ARCH), jax_get_config(ARCH)))
    abstract = jax.eval_shape(lambda: jmm.init_params(jcfg, jax.random.PRNGKey(0)))
    want = jax.tree.map(lambda a: tuple(a.shape), abstract)
    assert mm.param_shapes(cfg) == want
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple)))
    assert (10.6e9 < n < 10.7e9) if layers == 10 else (86e9 < n < 89e9)


@pytest.mark.parametrize("size", ["smoke", "100m"])
def test_port_init_matches_param_shapes(size):
    cfg = (get_smoke_config if size == "smoke" else model_100m)(ARCH)
    params = Model(cfg, device="cpu").init(0)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == mm.param_shapes(cfg)
    cross = params["cross_layers"]
    assert torch.equal(cross["gate_attn"], torch.zeros(mm.layout(cfg)[0]))
    assert torch.equal(cross["gate_mlp"], torch.zeros(mm.layout(cfg)[0]))
    assert "lm_head" in params
    # layers are drawn independently, not copies of one another
    w = params["self_layers"]["attn"]["wq"]
    assert not torch.equal(w[0, 0], w[1, 0])


def test_prefill_without_vision_and_splice_are_refused():
    cfg = get_smoke_config(ARCH)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    with pytest.raises(ValueError, match="'vision'"):
        m.prefill(params, {"tokens": torch.zeros((1, 3), dtype=torch.int64)})
    _, tb = _batches(cfg, 1, 3, seed=0)
    _, single = m.prefill(params, tb, max_seq=8)
    with pytest.raises(NotImplementedError, match="'vision'"):
        m.splice_cache(m.init_cache(2, 8), single, 0, 3)


def test_server_and_launchers_refuse_mllama():
    from repro_torch.launch import fleet, serve

    assert ARCH not in serve.SERVED_ARCH_IDS
    with pytest.raises(ValueError, match="'vision'"):
        InferenceServer(Model(get_smoke_config(ARCH), device="cpu"))
    for main in (serve.main, fleet.main):
        with pytest.raises(SystemExit):
            main(["--arch", ARCH, "--size", "smoke", "--device", "cpu"])


def test_loss_and_grads_match_jax(pair):
    """``Model.loss`` on tokens and vision input, and every gradient leaf
    (self layers, the gated cross layers with their gates set non-zero from
    the seed, so every cross leaf gets a gradient) against
    ``jax.value_and_grad`` of the reference's loss, f32, at 3e-5."""
    from _grad_parity import assert_grads_match_jax

    jcfg, jparams, cfg, params = pair
    jb, tb = _batches(cfg, 2, 11, seed=8)
    assert_grads_match_jax(lambda p: jmm.loss_fn(p, jb, jcfg), jparams,
                           Model(cfg, device="cpu"), params, tb)
