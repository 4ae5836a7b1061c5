"""The port's Whisper family held against the JAX reference on the same
inputs: the whole model on the same weights (carried across with
``params_from_numpy``) and the same frames, drawn from a seed with numpy —
prefill logits, every cache leaf and decode steps; bf16 logits within a
bound; the kernels each call goes through; the entry points.

The configs are the whisper smoke config (d_model 32, 4 heads of 8, 2
encoder and 2 decoder layers, 12 frames), the same with ``attn_chunk=4``
(the reference then takes its chunked online-softmax path wherever the
keys outnumber 4: the encoder, the decoder's self- and cross-attention at
prefill), and a narrow case at whisper-small's head dim of 64 (d_model 128,
2 heads of 64, 20 frames), all in f32.

Tolerance: 3e-5 (the repo's f32 tolerance) on logits of scale O(1); greedy
tokens and lengths must be equal.  The reference's server cannot serve
this family (its prefill needs frames, which no request carries), so the
port's server refuses it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.train import model_100m as jax_model_100m
from repro.models import whisper_model as jwm
from repro_torch.configs import get_config, get_smoke_config, model_100m
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import whisper_model as wm
from repro_torch.models.weights import params_from_numpy
from repro_torch.runtime import InferenceServer
from _port_env import port_test_env  # noqa: F401  (autouse)

TOL = 3e-5
ARCH = "whisper-small"
# whisper-small's head dim of 64 at a narrow width, 20 frames
NARROW_HD64 = dict(d_model=128, num_heads=2, num_kv_heads=2, head_dim=64, d_ff=256,
                   num_layers=2, encoder_layers=2, encoder_positions=20)
CASES = {"smoke": {}, "smoke-chunked": dict(attn_chunk=4), "narrow-hd64": NARROW_HD64}


def _perturb(tree, rng):
    """LayerNorm scales and biases initialise to constants; give them seeded
    values so that one applied wrongly shows."""
    if isinstance(tree, dict):
        return {k: (v + rng.normal(0, 0.2, v.shape).astype(v.dtype)
                    if k in ("scale", "bias") else _perturb(v, rng)) for k, v in tree.items()}
    return tree


def _pair(overrides: dict, seed: int = 0, dtypes: dict | None = None):
    jcfg = jax_get_smoke_config(ARCH).scaled(**overrides, **(dtypes or {}))
    cfg = get_smoke_config(ARCH).scaled(**overrides, **(dtypes or {}))
    tree = _perturb(jax.tree.map(np.asarray, jwm.init_params(jcfg, jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed + 3))
    return jcfg, tree, cfg, params_from_numpy(tree, cfg, "cpu")


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.encoder_positions, cfg.d_model)).astype(np.float32)


def _batches(cfg, b: int, s: int, seed: int):
    """The same prompt and frames for both packages."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    frames = _frames(cfg, b, seed + 1)
    return ({"tokens": jnp.asarray(toks, jnp.int32), "frames": jnp.asarray(frames)},
            {"tokens": torch.as_tensor(toks), "frames": torch.from_numpy(frames)})


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jcfg, tree, cfg, params = _pair(CASES[request.param])
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params


@pytest.fixture(scope="module")
def jax_decode():
    return jax.jit(jwm.decode_step, static_argnums=3)


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
    """Prefill logits and every cache leaf (self K/V, cross K/V from the
    encoder, lengths), then three greedy decode steps and the cache again."""
    jcfg, jparams, cfg, params = pair
    m = Model(cfg, device="cpu")
    jb, tb = _batches(cfg, b, s, seed=s)
    jl, jc = jwm.prefill(jparams, jb, jcfg, max_seq=32)
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


def test_encoder_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    frames = _frames(cfg, 2, seed=7)
    _close(wm.encode(params, torch.from_numpy(frames), cfg),
           jwm.encode(jparams, jnp.asarray(frames), jcfg), "encoder output")


def test_layer_norm_matches_jax():
    from repro.models.common import layer_norm as jax_layer_norm

    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((5, 48))).astype(np.float32)
    scale, bias = rng.standard_normal(48).astype(np.float32), rng.standard_normal(48)
    bias = bias.astype(np.float32)
    got = tcommon.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    _close(got, jax_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    xb = torch.from_numpy(x).bfloat16()
    assert tcommon.layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias)).dtype == \
        torch.bfloat16


def test_decode_position_clips_to_the_table(jax_decode):
    """Past the last row of the decoder's positional table the position
    sticks at that row, as the reference's ``jnp.clip``; the self K/V's
    write clamps at the cache's last row."""
    jcfg, tree, cfg, params = _pair(dict(max_seq=6))
    jparams = jax.tree.map(jnp.asarray, tree)
    m = Model(cfg, device="cpu")
    jb, tb = _batches(cfg, 2, 5, seed=11)
    jl, jc = jwm.prefill(jparams, jb, jcfg, max_seq=8)
    tl, tc = m.prefill(params, tb, max_seq=8)
    for _ in range(4):          # lengths 5 -> 9: positions 5, 5, 5, 5 and a full cache
        nxt = np.asarray(jl[:, -1]).argmax(-1)[:, None]
        jl, jc = jax_decode(jparams, jc, jnp.asarray(nxt, jnp.int32), jcfg)
        tl, tc = m.decode_step(params, tc, torch.as_tensor(nxt))
        _close(tl, jl, "decode logits")
    assert params["decoder"]["pos_embed"].shape[0] == 6


# bf16 model parity.  Prefill and two decode steps of the smoke config on one
# set of bf16 weights, run three ways: the JAX model in bf16, the port in
# bf16, and the JAX model in f32 on the same (bf16-rounded) weights, whose
# greedy token feeds every decode step.  The two bf16 runs round in
# different places (torch's GEMMs, GELU and LayerNorm computed in f32 inside
# one kernel), so they may differ by rounding and no more.  BF16_ATOL is set
# from readings of ``bf16_gaps`` over seeds 0-4 (PERF.md, Findings):
# the two packages' largest logit difference is at most 0.039 (logits of
# scale 3.0-4.4), and a planted fault that drops the decoder's
# cross-attention in every decode step
# (``test_bf16_bound_fails_a_planted_fault``) at least 1.66.  The port
# must also sit as close to the f32 model as the reference's own bf16 run
# does, within BF16_F32_FACTOR (readings up to 1.56x).
BF16_ATOL = 0.06
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
    j16, c16 = jwm.prefill(p16, jb, jcfg16, max_seq=32)
    j32, c32 = jwm.prefill(p32, jb, jcfg32, max_seq=32)
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


def plant_drop_cross_attention_fault(monkeypatch) -> None:
    """A fault for the bound to catch: every decode step's cross-attention
    gives zeros; prefill is untouched."""
    monkeypatch.setattr(wm, "cross_attention_decode",
                        lambda q, ck, cv, lengths, **kw: torch.zeros_like(q))


def test_bf16_logits_match_jax_within_bound(jax_decode):
    for i, g in enumerate(bf16_gaps(jax_decode)):
        assert g["port_vs_jax_bf16"] <= BF16_ATOL, (i, g)
        assert g["port_vs_f32"] <= BF16_F32_FACTOR * g["jax_bf16_vs_f32"], (i, g)


def test_bf16_bound_fails_a_planted_fault(jax_decode, monkeypatch):
    plant_drop_cross_attention_fault(monkeypatch)
    gaps = bf16_gaps(jax_decode)
    assert gaps[0]["port_vs_jax_bf16"] <= BF16_ATOL, gaps   # prefill is sound
    assert max(g["port_vs_jax_bf16"] for g in gaps[1:]) > BF16_ATOL, gaps


# ---------------------------------------------------------------------------
# the kernels each call goes through
# ---------------------------------------------------------------------------


def _count_attention(monkeypatch) -> dict:
    """Count the flash- and decode-attention wrappers' calls from the
    model's attention adapters (their plain versions run on the CPU)."""
    calls = {"flash": [], "decode": []}
    flash, decode = tattn.flash_attention, tattn.decode_attention

    def counted_flash(q, k, v, *, causal=True, **kw):
        calls["flash"].append((causal, q.shape[2], k.shape[2]))
        return flash(q, k, v, causal=causal, **kw)

    def counted_decode(q, kc, vc, lengths, **kw):
        calls["decode"].append((kc.shape[2], lengths.tolist()))
        return decode(q, kc, vc, lengths, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counted_flash)
    monkeypatch.setattr(tattn, "decode_attention", counted_decode)
    return calls


@pytest.mark.parametrize("depth", [None, 12], ids=["smoke", "full-depth"])
def test_attention_goes_through_the_kernels(depth, monkeypatch):
    """Each prefill calls the flash-attention wrapper 3L times (at
    whisper-small's depth of 12 encoder and 12 decoder layers: 36): each
    encoder layer non-causal over its frames, each decoder layer causal
    over the prompt and non-causal from the prompt to the frames.  Each
    decode step calls the decode-attention wrapper 2L times (24): the self
    K/V at ``len + 1``, the cross K/V at all of its frames.  No RMSNorm
    runs."""
    cfg = get_smoke_config(ARCH)
    if depth:
        cfg = cfg.scaled(num_layers=depth, encoder_layers=depth)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    calls = _count_attention(monkeypatch)
    from repro_torch.kernels.rmsnorm import ops as norm_ops

    monkeypatch.setattr(norm_ops, "rmsnorm_ref", lambda *a, **kw: pytest.fail("an RMSNorm ran"))
    _, tb = _batches(cfg, 2, 9, seed=0)
    p = cfg.encoder_positions
    logits, cache = m.prefill(params, tb, max_seq=16)
    want = [(False, p, p)] * cfg.encoder_layers + [(True, 9, 9), (False, 9, p)] * cfg.num_layers
    assert calls["flash"] == want and not calls["decode"]
    m.decode_step(params, cache, logits[:, -1].argmax(-1, keepdim=True))
    assert calls["decode"] == [(16, [10, 10]), (p, [p, p])] * cfg.num_layers
    assert len(calls["flash"]) == 3 * cfg.num_layers
    if depth:
        assert (len(calls["flash"]), len(calls["decode"])) == (36, 24)


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
    assert full.max_positions() == 33_024 and full.head_dim == 64
    assert get_smoke_config(ARCH).scaled(max_seq=0).max_positions() == 4096
    assert full.max_positions() == jax_get_config(ARCH).max_positions()


def test_param_shapes_match_reference_at_full_width():
    """The full config's tree, leaf for leaf, without allocating it."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    abstract = jax.eval_shape(lambda: jwm.init_params(jcfg, jax.random.PRNGKey(0)))
    want = jax.tree.map(lambda a: tuple(a.shape), abstract)
    assert wm.param_shapes(cfg) == want
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple)))
    assert 2.6e8 < n < 2.7e8


@pytest.mark.parametrize("size", ["smoke", "100m"])
def test_port_init_matches_param_shapes(size):
    cfg = (get_smoke_config if size == "smoke" else model_100m)(ARCH)
    params = Model(cfg, device="cpu").init(0)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == wm.param_shapes(cfg)
    layers = params["decoder"]["layers"]
    assert layers["ln1"]["bias"].dtype == torch.float32
    # layers are drawn independently, not copies of one another
    w = layers["cross_attn"]["wq"]
    assert not torch.equal(w[0], w[1])


def test_prefill_without_frames_and_splice_are_refused():
    cfg = get_smoke_config(ARCH)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    toks = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="'frames'"):
        m.prefill(params, {"tokens": toks})
    _, tb = _batches(cfg, 1, 3, seed=0)
    _, single = m.prefill(params, tb, max_seq=8)
    with pytest.raises(NotImplementedError, match="'frames'"):
        m.splice_cache(m.init_cache(2, 8), single, 0, 3)


def test_server_and_launchers_refuse_whisper():
    from repro_torch.launch import fleet, serve

    assert ARCH not in serve.SERVED_ARCH_IDS
    with pytest.raises(ValueError, match="'frames'"):
        InferenceServer(Model(get_smoke_config(ARCH), device="cpu"))
    for main in (serve.main, fleet.main):
        with pytest.raises(SystemExit):
            main(["--arch", ARCH, "--size", "smoke", "--device", "cpu"])


def test_whisper_model_without_device_does_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here, so the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_smoke_config(ARCH))


def test_loss_and_grads_match_jax(pair):
    """``Model.loss`` on tokens and frames, and every gradient leaf (the
    encoder, the decoder's self and cross attention, the LayerNorms, the
    tied head) against ``jax.value_and_grad`` of the reference's loss,
    f32, at 3e-5; the frames carry no gradient."""
    from _grad_parity import assert_grads_match_jax

    jcfg, jparams, cfg, params = pair
    jb, tb = _batches(cfg, 2, 11, seed=8)
    assert_grads_match_jax(lambda p: jwm.loss_fn(p, jb, jcfg), jparams,
                           Model(cfg, device="cpu"), params, tb)
