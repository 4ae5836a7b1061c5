"""The port's xLSTM family held against the JAX reference model on the same
weights (carried across with ``params_from_numpy``): prefill logits, every
cache leaf and 8 greedy decode steps; the port's parallel prefill against
its own sequential replay; and the port's server against the JAX model run
one request at a time.

The configs are the xlstm smoke config (``slstm_every=2``: one mLSTM block
per group) and a variant with ``slstm_every=4`` (three per group), in f32.
Prompt lengths are not multiples of ``ssm_chunk`` (4), and one prompt has
2 tokens, shorter than the conv kernel.

Tolerance: 3e-5 (the repo's f32 tolerance) on logits and states of scale
O(1)-O(10); greedy tokens and lengths must be equal.  The JAX server is
not the yardstick: its ``_splice_cache`` does not splice the (ng, nm, B,
...) mLSTM state leaves into their slots (ROADMAP.md, Queue 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.train import model_100m as jax_model_100m
from repro.models import xlstm_model as jxm
from repro_torch.configs import get_config, get_smoke_config, model_100m
from repro_torch.models import Model
from repro_torch.models import xlstm_model as xm
from repro_torch.kernels.rmsnorm.ops import _row_stride
from repro_torch.models.weights import params_from_numpy
from repro_torch.runtime import InferenceServer, Request

TOL = 3e-5
ARCH = "xlstm-1.3b"
CASES = {"smoke-every2": {}, "smoke-every4": {"slstm_every": 4}}
_PERTURB = ("scale", "norm_inner", "b_ih", "conv_b", "skip")


def _perturb(tree, rng):
    """Norm scales, biases and skips initialise to constants; give them
    seeded values so that one applied wrongly shows."""
    if isinstance(tree, dict):
        return {k: (v + rng.normal(0, 0.2, v.shape).astype(v.dtype) if k in _PERTURB
                    else _perturb(v, rng)) for k, v in tree.items()}
    return tree


def _pair(overrides: dict, seed: int = 0):
    jcfg = jax_get_smoke_config(ARCH).scaled(**overrides)
    cfg = get_smoke_config(ARCH).scaled(**overrides)
    tree = _perturb(jax.tree.map(np.asarray, jxm.init_params(jcfg, jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed + 3))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return _pair(CASES[request.param])


@pytest.fixture(scope="module")
def jax_decode():
    return jax.jit(jxm.decode_step, static_argnums=3)


def _leaves(cache: dict) -> dict:
    out = {"len": cache["len"]}
    for part in ("mlstm", "slstm"):
        out.update({f"{part}/{k}": v for k, v in cache[part].items()})
    return out


def _assert_cache_close(tc: dict, jc: dict) -> None:
    got, want = _leaves(tc), _leaves(jc)
    assert sorted(got) == sorted(want) == sorted(
        ["len", "mlstm/C", "mlstm/n", "mlstm/m", "mlstm/conv",
         "slstm/h", "slstm/c", "slstm/n", "slstm/m"])
    for k, v in got.items():
        w = np.asarray(want[k])
        assert tuple(v.shape) == w.shape, k
        np.testing.assert_allclose(v.float().numpy(), w.astype(np.float32),
                                   atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("b,s", [(2, 13), (1, 2)])
def test_prefill_cache_and_greedy_decode_match_jax(pair, jax_decode, b, s):
    jcfg, jparams, cfg, params = pair
    m = Model(cfg, device="cpu")
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (b, s))
    jl, jc = jxm.prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    tl, tc = m.prefill(params, {"tokens": torch.as_tensor(toks)})
    assert tl.shape == (b, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _assert_cache_close(tc, jc)
    for _ in range(8):
        nxt = np.asarray(jl[:, -1]).argmax(-1)[:, None]
        assert np.array_equal(nxt, tl[:, -1].argmax(-1, keepdim=True).numpy())
        jl, jc = jax_decode(jparams, jc, jnp.asarray(nxt, jnp.int32), jcfg)
        tl, tc = m.decode_step(params, tc, torch.as_tensor(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _assert_cache_close(tc, jc)
    assert tc["len"].tolist() == [s + 8] * b


def test_parallel_prefill_matches_sequential_replay(pair):
    """The port's closed-form prefill states equal its own replay of decode
    steps, as ``tests/test_xlstm_prefill.py`` holds the reference's.  1e-4:
    the two sum the same series in different orders over 24 steps."""
    _, _, cfg, params = pair
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
    lp, cp = xm.prefill(params, toks, cfg)
    ls, cs = xm.prefill_sequential(params, toks, cfg)
    torch.testing.assert_close(lp, ls, atol=1e-4, rtol=1e-4)
    for k, v in _leaves(cp).items():
        torch.testing.assert_close(v, _leaves(cs)[k], atol=1e-4, rtol=1e-4, msg=k)


# bf16 model parity.  Prefill and two decode steps of the smoke config on one
# set of bf16 weights, run three ways: the JAX model in bf16, the port in
# bf16, and the JAX model in f32 on the same (bf16-rounded) weights, whose
# greedy token feeds every decode step.  The two bf16 runs round in
# different places (the port's fused norm, the mLSTM cell's casts, torch's
# GEMMs), so they may differ by rounding and no more.  BF16_ATOL is set from
# readings of ``bf16_gaps`` (PERF.md, PR 16 findings): the two packages'
# largest logit difference over seeds 0-4 (logits of scale about 1.3) lies
# below it, and a planted forget-gate fault
# (``test_bf16_bound_fails_a_planted_fault``) lies above it.  The port must
# also sit as close to the f32 model as the reference's own bf16 run does,
# within BF16_F32_FACTOR.
BF16_ATOL = 0.045
BF16_F32_FACTOR = 2.0
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _as_f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def bf16_gaps(jax_decode, seed: int = 0) -> list[dict]:
    """Per step (prefill, then two decode steps): the largest absolute logit
    difference of the port's bf16 run from the reference's bf16 run and of
    each from the reference's f32 run."""
    jcfg32 = jax_get_smoke_config(ARCH)
    jcfg16, cfg = jcfg32.scaled(**BF16), get_smoke_config(ARCH).scaled(**BF16)
    tree = _perturb(jax.tree.map(np.asarray, jxm.init_params(jcfg16, jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed + 3))
    p16 = jax.tree.map(jnp.asarray, tree)
    p32 = jax.tree.map(lambda a: jnp.asarray(_as_f32(a)), tree)
    m, params = Model(cfg, device="cpu"), params_from_numpy(tree, cfg, "cpu")
    toks = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (2, 13))
    j16, c16 = jxm.prefill(p16, jnp.asarray(toks, jnp.int32), jcfg16)
    j32, c32 = jxm.prefill(p32, jnp.asarray(toks, jnp.int32), jcfg32)
    t16, tc = m.prefill(params, {"tokens": torch.as_tensor(toks)})
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


def plant_forget_gate_fault(monkeypatch, factor: float = 0.9) -> None:
    """A subtle fault for the bound to catch: the mLSTM decode step scales
    its forget gate by ``factor`` (prefill is untouched)."""
    import math
    import types

    from repro_torch.models import xlstm

    F = xlstm.F
    shifted = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F) if not k.startswith("__")})
    shifted.logsigmoid = lambda x: F.logsigmoid(x) + (math.log(factor) if x.dim() == 2 else 0.0)
    monkeypatch.setattr(xlstm, "F", shifted)


def test_bf16_logits_match_jax_within_bound(jax_decode):
    for i, g in enumerate(bf16_gaps(jax_decode)):
        assert g["port_vs_jax_bf16"] <= BF16_ATOL, (i, g)
        assert g["port_vs_f32"] <= BF16_F32_FACTOR * g["jax_bf16_vs_f32"], (i, g)


def test_bf16_bound_fails_a_planted_fault(jax_decode, monkeypatch):
    plant_forget_gate_fault(monkeypatch)
    gaps = bf16_gaps(jax_decode)
    assert gaps[0]["port_vs_jax_bf16"] <= BF16_ATOL, gaps   # prefill is sound
    assert max(g["port_vs_jax_bf16"] for g in gaps[1:]) > BF16_ATOL, gaps


def _norm_calls(cfg) -> int:
    """K1 calls per prefill or decode step: each block's pre-norm and inner
    norm, each sLSTM block's ln_s2, and the final norm."""
    ng, nm = xm._layout(cfg)
    n_slstm = ng if cfg.slstm_every > 0 else 0
    return 2 * cfg.num_layers + n_slstm + 1


@pytest.mark.parametrize("overrides", list(CASES.values()), ids=list(CASES))
def test_every_norm_goes_through_fused_rmsnorm(overrides, monkeypatch):
    """The fusion plan, pinned on the CPU: one prefill and one decode step
    each call ``fused_rmsnorm`` blocks + sLSTM blocks + 1 + inner norms
    times, 103 at full width; no other RMSNorm runs."""
    from repro_torch.models import xlstm as xl

    cfg = get_smoke_config(ARCH).scaled(**overrides)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    calls = []
    fused = xm.fused_rmsnorm

    def counted(x, residual, scale, **kw):
        # every input is rows the kernel reads on the card (raises otherwise)
        for t in (x, residual) if residual is not None else (x,):
            _row_stride(t, t.shape[-1], "input")
        calls.append(residual is not None)
        return fused(x, residual, scale, **kw)

    monkeypatch.setattr(xm, "fused_rmsnorm", counted)
    monkeypatch.setattr(xl, "fused_rmsnorm", counted)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)))
    logits, cache = m.prefill(params, {"tokens": toks})
    ng, _ = xm._layout(cfg)
    assert len(calls) == _norm_calls(cfg)
    # the norm alone: block 0's pre-norm and each sLSTM block's inner norm
    assert calls.count(False) == 1 + ng
    m.decode_step(params, cache, logits[:, -1].argmax(-1, keepdim=True))
    assert len(calls) == 2 * _norm_calls(cfg)
    assert not hasattr(xm, "rms_norm") and not hasattr(xl, "rms_norm")
    assert _norm_calls(get_config(ARCH)) == 103


def test_config_mirrors_reference():
    def fields(c):
        return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}

    assert fields(get_config(ARCH)) == fields(jax_get_config(ARCH))
    assert fields(get_smoke_config(ARCH)) == fields(jax_get_smoke_config(ARCH))
    assert fields(model_100m(ARCH)) == fields(jax_model_100m(ARCH))
    full = get_config(ARCH)
    assert xm._layout(full) == (6, 7) and full.pdt == torch.bfloat16
    assert xm._layout(model_100m(ARCH)) == (1, 7)


def test_param_shapes_match_reference_at_full_width():
    """The full config's tree, leaf for leaf, without allocating it: 3.61 B
    parameters, from the reference's ``jax.eval_shape``."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    abstract = jax.eval_shape(lambda: jxm.init_params(jcfg, jax.random.PRNGKey(0)))
    want = jax.tree.map(lambda a: tuple(a.shape), abstract)
    assert xm.param_shapes(cfg) == want
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple)))
    assert 3.60e9 < n < 3.62e9


def test_port_init_matches_param_shapes():
    cfg = get_smoke_config(ARCH).scaled(slstm_every=4, tie_embeddings=False)
    params = Model(cfg, device="cpu").init(0)
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert shapes == xm.param_shapes(cfg) and "lm_head" in params
    assert params["mlstm"]["w_gates"].dtype == torch.float32
    # blocks are drawn independently, not copies of one another
    wq = params["mlstm"]["wq"]
    assert not torch.equal(wq[0, 0], wq[0, 1])


def test_xlstm_model_without_device_does_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here, so the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_smoke_config(ARCH))


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def every4():
    return _pair({"slstm_every": 4}, seed=1)


def _jax_greedy(jcfg, jparams, jax_decode, toks, max_new):
    """The JAX model run alone on one request: prefill, then greedy decode."""
    logits, cache = jxm.prefill(jparams, jnp.asarray(toks[None], jnp.int32), jcfg)
    out = [int(np.asarray(logits[0, -1]).argmax())]
    while len(out) < max_new:
        logits, cache = jax_decode(jparams, cache, jnp.asarray([[out[-1]]], jnp.int32), jcfg)
        out.append(int(np.asarray(logits[0, -1]).argmax()))
    return out


def _assert_pool_clean(srv):
    st = srv.stats()
    assert st["live_publications"] == 0 and st["free_pages"] == srv.pool.num_pages
    srv.pool.check_invariants()


def test_server_tokens_match_jax_model_one_request_at_a_time(every4, jax_decode):
    jcfg, jparams, cfg, params = every4
    srv = InferenceServer(Model(cfg, device="cpu"), slots=2, max_seq=64, page_tokens=16)
    srv.load(params)
    rng = np.random.default_rng(4)
    reqs = [(f"r{i}", rng.integers(0, cfg.vocab_size, int(rng.integers(2, 20))))
            for i in range(5)]                          # 5 requests through 2 slots
    for rid, toks in reqs:
        srv.submit(Request(rid=rid, tokens=toks, max_new=6))
    res = srv.serve()
    assert sorted(res) == sorted(r for r, _ in reqs)
    for rid, toks in reqs:
        assert res[rid].tokens == _jax_greedy(jcfg, jparams, jax_decode, toks, 6), rid
    _assert_pool_clean(srv)
    assert srv.idle


def test_server_cancel_janitor(every4):
    _, _, cfg, params = every4
    srv = InferenceServer(Model(cfg, device="cpu"), slots=2, max_seq=64, page_tokens=16)
    srv.load(params)
    rng = np.random.default_rng(2)
    srv.submit(Request(rid="victim", tokens=rng.integers(0, cfg.vocab_size, 8), max_new=30))
    srv.submit(Request(rid="survivor", tokens=rng.integers(0, cfg.vocab_size, 8), max_new=4))
    srv.step_rounds()
    assert srv.cancel("victim")
    results = srv.serve()
    assert "survivor" in results and "victim" not in results
    _assert_pool_clean(srv)


def test_serve_entry_point_runs_xlstm_on_cpu_when_asked():
    from repro_torch.launch.serve import main

    out = main(["--arch", ARCH, "--size", "smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    assert out["completed"] == 3 and out["pool_clean"] and out["generated_tokens"] == 12
