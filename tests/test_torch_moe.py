"""The port's MoE layer (``repro_torch.models.mlp``) held against the JAX
reference's (``repro.models.mlp``) on the same numpy inputs, and the
properties ``tests/test_moe_dispatch.py`` pins on the reference, on the
port.

Tolerances: 3e-5 in f32 and 2e-2 in bf16 (``tests/test_kernels.py``);
the routes themselves (top-k expert ids) must be equal.  The mesh
branches (``_moe_serving``, expert parallelism) are held against the
reference in ``tests/test_torch_sharding.py``, on meshes of one rank and
on spawned ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as jax_mlp
from repro.models.common import ModelConfig as JaxModelConfig
from repro_torch.models import mlp
from repro_torch.models.common import ModelConfig
from _port_env import port_test_env  # noqa: F401  (autouse)

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(**kw):
    """The same config for both packages (tests/test_moe_dispatch.py's)."""
    base = dict(name="t", family="moe", num_layers=1, d_model=32, num_heads=2,
                num_kv_heads=2, d_ff=16, vocab_size=64, head_dim=16, num_experts=8,
                top_k=2, param_dtype="float32", compute_dtype="float32",
                moe_capacity_factor=4.0)   # generous: no token drops
    base.update(kw)
    return JaxModelConfig(**base), ModelConfig(**base)


def _params(cfg, seed: int, dtype: str = "float32", e: int | None = None) -> dict:
    """Numpy leaves of the reference's tree, ``e`` experts (default the
    config's); expert weights and the shared MLP rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, e or cfg.num_experts

    def w(*shape, fan):
        a = (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)
        return a if dtype == "float32" else np.asarray(jnp.asarray(a, jnp.bfloat16)
                                                       .astype(jnp.float32))

    p = {"router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32),
         "e_gate": w(e, d, f, fan=d), "e_up": w(e, d, f, fan=d), "e_down": w(e, f, d, fan=f)}
    if cfg.num_shared_experts:
        fs = cfg.d_ff_shared
        p["shared"] = {"w_gate": w(d, fs, fan=d), "w_up": w(d, fs, fan=d),
                       "w_down": w(fs, d, fan=fs),
                       "shared_gate": rng.standard_normal(d).astype(np.float32) / np.sqrt(d)}
    return p


def _both(p: dict, dtype: str = "float32"):
    """The numpy tree as JAX arrays and as torch tensors; the router and
    the shared gate stay f32, as the reference keeps them."""
    jdt, tdt = DT[dtype]

    def conv(tree, f):
        return {k: conv(v, f) if isinstance(v, dict) else
                f(v, k in ("router", "shared_gate")) for k, v in tree.items()}

    return (conv(p, lambda a, f32: jnp.asarray(a, jnp.float32 if f32 else jdt)),
            conv(p, lambda a, f32: torch.from_numpy(a.copy()).to(
                torch.float32 if f32 else tdt)))


def _x(t: int, d: int, seed: int, dtype: str = "float32"):
    a = np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)
    return jnp.asarray(a, DT[dtype][0]), torch.from_numpy(a).to(DT[dtype][1])


def _layer(fn_j, fn_t, pj, pt, xj, xt, jcfg, cfg, **kw):
    jo, jaux = fn_j(xj, pj["router"], pj["e_gate"], pj["e_up"], pj["e_down"], cfg=jcfg,
                    axis_name=None, **kw)
    to, taux = fn_t(xt, pt["router"], pt["e_gate"], pt["e_up"], pt["e_down"], cfg=cfg, **kw)
    return (np.asarray(jo.astype(jnp.float32)), float(jaux)), (to.float().numpy(), float(taux))


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (37, 60, 4), (48, 128, 8)])
def test_route_matches_reference(t, e, k):
    """The f32 router's softmax, descending top-k and renormalised weights:
    the same experts in the same order (qwen2-moe's 60 top-4 and
    qwen3-moe's 128 top-8 among them)."""
    jcfg, cfg = _cfgs(num_experts=e, top_k=k)
    p = _params(cfg, seed=1)
    xj, xt = _x(t, cfg.d_model, seed=2)
    probs, top_p, top_e = mlp._route(xt, torch.from_numpy(p["router"]), k, None)
    jprobs = jax.nn.softmax(xj @ jnp.asarray(p["router"]), axis=-1)
    jtop_p, jtop_e = jax.lax.top_k(jprobs, k)
    _close(probs.numpy(), np.asarray(jprobs))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    _close(top_p.numpy(), np.asarray(jtop_p / jtop_p.sum(-1, keepdims=True)))
    assert bool((top_p[:, :-1] >= top_p[:, 1:]).all())


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (37, 60, 4), (48, 16, 4)])
def test_moe_local_matches_reference(t, e, k):
    """The dropless path: output and aux loss within 3e-5 of the reference's
    ``_moe_local`` (its ``ragged_dot`` grouped GEMMs)."""
    jcfg, cfg = _cfgs(num_experts=e, top_k=k)
    pj, pt = _both(_params(cfg, seed=3))
    xj, xt = _x(t, cfg.d_model, seed=4)
    (jo, jaux), (to, taux) = _layer(jax_mlp._moe_local, mlp._moe_local, pj, pt, xj, xt,
                                    jcfg, cfg, n_local=e, offset=0)
    _close(to, jo)
    _close(taux, jaux)


@pytest.mark.parametrize("factor,t", [(4.0, 64), (1.25, 256), (0.5, 200)])
def test_moe_local_capacity_matches_reference(factor, t):
    """The capacity path at a generous factor, qwen2-moe's 1.25 and one
    that drops pairs: output and aux loss within 3e-5 of the reference's
    ``_moe_local_capacity``, drops included."""
    jcfg, cfg = _cfgs(moe_capacity_factor=factor)
    pj, pt = _both(_params(cfg, seed=5))
    xj, xt = _x(t, cfg.d_model, seed=6)
    (jo, jaux), (to, taux) = _layer(jax_mlp._moe_local_capacity, mlp._moe_local_capacity,
                                    pj, pt, xj, xt, jcfg, cfg, n_local=8, offset=0)
    _close(to, jo)
    _close(taux, jaux)


@pytest.mark.parametrize("b,s,shared,factor", [
    (2, 8, 0, 1.25),        # 8 experts see 4 rows each: dropless
    (2, 160, 0, 1.25),      # 80 rows each: the capacity path
    (1, 13, 2, 0.0),        # shared experts, factor 0: always dropless
    (2, 160, 1, 1.25),      # shared experts on the capacity path
])
def test_moe_ffn_matches_reference(b, s, shared, factor):
    """``moe_ffn`` on (B, S, D): the same path switch (B*S*k/E >= 64), the
    shared experts' sigmoid gate, output within 3e-5; the aux loss only
    when asked for, equal to the reference's."""
    jcfg, cfg = _cfgs(num_shared_experts=shared, d_ff_shared=48 * bool(shared),
                      moe_capacity_factor=factor)
    pj, pt = _both(_params(cfg, seed=7))
    a = np.random.default_rng(8).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jo, jaux = jax_mlp.moe_ffn(pj, jnp.asarray(a), cfg=jcfg)
    to, none = mlp.moe_ffn(pt, torch.from_numpy(a), cfg=cfg)
    assert none is None and to.shape == (b, s, cfg.d_model)
    _close(to.numpy(), np.asarray(jo))
    _, taux = mlp.moe_ffn(pt, torch.from_numpy(a), cfg=cfg, aux=True)
    _close(float(taux), float(jaux))


def test_moe_ffn_takes_the_reference_path(monkeypatch):
    """The switch: capacity when the factor is positive and experts see at
    least 64 rows on average, else dropless."""
    _, cfg = _cfgs(moe_capacity_factor=1.25)
    pt = _both(_params(cfg, seed=9))[1]
    taken = []
    for name in ("_moe_local", "_moe_local_capacity"):
        fn = getattr(mlp, name)
        monkeypatch.setattr(mlp, name, lambda *a, _fn=fn, _n=name, **kw: (taken.append(_n),
                                                                           _fn(*a, **kw))[1])
    for (b, s), want in (((1, 255), "_moe_local"), ((1, 256), "_moe_local_capacity"),
                         ((2, 128), "_moe_local_capacity")):
        taken.clear()
        mlp.moe_ffn(pt, torch.zeros(b, s, cfg.d_model), cfg=cfg)
        assert taken == [want], (b, s)
    taken.clear()
    mlp.moe_ffn(pt, torch.zeros(1, 512, cfg.d_model), cfg=cfg.scaled(moe_capacity_factor=0.0))
    assert taken == ["_moe_local"]


def test_capacity_matches_dropless_when_no_drops():
    _, cfg = _cfgs()
    pt = _both(_params(cfg, seed=0))[1]
    xt = _x(64, cfg.d_model, seed=1)[1]
    args = (xt, pt["router"], pt["e_gate"], pt["e_up"], pt["e_down"])
    out_d, aux_d = mlp._moe_local(*args, cfg=cfg, n_local=8)
    out_c, aux_c = mlp._moe_local_capacity(*args, cfg=cfg, n_local=8)
    _close(out_c.numpy(), out_d.numpy())
    _close(float(aux_c), float(aux_d))


def test_capacity_drops_overflow_gracefully():
    """Capacity near 0: heavy oversubscription stays finite, every pair past
    the 128-row floor is dropped, and the reference drops the same ones."""
    jcfg, cfg = _cfgs(moe_capacity_factor=0.001)
    pj, pt = _both(_params(cfg, seed=0))
    xj, xt = _x(2048, cfg.d_model, seed=2)
    (jo, jaux), (to, taux) = _layer(jax_mlp._moe_local_capacity, mlp._moe_local_capacity,
                                    pj, pt, xj, xt, jcfg, cfg, n_local=8, offset=0)
    assert np.isfinite(to).all() and np.isfinite(taux)
    dropless = mlp._moe_local(xt, pt["router"], pt["e_gate"], pt["e_up"], pt["e_down"],
                              cfg=cfg, n_local=8)[0].numpy()
    assert np.abs(to - dropless).max() > 0.1      # 4096 pairs into 8 x 128 rows: drops
    _close(to, jo)


def test_expert_padding_masks_phantoms():
    """6 experts padded to 8 with zero weights: the phantoms never win, and
    the padded layer equals the unpadded one (and the reference's)."""
    jcfg, cfg = _cfgs(num_experts=6, top_k=2, moe_capacity_factor=0.0)
    p6 = _params(cfg, seed=3)
    pad = {k: np.concatenate([v, np.zeros((2,) + v.shape[1:], v.dtype)]) if k != "router"
           else np.concatenate([v, np.full((v.shape[0], 2), 5.0, np.float32)], 1)
           for k, v in p6.items()}       # phantom router columns that would win unmasked
    (pj, pt), (pj6, pt6) = _both(pad), _both(p6)
    xj, xt = _x(32, cfg.d_model, seed=4)
    _, _, top_e = mlp._route(xt, pt["router"], 2, 6)
    assert int(top_e.max()) < 6
    (jo, _), (to, _) = _layer(jax_mlp._moe_local, mlp._moe_local, pj, pt, xj, xt, jcfg, cfg,
                              n_local=8, offset=0, e_valid=6)
    ref = mlp._moe_local(xt, pt6["router"], pt6["e_gate"], pt6["e_up"], pt6["e_down"],
                         cfg=cfg, n_local=6)[0].numpy()
    _close(to, ref)
    _close(to, jo)


@pytest.mark.parametrize("fn", ["_moe_local", "_moe_local_capacity"])
def test_shard_overflow_bucket_matches_reference(fn):
    """One shard's view: experts [4, 8) of 8 (``offset`` 4, ``n_local`` 4).
    Pairs routed to other shards go to the overflow bucket and add nothing;
    the shards' outputs sum to the whole layer's."""
    jcfg, cfg = _cfgs(moe_capacity_factor=4.0)
    p = _params(cfg, seed=5)
    xj, xt = _x(64, cfg.d_model, seed=6)
    parts = []
    for offset in (0, 4):
        sl = {k: v if k == "router" else v[offset:offset + 4] for k, v in p.items()}
        pj, pt = _both(sl)
        pj["router"], pt["router"] = jnp.asarray(p["router"]), torch.from_numpy(p["router"])
        (jo, _), (to, _) = _layer(getattr(jax_mlp, fn), getattr(mlp, fn), pj, pt, xj, xt,
                                  jcfg, cfg, n_local=4, offset=offset)
        _close(to, jo)
        parts.append(to)
    pt = _both(p)[1]
    whole = getattr(mlp, fn)(xt, pt["router"], pt["e_gate"], pt["e_up"], pt["e_down"],
                             cfg=cfg, n_local=8)[0].numpy()
    _close(parts[0] + parts[1], whole)


@pytest.mark.parametrize("fn,t", [("_moe_local", 64), ("_moe_local_capacity", 256)])
def test_bf16_layer_matches_jax_bf16(fn, t):
    """bf16 activations and expert weights (the router in f32): within
    2e-2 of the reference's bf16 layer."""
    jcfg, cfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16",
                      moe_capacity_factor=1.25)
    pj, pt = _both(_params(cfg, seed=10, dtype="bfloat16"), "bfloat16")
    xj, xt = _x(t, cfg.d_model, seed=11, dtype="bfloat16")
    (jo, jaux), (to, taux) = _layer(getattr(jax_mlp, fn), getattr(mlp, fn), pj, pt, xj, xt,
                                    jcfg, cfg, n_local=8, offset=0)
    _close(to, jo, "bfloat16")
    _close(taux, jaux, "bfloat16")


def test_init_moe_tree_matches_reference_shapes():
    """The port's ``init_moe`` draws the reference's tree: the same leaves,
    shapes and dtypes (router and shared gate f32)."""
    for shared in (0, 4):
        jcfg, cfg = _cfgs(num_shared_experts=shared, d_ff_shared=40 * bool(shared),
                          param_dtype="bfloat16")
        jt = jax_mlp.init_moe(jax.random.PRNGKey(0), jcfg)
        tt = mlp.init_moe(torch.Generator().manual_seed(0), cfg)
        flat = lambda tr, f: {k: (flat(v, f) if isinstance(v, dict) else f(v))  # noqa: E731
                              for k, v in tr.items()}
        assert flat(tt, lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1])) == \
            flat(jt, lambda a: (tuple(a.shape), str(a.dtype)))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_server_greedy_tokens_match_jax_server(arch):
    """The MoE smoke configs behind the continuous-batching server: 3
    ragged requests through 2 slots give the JAX server's greedy tokens on
    the same weights (each decode round routes the busy slots' tokens and
    the idle ones' together, as the reference's does)."""
    from repro.configs import get_smoke_config as jax_get_smoke_config
    from repro.models import Model as JaxModel
    from repro.runtime import InferenceServer as JaxServer
    from repro.runtime import Request as JaxRequest
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.runtime import InferenceServer, Request

    jm = JaxModel(jax_get_smoke_config(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    kw = dict(slots=2, max_seq=64, page_tokens=16)
    jsrv, srv = JaxServer(jm, **kw), InferenceServer(Model(cfg, device="cpu"), **kw)
    jsrv.load(jparams)
    srv.load(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    rng = np.random.default_rng(1)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 30)))
        jsrv.submit(JaxRequest(rid=f"r{i}", tokens=toks, max_new=5))
        srv.submit(Request(rid=f"r{i}", tokens=toks, max_new=5))
    jres, res = jsrv.serve(), srv.serve()
    assert sorted(res) == sorted(jres) and len(res) == 3
    for rid in res:
        assert res[rid].tokens == jres[rid].tokens, rid


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_serve_entry_point_runs_moe_archs_on_cpu(arch):
    """``launch.serve --arch <moe> --size smoke --device cpu`` end to end,
    with the depth cut ``--layers`` that serves qwen3-moe on one card."""
    from repro_torch.launch.serve import main

    out = main(["--arch", arch, "--size", "smoke", "--device", "cpu", "--layers", "2",
                "--requests", "3", "--max-new", "4"])
    assert out["completed"] == 3 and out["pool_clean"] and out["generated_tokens"] == 12
