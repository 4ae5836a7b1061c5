"""The port's dense transformer held against the JAX reference model on the
same weights (carried across with ``params_from_numpy``), plus the port's
package boundaries.

Model tolerance: 3e-5 (the f32 kernel tolerance of ``tests/test_kernels.py``)
on logits whose scale is O(1); greedy tokens and cache lengths must be
equal."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.qwen2_1_5b import smoke as jax_smoke
from repro.launch.train import model_100m as jax_model_100m
from repro.models import Model as JaxModel
from repro.models import ModelConfig as JaxModelConfig
from repro_torch.configs import get_config, get_smoke_config, model_100m
from repro_torch.models import Model, ModelConfig
from repro_torch.models.transformer import param_shapes
from repro_torch.kernels.rmsnorm.ops import _row_stride
from repro_torch.models.weights import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = 3e-5

NARROW = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=1024)
# the dense branches the qwen2 configs leave off (gemma-2b / qwen3-8b features)
VARIANTS = dict(NARROW, qk_norm=True, gemma_norm=True, embed_scale=True,
                mlp_act="geglu", tie_embeddings=False, qkv_bias=False)
CASES = {
    "qwen2-1.5b-smoke": (lambda: jax_smoke(), lambda: get_smoke_config("qwen2-1.5b")),
    "qwen2-1.5b-100m-2L": (lambda: jax_model_100m("qwen2-1.5b").scaled(**NARROW),
                           lambda: model_100m("qwen2-1.5b").scaled(**NARROW)),
    "dense-variants-100m-2L": (lambda: jax_model_100m("qwen2-1.5b").scaled(**VARIANTS),
                               lambda: model_100m("qwen2-1.5b").scaled(**VARIANTS)),
}


def _cfg_dict(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _perturb_norms(tree, rng):
    """Norm scales initialise to ones; give them seeded values so that a
    scale applied wrongly (or ``1 + scale`` for ``scale``) shows."""
    if isinstance(tree, dict):
        return {k: (v + rng.normal(0, 0.2, v.shape).astype(v.dtype)
                    if k in ("scale", "q_norm", "k_norm") else _perturb_norms(v, rng))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jcfg, cfg = CASES[request.param][0](), CASES[request.param][1]()
    jm = JaxModel(jcfg)
    tree = _perturb_norms(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                          np.random.default_rng(3))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, cfg, "cpu")
    return jm, jparams, Model(cfg, device="cpu"), params


def test_prefill_and_greedy_decode_match_jax(pair):
    jm, jparams, m, params = pair
    cfg = m.cfg
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 13))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, max_seq=32)
    tl, tc = m.prefill(params, {"tokens": torch.as_tensor(toks)}, max_seq=32)
    assert tl.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    # the prompt's K/V landed in the cache as the reference wrote them
    np.testing.assert_allclose(tc["k"][:, :, :13].numpy(), np.asarray(jc["k"])[:, :, :13],
                               atol=TOL, rtol=TOL)
    for _ in range(8):
        nxt = np.asarray(jl[:, -1]).argmax(-1)[:, None]
        assert np.array_equal(nxt, tl[:, -1].argmax(-1, keepdim=True).numpy())
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt, jnp.int32))
        tl, tc = m.decode_step(params, tc, torch.as_tensor(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert int(tc["len"][0]) == 13 + 8


@pytest.mark.parametrize("case", ["qwen2-1.5b-smoke", "dense-variants-100m-2L"])
def test_every_norm_goes_through_fused_rmsnorm(case, monkeypatch):
    """The fusion plan, pinned on the CPU: one prefill and one decode step
    each call ``fused_rmsnorm`` 2L + 1 times (ln1, ln2, the final norm; all
    but layer 0's ln1 with the residual add fused in) and the plain
    ``rms_norm`` only for the per-head ``qk_norm``."""
    from repro_torch.models import transformer

    cfg = CASES[case][1]()
    m = Model(cfg, device="cpu")
    params = m.init(0)
    calls = {"fused": [], "rms_norm": 0}
    fused, plain_norm = transformer.fused_rmsnorm, transformer.rms_norm

    def counted(x, residual, scale, **kw):
        # every input is rows the kernel reads on the card (raises otherwise)
        for t in (x, residual) if residual is not None else (x,):
            _row_stride(t, t.shape[-1], "input")
        calls["fused"].append(residual is not None)
        return fused(x, residual, scale, **kw)

    def counted_rms_norm(*args, **kw):
        calls["rms_norm"] += 1
        return plain_norm(*args, **kw)

    monkeypatch.setattr(transformer, "fused_rmsnorm", counted)
    monkeypatch.setattr(transformer, "rms_norm", counted_rms_norm)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)))
    logits, cache = m.prefill(params, {"tokens": toks}, max_seq=16)
    n = cfg.num_layers
    assert len(calls["fused"]) == 2 * n + 1
    assert calls["fused"].count(False) == 1           # layer 0's ln1: the norm alone
    m.decode_step(params, cache, logits[:, -1].argmax(-1, keepdim=True))
    assert len(calls["fused"]) == 2 * (2 * n + 1)
    assert calls["rms_norm"] == (4 * n if cfg.qk_norm else 0)


def test_config_mirrors_reference():
    """``ModelConfig`` mirrors the reference field for field, and the ported
    configs equal the reference's."""
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxModelConfig)]
    assert _cfg_dict(get_config("qwen2-1.5b")) == _cfg_dict(jax_get_config("qwen2-1.5b"))
    assert _cfg_dict(model_100m("qwen2-1.5b")) == _cfg_dict(jax_model_100m("qwen2-1.5b"))
    cfg = get_config("qwen2-1.5b")
    assert (cfg.pdt, cfg.cdt) == (torch.bfloat16, torch.bfloat16)
    assert cfg.head_dim == 128 and cfg.scaled(head_dim=0).head_dim == 1536 // 12


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("llama3-8b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    moe = get_smoke_config("qwen2-1.5b").scaled(family="moe")
    with pytest.raises(NotImplementedError, match="MoE"):
        Model(moe, device="cpu")


def test_params_from_numpy_bf16_round_trip():
    """JAX bf16 leaves arrive as ml_dtypes arrays, which torch.from_numpy
    refuses; they go through f32 and back to bf16, exactly."""
    jcfg = jax_smoke().scaled(param_dtype="bfloat16")
    cfg = get_smoke_config("qwen2-1.5b").scaled(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(1)))
    params = params_from_numpy(tree, cfg, "cpu")
    wq = params["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.float().numpy(),
                                  tree["layers"]["attn"]["wq"][1].astype(np.float32))
    assert params["layers"][0]["ln1"]["scale"].dtype == torch.float32
    # every leaf mapped, with the port's own shapes
    assert len(params["layers"]) == cfg.num_layers
    spec = param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in params["layers"][0]["mlp"].items()} == \
        spec["layers"][0]["mlp"]


def test_params_from_numpy_rejects_mismatched_trees():
    cfg = get_smoke_config("qwen2-1.5b")
    tree = jax.tree.map(np.asarray, JaxModel(jax_smoke()).init(jax.random.PRNGKey(2)))
    bad = dict(tree, layers=dict(tree["layers"], extra={"w": np.zeros((2, 3))}))
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, cfg.scaled(d_model=64), "cpu")


def test_port_init_matches_param_shapes():
    cfg = get_smoke_config("qwen2-1.5b")
    params = Model(cfg, device="cpu").init(0)
    spec = param_shapes(cfg)
    assert tuple(params["tok_embed"].shape) == spec["tok_embed"]
    assert "lm_head" not in params                     # tied embeddings
    for got, want in zip(params["layers"], spec["layers"]):
        assert {k: tuple(v.shape) for k, v in got["attn"].items()} == want["attn"]


def test_model_without_device_does_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here, so the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_smoke_config("qwen2-1.5b"))


def test_port_sources_import_no_jax_or_reference():
    """No file of the port, nor chip_smoke.py, imports jax or ``repro``; nor,
    since every kernel is CUDA C++, ``triton``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro", "flax", "triton"), \
                    f"{path.relative_to(ROOT)}: {s}"


def test_port_modules_load_no_jax_in_a_fresh_process():
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch.runtime.server, repro_torch.launch.serve\n"
        "import repro_torch.models.xlstm_model, repro_torch.configs.xlstm_1_3b\n"
        "import repro_torch.kernels.slstm_scan.ops, repro_torch.kernels.ragged_concat.ops\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 20 and bad.strip() == "[]", out.stdout
