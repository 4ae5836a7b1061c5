"""The dry run's surface on the port against the reference's: ``WORKLOADS``,
``supports``, ``abstract_params``, ``abstract_cache`` and ``input_specs``
(``meta`` tensors against ``jax.eval_shape``), the prefill and decode
step builders on bridged weights, and ``launch/dryrun.py`` with
``launch/roofline.py`` at smoke width."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import WORKLOADS as JAX_WORKLOADS
from repro.models import Model as JaxModel
from repro.models import Workload as JaxWorkload
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import HW
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import WORKLOADS, Model, Workload
from repro_torch.models.common import tree_items
from repro_torch.models.weights import params_from_numpy
from _port_env import port_test_env  # noqa: F401  (autouse)

TOL = 3e-5      # tests/test_kernels.py:17-18, f32


def _ref_leaves(tree, cfg) -> dict:
    """path -> (shape, dtype) of a reference tree in the port's layout: the
    dense and MoE families' stacked ``layers`` unstacked, as
    ``params_from_numpy`` maps them; the other families' as they are."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key, shape = jax.tree_util.keystr(path), tuple(leaf.shape)
        head = "['layers']"
        if cfg.family in ("dense", "moe") and key.startswith(head):
            for i in range(cfg.num_layers):
                out[f"{head}[{i}]{key[len(head):]}"] = (shape[1:], str(leaf.dtype))
        else:
            out[key] = (shape, str(leaf.dtype))
    return out


def _port_leaves(tree) -> dict:
    return {path: (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            for path, leaf in tree_items(tree)}


def test_workloads_and_supports_match_the_reference():
    assert {k: vars(w) for k, w in WORKLOADS.items()} == \
        {k: vars(w) for k, w in JAX_WORKLOADS.items()}
    for arch in ARCH_IDS:
        ref, port = JaxModel(jax_config(arch)), Model(get_config(arch), device="meta")
        for name in WORKLOADS:
            assert port.supports(WORKLOADS[name]) == ref.supports(JAX_WORKLOADS[name]), \
                (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_eval_shape_at_full_width(arch):
    """Leaf for leaf (shape and dtype) against ``jax.eval_shape`` of the
    reference's init, at the published config, all on ``meta``."""
    cfg = get_config(arch)
    params = Model(cfg, device="meta").abstract_params()
    assert all(leaf.is_meta for _, leaf in tree_items(params))
    assert _port_leaves(params) == _ref_leaves(JaxModel(jax_config(arch)).abstract_params(), cfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_and_input_specs_match_every_supported_cell(arch):
    """``input_specs`` of every cell the arch supports (the decode cells'
    caches at the reference's rounded capacity) and ``abstract_cache``."""
    ref, port = JaxModel(jax_config(arch)), Model(get_config(arch), device="meta")
    for name, wl in WORKLOADS.items():
        if not port.supports(wl)[0]:
            continue
        specs = port.input_specs(wl)
        assert all(leaf.is_meta for _, leaf in tree_items(specs))
        assert _port_leaves(specs) == _ref_leaves(ref.input_specs(JAX_WORKLOADS[name]),
                                                  port.cfg), name
    assert _port_leaves(port.abstract_cache(2, 300)) == \
        _ref_leaves(ref.abstract_cache(2, 300), port.cfg)


FAMILY_ARCHS = ["qwen2-1.5b", "qwen2-moe-a2.7b", "xlstm-1.3b", "zamba2-2.7b", "whisper-small",
                "llama-3.2-vision-90b"]


def _batches(cfg, b: int, s: int, seed: int):
    """The same prompt (and frames or vision input) for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    extra = {"whisper": ("frames", cfg.encoder_positions), "mllama": ("vision", cfg.vision_tokens)}
    if cfg.family in extra:
        key, n = extra[cfg.family]
        x = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
        jb[key], tb[key] = jnp.asarray(x), torch.from_numpy(x)
    return jb, tb


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_step_builders_match_the_reference(arch):
    """``make_prefill_step`` and ``make_decode_step`` on the smoke config
    with bridged weights: prefill logits within 3e-5 and every greedy token
    of 3 decode steps equal, each step fed the reference's token."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jm, model = JaxModel(jcfg), Model(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, cfg, "cpu")
    jb, tb = _batches(cfg, 2, 12, seed=1)
    jwl, wl = JaxWorkload("w", 20, 2, "prefill"), Workload("w", 20, 2, "prefill")
    jtree = jax.tree.map(jnp.asarray, tree)
    jlogits, jcache = jax.jit(jax_prefill_step(jm, jwl))(jtree, jb)
    logits, cache = make_prefill_step(model, wl)(params, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    jstep, step = jax.jit(jax_decode_step(jm)), make_decode_step(model)
    tok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    for i in range(3):
        jtok, jcache = jstep(jtree, jcache, tok)
        got, cache = step(params, cache, torch.from_numpy(np.array(tok)))
        assert got.dtype == torch.int32 and got.shape == (2, 1)
        assert np.array_equal(got.numpy(), np.asarray(jtok)), (arch, i)
        tok = jtok


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_on_smoke_configs_is_never_error(arch, tmp_path):
    """Every workload kind on the smoke config, reduced to B 2 x S 32 (the
    500k decode cell to a cache of 64): ``ok``, or ``skipped`` for the
    reference's reason; the record holds the reference's fields."""
    for name, wl in WORKLOADS.items():
        reduced = Workload(wl.name, 64 if name == "long_500k" else 32, 2, wl.kind)
        rec = dryrun.run_cell(arch, name, smoke=True, workload=reduced, out_dir=str(tmp_path))
        ok, why = Model(get_smoke_config(arch), device="meta").supports(reduced)
        assert rec["status"] == ("ok" if ok else "skipped"), rec.get("trace")
        if not ok:
            assert rec["why"] == why
            continue
        assert rec["n_devices"] == 1 and rec["mesh"] == "1"
        assert rec["flops"] == rec["costs"]["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["collectives"]["total_bytes"] == 0
        assert rec["memory"]["peak_memory_in_bytes"] >= rec["memory"]["argument_size_in_bytes"]
        assert rec["model_flops"] == dryrun._model_flops(get_smoke_config(arch), reduced)
    assert len(list(tmp_path.glob("*.json"))) == len(WORKLOADS)


def test_a_cell_that_raises_is_error_and_main_exits_1(tmp_path, monkeypatch):
    def planted(model, wl):
        raise RuntimeError("planted fault")

    monkeypatch.setattr(dryrun, "count_cell", planted)
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--smoke",
                     "--out", str(tmp_path)])
    assert exit_.value.code == 1
    rec = json.loads((tmp_path / "qwen2-1.5b__decode_32k__1.json").read_text())
    assert rec["status"] == "error" and "planted fault" in rec["error"]


def test_roofline_rows_from_the_records(tmp_path):
    """The roofline reads the records and writes its rows beside them: the
    compute term each product's FLOPs over its type's peak, the memory term
    the bytes over HBM's rate, no collective term."""
    for name in ("prefill_32k", "decode_32k"):
        dryrun.run_cell("xlstm-1.3b", name, smoke=True, out_dir=str(tmp_path),
                        workload=Workload(name, 32, 2, WORKLOADS[name].kind))
    rows = roofline.main(str(tmp_path))
    assert [r["shape"] for r in rows] == ["decode_32k", "prefill_32k"]
    for r in rows:
        rec = json.loads((tmp_path / f"xlstm-1.3b__{r['shape']}__1.json").read_text())
        c = rec["costs"]
        assert r["t_compute_s"] == pytest.approx(c["flops_bf16"] / HW.PEAK_BF16_FLOPS
                                                 + c["flops_f32"] / HW.PEAK_F32_FLOPS)
        assert r["t_memory_s"] == pytest.approx(c["bytes"] / HW.HBM_BW)
        assert r["t_collective_s"] == 0 and r["dominant"] in ("compute", "memory")
    assert json.loads((tmp_path / "roofline_1.json").read_text()) == rows
