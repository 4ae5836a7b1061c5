"""The port's mesh (``repro_torch.sharding``, ``launch/mesh.py``, the
sharding helpers of ``launch/steps.py``, the MoE layer's mesh branches,
``Checkpointer.restore(shardings=...)`` and ``Trainer(mesh=...)``) held
against the JAX reference on the same numpy inputs.

* Specs: for every arch at full width on abstract params (``meta`` here,
  ``jax.eval_shape`` there), on abstract 16x16, 2x16x16 and 1x1 meshes,
  under the default, decode and train rules, the param, cache and batch
  specs equal the reference's leaf for leaf (a stacked ``layers`` axis the
  port unstacks is always ``None`` in the reference's spec and is dropped).
* Meshes of size 1 (one ``gloo`` rank): the MoE layer's two mesh branches
  against the reference's ``moe_ffn`` at 3e-5 (f32), the trainer with and
  without a mesh, a resume restored through shardings.
* Spawned ``gloo`` ranks (``tests/_mesh_ranks.py``): the collectives at 4
  ranks against numpy, the expert-parallel layer at ``model`` = 2 (8
  experts as blocks and whole, 7 with a phantom; dropless and capacity)
  and ``_moe_serving`` at 4 ranks on (1, 2, 2) and (2, 2, 1) against the
  reference's no-mesh layer on every rank.  On (2, 2, 1) the reference's
  own ``_moe_serving`` hands ranks (pod 0, data 1) and (pod 1, data 0)
  each other's tokens (ROADMAP.md Queue 3); the port's order is pinned
  here.
"""

import datetime
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.launch import steps as jax_steps
from repro.models import WORKLOADS as JAX_WORKLOADS
from repro.models import Model as JaxModel
from repro.models import mlp as jax_mlp
from repro.models.common import ModelConfig as JaxModelConfig
from repro.sharding import MeshContext as JaxMeshContext
from repro.sharding import param_partition_specs as jax_param_specs
from repro.sharding.partition import unmatched_param_leaves as jax_unmatched
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, model_100m
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import WORKLOADS, Model, mlp
from repro_torch.models.common import ModelConfig, tree_items
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding import (AbstractMesh, MeshContext, NamedSharding, P,
                                  logical_to_spec, param_partition_specs, psum, shard_map,
                                  unmatched_param_leaves, use_mesh)
from repro_torch.sharding.partition import COLLECTIVE_CALLS, map_specs
from _mesh_ranks import run_ranks
from _port_env import port_test_env  # noqa: F401  (autouse)

TOL = 3e-5      # tests/test_kernels.py:17-18, f32

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model"))]
_LAYER = re.compile(r"^\['layers'\]\[\d+\]")


# ---------------------------------------------------------------------------
# specs against the reference
# ---------------------------------------------------------------------------


def _jax_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


def _jax_ranks(tree) -> dict:
    return {jax.tree_util.keystr(p): len(leaf.shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fold(path: str, family: str) -> str:
    """The dense and MoE families' unstacked layer index taken out of a
    port path, which is then the reference's stacked path."""
    return _LAYER.sub("['layers']", path) if family in ("dense", "moe") else path


def _port_specs(tree, family: str) -> dict:
    """path -> spec, folded paths (every layer must give the same spec)."""
    out: dict = {}
    for path, spec in _spec_paths(tree):
        path = _fold(path, family)
        assert out.setdefault(path, tuple(spec)) == tuple(spec), path
    return out


def _spec_paths(tree, prefix=""):
    if isinstance(tree, P):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], f"{prefix}[{k!r}]")
    else:
        for i, v in enumerate(tree):
            yield from _spec_paths(v, f"{prefix}[{i}]")


def _same(port: dict, ref: dict, port_tree, ref_tree, family: str, what) -> None:
    """The port's spec is the reference's less its leading entries where the
    port unstacks a layer axis; those entries are ``None``."""
    assert set(port) == set(ref), what
    ranks = {_fold(p, family): leaf.dim() for p, leaf in tree_items(port_tree)}
    ref_ranks = _jax_ranks(ref_tree)
    for path, spec in port.items():
        want, lead = ref[path], ref_ranks[path] - ranks[path]
        assert all(x is None for x in want[:lead]), (what, path, want)
        assert spec == want[lead:], (what, path, spec, want)


def _jax_mesh_shim(mesh):
    """``decode_rules`` reads ``mesh.devices.shape``, which an abstract mesh
    lacks."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 devices=np.empty(tuple(mesh.shape.values())))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference_for_every_mesh_and_rule_set(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    model, ref = Model(cfg, device="meta"), JaxModel(jcfg)
    params, jparams = model.abstract_params(), ref.abstract_params()
    dec = WORKLOADS["decode_32k"]
    cap = -(-(dec.seq_len + 1) // 256) * 256
    cache, jcache = model.abstract_cache(dec.global_batch, cap), \
        ref.abstract_cache(dec.global_batch, cap)
    batch = model.input_specs(WORKLOADS["train_4k"])
    jbatch = ref.input_specs(JAX_WORKLOADS["train_4k"])
    for shape, names in MESHES:
        mesh = AbstractMesh(shape, names)
        jmesh = jax.sharding.AbstractMesh(shape, names)
        rule_sets = {
            "default": ({}, {}),
            "decode": (steps.decode_rules(cfg, mesh),
                       jax_steps.decode_rules(jcfg, _jax_mesh_shim(jmesh))),
            "train": (steps.train_rules(cfg, mesh), jax_steps.train_rules(jcfg, jmesh)),
        }
        for rname, (rules, jrules) in rule_sets.items():
            what = (arch, shape, rname)
            assert rules == jrules, what
            ctx, jctx = MeshContext(mesh, rules), JaxMeshContext(jmesh, jrules)
            _same(_port_specs(param_partition_specs(params, ctx), cfg.family),
                  _jax_specs(jax_param_specs(jparams, jctx)), params, jparams, cfg.family,
                  what + ("params",))
            _same(_port_specs(steps.cache_partition_specs(cache, ctx), "cache"),
                  _jax_specs(jax_steps.cache_partition_specs(jcache, jctx)), cache, jcache,
                  "cache", what + ("cache",))
            _same(_port_specs(steps.batch_specs(cfg, batch, ctx), "batch"),
                  _jax_specs(jax_steps.batch_specs(jcfg, jbatch, jctx)), batch, jbatch,
                  "batch", what + ("batch",))
    got = sorted({_fold(p, cfg.family) for p in unmatched_param_leaves(params)})
    assert got == sorted(jax_unmatched(jparams))


def test_partition_spec_helpers_and_abstract_meshes():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    ctx = MeshContext(mesh, {})
    assert ctx.rule("batch") == ("data",)              # no pod axis in this mesh
    assert logical_to_spec(("batch", "embed"), (8, 6), ctx) == P("data")   # data taken
    spec = P(("data", "model"), None)
    sh = NamedSharding(mesh, spec)
    assert sh.shard_shape((16, 3)) == (2, 3)
    t = torch.arange(48).reshape(16, 3)
    blocks = [NamedSharding(AbstractMesh((2, 4), ("data", "model"), (d, m)), spec).block(t)
              for d in range(2) for m in range(4)]
    assert torch.equal(torch.cat(blocks), t)            # row-major over (data, model)
    with pytest.raises(ValueError, match="split"):
        sh.shard_shape((6, 3))
    with pytest.raises(ValueError, match="coordinate"):
        sh.block(t)
    assert repr(P("data", None)) == "P('data', None)"
    assert isinstance(make_production_mesh(), AbstractMesh)
    m = make_production_mesh(multi_pod=True)
    assert (m.shape, m.mesh_dim_names) == ((2, 16, 16), ("pod", "data", "model"))


def test_make_mesh_needs_a_group_of_its_size():
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# one gloo rank: meshes of size 1
# ---------------------------------------------------------------------------


@pytest.fixture
def group1():
    """A process group of one ``gloo`` rank, destroyed after the test (the
    xdist worker runs other files after this one)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_make_mesh_checks_the_world_size(group1):
    with pytest.raises(ValueError, match="world"):
        make_mesh((2, 1), ("data", "model"), device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="abstract|process group"):
        shard_map(lambda: psum(torch.ones(1), "data"), mesh=AbstractMesh((1,), ("data",)))()
    x = torch.ones(1, requires_grad=True)     # a collective with a gradient: psum's is 1
    shard_map(lambda: (psum(x, "data") * 3.0).sum().backward(), mesh=mesh)()
    assert torch.equal(x.grad, torch.full((1,), 3.0))


def _moe_cfgs(**kw):
    base = dict(name="t", family="moe", num_layers=1, d_model=32, num_heads=2,
                num_kv_heads=2, d_ff=16, vocab_size=64, head_dim=16, num_experts=8,
                top_k=2, param_dtype="float32", compute_dtype="float32",
                moe_capacity_factor=0.0)
    base.update(kw)
    return base, JaxModelConfig(**base), ModelConfig(**base)


def _moe_params(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {"router": w(d, e, fan=d), "e_gate": w(e, d, f, fan=d), "e_up": w(e, d, f, fan=d),
         "e_down": w(e, f, d, fan=f)}
    if cfg.num_shared_experts:
        fs = cfg.d_ff_shared
        p["shared"] = {"w_gate": w(d, fs, fan=d), "w_up": w(d, fs, fan=d),
                       "w_down": w(fs, d, fan=fs), "shared_gate": w(d, fan=d)}
    return p


def _jax_tree(p):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in p.items()}


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in p.items()}


def _jax_moe(jcfg, p, x) -> np.ndarray:
    return np.asarray(jax_mlp.moe_ffn(_jax_tree(p), jnp.asarray(x), cfg=jcfg)[0])


@pytest.mark.parametrize("branch", ["serving", "expert_parallel"])
def test_moe_mesh_branches_on_a_mesh_of_size_1_match_the_reference(group1, branch):
    _, jcfg, cfg = _moe_cfgs(num_shared_experts=1, d_ff_shared=32)
    p = _moe_params(cfg, 3)
    x = np.random.default_rng(4).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    want = _jax_moe(jcfg, p, x)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    calls = dict(COLLECTIVE_CALLS)
    with torch.no_grad():
        if branch == "serving":
            with use_mesh(mesh, {"expert_ff": ("data",), "embed": ()}):
                got = mlp.moe_ffn(_torch_tree(p), torch.from_numpy(x), cfg=cfg)[0]
        else:   # model 1 takes the plain branch in moe_ffn: call the branch itself
            with use_mesh(mesh) as ctx:
                out = mlp._moe_expert_parallel(_torch_tree(p), torch.from_numpy(x), cfg=cfg,
                                               ctx=ctx)[0]
            sh = _torch_tree(p)["shared"]
            xt = torch.from_numpy(x)
            got = out + mlp.gated_mlp(sh, xt) * torch.sigmoid(xt @ sh["shared_gate"])[..., None]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert COLLECTIVE_CALLS["psum"] > calls.get("psum", 0)


def _trainer_cfg():
    return model_100m("qwen2-1.5b").scaled(num_layers=2, d_model=64, d_ff=128, vocab_size=512,
                                          num_heads=2, num_kv_heads=1, head_dim=32)


def _train(tmp, mesh, total: int, stop: int | None = None, ckpt_every: int = 2) -> Trainer:
    tc = TrainerConfig(batch=2, seq_len=64, total_steps=total, ckpt_every=ckpt_every, warmup=2,
                       lr=3e-3, ckpt_dir=str(tmp), zero_copy_data=False, log_every=100)
    t = Trainer(Model(_trainer_cfg(), device="cpu"), tc, mesh=mesh)
    t.run(stop)
    t.close()
    return t


def test_trainer_on_a_mesh_of_size_1_equals_the_run_without_one(group1, tmp_path):
    """Six steps with and without a (1, 1) mesh give the same losses and
    params; a resume on the mesh from a checkpoint saved without one,
    restored through the state's shardings, gives the uninterrupted run's
    losses at steps 5 and 6."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    plain = _train(tmp_path / "plain", None, 6)
    meshed = _train(tmp_path / "mesh", mesh, 6)
    assert [r["loss"] for r in meshed.metrics_log] == [r["loss"] for r in plain.metrics_log]
    for (p, a), (_, b) in zip(tree_items(plain.state["params"]),
                              tree_items(meshed.state["params"])):
        assert torch.equal(a, b), p
    _train(tmp_path / "resume", None, 6, stop=4)
    resumed = _train(tmp_path / "resume", mesh, 6)
    assert [r["step"] for r in resumed.metrics_log] == [5, 6]
    assert [r["loss"] for r in resumed.metrics_log] == \
        [r["loss"] for r in plain.metrics_log[4:]]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_trainer_refuses_a_mesh_it_cannot_run(shape):
    """Beyond world size 1 only the dense family trains (its runs are in
    ``test_torch_tensor_parallel.py``); an MoE model on a 2-way mesh, or a
    dense one with sequence-parallel activations, raises naming item 8c."""
    mesh = AbstractMesh(shape, ("data", "model"))
    moe = model_100m("qwen2-moe-a2.7b").scaled(num_layers=2)
    for cfg in (moe, _trainer_cfg().scaled(seq_shard_activations=True)):
        with pytest.raises(NotImplementedError, match="8c"):
            Trainer(Model(cfg, device="cpu"), TrainerConfig(), mesh=mesh)


def test_restore_reshards_onto_an_abstract_two_way_mesh(tmp_path):
    """Saved whole at world size 1, restored at each coordinate of a 2-way
    ``data`` mesh: the blocks concatenate to the saved leaves."""
    rng = np.random.default_rng(7)
    state = {"params": {"tok_embed": torch.from_numpy(rng.standard_normal((64, 32))),
                        "layers": [{"attn": {"wq": torch.from_numpy(
                            rng.standard_normal((32, 4, 8)))}}],
                        "final_norm": {"scale": torch.from_numpy(rng.standard_normal(32))}},
             "step": torch.tensor(3, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, state)
    got = []
    for c in range(2):
        mesh = AbstractMesh((2,), ("data",), coordinate=(c,))
        specs = {"params": param_partition_specs(state["params"], MeshContext(mesh, {})),
                 "step": P()}
        sh = steps.shardings_for(specs, mesh)
        like = {"params": map_specs(lambda s, t: torch.zeros(NamedSharding(mesh, s).shard_shape(
            t.shape), dtype=t.dtype), specs["params"], state["params"]),
            "step": torch.zeros((), dtype=torch.int32)}
        out, step, _ = ck.restore(like, shardings=sh)
        assert step == 3 and out is not None
        got.append(out)
    dims = {"tok_embed": 1, "wq": 0, "scale": 0}           # the dim "embed" (data) splits
    for (path, whole), (_, a), (_, b) in zip(tree_items(state["params"]),
                                             tree_items(got[0]["params"]),
                                             tree_items(got[1]["params"])):
        name = re.findall(r"'(\w+)'\]$", path)[0]
        assert a.shape[dims[name]] * 2 == whole.shape[dims[name]], path
        assert torch.equal(torch.cat([a, b], dims[name]), whole), path
    with pytest.raises(ValueError, match="block"):
        ck.restore({"params": state["params"], "step": state["step"]}, shardings=sh)


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------

COLLECTIVE_MESHES = {"4": ((4,), ("x",), ["x"]),
                     "2x2": ((2, 2), ("a", "b"), ["a", "b", ("a", "b"), ("b", "a")])}
SERVING_MESHES = [(1, 2, 2), (2, 2, 1)]
SERVING_RULES = {"expert_ff": ("data",), "embed": ()}


def _serving_case():
    kw, jcfg, cfg = _moe_cfgs(d_model=64, d_ff=32, num_shared_experts=1, d_ff_shared=64)
    p = _moe_params(cfg, 11)
    x = np.random.default_rng(12).standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    return kw, jcfg, p, x


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of 4 ranks: the collectives on (4,) and (2, 2), then
    ``_moe_serving`` on each of ``SERVING_MESHES`` with the params as
    the ranks' blocks; and the reference's no-mesh layer, computed here
    while they run."""
    kw, jcfg, p, x = _serving_case()
    cases = [(kw, shape, ("pod", "data", "model"), SERVING_RULES, p, x, True)
             for shape in SERVING_MESHES]
    jobs = [("collectives", m) for m in COLLECTIVE_MESHES.values()] + [("moe_mesh", (cases,))]
    out = run_ranks("several", 4, tmp_path_factory.mktemp("four"), jobs)
    return out, _jax_moe(jcfg, p, x)


@pytest.mark.parametrize("name", list(COLLECTIVE_MESHES))
def test_collectives_at_four_ranks_match_numpy(four_ranks, name):
    ranks, _ = four_ranks
    shape, names, axes_list = COLLECTIVE_MESHES[name]
    job = list(COLLECTIVE_MESHES).index(name)
    xs = [np.arange(6, dtype=np.float64).reshape(2, 3) + 10.0 * r for r in range(4)]
    coords = [dict(zip(names, r[job]["coords"])) for r in ranks]
    sizes = dict(zip(names, shape))
    for axes in axes_list:
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        for r, res in enumerate(ranks):
            got = res[job]["out"][axes if isinstance(axes, str) else tuple(axes)]
            # the members: ranks equal to this one off ``key``, row-major over key
            members = sorted((q for q in range(4)
                              if all(coords[q][a] == coords[r][a] for a in names
                                     if a not in key)),
                             key=lambda q: [coords[q][a] for a in key])
            index = 0
            for a in key:
                index = index * sizes[a] + coords[r][a]
            assert got["index"] == index == members.index(r), (name, axes, r)
            assert got["size"] == len(members)
            total = sum(xs[q] for q in members)
            np.testing.assert_array_equal(got["psum"].numpy(), total)
            np.testing.assert_allclose(got["pmean"].numpy(), total / len(members))
            np.testing.assert_array_equal(got["tiled"].numpy(),
                                          np.concatenate([xs[q] for q in members], 1))
            np.testing.assert_array_equal(got["stacked"].numpy(),
                                          np.stack([xs[q] for q in members]))
            np.testing.assert_array_equal(got["scalar"].numpy(),
                                          np.array([xs[q][0, 0] for q in members]))


@pytest.mark.parametrize("shape", SERVING_MESHES)
def test_moe_serving_at_four_ranks_equals_the_no_mesh_layer(four_ranks, shape):
    """Every rank's tokens through ``_moe_serving`` equal the reference's
    no-mesh layer at 3e-5: on (2, 2, 1) too, where the reference's own
    serving branch swaps the token blocks of ranks 1 and 2."""
    ranks, want = four_ranks
    case = SERVING_MESHES.index(shape)
    rows = set()
    for r, res in enumerate(ranks):
        got, first, calls = res[len(COLLECTIVE_MESHES)][case]
        np.testing.assert_allclose(got, want[first:first + got.shape[0]], atol=TOL, rtol=TOL,
                                   err_msg=f"rank {r} on {shape}")
        assert calls.get("all_gather", 0) > 0 and calls.get("psum", 0) > 0
        rows.add(first)
    pods_x_data = shape[0] * shape[1]
    assert len(rows) == pods_x_data          # each batch shard's own rows


EP_CASES = {"8-dropless-blocks": (8, 0.0, True), "8-dropless-whole": (8, 0.0, False),
            "7-dropless": (7, 0.0, False), "8-capacity-blocks": (8, 4.0, True),
            "7-capacity": (7, 4.0, False)}


def _ep_case(name):
    e, factor, blocks = EP_CASES[name]
    kw, jcfg, cfg = _moe_cfgs(num_experts=e, moe_capacity_factor=factor, num_shared_experts=1,
                              d_ff_shared=32)
    p = _moe_params(cfg, 21 + e)
    s = 160 if factor else 8               # capacity: 2*160*2/E >= 64 rows an expert
    x = np.random.default_rng(22).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    return kw, jcfg, p, x, blocks


@pytest.fixture(scope="module")
def two_ranks_ep(tmp_path_factory):
    """One spawn of 2 ranks, mesh (1, 2) ``("data", "model")``, the default
    rules (``model`` > 1: the expert-parallel branch) for every case."""
    cases, wants = [], []
    for name in EP_CASES:
        kw, jcfg, p, x, blocks = _ep_case(name)
        cases.append((kw, (1, 2), ("data", "model"), {}, p, x, blocks))
        wants.append(_jax_moe(jcfg, p, x))
    out = run_ranks("moe_mesh", 2, tmp_path_factory.mktemp("ep"), cases)
    return out, wants


@pytest.mark.parametrize("name", list(EP_CASES))
def test_expert_parallel_at_two_ranks_equals_the_no_mesh_layer(two_ranks_ep, name):
    """Experts over ``model`` = 2: 8 experts arriving as each rank's 4 (the
    spec shards them) or whole, 7 whole with one phantom expert; the
    dropless and the capacity path.  Both ranks equal the reference."""
    ranks, wants = two_ranks_ep
    case = list(EP_CASES).index(name)
    for r, res in enumerate(ranks):
        got, first, calls = res[case]
        assert first == 0 and got.shape == wants[case].shape     # no batch split
        np.testing.assert_allclose(got, wants[case], atol=TOL, rtol=TOL, err_msg=f"rank {r}")
        assert calls.get("psum", 0) > 0
