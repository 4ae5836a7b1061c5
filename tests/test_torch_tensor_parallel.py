"""The dense family trained on a mesh: tensor-parallel and FSDP layers with
differentiable collectives, the ``GradPlan``, the global gradient norm,
and ``Trainer`` with its checkpoint on a mesh, against the JAX reference.

One spawn of 4 ``gloo`` ranks on the CPU (``tests/_mesh_ranks.py``) runs
every case: the smoke configs of qwen2-1.5b (bias, tied embeddings; its 2
KV heads whole at ``model`` 4), llama3-8b, qwen3-8b (``qk_norm``) and
gemma-2b (MQA, ``1 + scale``, the embedding scale) on meshes (2, 2) and
(1, 4) ``("data", "model")``, (4, 1) and (2, 1, 2) ``("pod", "data",
"model")``, on the reference's weights bridged through numpy; three
planted faults; the collectives' gradients; and ``Trainer`` on (2, 2)
with a save, a resume and restores on (1, 4) and one rank.  The parent
assembles each rank's gradient blocks into global leaves and holds them
against ``jax.value_and_grad`` of the reference's ``Model.loss`` with no
mesh: the loss within 1e-5 relative, each gradient leaf within 3e-5 of
its largest magnitude (f32).  A last test runs the reference's own
``Trainer`` on a (2, 2) mesh of host devices in a subprocess.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh_ranks import run_ranks
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.data import BatchSpec as JaxBatchSpec
from repro.data import InProcessPipeline as JaxPipeline
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import BatchSpec, InProcessPipeline
from repro_torch.models import Model
from repro_torch.models.attention import kv_heads_for
from repro_torch.models.common import tree_items
from repro_torch.models.weights import params_from_numpy
from repro_torch.sharding import AbstractMesh, MeshContext, NamedSharding, leaf_spec
from _port_env import port_test_env  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-1.5b", "llama3-8b", "qwen3-8b", "gemma-2b")
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")), "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# (fault, arch, mesh): each must break the bound
FAULTS = {"wo_psum": ("llama3-8b", "2x2"), "q_norm_model": ("qwen3-8b", "1x4"),
          "pod_leaf": ("qwen2-1.5b", "2x1x2")}
B, S = 4, 16
LOSS_RTOL, GRAD_TOL = 1e-5, 3e-5
# Trainer on (2, 2): qwen2's smoke config, 3 steps, a checkpoint at step 2
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_TC = dict(batch=4, seq_len=16, lr=1e-3, warmup=1, total_steps=3, ckpt_every=2,
                ckpt_keep=3, zero_copy_data=False, log_every=100, seed=0)
PARAM_ATOL = 1e-3 * TRAIN_TC["lr"]        # a thousandth of one AdamW step's move
# the one spawn runs every case in about 40 s alone; under a loaded
# machine (the suite's parallel workers) it gets more room than the
# other spawns' 120 s
RANKS_JOIN_S = 360


def _tree(arch: str) -> dict:
    """The reference's init of ``arch``'s smoke config, numpy leaves, the
    norm scales and biases moved off their constant init (so their
    gradients say something)."""
    jm = JaxModel(jax_get_smoke_config(arch))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("scale", "norm", "'bq'", "'bk'", "'bv'")):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _tokens(arch: str) -> np.ndarray:
    cfg = get_smoke_config(arch)
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 4 ranks: every (arch, mesh) case and every fault, the
    collectives' gradients, and the Trainer on (2, 2)."""
    tmp = tmp_path_factory.mktemp("tp")
    cases = [(arch, *MESHES[m], _tree(arch), _tokens(arch), None)
             for arch in ARCHS for m in MESHES]
    cases += [(arch, *MESHES[m], _tree(arch), _tokens(arch), fault)
              for fault, (arch, m) in FAULTS.items()]
    out = run_ranks("several", 4, tmp, [("dense_mesh", (cases,)),
                                        ("autograd_collectives", ()),
                                        ("autograd_collectives_staged", ()),
                                        ("dense_trainer", (TRAIN_ARCH, TRAIN_TC,
                                                           str(tmp / "ckpt")))],
                    join_s=RANKS_JOIN_S)
    n = len(ARCHS) * len(MESHES)
    keys = [(a, m) for a in ARCHS for m in MESHES]
    return {"cases": {k: [r[0][i] for r in out] for i, k in enumerate(keys)},
            "faults": {f: [r[0][n + i] for r in out] for i, f in enumerate(FAULTS)},
            "collectives": [r[1] for r in out], "staged": [r[2] for r in out],
            "trainer": [r[3] for r in out],
            "ckpt": tmp / "ckpt"}


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's loss, gradient (the port's layout, global)
    and AdamW ``grad_norm`` with no mesh."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_smoke_config(arch)
        jm = JaxModel(jcfg)
        jparams = jax.tree.map(jnp.asarray, _tree(arch))
        jb = {"tokens": jnp.asarray(_tokens(arch))}
        loss, grads = jax.value_and_grad(lambda p: jm.loss(p, jb))(jparams)
        opt = JaxAdamW(lr=1e-3)
        _, metrics = opt.update(opt.init(jparams), grads)
        g = params_from_numpy(jax.tree.map(np.asarray, grads), get_smoke_config(arch), "cpu")
        out[arch] = (float(loss), dict(tree_items(g)), float(metrics["grad_norm"]))
    return out


def _specs(arch: str, shape, names) -> tuple:
    """(mesh, {path: (spec, global shape)}) of ``arch``'s params on an
    abstract mesh of ``shape``."""
    ctx = MeshContext(AbstractMesh(shape, names), {})
    whole = Model(get_smoke_config(arch), device="cpu").abstract_params(whole=True)
    return ctx.mesh, {p: (leaf_spec(p[p.rindex("['") + 2:-2], tuple(t.shape), ctx),
                          tuple(t.shape)) for p, t in tree_items(whole)}


def _assemble_tree(arch: str, shape, names, per_rank: list) -> dict:
    """Global leaves from each rank's blocks: ``per_rank`` holds (coords,
    {path: block}) pairs of a params tree or a Trainer's state (whose
    ``step`` is whole)."""
    mesh, specs = _specs(arch, shape, names)
    out = {}
    for coords, blocks in per_rank:
        for path, b in blocks.items():
            inner = path if path in specs else path[path.index("]") + 1:]
            if inner not in specs:               # the state's step
                out[path] = b
                continue
            spec, whole = specs[inner]
            t = out.setdefault(path, torch.full(whole, float("nan"), dtype=b.dtype))
            t[NamedSharding(mesh, spec).index(whole, coords)] = b
    return out


def _assemble(arch: str, mesh: str, per_rank: list) -> dict:
    """Global gradient leaves from each rank's blocks in a case's results."""
    return _assemble_tree(arch, *MESHES[mesh], [(r[0], r[3]) for r in per_rank])


def _worst(got: dict, want: dict) -> tuple[float, str]:
    """The largest gradient error over a leaf's largest magnitude, and its leaf."""
    errs = [(float((got[p] - w).abs().max() / w.abs().max().clamp(min=1e-30)), p)
            for p, w in want.items()]
    return max(errs)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_grad_norm_on_a_mesh_match_jax(ranks, reference, arch, mesh):
    """Every rank's loss is the global one (1e-5 relative), the assembled
    gradient of every leaf is within 3e-5 of its largest magnitude, and
    AdamW's global ``grad_norm`` equals the reference's metric (1e-5)."""
    per_rank = ranks["cases"][(arch, mesh)]
    want_loss, want, want_norm = reference[arch]
    for _, loss, norm, _, _ in per_rank:
        assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
        assert abs(norm - want_norm) <= LOSS_RTOL * want_norm, (norm, want_norm)
    got = _assemble(arch, mesh, per_rank)
    assert not any(torch.isnan(g).any() for g in got.values())      # every block came back
    err, leaf = _worst(got, want)
    assert err <= GRAD_TOL, (leaf, err)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_breaks_the_bound(ranks, reference, fault):
    arch, mesh = FAULTS[fault]
    per_rank = ranks["faults"][fault]
    want_loss, want, _ = reference[arch]
    loss_off = max(abs(r[1] - want_loss) / abs(want_loss) for r in per_rank)
    err, leaf = _worst(_assemble(arch, mesh, per_rank), want)
    assert loss_off > LOSS_RTOL or err > GRAD_TOL, (fault, loss_off, err, leaf)


def test_attention_sees_an_integral_group_at_model_4(ranks):
    """At ``model`` 4 the smoke configs' 4 query heads split 1 a rank; the
    KV heads do not tile the axis and stay whole, and each rank slices the
    one its query head reads: every K2 call sees H = 1 over KV = 1.  At
    ``model`` 2, qwen2's 2 KV heads split (2 over 1) and gemma's 1 stays
    whole (2 over 1).  ``kv_heads_for`` holds the full widths' plans."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for mesh, want in (("1x4", (1, 1)), ("2x2", (2, 1)), ("4x1", (4, cfg.num_kv_heads))):
            calls = {c for r in ranks["cases"][(arch, mesh)] for c in r[4]}
            assert calls == {want}, (arch, mesh, calls)
    assert [kv_heads_for(r, 3, 12, 2) for r in range(4)] == [(0, 1), (0, 1), (1, 1), (1, 1)]
    assert [kv_heads_for(r, 2, 32, 8)[0] for r in range(16)] == [r // 2 for r in range(16)]
    assert kv_heads_for(1, 4, 8, 2) == (1, 1)
    with pytest.raises(ValueError, match="integral"):
        kv_heads_for(1, 3, 8, 2)        # heads 3-5 read KV heads 0 and 1, unevenly


def test_collectives_have_their_gradients(ranks):
    """The collectives' backwards on mesh (2, 2): ``psum`` the identity,
    ``copy_to`` the psum of the gradient, ``pmean`` the gradient over 4,
    ``all_gather`` the gradient's reduce-scatter, ``constrain`` a slice
    whose backward gathers and a join whose backward slices."""
    res = ranks["collectives"]
    base = [torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10.0 * r for r in range(4)]
    w = torch.arange(1, 7, dtype=torch.float64).reshape(2, 3)

    def wy(shape, r):
        return torch.arange(int(np.prod(shape)), dtype=torch.float64).reshape(shape) + r

    for r, out in enumerate(res):
        d, m = out["coords"]
        row = [2 * d, 2 * d + 1]                     # the ranks of this rank's model group
        col = [m, 2 + m]                              # ... and of its data group
        y, g = out["psum"]
        assert torch.equal(y, base[row[0]] + base[row[1]]) and torch.equal(g, wy((2, 3), r))
        y, g = out["copy_to"]
        assert torch.equal(g, sum(wy((2, 3), q) * (1 + q) for q in row))
        y, g = out["pmean"]
        assert torch.allclose(y, sum(base) / 4) and torch.equal(g, wy((2, 3), r) / 4)
        y, g = out["tiled"]
        assert torch.equal(y, torch.cat([base[col[0]], base[col[1]]], dim=1))
        assert torch.equal(g, sum(wy((2, 6), q) for q in col)[:, 3 * d:3 * d + 3])
        y, g = out["stacked"]
        assert torch.equal(y, torch.stack(base)) and torch.equal(g, sum(wy((4, 2, 3), q)
                                                                        for q in range(4))[r])
        assert torch.equal(out["pmax"], base[3])
        y, g = out["slice"]
        assert torch.equal(y, base[r][d:d + 1]) and torch.equal(g, torch.cat([w[:1], w[:1]]))
        y, g = out["join"]
        assert torch.equal(y, torch.cat([base[col[0]][:1], base[col[1]][:1]]))
        assert torch.equal(g, w[d:d + 1])
        assert out["same"]


def test_collectives_through_host_buffers_equal_the_direct_ones(ranks):
    """A ``gloo`` group stages CUDA tensors through pinned host buffers
    (``launch.mesh.make_mesh``): the same collectives and gradients sent
    that way, every operand copied in (an all-reduce's in place), give
    the direct results bit for bit, and the staged bytes are counted."""
    for direct, staged in zip(ranks["collectives"], ranks["staged"]):
        bytes_ = staged.pop("staged_bytes")
        assert set(direct) == set(staged)
        for k, v in direct.items():
            w = staged[k]
            pairs = list(zip(v, w)) if isinstance(v, tuple) else [(v, w)]
            assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                       for a, b in pairs), k
        assert {"psum", "pmax", "all_gather", "reduce_scatter"} <= set(bytes_)
        assert all(n > 0 for n in bytes_.values())


# -- Trainer and checkpoint on a mesh ----------------------------------------------


def _to_reference(arch: str, port: dict) -> dict:
    """The port's parameter tree (global, unstacked) in the reference's
    layout: each layer leaf stacked over the layers."""
    out = {k: v.numpy() for k, v in port.items() if isinstance(v, torch.Tensor)}
    out.update({k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in port.items()
                if isinstance(v, dict)})
    layers = port["layers"]
    out["layers"] = {sub: {k: np.stack([layer[sub][k].numpy() for layer in layers])
                           for k in layers[0][sub]} for sub in layers[0]}
    return out


def _jax_train(arch: str, steps: int):
    """The reference's ``make_train_step`` + AdamW (the Trainer's schedule)
    with no mesh, from the port's init and on the port pipeline's batches:
    (losses, grad norms, final params in the port's layout)."""
    cfg = get_smoke_config(arch)
    init = Model(cfg, device="cpu").init(TRAIN_TC["seed"])
    jm = JaxModel(jax_get_smoke_config(arch))
    opt = JaxAdamW(lr=jax_cosine_schedule(TRAIN_TC["lr"], TRAIN_TC["warmup"],
                                          TRAIN_TC["total_steps"]))
    state = opt.init(jax.tree.map(jnp.asarray, _to_reference(arch, init)))
    step = jax.jit(jax_make_train_step(jm, opt))
    spec = JaxBatchSpec(TRAIN_TC["batch"], TRAIN_TC["seq_len"], cfg.vocab_size,
                        seed=TRAIN_TC["seed"])
    pipe, port_pipe = JaxPipeline(spec), InProcessPipeline(
        BatchSpec(TRAIN_TC["batch"], TRAIN_TC["seq_len"], cfg.vocab_size, seed=TRAIN_TC["seed"]))
    losses, norms = [], []
    for _ in range(steps):
        tokens = next(pipe)["tokens"]
        assert np.array_equal(tokens, next(port_pipe)["tokens"])   # the same batches
        state, m = step(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = params_from_numpy(jax.tree.map(np.asarray, state["params"]), cfg, "cpu")
    return losses, norms, dict(tree_items(final))


def test_trainer_on_2x2_matches_the_reference_step_without_a_mesh(ranks):
    """3 steps of ``Trainer`` on (2, 2): the losses and grad norms every rank
    logs are the reference's ``make_train_step`` + AdamW with no mesh (same
    init, same batches) within 1e-5 relative, and the gathered final params
    within 3e-5 of each leaf's largest magnitude or ``PARAM_ATOL``,
    whichever is larger: AdamW moves a zero-initialised bias about ``lr``
    a step, whatever its gradient's size, so such a leaf's largest
    magnitude is a few ``lr`` (the port without a mesh is 1.3e-7 from the
    reference on qwen2's ``bk``)."""
    losses, norms, final = _jax_train(TRAIN_ARCH, TRAIN_TC["total_steps"])
    for r in ranks["trainer"]:
        got = [x["loss"] for x in r["log"]]
        assert np.allclose(got, losses, rtol=LOSS_RTOL, atol=0), (got, losses)
        assert np.allclose([x["grad_norm"] for x in r["log"]], norms, rtol=LOSS_RTOL, atol=0)
    got = _assemble_tree(TRAIN_ARCH, (2, 2), ("data", "model"),
                         [(r["coords"], r["final"]) for r in ranks["trainer"]])
    for path, w in final.items():
        tol = max(GRAD_TOL * float(w.abs().max()), PARAM_ATOL)
        assert float((got[path] - w).abs().max()) <= tol, path


def test_resume_on_the_same_mesh_repeats_the_losses_bit_for_bit(ranks):
    for r in ranks["trainer"]:
        assert [x["step"] for x in r["resumed"]["log"]] == [3]
        assert r["resumed"]["log"][0]["loss"] == r["log"][2]["loss"]
        assert r["resumed"]["log"][0]["grad_norm"] == r["log"][2]["grad_norm"]
        assert all(torch.equal(a, r["final"][p]) for p, a in r["resumed"]["final"].items())


def test_checkpoint_saved_on_2x2_restores_on_1x4_and_one_rank_bit_for_bit(ranks):
    """The step-2 checkpoint holds each global leaf once, at its logical
    shape; restored on one rank, and onto (1, 4) through shardings, every
    leaf equals the blocks the (2, 2) ranks held when they saved it, bit for
    bit."""
    saved = _assemble_tree(TRAIN_ARCH, (2, 2), ("data", "model"),
                           [(r["coords"], r["at2"]) for r in ranks["trainer"]])
    on14 = _assemble_tree(TRAIN_ARCH, (1, 4), ("data", "model"),
                          [(r["on14"]["coords"], r["on14"]["state"]) for r in ranks["trainer"]])
    assert all(r["on14"]["step"] == 2 for r in ranks["trainer"])
    cfg = get_smoke_config(TRAIN_ARCH)
    p = Model(cfg, device="cpu").abstract_params(whole=True)
    like = {"params": p, "master": p, "m": p, "v": p,
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    like = {k: _zeros(v, k) for k, v in like.items()}
    one, step, extra = Checkpointer(str(ranks["ckpt"])).restore(like, step=2)
    assert step == 2 and extra["data_state"]["cursor"] > 0
    one = dict(tree_items(one))
    manifest = json.loads((ranks["ckpt"] / "step_0000000002" / "manifest.json").read_text())
    assert [tuple(r["shape"]) for r in manifest["leaves"]] == [tuple(t.shape) for t in one.values()]
    assert set(saved) == set(on14) == set(one)
    for path, t in one.items():
        assert torch.equal(saved[path], t) and torch.equal(on14[path], t), path


def _zeros(tree, key):
    from repro_torch.models.common import tree_map

    if key == "step":
        return torch.zeros((), dtype=torch.int32)
    dt = None if key == "params" else torch.float32
    return tree_map(lambda t: torch.zeros(t.shape, dtype=dt or t.dtype), tree)


_REFERENCE_TRAINER = """
import os, sys, json, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import shutil
import jax, jax.numpy as jnp
from repro.checkpoint import Checkpointer
from repro.configs import get_smoke_config
from repro.data import BatchSpec, InProcessPipeline
from repro.launch.mesh import make_mesh
from repro.models import Model
from repro.optim import AdamW
from repro.runtime.trainer import Trainer, TrainerConfig

arch, tc, tree, ckpt = pickle.load(open(sys.argv[1], "rb"))
cfg = get_smoke_config(arch)
tc = TrainerConfig(ckpt_dir=ckpt, **dict(tc, ckpt_every=100))
spec = BatchSpec(tc.batch, tc.seq_len, cfg.vocab_size, seed=tc.seed)
out = {}
for name, mesh in (("mesh", make_mesh((2, 2), ("data", "model"))), ("none", None)):
    # the port's initial state, as a step-0 checkpoint the Trainer restores
    shutil.rmtree(ckpt, ignore_errors=True)
    c = Checkpointer(ckpt, async_save=False)
    c.save(0, AdamW().init(jax.tree.map(jnp.asarray, tree)),
           extra={"data_state": InProcessPipeline(spec).state()})
    t = Trainer(Model(cfg), tc, mesh=mesh)
    try:
        t.run()
        out[name] = [[r["loss"], r["grad_norm"]] for r in t.metrics_log]
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"
print(json.dumps(out))
"""


def test_the_references_trainer_on_a_2x2_host_mesh_gives_the_ports_losses(ranks, tmp_path):
    """The reference's own ``Trainer`` on a (2, 2) mesh of 4 host devices
    (a subprocess: the device count is fixed before jax is imported),
    started from the port's initial state (a step-0 checkpoint), and
    without a mesh.  Its run on the mesh fails at the first step: its jit
    donates a state that lies whole on one device into ``out_shardings``
    of other per-device sizes (ROADMAP.md, Queue 3); so the port's 4-rank
    losses and grad norms are held against its run without a mesh, within
    1e-5 relative (and against the mesh run's, should it run)."""
    cfg = get_smoke_config(TRAIN_ARCH)
    tree = _to_reference(TRAIN_ARCH, Model(cfg, device="cpu").init(TRAIN_TC["seed"]))
    args = tmp_path / "args.pkl"
    with open(args, "wb") as f:
        pickle.dump((TRAIN_ARCH, TRAIN_TC, tree, str(tmp_path / "ckpt")), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE_TRAINER, str(args)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    port = ranks["trainer"][0]["log"]
    runs = [ref["none"]]
    if isinstance(ref["mesh"], str):
        assert "aliased input" in ref["mesh"], ref["mesh"]
    else:
        runs.append(ref["mesh"])
    for run in runs:
        assert np.allclose([x["loss"] for x in port], [r[0] for r in run], rtol=LOSS_RTOL,
                           atol=0)
        assert np.allclose([x["grad_norm"] for x in port], [r[1] for r in run],
                           rtol=LOSS_RTOL, atol=0)
