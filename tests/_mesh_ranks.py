"""Spawned ``gloo`` ranks on the CPU for the port's mesh tests.

:func:`run_ranks` runs one of the jobs below on ``world`` ranks through
``repro_torch.launch.ranks.run_ranks`` (spawned processes, one process
group through a ``FileStore``, a join deadline after which every rank is
killed, so a hung rank fails its test rather than the suite); each job's
result comes back to the parent, which holds it against the JAX reference
and numpy.  The jobs live here, importable by a spawned child.
"""

from __future__ import annotations

from repro_torch.launch.ranks import run_ranks as _run_ranks

JOIN_S = 120


def run_ranks(job: str, world: int, tmp, *args, join_s: float = JOIN_S) -> list:
    """``job(rank, world, *args)`` on ``world`` spawned ranks; returns each
    rank's result, rank by rank.  Raises if a rank fails or overruns
    ``join_s``."""
    return _run_ranks(JOBS[job], world, *args, workdir=str(tmp), join_s=join_s)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def several(rank: int, world: int, jobs: list) -> list:
    """Each ``(job, args)`` of ``jobs`` in turn, on one process group."""
    return [JOBS[job](rank, world, *args) for job, args in jobs]


def collectives(rank: int, world: int, mesh_shape: tuple, names: tuple,
                axes_list: list) -> dict:
    """For each entry of ``axes_list``: ``axis_index``, ``psum``, ``pmean``
    and ``all_gather`` (tiled along dim 1, stacked, and of a 0-dim tensor)
    of a tensor that depends on the rank, under ``shard_map`` over the
    mesh."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import all_gather, axis_index, axis_size, pmean, psum, shard_map

    mesh = make_mesh(mesh_shape, names, device="cpu")
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10.0 * rank

    def body():
        out = {}
        for axes in axes_list:
            key = axes if isinstance(axes, str) else tuple(axes)
            out[key] = {"index": axis_index(key), "size": axis_size(key),
                        "psum": psum(x, key), "pmean": pmean(x, key),
                        "tiled": all_gather(x, key, axis=1, tiled=True),
                        "stacked": all_gather(x, key), "scalar": all_gather(x[0, 0], key)}
        return out

    return {"coords": mesh.get_coordinate(), "out": shard_map(body, mesh=mesh)()}


def _tensors(tree):
    import torch

    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def moe_mesh(rank: int, world: int, cases: list) -> list:
    """``moe_ffn`` under a mesh for each case: ``(cfg kwargs, mesh shape,
    axis names, rules, numpy params, numpy x (B, S, D), params as blocks)``.
    ``x`` arrives whole and the rank takes its block of the batch; the
    params arrive as the rank's blocks under ``param_partition_specs`` or
    whole.  Returns each case's (this rank's output rows, their first
    row, the collectives' calls)."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import batch_specs
    from repro_torch.models import mlp
    from repro_torch.models.common import ModelConfig
    from repro_torch.sharding import NamedSharding, param_partition_specs, use_mesh
    from repro_torch.sharding.partition import COLLECTIVE_CALLS, map_specs

    out = []
    for kw, shape, names, rules, params, x, as_blocks in cases:
        cfg = ModelConfig(**kw)
        mesh = make_mesh(shape, names, device="cpu")
        before = dict(COLLECTIVE_CALLS)
        with torch.no_grad(), use_mesh(mesh, rules) as ctx:
            xt = torch.from_numpy(x)
            xb = NamedSharding(mesh, batch_specs(cfg, {"x": xt}, ctx)["x"]).block(xt)
            first = (xb.data_ptr() - xt.data_ptr()) // (xt.stride(0) * xt.element_size())
            p = _tensors(params)
            if as_blocks:
                p = map_specs(lambda s, t: NamedSharding(mesh, s).block(t).clone(),
                              param_partition_specs(p, ctx), p)
            got, _ = mlp.moe_ffn(p, xb.clone(), cfg=cfg)
        calls = {k: COLLECTIVE_CALLS[k] - before.get(k, 0) for k in COLLECTIVE_CALLS}
        out.append((got.numpy(), first, calls))
    return out


def hierarchical(rank: int, world: int, cfg_kw: dict, tokens, steps: int) -> dict:
    """``make_hierarchical_train_step`` on a ``("pod",)`` mesh of ``world``
    ranks, each on its rows of ``tokens``: ``steps`` uncompressed steps
    (losses, final params), then one compressed step from a fresh state
    (this rank's grads before it, and the grads the step hands the
    optimizer)."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.common import ModelConfig, tree_items
    from repro_torch.optim import AdamW, init_error_state, make_hierarchical_train_step

    class Recording:
        """AdamW that keeps the grads it was given."""

        def __init__(self):
            self.opt, self.grads = AdamW(lr=1e-3), None

        def init(self, params):
            return self.opt.init(params)

        def update(self, state, grads):
            self.grads = {p: g.clone() for p, g in tree_items(grads)}
            return self.opt.update(state, grads)

    model = Model(ModelConfig(**cfg_kw), device="cpu")
    mesh = make_mesh((world,), ("pod",), device="cpu")
    rows = tokens.shape[0] // world
    batch = {"tokens": torch.from_numpy(tokens[rank * rows:(rank + 1) * rows])}
    rec = Recording()
    state = rec.init(model.init(0))
    step = make_hierarchical_train_step(model, rec, mesh, compress=False)
    losses = []
    for _ in range(steps):
        state, _, m = step(state, None, batch)
        losses.append(float(m["loss"]))
    out = {"losses": losses,
           "params": {p: t.detach().clone() for p, t in tree_items(state["params"])}}

    state = rec.init(model.init(0))
    params = state["params"]
    leaves = [p.requires_grad_() for _, p in tree_items(params)]
    local = torch.autograd.grad(model.loss(params, batch), leaves)
    out["local_grads"] = {p: g for (p, _), g in zip(tree_items(params), local)}
    err = init_error_state(params)
    step = make_hierarchical_train_step(model, rec, mesh, compress=True)
    state, err, m = step(state, err, batch)
    out["reduced_grads"] = rec.grads
    out["errors"] = {p: e[0].clone() for p, e in tree_items(err)}
    out["compressed_loss"] = float(m["loss"])
    return out


JOBS = {"several": several, "collectives": collectives, "moe_mesh": moe_mesh,
        "hierarchical": hierarchical}


# ---------------------------------------------------------------------------
# the dense family trained on a mesh (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------


def _dense_fault(fault: str | None, plan, paths: list, monkeypatch: list) -> None:
    """Plant ``fault`` in the step: ``wo_psum`` drops the row-parallel psum
    after ``wo``, ``q_norm_model`` the psum of ``q_norm``'s and ``k_norm``'s
    gradients over ``model``, ``pod_leaf`` the psum of ``final_norm``'s
    scale's gradient over ``pod``."""
    from repro_torch.models import transformer

    if fault == "wo_psum":
        split = transformer._Plan.split
        transformer._Plan.split = lambda self, path, dim: () if path == ("attn", "wo") \
            else split(self, path, dim)
        monkeypatch.append(lambda: setattr(transformer._Plan, "split", split))
    elif fault in ("q_norm_model", "pod_leaf"):
        axis, leaves = ("model", ("q_norm", "k_norm")) if fault == "q_norm_model" else \
            ("pod", ("['final_norm']['scale']",))
        for i, p in enumerate(paths):
            if any(p.endswith(f"['{k}']") or p == k for k in leaves):
                assert axis in plan.reduce[i], (p, plan.reduce[i])
                plan.reduce[i] = tuple(a for a in plan.reduce[i] if a != axis)
    elif fault is not None:
        raise ValueError(fault)


def dense_mesh(rank: int, world: int, cases: list) -> list:
    """For each case ``(arch, mesh shape, axis names, the reference's numpy
    params (global), numpy tokens (global), fault)``: the smoke config's
    loss and gradients on the mesh (``launch.steps.loss_and_grads`` with
    the specs' ``GradPlan``, this rank's blocks of the bridged weights and
    its rows of the batch), and AdamW's global ``grad_norm`` of them.
    Returns each case's (coords, loss, grad norm, {path: this rank's
    gradient block}, the (H, KV) of every attention call)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import batch_specs, grad_plan, loss_and_grads
    from repro_torch.models import Model, attention
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.optim import AdamW
    from repro_torch.sharding import NamedSharding, param_partition_specs, use_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for arch, shape, names, tree, tokens, fault in cases:
        cfg = get_smoke_config(arch)
        model = Model(cfg, device="cpu")
        mesh = make_mesh(shape, names, device="cpu")
        calls = []
        flash = attention.flash_attention

        def recording(q, k, v, **kw):
            calls.append((q.shape[1], k.shape[1]))
            return flash(q, k, v, **kw)

        attention.flash_attention = recording
        undo = [lambda: setattr(attention, "flash_attention", flash)]
        try:
            with use_mesh(mesh) as ctx:
                params = params_from_numpy(tree, cfg, "cpu")
                toks = torch.from_numpy(tokens)
                rows = NamedSharding(mesh, batch_specs(cfg, {"t": toks}, ctx)["t"]).block(toks)
                plan = grad_plan(param_partition_specs(model.abstract_params(whole=True), ctx),
                                 ctx)
                paths = [p for p, _ in tree_items(params)]
                _dense_fault(fault, plan, paths, undo)
                loss, grads = loss_and_grads(model, params, {"tokens": rows}, plan)
                opt = AdamW(lr=1e-3)
                state = opt.init(tree_map(lambda t: t.detach().clone(), params))
                it = iter([g.clone() for g in grads])      # update scales its grads in place
                _, metrics = opt.update(state, tree_map(lambda _: next(it), params),
                                        world=(plan.world, plan.replicas))
        finally:
            for f in undo:
                f()
        out.append((dict(zip(names, mesh.get_coordinate())), float(loss),
                    float(metrics["grad_norm"]), dict(zip(paths, grads)), calls))
    return out


def _blocks(tree) -> dict:
    from repro_torch.models.common import tree_items

    return {p: t.detach().clone() for p, t in tree_items(tree)}


def dense_trainer(rank: int, world: int, arch: str, tc_kw: dict, ckpt_dir: str) -> dict:
    """``Trainer`` on qwen2's smoke config on mesh (2, 2) ``("data",
    "model")``: steps 1-2 (a checkpoint at step 2, the state's blocks kept
    here), step 3 (the losses, grad norms and final params' blocks); then,
    the step-3 checkpoint removed, a second ``Trainer`` on the same mesh
    resumes from step 2 and runs step 3; then the step-2 checkpoint is
    restored onto mesh (1, 4) through its shardings."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(arch)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tc = TrainerConfig(ckpt_dir=ckpt_dir, **tc_kw)
    t = Trainer(Model(cfg, device="cpu"), tc, mesh=mesh)
    t.run(2)
    at2 = _blocks(t.state)
    t.run(tc.total_steps)
    t.close()
    out = {"coords": dict(zip(("data", "model"), mesh.get_coordinate())),
           "log": list(t.metrics_log), "at2": at2, "final": _blocks(t.state["params"])}
    if rank == 0:
        shutil.rmtree(f"{ckpt_dir}/step_{tc.total_steps:010d}")
    dist.barrier()
    r = Trainer(Model(cfg, device="cpu"), tc, mesh=mesh)
    r.run()
    r.close()
    out["resumed"] = {"log": list(r.metrics_log), "final": _blocks(r.state["params"])}

    mesh14 = make_mesh((1, 4), ("data", "model"), device="cpu")
    r14 = Trainer(Model(cfg, device="cpu"), tc, mesh=mesh14)
    sh = r14._state_shardings()
    like = tree_map(lambda t, s: torch.zeros(s.shard_shape(t.shape), dtype=t.dtype),
                    _whole_state(r14), sh)
    state, step, _ = Checkpointer(ckpt_dir).restore(like, step=2, shardings=sh)
    out["on14"] = {"coords": dict(zip(("data", "model"), mesh14.get_coordinate())),
                   "step": step, "state": _blocks(state)}
    return out


def _whole_state(trainer):
    """The trainer's state tree with each leaf a ``meta`` tensor of its
    global shape."""
    import torch

    p = trainer.model.abstract_params(whole=True)
    return {"params": p, "master": _f32(p), "m": _f32(p), "v": _f32(p),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _f32(tree):
    from repro_torch.models.common import tree_map

    import torch

    return tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"), tree)


JOBS.update(dense_mesh=dense_mesh, dense_trainer=dense_trainer)


def autograd_collectives(rank: int, world: int) -> dict:
    """On mesh (2, 2) ``("data", "model")``: the gradients the collectives
    give a tensor that depends on the rank (``psum``, ``copy_to``,
    ``pmean``, ``all_gather`` tiled and stacked, ``pmax``), and
    :func:`constrain` between layouts, forward and backward."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import (all_gather, constrain, copy_to, pmax, pmean, psum,
                                      use_mesh)

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    base = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10.0 * rank
    w = torch.arange(1, 7, dtype=torch.float64).reshape(2, 3)
    out = {"coords": mesh.get_coordinate()}
    with use_mesh(mesh):
        for name, fn in (("psum", lambda x: psum(x, "model")),
                         ("copy_to", lambda x: copy_to(x, "model") * (1 + rank)),
                         ("pmean", lambda x: pmean(x, ("data", "model"))),
                         ("tiled", lambda x: all_gather(x, "data", axis=1, tiled=True)),
                         ("stacked", lambda x: all_gather(x, ("data", "model")))):
            x = base.clone().requires_grad_()
            y = fn(x)
            wy = torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape) + rank
            (y * wy).sum().backward()
            out[name] = (y.detach(), x.grad)
        out["pmax"] = pmax(base, ("data", "model"))
        x = base.clone().requires_grad_()
        y = constrain(x, "batch", None, held=(None, None))       # whole -> rows of data
        (y * w[:1]).sum().backward()
        out["slice"] = (y.detach(), x.grad)
        x = base[:1].clone().requires_grad_()
        y = constrain(x, None, None, held=("batch", None))       # rows of data -> whole
        (y * w).sum().backward()
        out["join"] = (y.detach(), x.grad)
        out["same"] = constrain(base, "batch", None, held=("batch", None)) is base
    return out


def autograd_collectives_staged(rank: int, world: int) -> dict:
    """:func:`autograd_collectives` with every collective sent through the
    host buffers a ``gloo`` group uses for CUDA tensors (the CPU tensors
    staged as those would be), and the bytes staged by collective."""
    from repro_torch.sharding import partition

    partition._staged = lambda ts: True
    out = autograd_collectives(rank, world)
    out["staged_bytes"] = dict(partition.STAGED_BYTES)
    return out


JOBS.update(autograd_collectives=autograd_collectives,
            autograd_collectives_staged=autograd_collectives_staged)
