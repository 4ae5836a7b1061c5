"""Spawned ``gloo`` ranks on the CPU for the port's mesh tests.

:func:`run_ranks` starts ``world`` processes (spawn), each joining one
process group through a ``FileStore`` (group timeout 60 s) and running one
of the jobs below; each job's result is saved by its rank and returned to
the parent, which holds it against the JAX reference and numpy.  The
children are joined within ``JOIN_S`` together and killed if they are
not done, so a hung rank fails its test rather than the suite.  The jobs
live here, importable by a spawned child.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import time
import traceback

JOIN_S = 120
GROUP_TIMEOUT_S = 60


def run_ranks(job: str, world: int, tmp, *args) -> list:
    """``job(rank, world, *args)`` on ``world`` spawned ranks; returns each
    rank's result, rank by rank.  Raises if a rank fails or overruns."""
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp), f"{job}-store")
    procs = [ctx.Process(target=_child, args=(job, r, world, store, str(tmp), args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    if late:
        raise TimeoutError(f"{job}: ranks {late} did not finish within {JOIN_S} s")
    import torch

    out = []
    for r, p in enumerate(procs):
        path = os.path.join(str(tmp), f"{job}-{r}.pt")
        if p.exitcode != 0 or not os.path.exists(path):
            err = os.path.join(str(tmp), f"{job}-{r}.err")
            why = open(err).read() if os.path.exists(err) else ""
            raise RuntimeError(f"{job}: rank {r} exited with {p.exitcode}\n{why}")
        out.append(torch.load(path, weights_only=False))
    return out


def _child(job: str, rank: int, world: int, store: str, tmp: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            result = JOBS[job](rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(tmp, f"{job}-{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"{job}-{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


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
