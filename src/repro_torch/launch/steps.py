"""Step builders and sharding assignments for train, prefill and decode.

Counterpart of ``repro/launch/steps.py``.  ``shardings_for`` turns spec
trees into ``NamedSharding``s: params by their names' rules
(``sharding.param_partition_specs``), caches by ``_CACHE_AXES``, batches
by the batch convention; ``decode_rules`` and ``train_rules`` are the
reference's per-arch overrides.  Each ``make_*_step`` returns a plain
function of tensors, run as it is on the card, the CPU or ``meta`` (the
dry run, ``launch/dryrun.py``); under a mesh its tensors are the rank's
blocks (``repro_torch.sharding``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import tree_items, tree_map
from repro_torch.sharding import (P, MeshContext, NamedSharding, active, check_on_mesh,
                                  logical_to_spec, mesh_shape, param_partition_specs, pmean,
                                  psum)
from repro_torch.sharding.partition import _named, map_specs

__all__ = ["make_train_step", "loss_and_grads", "grad_plan", "GradPlan", "make_prefill_step",
           "make_decode_step", "shardings_for", "batch_specs", "cache_partition_specs",
           "decode_rules", "train_rules"]


# ---------------------------------------------------------------------------
# sharding assignment
# ---------------------------------------------------------------------------

_CACHE_AXES: dict[tuple[str, int], tuple[str | None, ...]] = {
    # KV caches (contiguous): rank 5 = (L, B, S, KV, hd); rank 6 adds a group dim
    ("k", 5): ("layers", "batch", "kv_seq", "kv_heads", None),
    ("v", 5): ("layers", "batch", "kv_seq", "kv_heads", None),
    ("k", 6): ("layers", "layers", "batch", "kv_seq", "kv_heads", None),
    ("v", 6): ("layers", "layers", "batch", "kv_seq", "kv_heads", None),
    ("ck", 5): ("layers", "batch", None, "kv_heads", None),
    ("cv", 5): ("layers", "batch", None, "kv_heads", None),
    # mamba states
    ("ssm", 6): ("layers", "layers", "batch", "heads", "state", None),
    ("conv", 5): ("layers", "layers", "batch", None, "mlp"),
    # mlstm states
    ("C", 6): ("layers", "layers", "batch", "heads", None, None),
    ("n", 5): ("layers", "layers", "batch", "heads", None),
    ("m", 4): ("layers", "layers", "batch", "heads"),
    # slstm states
    ("h", 3): ("layers", "batch", None),
    ("c", 3): ("layers", "batch", None),
    ("n", 3): ("layers", "batch", None),
    ("m", 3): ("layers", "batch", None),
    ("len", 1): ("batch",),
}


def cache_partition_specs(abstract_cache, ctx: MeshContext):
    """Tree of ``P`` for a cache tree (``Model.abstract_cache``), by each
    leaf's name and rank; a leaf the table does not name replicates."""
    return _named(lambda name, _, leaf: logical_to_spec(
        _CACHE_AXES.get((name, leaf.dim()), (None,) * leaf.dim()), tuple(leaf.shape), ctx),
        abstract_cache)


def batch_specs(cfg, batch_abstract, ctx: MeshContext):
    """Tree of ``P`` for a batch: every leaf split over ``batch`` on its
    first dim (tokens, frames, vision embeddings alike)."""
    return _named(lambda _, __, leaf: logical_to_spec(
        ("batch",) + (None,) * (leaf.dim() - 1), tuple(leaf.shape), ctx), batch_abstract)


def shardings_for(spec_tree, mesh):
    """The tree of ``NamedSharding(mesh, spec)`` for a tree of specs."""
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def decode_rules(cfg, mesh) -> dict:
    """Per-arch rule overrides for serving (prefill + decode), the
    reference's:

    * KV heads that cannot tile the model axis: shard the cache's sequence
      dim instead (flash-decoding style);
    * no FSDP ``embed`` sharding (serving keeps no optimizer state, and an
      all-gather of every weight each step is what it would cost);
    * MoE: each expert's FFN column-split over ``data`` (``expert_ff``).
    """
    rules: dict = {"embed": ()}
    tp = mesh_shape(mesh).get("model", 1)
    if cfg.num_kv_heads % tp != 0:
        rules["kv_seq"] = ("model",)
        rules["kv_heads"] = ()
    if cfg.num_experts:
        rules["expert_ff"] = ("data",)
    if cfg.seq_shard_activations:
        rules["res_seq"] = ("model",)
    return rules


def train_rules(cfg, mesh) -> dict:
    rules: dict = {}
    if cfg.seq_shard_activations:
        rules["res_seq"] = ("model",)
    return rules


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GradPlan:
    """What a training step on a mesh does beyond the layers, derived from
    the param specs in one place (:func:`grad_plan`):

    * ``batch``: the batch axes (larger than 1) the loss is ``pmean``'d
      over;
    * ``reduce``: for each leaf (in ``tree_items`` order), the axes its
      gradient is ``psum``'d over: every batch axis its spec does not split
      (its use is split there: the rank's rows; a batch axis its spec does
      split is summed by its FSDP gather's backward), and every other axis
      that splits a leaf of the same dict but not this one (its use is
      split there: ``q_norm``/``k_norm`` beside split heads, ``wk``/``wv``/
      ``bk``/``bv`` whole where the KV heads do not tile the axis);
    * ``replicas``: for each leaf, the ranks that hold its block (for the
      global gradient norm, ``AdamW.update``);
    * ``world``: every axis of the mesh, the norm's group."""

    batch: tuple
    reduce: list
    replicas: list
    world: tuple


def grad_plan(specs, ctx: MeshContext) -> GradPlan:
    """The :class:`GradPlan` of a param spec tree on ``ctx``'s mesh."""
    names = ctx.axis_names
    big = lambda axes: tuple(a for a in names if a in axes and ctx.size(a) > 1)  # noqa: E731
    batch = big(ctx.rule("batch"))
    world_size = ctx.axes_size(names)
    reduce, replicas = [], []

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
            return
        leaves = {k: v for k, v in node.items() if isinstance(v, P)}
        used = {a for spec in leaves.values() for d in range(len(spec))
                for a in spec.axes(d) if a not in batch}
        for k in sorted(node):
            spec = node[k]
            if not isinstance(spec, P):
                walk(spec)
                continue
            own = {a for d in range(len(spec)) for a in spec.axes(d)}
            reduce.append(big((set(batch) | used) - own))
            replicas.append(world_size // ctx.axes_size(tuple(own)))

    walk(specs)
    return GradPlan(batch, reduce, replicas, names)


def loss_and_grads(model, params: dict, batch: dict, plan: GradPlan | None = None):
    """(loss, grads in ``tree_items`` order) of ``model.loss`` at ``params``
    (made leaves that need grad).  With a :class:`GradPlan` (a mesh whose
    axes are not all 1) the loss is the mean over the batch axes and each
    gradient is reduced over its plan's axes: the global loss and the
    rank's block of the global gradient, on every rank."""
    leaves = [p.requires_grad_() for _, p in tree_items(params)]
    loss = model.loss(params, batch)
    if plan is not None and plan.batch:
        loss = pmean(loss, plan.batch)
    grads = list(torch.autograd.grad(loss, leaves))
    if plan is not None:
        with torch.no_grad():
            for i, axes in enumerate(plan.reduce):
                if axes:
                    grads[i] = psum(grads[i], axes)
    return loss.detach(), grads


def make_train_step(model, opt):
    """``train_step(state, batch) -> (state, metrics)``: the loss, its
    gradient through ``backward`` of every param leaf, then ``opt.update``
    on the state in place; metrics hold ``loss``, ``grad_norm`` and
    ``lr``.

    Under a mesh (``sharding.use_mesh``) whose axes are not all 1, the
    state holds the rank's blocks and ``batch`` its rows; the step takes
    the :class:`GradPlan` of the model's specs (:func:`loss_and_grads`) and
    the global gradient norm, so ``loss`` and ``grad_norm`` are the global
    values.  Only the dense family runs there; another raises naming the
    part of ROADMAP.md Queue 1 item 8c that brings it."""
    plans: dict = {}

    def plan_for():
        ctx = active()
        if ctx is None or ctx.axes_size(ctx.axis_names) == 1:
            return None
        check_on_mesh(model.cfg, "train", ctx.mesh)
        key = (id(ctx.mesh), tuple(sorted(ctx.rules.items())))
        if key not in plans:
            plans[key] = grad_plan(param_partition_specs(model.abstract_params(whole=True),
                                                         ctx), ctx)
        return plans[key]

    def train_step(state: dict, batch: dict):
        params = state["params"]
        plan = plan_for()
        loss, grads = loss_and_grads(model, params, batch, plan)
        grads = iter(grads)
        grads = tree_map(lambda _: next(grads), params)
        if plan is None:
            state, metrics = opt.update(state, grads)
        else:
            state, metrics = opt.update(state, grads, world=(plan.world, plan.replicas))
        return state, dict(metrics, loss=loss)

    return train_step


def make_prefill_step(model, wl):
    """``prefill_step(params, batch) -> (logits (B, 1, V), cache)``: the
    prompt through ``model.prefill`` into a cache of ``wl.seq_len``
    positions."""

    def prefill_step(params: dict, batch: dict):
        return model.prefill(params, batch, max_seq=wl.seq_len)

    return prefill_step


def make_decode_step(model):
    """``decode_step(params, cache, tokens) -> (next tokens (B, 1) int32,
    cache)``: one ``model.decode_step`` (the cache updated in place) and
    the greedy next token of each row."""

    def decode_step(params: dict, cache: dict, tokens: torch.Tensor):
        logits, cache = model.decode_step(params, cache, tokens)
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None], cache

    return decode_step
