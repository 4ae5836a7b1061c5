"""Logical-axis sharding: DP / TP / EP / SP rules over a mesh.

Counterpart of ``repro/sharding/partition.py``.  Parameters and
activations are annotated with *logical* axis names; a rule table maps
them to physical mesh axes, divisibility-aware (gemma's 8 query heads
cannot shard over a 16-way ``model`` axis: that dim stays whole), with the
reference's table, ``DEFAULT_RULES``, and its parameter-name table,
``_PARAM_AXES``.  ``logical_to_spec`` and ``param_partition_specs`` give
the reference's specs leaf for leaf.

**How the port holds a sharded tensor.**  The reference's arrays are
global and GSPMD or ``shard_map`` hands each device its block.  The
port's kernels are hand-written and take plain tensors, so every sharded
tensor here is *the rank's local block, a plain tensor*; a
:class:`NamedSharding` says which block (``shard_shape``, ``block``).
The mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(``launch/mesh.make_mesh``) or an :class:`AbstractMesh` (shape and axis
names, no process group: the production meshes on one process, for the
spec functions).  Collectives are explicit, named after the reference's
``jax.lax`` ones (:func:`axis_index`, :func:`psum`, :func:`pmean`,
:func:`all_gather`), and resolve their axes against the mesh of the
enclosing :func:`shard_map` (or :func:`use_mesh`).  A tuple of axes is
one group over those axes, in row-major order of the tuple: rank ``(a,
b)`` is member ``a * |b| + b`` in ``axis_index``, in the order
``all_gather`` lays the blocks out, and so in any slice back.  (The
reference's ``_moe_serving`` gathers one axis at a time but slices back
in the other order; ROADMAP.md, Queue 3.)

A collective of a tensor that needs grad raises: training through a
sharded layer (tensor-parallel products, FSDP gathers) is ROADMAP.md
Queue 1 item 8c, and so is :func:`constrain` beyond the identity.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_RULES", "P", "AbstractMesh", "NamedSharding", "MeshContext", "use_mesh",
    "current_mesh", "active", "constrain", "logical_to_spec", "param_partition_specs",
    "unmatched_param_leaves", "map_specs", "mesh_shape", "shard_map", "axis_index",
    "axis_size", "psum", "pmean", "all_gather", "COLLECTIVE_CALLS",
]

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_ff": (),  # serving: ("data",) = EP x TP-within-expert
    "seq": (),
    "res_seq": (),   # residual stream between blocks (SP when enabled)
    "kv_seq": (),
    "layers": (),     # scan axis: never sharded
    "state": (),      # SSM state dims
}


class P(tuple):
    """``PartitionSpec``: per dim ``None`` (whole), an axis name, or a
    tuple of axis names (the dim split row-major over them); dims past the
    end are whole."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes that split ``dim``, in order."""
        part = self[dim] if dim < len(self) else None
        return () if part is None else (part,) if isinstance(part, str) else tuple(part)


class AbstractMesh:
    """A mesh's shape and axis names with no process group behind it:
    ``DeviceMesh``'s ``mesh_dim_names``, ``shape``, ``size`` and
    ``get_coordinate``, enough for the spec functions (the production
    meshes on one process).  ``coordinate`` places the caller on it (a
    size-1 mesh's is all 0).  Collectives over it raise."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 coordinate: tuple[int, ...] | None = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axis_names)
        if coordinate is None and self.size() == 1:
            coordinate = (0,) * len(self.shape)
        self._coordinate = None if coordinate is None else list(coordinate)

    def size(self, dim: int | None = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def get_coordinate(self) -> list[int] | None:
        return self._coordinate

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's order (``jax``'s ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _coords(mesh) -> dict[str, int]:
    """This rank's coordinate on each axis of ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"{mesh} does not place this rank: give it a coordinate")
    return dict(zip(mesh.mesh_dim_names, coord))


def _row_major(axes: tuple[str, ...], sizes: dict[str, int], coords: dict[str, int]) -> int:
    i = 0
    for a in axes:
        i = i * sizes[a] + coords[a]
    return i


class NamedSharding:
    """Where a global tensor's block lies on ``mesh`` under ``spec``: each
    dim split into equal blocks, row-major over the axes its entry names.
    The port holds the block (:meth:`block`) and never the global tensor
    on a rank."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _splits(self, shape) -> list[int]:
        sizes = mesh_shape(self.mesh)
        out = []
        for dim, n in enumerate(shape):
            parts = math.prod(sizes[a] for a in self.spec.axes(dim))
            if n % parts:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split into {parts} blocks "
                                 f"under {self.spec}")
            out.append(parts)
        return out

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """The block's shape (``jax``'s ``NamedSharding.shard_shape``)."""
        return tuple(n // parts for n, parts in zip(global_shape, self._splits(global_shape)))

    def block(self, t: torch.Tensor, coords: dict[str, int] | None = None) -> torch.Tensor:
        """The block of the global tensor ``t`` at mesh ``coords`` (this
        rank's by default), a view; ``t`` itself where every dim is whole."""
        sizes = mesh_shape(self.mesh)
        coords = _coords(self.mesh) if coords is None else coords
        out = t
        for dim, parts in enumerate(self._splits(t.shape)):
            if parts > 1:
                n = t.shape[dim] // parts
                out = out.narrow(dim, _row_major(self.spec.axes(dim), sizes, coords) * n, n)
        return out


@dataclass
class MeshContext:
    mesh: object
    rules: dict[str, tuple[str, ...]] = field(default_factory=dict)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def size(self, axis: str) -> int:
        return mesh_shape(self.mesh)[axis]

    def rule(self, name: str) -> tuple[str, ...]:
        r = self.rules.get(name, DEFAULT_RULES.get(name, ()))
        # keep only axes that exist in this mesh (the pod axis is optional)
        return tuple(a for a in r if a in self.axis_names)

    def axes_size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.size(a) for a in axes)


_ctx: contextvars.ContextVar[MeshContext | None] = contextvars.ContextVar(
    "agnocast_torch_mesh_ctx", default=None)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    ctx = MeshContext(mesh, dict(rules or {}))
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)


def active() -> MeshContext | None:
    return _ctx.get()


def current_mesh():
    ctx = _ctx.get()
    return ctx.mesh if ctx else None


def logical_to_spec(axes: tuple[str | None, ...], shape: tuple[int, ...],
                    ctx: MeshContext | None = None) -> P:
    """Map logical axes to a spec, dropping rules that do not divide the dim
    or name an axis an earlier dim took; trailing ``None``s dropped."""
    ctx = ctx or _ctx.get()
    if ctx is None:
        return P()
    used: set[str] = set()
    out: list = []
    for name, dim in zip(axes, shape):
        phys = ctx.rule(name) if name else ()
        phys = tuple(a for a in phys if a not in used)
        if phys and dim % ctx.axes_size(phys) == 0:
            used.update(phys)
            out.append(phys if len(phys) > 1 else phys[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """The reference's activation sharding constraint, the identity here: a
    rank holds its block already, and no dense layer runs tensor-parallel
    in the port yet, so there is no layout to change between layers
    (ROADMAP.md Queue 1 item 8c)."""
    return x


# ---------------------------------------------------------------------------
# Parameter specs: leaf name -> logical axes (rank-aware)
# ---------------------------------------------------------------------------

# name -> logical axes for the *trailing* dims; stacked params get a leading
# "layers" axis when their rank exceeds the base rank
_PARAM_AXES: dict[str, tuple[str | None, ...]] = {
    # embeddings / head
    "tok_embed": ("vocab", "embed"),
    "pos_embed": (None, "embed"),
    "lm_head": ("vocab", "embed"),
    # attention
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "q_norm": ("head_dim",),
    "k_norm": ("head_dim",),
    # mlp
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    # moe
    "router": ("embed", "experts"),
    "e_gate": ("experts", "embed", "expert_ff"),
    "e_up": ("experts", "embed", "expert_ff"),
    "e_down": ("experts", "expert_ff", "embed"),
    "shared_gate": ("embed",),
    # norms / scalars
    "scale": ("embed",),
    "bias": ("embed",),
    # ssm (mamba2)
    "in_proj": ("embed", "mlp"),
    "conv_w": (None, "mlp"),
    "conv_b": ("mlp",),
    "A_log": ("heads",),
    "D_skip": ("heads",),
    "dt_bias": ("heads",),
    "out_proj": ("mlp", "embed"),
    "norm_inner": ("mlp",),
    # xlstm
    "w_ih": ("embed", "mlp"),
    "w_hh": (None, "mlp"),
    "b_ih": ("mlp",),
    # generic projections (whisper/mllama frontends, gates)
    "w_in": ("embed", "mlp"),
    "w_out": ("mlp", "embed"),
    "gate_attn": (),
    "gate_mlp": (),
}


def _axes_for_leaf(name: str | None, rank: int) -> tuple[str | None, ...]:
    base = _PARAM_AXES.get(name)
    if base is None:
        return (None,) * rank          # unknown leaf: replicate (unmatched_param_leaves)
    if rank == len(base):
        return base
    if rank == len(base) + 1:
        return ("layers",) + base
    if rank == len(base) + 2:          # grouped stacks (mllama groups x inner)
        return ("layers", "layers") + base
    return (None,) * rank


def _named(fn, tree, name: str | None = None, prefix: str = ""):
    """``fn(name, path, leaf)`` over a tree of dicts and lists, ``name`` the
    leaf's last dict key (list indices skipped, as the reference's path
    keys are) and ``path`` as ``models.common.tree_items`` writes it."""
    if isinstance(tree, dict):
        return {k: _named(fn, tree[k], k, f"{prefix}[{k!r}]") for k in sorted(tree)}
    if isinstance(tree, list):
        return [_named(fn, v, name, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(name, prefix, tree)


def map_specs(fn, tree, *rest):
    """``fn`` over the :class:`P` leaves of a spec tree (and the same leaves
    of ``rest``); ``models.common.tree_map`` would walk into a ``P``."""
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_specs(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_partition_specs(abstract_params, ctx: MeshContext | None = None):
    """Tree of :class:`P` for a parameter tree (global shapes: ``meta``
    tensors from ``Model.abstract_params``, or real ones)."""
    ctx = ctx or _ctx.get()
    return _named(lambda name, _, leaf: logical_to_spec(
        _axes_for_leaf(name, len(leaf.shape)), tuple(leaf.shape), ctx), abstract_params)


def unmatched_param_leaves(abstract_params) -> list[str]:
    """Test hook: paths of leaves whose name has no rule (they replicate)."""
    bad: list[str] = []
    _named(lambda name, path, _: bad.append(path) if name not in _PARAM_AXES else None,
           abstract_params)
    return bad


# ---------------------------------------------------------------------------
# shard_map and the named-axis collectives
# ---------------------------------------------------------------------------

_manual: contextvars.ContextVar[object | None] = contextvars.ContextVar(
    "agnocast_torch_manual_mesh", default=None)

# calls of each collective, for a caller to see that a mesh path ran
COLLECTIVE_CALLS: collections.Counter = collections.Counter()


def shard_map(f, *, mesh):
    """The reference's ``shard_map``: ``f`` runs on the rank's local blocks,
    which is what the port's tensors are (so there are no in or out specs:
    nothing is split or joined here), and the named-axis collectives inside
    it resolve against ``mesh``."""

    def run(*args, **kwargs):
        token = _manual.set(mesh)
        try:
            return f(*args, **kwargs)
        finally:
            _manual.reset(token)

    return run


@dataclass
class _Group:
    pg: object                 # the process group
    members: list[int]         # global ranks in row-major order of the axes
    order: list[int]           # the group rank of each member, in that order
    index: int                 # this rank's place in ``members``


_GROUPS: dict = {}

# the blocks joined along dim 0 (torch 2.13 renames all_gather_into_tensor)
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _mesh_for(axes: tuple[str, ...]):
    mesh = _manual.get() or current_mesh()
    if mesh is None:
        raise RuntimeError(f"a collective over {axes} needs a mesh: run it under shard_map "
                           f"or use_mesh")
    if isinstance(mesh, AbstractMesh):
        raise RuntimeError(f"{mesh} has no process group: a collective needs launch.mesh."
                           f"make_mesh's mesh")
    missing = [a for a in axes if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh's {mesh.mesh_dim_names}")
    return mesh


def _group(axes: tuple[str, ...]) -> _Group:
    """The group over ``axes`` that holds this rank.  One axis is the
    ``DeviceMesh``'s own group; a tuple is a group made here once per mesh,
    by every rank in the same order (its first collective)."""
    mesh = _mesh_for(axes)
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        n = math.prod(mesh.shape[d] for d in dims)
        every = mesh.mesh.permute(rest + dims).reshape(-1, n).tolist()
        me = dist.get_rank()
        members = next(m for m in every if me in m)
        if len(axes) == 1:
            pg = mesh.get_group(axes[0])
        else:
            pg, _ = dist.new_subgroups_by_enumeration(every)
        order = [dist.get_group_rank(pg, r) for r in members]
        _GROUPS[key] = (mesh, _Group(pg, members, order, members.index(me)))
    return _GROUPS[key][1]


def _no_grad(x: torch.Tensor, what: str) -> None:
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(f"{what} of a tensor that needs grad: training through a "
                                  f"sharded layer is ROADMAP.md Queue 1 item 8c")


def axis_index(axes) -> int:
    """This rank's index over ``axes`` (row-major over a tuple)."""
    return _group(_axes(axes)).index


def axis_size(axes) -> int:
    return len(_group(_axes(axes)).members)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, on each of them."""
    _no_grad(x, "psum")
    g = _group(_axes(axes))
    COLLECTIVE_CALLS["psum"] += 1
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=g.pg)
    return out


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    return psum(x, axes) / axis_size(axes)


def all_gather(x: torch.Tensor, axes, *, axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, in row-major order: stacked on a
    new dim ``axis``, or with ``tiled`` joined along ``axis``."""
    _no_grad(x, "all_gather")
    g = _group(_axes(axes))
    COLLECTIVE_CALLS["all_gather"] += 1
    x = x.contiguous()
    n = len(g.members)
    flat = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]) if x.dim() else (n,))
    _gather_into(flat, x if x.dim() else x.reshape(1), group=g.pg)
    out = flat.view((n,) + tuple(x.shape))
    if g.order != list(range(len(g.order))):
        out = out[g.order]            # group ranks follow global ranks, not the tuple's order
    if not tiled:
        return out.movedim(0, axis % out.dim())
    axis %= x.dim()
    return out.movedim(0, axis).reshape(x.shape[:axis] + (-1,) + x.shape[axis + 1:])
