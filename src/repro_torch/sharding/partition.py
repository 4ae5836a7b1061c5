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

Each collective is a ``torch.autograd.Function`` whose docstring states
its backward (:func:`psum`, :func:`copy_to`, :func:`all_gather`,
:func:`pmean`; :func:`pmax` has none), so the dense family's
tensor-parallel and FSDP layers train through them (ROADMAP.md Queue 1
item 8c, part one); :func:`constrain` moves an activation between
layouts by gather or slice.  A ``gloo`` group whose ranks share one card
stages CUDA tensors through pinned host buffers (``STAGED_BYTES``).  On
an :class:`AbstractMesh` with a coordinate, the dry run's, a collective
of ``meta`` tensors sends nothing: it gives the result's shape and
records its per-device wire bytes in the active cost counter.  Serving
steps under ``decode_rules``, MoE training and SP, and the other
families' layers on a mesh are item 8c's remaining parts.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.kernels import _device

__all__ = [
    "DEFAULT_RULES", "P", "AbstractMesh", "NamedSharding", "MeshContext", "use_mesh",
    "current_mesh", "active", "constrain", "logical_to_spec", "param_partition_specs",
    "unmatched_param_leaves", "map_specs", "mesh_shape", "shard_map", "axis_index",
    "axis_size", "psum", "pmean", "pmax", "copy_to", "all_gather", "leaf_spec", "split_axes",
    "local_blocks", "mesh_unsupported", "check_on_mesh", "COLLECTIVE_CALLS", "STAGED_BYTES",
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


_LATER = "ROADMAP.md Queue 1 item 8c"


def mesh_unsupported(cfg, kind: str) -> str:
    """Why ``cfg``'s ``kind`` step ("train", "prefill" or "decode") does not
    run on a mesh with a split axis yet, empty if it does: the part of
    ROADMAP.md Queue 1 item 8c that brings it.  The one test the layers,
    the train step, ``Trainer`` and the dry run apply."""
    if kind != "train":
        return f"{_LATER}: serving steps under decode_rules on a mesh"
    if cfg.family == "moe":
        return f"{_LATER}: MoE training through the expert-parallel collectives, and SP"
    if cfg.family != "dense":
        return f"{_LATER}: the {cfg.family} layers under a mesh"
    if cfg.seq_shard_activations:
        return f"{_LATER}: sequence-parallel activations (res_seq)"
    return ""


def check_on_mesh(cfg, kind: str, mesh) -> None:
    """Raise where ``mesh`` splits an axis and :func:`mesh_unsupported`
    gives a reason."""
    split = {a: n for a, n in mesh_shape(mesh).items() if n > 1}
    why = mesh_unsupported(cfg, kind) if split else ""
    if why:
        raise NotImplementedError(f"{cfg.name}: the {kind} step on a mesh with axes {split} "
                                  f"is {why}")


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

    def global_shape(self, block_shape) -> tuple[int, ...]:
        """The global shape whose blocks are ``block_shape``."""
        sizes = mesh_shape(self.mesh)
        return tuple(n * math.prod(sizes[a] for a in self.spec.axes(dim))
                     for dim, n in enumerate(block_shape))

    def index(self, global_shape, coords: dict[str, int] | None = None) -> tuple[slice, ...]:
        """The block at mesh ``coords`` (this rank's by default) as one
        slice a dim of the global array."""
        sizes = mesh_shape(self.mesh)
        coords = _coords(self.mesh) if coords is None else coords
        out = []
        for dim, parts in enumerate(self._splits(global_shape)):
            n = global_shape[dim] // parts
            i = _row_major(self.spec.axes(dim), sizes, coords) if parts > 1 else 0
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    def writes(self, coords: dict[str, int] | None = None) -> bool:
        """Whether the rank at ``coords`` (this one by default) is the first
        of the ranks that hold its block: its coordinate is 0 on every axis
        the spec does not split over."""
        coords = _coords(self.mesh) if coords is None else coords
        used = {a for dim in range(len(self.spec)) for a in self.spec.axes(dim)}
        return all(c == 0 for a, c in coords.items() if a not in used)

    def block(self, t: torch.Tensor, coords: dict[str, int] | None = None) -> torch.Tensor:
        """The block of the global tensor ``t`` at mesh ``coords`` (this
        rank's by default), a view; ``t`` itself where every dim is whole."""
        out = t
        for dim, sl in enumerate(self.index(t.shape, coords)):
            if sl.stop - sl.start != t.shape[dim]:
                out = out.narrow(dim, sl.start, sl.stop - sl.start)
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


def leaf_spec(name: str, shape: tuple[int, ...], ctx: MeshContext | None = None) -> P:
    """The spec of one parameter leaf named ``name`` of global ``shape``
    (what :func:`param_partition_specs` gives it)."""
    return logical_to_spec(_axes_for_leaf(name, len(shape)), tuple(shape), ctx)


def split_axes(spec: P, dim: int, ctx: MeshContext) -> tuple[str, ...]:
    """The axes of ``spec``'s ``dim`` that are larger than 1: the ranks
    that hold different blocks along it."""
    return tuple(a for a in spec.axes(dim) if ctx.size(a) > 1)


def local_blocks(tree, ctx: MeshContext | None = None):
    """Each leaf of a parameter tree of global tensors replaced by the rank's
    block under :func:`param_partition_specs` (a copy, so the global
    tensor can go), on the mesh of ``ctx`` (the active one by default);
    the tree itself where no mesh is active or every block is whole."""
    ctx = ctx or _ctx.get()
    if ctx is None or math.prod(ctx.mesh.shape) == 1:
        return tree
    return map_specs(lambda s, t: NamedSharding(ctx.mesh, s).block(t).clone(),
                     param_partition_specs(tree, ctx), tree)


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
# bytes copied between CUDA tensors and their pinned host buffers (both
# ways), by collective: what a ``gloo`` group of ranks that share one card
# moves through host memory (``launch.mesh.make_mesh``)
STAGED_BYTES: collections.Counter = collections.Counter()


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
    host: bool                 # a ``gloo`` group: CUDA tensors go through host buffers


_GROUPS: dict = {}

# torch 2.13 renames the tensor forms of all-gather and reduce-scatter
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _mesh_for(axes: tuple[str, ...], mesh=None):
    mesh = mesh or _manual.get() or current_mesh()
    if mesh is None:
        raise RuntimeError(f"a collective over {axes} needs a mesh: run it under shard_map "
                           f"or use_mesh")
    missing = [a for a in axes if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh's {mesh.mesh_dim_names}")
    return mesh


def _group(axes: tuple[str, ...], mesh) -> _Group:
    """The group over ``axes`` that holds this rank.  One axis is the
    ``DeviceMesh``'s own group; a tuple is a group made here once per mesh,
    by every rank in the same order (its first collective)."""
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
        _GROUPS[key] = (mesh, _Group(pg, members, order, members.index(me),
                                     dist.get_backend(pg) == "gloo"))
    return _GROUPS[key][1]


def _resolve(axes: tuple[str, ...], x: torch.Tensor | None = None, mesh=None):
    """(size, this rank's index, group) over ``axes`` of ``mesh`` (the
    enclosing one by default).  On an :class:`AbstractMesh` (the dry
    run's) the group is None and only ``meta`` tensors may take part:
    nothing is sent there."""
    mesh = _mesh_for(axes, mesh)
    if isinstance(mesh, AbstractMesh):
        if x is not None and not x.is_meta:
            raise RuntimeError(f"{mesh} has no process group: a collective of a {x.device} "
                               f"tensor needs launch.mesh.make_mesh's mesh (only meta "
                               f"tensors, the dry run's, are counted on an abstract mesh)")
        sizes = mesh_shape(mesh)
        return math.prod(sizes[a] for a in axes), _row_major(axes, sizes, _coords(mesh)), None
    g = _group(axes, mesh)
    return len(g.members), g.index, g


def axis_index(axes) -> int:
    """This rank's index over ``axes`` (row-major over a tuple)."""
    return _resolve(_axes(axes))[1]


def axis_size(axes) -> int:
    return _resolve(_axes(axes))[0]


# -- the transfers (no autograd) ------------------------------------------------

_PINNED: list = [None]


def _host_views(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Views of one pinned host buffer, one like each of ``ts`` (shape and
    dtype), laid end to end; the buffer is kept and grown as needed.  A
    collective copies its CUDA operands in, runs on these, and copies its
    results back, each copy synchronous, so the next one may reuse it."""
    sizes = [-(-t.numel() * t.element_size() // 256) * 256 for t in ts]
    buf = _PINNED[0]
    if buf is None or buf.numel() < sum(sizes):
        _PINNED[0] = None
        buf = _PINNED[0] = torch.empty(max(sum(sizes), 2 * (0 if buf is None else buf.numel())),
                                       dtype=torch.uint8, pin_memory=torch.cuda.is_available())
    out, at = [], 0
    for t, n in zip(ts, sizes):
        nb = t.numel() * t.element_size()
        out.append(buf[at:at + nb].view(t.dtype).view(t.shape))
        at += n
    return out


def _staged(ts: list) -> bool:
    """Whether a ``gloo`` group's collective goes through host buffers:
    where it meets CUDA tensors."""
    return any(t.is_cuda for t in ts)


def _run(g: _Group, name: str, fn, outs: list, ins: list, *, inplace: bool = False) -> None:
    """``fn(*outs, *ins)`` on the group's backend; where a ``gloo`` group
    meets CUDA tensors (:func:`_staged`), on pinned host copies: ``ins`` copied in, and ``outs`` too where the
    collective works ``inplace`` (all-reduce), then ``outs`` copied back;
    the bytes copied, both ways, counted in ``STAGED_BYTES[name]``."""
    if not (g.host and _staged(outs + ins)):
        fn(*outs, *ins)
        return
    hosts = _host_views(*outs, *ins)
    sent = list(zip(hosts, outs + ins)) if inplace else list(zip(hosts[len(outs):], ins))
    for h, t in sent:
        h.copy_(t)
    fn(*hosts)
    for t, h in zip(outs, hosts):
        t.copy_(h)
    STAGED_BYTES[name] += sum(t.numel() * t.element_size()
                              for t in [t for _, t in sent] + outs)


def _record(kind: str, result: torch.Tensor, g: int) -> None:
    """One collective of ``kind`` over ``g`` ranks whose result is
    ``result``, in the active cost counter (``launch/cost_analysis``)."""
    if _device.COUNTERS:
        _device.COUNTERS[-1].record_collective(kind, result.numel() * result.element_size(), g)


def _all_reduce(x: torch.Tensor, axes: tuple[str, ...], op, name: str,
                mesh=None) -> torch.Tensor:
    n, _, g = _resolve(axes, x, mesh)
    COLLECTIVE_CALLS[name] += 1
    with _device.uncounted():
        out = x.clone(memory_format=torch.contiguous_format)
        if g is not None:
            _run(g, name, lambda t: dist.all_reduce(t, op=op, group=g.pg), [out], [],
                 inplace=True)
    _record("all-reduce", out, n)
    return out


def _gather(x: torch.Tensor, axes: tuple[str, ...], axis: int, tiled: bool,
            mesh=None) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` in row-major order: stacked on a new
    dim ``axis``, or with ``tiled`` joined along ``axis``."""
    name = "all_gather"
    n, _, g = _resolve(axes, x, mesh)
    COLLECTIVE_CALLS[name] += 1
    with _device.uncounted():
        x = x.contiguous()
        flat = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]) if x.dim() else (n,))
        if g is not None:
            _run(g, name, lambda o, i: _gather_into(o, i, group=g.pg), [flat],
                 [x if x.dim() else x.reshape(1)])
        out = flat.view((n,) + tuple(x.shape))
        if g is not None and g.order != list(range(n)):
            out = out[g.order]        # group ranks follow global ranks, not the tuple's order
        if not tiled:
            out = out.movedim(0, axis % out.dim())
        else:
            axis %= x.dim()
            out = out.movedim(0, axis).reshape(x.shape[:axis] + (-1,) + x.shape[axis + 1:])
    _record("all-gather", out, n)
    return out


def _stacked(y: torch.Tensor, n: int, axis: int, tiled: bool) -> torch.Tensor:
    """A gathered tensor ``y`` (see :func:`_gather`) as (n, block...)."""
    if not tiled:
        return y.movedim(axis % y.dim(), 0)
    axis %= y.dim()
    shape = y.shape[:axis] + (n, y.shape[axis] // n) + y.shape[axis + 1:]
    return y.reshape(shape).movedim(axis, 0)


def _reduce_scatter(y: torch.Tensor, axes: tuple[str, ...], axis: int, tiled: bool,
                    mesh=None) -> torch.Tensor:
    """The sum over the group of each rank's ``y``, a tensor laid out as
    :func:`_gather` lays out its result, of which this rank keeps its own
    block."""
    n, _, g = _resolve(axes, y, mesh)
    COLLECTIVE_CALLS["reduce_scatter"] += 1
    with _device.uncounted():
        blocks = _stacked(y, n, axis, tiled).contiguous()
        out = blocks.new_empty(blocks.shape[1:])
        if g is not None:
            if g.order != list(range(n)):       # block of member i to group rank order[i]
                perm = torch.empty_like(blocks)
                perm[g.order] = blocks
                blocks = perm
            _run(g, "reduce_scatter",
                 lambda o, b: _scatter_from(o, b.reshape((-1,) + tuple(b.shape[2:])),
                                            group=g.pg),
                 [out if out.dim() else out.reshape(1)], [blocks])
    _record("reduce-scatter", out, n)
    return out


def _own_block(y: torch.Tensor, axes: tuple[str, ...], axis: int, mesh=None) -> torch.Tensor:
    """This rank's block of ``y`` along ``axis``, split over ``axes`` in
    row-major order (no communication)."""
    n, i, _ = _resolve(axes, y, mesh)
    size = y.shape[axis] // n
    return y.narrow(axis, i * size, size)


# -- the collectives, with their gradients ---------------------------------------


class _PSum(torch.autograd.Function):
    """``psum``: forward, the sum over the group, on every rank.  Backward:
    the identity, since every rank's input enters the sum once and the
    output's gradient is the same on every rank of the group (the output
    is whole there: the reduce out of a row-parallel product, the sums of
    a vocab-parallel softmax)."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _all_reduce(x, axes, dist.ReduceOp.SUM, "psum", mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    """``copy_to`` (Megatron's "f"), at the entry of a tensor-parallel
    region: forward, the identity.  Backward: the psum of the gradient over
    the group, since each rank's part of the region (its heads, its FFN
    columns, its vocab rows) gives a part of the input's gradient."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.args = (axes, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        axes, mesh = ctx.args
        return _all_reduce(grad, axes, dist.ReduceOp.SUM, "psum", mesh), None, None


class _AllGather(torch.autograd.Function):
    """``all_gather``: forward, every rank's block in row-major order of the
    axes.  Backward: the gradient summed over the group, each rank keeping
    its own block (a reduce-scatter), since each rank uses the gathered
    tensor on its own rows (an FSDP weight on the rank's batch) and so
    gives a part of every block's gradient."""

    @staticmethod
    def forward(ctx, x, axes, axis, tiled, mesh):
        ctx.args = (axes, axis, tiled, mesh)
        return _gather(x, axes, axis, tiled, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, *ctx.args), None, None, None, None


class _Join(torch.autograd.Function):
    """:func:`constrain`'s gather: forward, the blocks over the group joined
    along ``axis``.  Backward: the rank's own block of the gradient, no
    communication, since the joined tensor is used alike on every rank of
    the group and its gradient is whole there."""

    @staticmethod
    def forward(ctx, x, axes, axis, mesh):
        ctx.args = (axes, axis, mesh)
        return _gather(x, axes, axis, True, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, *ctx.args).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    """:func:`constrain`'s slice: forward, the rank's block along ``axis``.
    Backward: the blocks' gradients joined over the group (an all-gather),
    since each rank holds only its own block's."""

    @staticmethod
    def forward(ctx, x, axes, axis, mesh):
        ctx.args = (axes, axis, mesh)
        return _own_block(x, axes, axis, mesh).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        axes, axis, mesh = ctx.args
        return _gather(grad, axes, axis, True, mesh), None, None, None


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, on each of them
    (backward: the identity, :class:`_PSum`)."""
    axes = _axes(axes)
    return _PSum.apply(x, axes, _mesh_for(axes))


def copy_to(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` as it is, entering a region split over ``axes`` (backward: the
    gradient's psum, :class:`_CopyTo`)."""
    axes = _axes(axes)
    return _CopyTo.apply(x, axes, _mesh_for(axes))


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    """The mean over the ranks of ``axes``; its gradient is the output's
    over their number, through :func:`psum`'s identity."""
    return psum(x, axes) / axis_size(axes)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise max over the ranks of ``axes``, with no gradient (a
    softmax's shift)."""
    return _all_reduce(x.detach(), _axes(axes), dist.ReduceOp.MAX, "pmax")


def all_gather(x: torch.Tensor, axes, *, axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, in row-major order: stacked on a
    new dim ``axis``, or with ``tiled`` joined along ``axis`` (backward: a
    reduce-scatter, :class:`_AllGather`)."""
    axes = _axes(axes)
    return _AllGather.apply(x, axes, axis, tiled, _mesh_for(axes))


def constrain(x: torch.Tensor, *axes: str | None, held: tuple | None = None) -> torch.Tensor:
    """The reference's activation sharding constraint.  ``x`` is the rank's
    block under the logical axes ``held`` (None: already as ``axes`` ask);
    each dim whose layout differs is joined over the axes it is split over
    and then cut to the block ``axes`` ask for (backward: the rank's block,
    and the blocks joined, :class:`_Join` and :class:`_Split`).  The
    identity where the two layouts are the same, or with no mesh."""
    ctx = _ctx.get()
    if ctx is None or held is None or tuple(held) == tuple(axes):
        return x
    if len(held) != x.dim() or len(axes) != x.dim():
        raise ValueError(f"constrain: {x.dim()} dims, axes {axes}, held as {held}")
    used: set[str] = set()
    have = []
    for name in held:                        # the split each dim has, as logical_to_spec
        phys = tuple(a for a in (ctx.rule(name) if name else ()) if a not in used)
        used.update(phys)
        have.append(phys)
    shape = tuple(n * ctx.axes_size(h) for n, h in zip(x.shape, have))
    want = logical_to_spec(axes, shape, ctx)
    for dim, h in enumerate(have):
        w = want.axes(dim)
        if h == w:
            continue
        if h:
            x = _Join.apply(x, h, dim, ctx.mesh)
        if w:
            x = _Split.apply(x, w, dim, ctx.mesh)
    return x
