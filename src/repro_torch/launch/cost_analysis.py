"""The cost of one step, counted op by op: the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference compiles a step and reparses its optimized HLO; the port
runs the step under a ``TorchDispatchMode`` that sees every aten op it
dispatches, on any device.  On ``meta`` tensors (the dry run) nothing is
allocated or computed and a full-width step counts in seconds; on the
card the same step gives the same numbers (``chip_smoke.py`` checks it).

* **FLOPs** — ``torch.utils.flop_counter``'s formulas for the matmul
  family (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions): 2 M N K,
  the reference's ``2 x result_elems x k`` for a ``dot``.  Each is filed
  under the peak rate of its operands' type: bf16 and f16 products on the
  tensor cores, f32 on the CUDA cores.  A Hopper kernel adds its ``cost``
  (``kernels/*/ops.py``) and its own peak.  Elementwise ops add no FLOPs,
  as in the reference.
* **Bytes** — the reference's convention (``hlo_analysis.py:12-19``):
  every op is charged its tensor operands plus its results.  Views and
  metadata ops (``_FREE``, and every op whose schema returns an alias)
  are free, as ``bitcast``/``get-tuple-element`` are; so are allocations
  (``empty``: nothing is read or written) and ``log_sigmoid``'s buffer
  (the CPU kernel's scratch: the card's kernel returns it empty).  An
  in-place write of a window (``copy_`` into a slice, ``index_put_``,
  ``index_copy_``, ``index_add_``, ``scatter``) is charged the window
  only, as the reference charges a ``dynamic-update-slice``: the source
  (and indices) read and the window written, never the whole buffer it
  lands in, or a decode step would be charged the whole KV cache.  An ``out=`` operand is a result, charged
  once.
* **Kernels** — a wrapper's ``kernels/_device.kernel_call`` records the
  kernel's ``cost`` once and hides the aten ops the wrapper runs around
  the launch: the record replaces them.
* **Collectives** — none at world size 1: ``collective_wire_bytes`` is 0
  and every collective of the reference's table counts 0.
* **Memory** — the arguments' and the results' bytes (storages counted
  once; results that alias an argument, as an updated cache does, also
  under ``alias_bytes``), and the peak of live storages: each storage is
  counted from the op that makes it until its last tensor dies (a
  ``weakref.finalize`` on the storage), the arguments included from the
  start.  Python reference cycles could only delay a free, so the peak is
  an upper estimate of what the ops hold; the caching allocator's
  rounding and fragmentation are not in it.

The MoE layer's dropless path, which sizes its expert GEMMs from group
sizes read to the host, has a shape-only rule on ``meta``
(``models/mlp.py``): its T·k routed rows spread evenly over the experts.
Its FLOPs are the same for any split; its bytes equal the card's when
every expert is routed to.

Under ``torch.utils.checkpoint`` the recomputed forward is counted again,
as the reference's HLO counts remat; the ``dots`` policy's saved products
are not recomputed and not counted twice (its selective-checkpoint mode
nests inside this one).

Usage::

    costs = count(step, *args)          # StepCosts
    costs.flops, costs.bytes, costs.memory, costs.top_ops(10)
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _device

__all__ = ["count", "CostCounter", "StepCosts", "COLLECTIVES"]

# the reference's collective kinds (hlo_analysis._COLLECTIVES): all 0 here
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

aten = torch.ops.aten

# ops that move no bytes: allocations, aliases and metadata (views are found
# from their schemas as well)
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh, aten.resize_,
         aten.set_, aten._local_scalar_dense, aten.view, aten._unsafe_view,
         aten.as_strided, aten.sym_size, aten.sym_stride, aten.sym_numel, aten.is_same_size}

# in-place writes of a window of ``self``: charged the operands but ``self``
# (the source, the indices) and the window written, the source's size
_WINDOW_WRITES = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.index_add_,
                  aten.scatter_, aten.scatter_add_, aten.scatter_reduce_, aten.index_fill_,
                  aten.masked_scatter_}

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _peak_class(dtype: torch.dtype) -> str:
    """The peak a product of this type runs at: ``bf16`` (tensor cores) or
    ``f32`` (CUDA cores)."""
    return "bf16" if dtype in _LOW_PRECISION else "f32"


def _op_bytes(func, args, kwargs, out) -> int:
    packet = func.overloadpacket
    if packet is aten.log_sigmoid_forward:     # (output, buffer): the buffer is the
        out = out[0]                           # CPU kernel's scratch, empty on the card
    elif packet is aten.log_sigmoid_backward:  # (grad, self, buffer)
        args = args[:2]
    if packet is aten.copy_:                       # dst window written, src read
        return _nbytes(args[0]) + _nbytes(args[1]) if isinstance(args[1], torch.Tensor) \
            else _nbytes(args[0])
    if packet in _WINDOW_WRITES:
        rest = _tensors((args[1:], kwargs))
        window = max((_nbytes(t) for t in rest if t.is_floating_point()), default=0)
        return sum(map(_nbytes, rest)) + window
    outs = _tensors(kwargs.get("out")) if "out" in kwargs else []
    ins = _tensors((args, {k: v for k, v in kwargs.items() if k != "out"}))
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs or _tensors(out)))


@dataclass
class StepCosts:
    """What :func:`count` found for one step; ``ops`` maps an op (``aten.mm``)
    or a kernel (``kernel.flash_attention``) to its calls, FLOPs and bytes."""

    flops: float
    flops_bf16: float
    flops_f32: float
    bytes: float
    collective_wire_bytes: float
    collectives: dict
    ops: dict
    memory: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "flops_bf16": self.flops_bf16,
                "flops_f32": self.flops_f32, "bytes": self.bytes,
                "collective_wire_bytes": self.collective_wire_bytes,
                "collectives": self.collectives, "ops": self.ops}

    def kernels(self) -> dict:
        """Calls of each Hopper kernel the step ran (or stood in for)."""
        return {k[len("kernel."):]: v["calls"] for k, v in self.ops.items()
                if k.startswith("kernel.")}

    def top_ops(self, n: int = 25, by: str = "bytes") -> list[tuple]:
        """The counterpart of ``top_instructions``: the ``n`` most expensive
        ops as (cost, op, calls), ``by`` "bytes" or "flops"."""
        rows = [(v[by], k, v["calls"]) for k, v in self.ops.items() if v[by] > 0]
        return sorted(rows, key=lambda r: -r[0])[:n]


class CostCounter(TorchDispatchMode):
    """``with CostCounter(args) as c: out = step(*args)``, then
    ``c.costs(out)``: the step's :class:`StepCosts`.  ``args`` are the
    step's inputs (their storages are live from the start)."""

    def __init__(self, args=()):
        super().__init__()
        self.hidden = 0                  # > 0 inside a kernel_call: ops not counted
        self.flops = {"bf16": 0.0, "f32": 0.0}
        self.bytes = 0.0
        self.ops: dict[str, dict] = {}
        self.live = self.peak = 0
        self._storages: dict[int, int] = {}
        self._args = _tensors(args)
        for t in self._args:
            self._track(t)

    # -- storages: live bytes and their peak ------------------------------------

    def _free(self, key: int, nbytes: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        nbytes = st.nbytes()
        self._storages[key] = nbytes
        weakref.finalize(st, self._free, key, nbytes)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    # -- the count -----------------------------------------------------------------

    def _add(self, key: str, flops: float, nbytes: float) -> None:
        rec = self.ops.get(key)
        if rec is None:
            rec = self.ops[key] = {"calls": 0, "flops": 0.0, "bytes": 0.0}
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.bytes += nbytes

    def record_kernel(self, name: str, flops: float, nbytes: float, peak: torch.dtype) -> None:
        """One call of a Hopper kernel at its ``cost`` (``kernel_call``)."""
        self.flops[_peak_class(peak)] += flops
        self._add(f"kernel.{name}", flops, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        packet = func.overloadpacket
        if self.hidden or packet in _FREE or func.is_view:
            return out
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            first = next(iter(_tensors(args)), None)
            self.flops[_peak_class(first.dtype if first is not None else torch.float32)] += flops
        self._add(str(packet), flops, _op_bytes(func, args, kwargs, out))
        return out

    def __enter__(self):
        _device.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _device.COUNTERS.remove(self)

    def costs(self, outputs=()) -> StepCosts:
        """The count so far, with the memory of ``outputs``."""
        def unique_bytes(ts):
            seen = {}
            for t in ts:
                st = t.untyped_storage()
                seen[id(st)] = st.nbytes()
            return seen

        arg, res = unique_bytes(self._args), unique_bytes(_tensors(outputs))
        memory = {"argument_bytes": sum(arg.values()), "output_bytes": sum(res.values()),
                  "alias_bytes": sum(v for k, v in res.items() if k in arg),
                  "peak_bytes": self.peak}
        return StepCosts(
            flops=self.flops["bf16"] + self.flops["f32"], flops_bf16=self.flops["bf16"],
            flops_f32=self.flops["f32"], bytes=self.bytes, collective_wire_bytes=0.0,
            collectives={c: {"count": 0, "wire_bytes": 0.0} for c in COLLECTIVES},
            ops=dict(self.ops), memory=memory)


def count(fn, *args, **kwargs) -> StepCosts:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter` and return
    its :class:`StepCosts` (FLOPs, bytes, per-op breakdown, memory)."""
    with CostCounter((args, kwargs)) as counter:
        out = fn(*args, **kwargs)
    return counter.costs(out)
