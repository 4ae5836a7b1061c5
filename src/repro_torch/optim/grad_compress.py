"""Error-feedback int8 gradient compression for the cross-pod reduce.

Counterpart of ``repro/optim/grad_compress.py``.  The production mesh's
cross-pod hop is the slow link, so its gradient sum is sent as int8 with
one f32 scale per tensor, and what the quantization loses is kept and
sent again next step (error feedback, so its bias does not accumulate).
The cross-pod sum of a tensor ``g`` on each pod's rank::

    x      = g + error              # apply EF memory (f32)
    scale  = max|x| / 127
    q      = round(x / scale) : int8
    error' = x - q * scale          # what quantization lost, re-sent next step
    qs     = all_gather(q, 'pod')   # int8 on the wire
    ss     = all_gather(scale, 'pod')
    sum    = sum_p qs[p] * ss[p]

Each rank holds its own blocks (``repro_torch.sharding``): the error
memory is sharded over ``pod``, so a rank's tree has a leading dim of 1
(:func:`init_error_state`'s default), and the batch a step takes is its
pod's share.  The step runs under ``sharding.shard_map`` over the mesh,
the collectives over ``pod``; within a pod the mesh's ``data`` and
``model`` axes must be 1.  The dense family's tensor-parallel and FSDP
layers train through ``launch.steps.make_train_step`` (ROADMAP.md Queue 1
item 8c, part one, whose cross-pod sum is a plain psum); this int8 sum
beside them is the last of item 8c's remaining parts.  The state is
updated in place, as ``make_train_step`` does.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_items, tree_map
from repro_torch.sharding import all_gather, mesh_shape, pmean, psum, shard_map

__all__ = ["ef_int8_psum", "tree_ef_int8_psum", "init_error_state",
           "make_hierarchical_train_step"]

SMALL_BYTES = 1024    # leaves below this are summed uncompressed


def ef_int8_psum(g: torch.Tensor, error: torch.Tensor, axis_name: str):
    """Compressed psum of one tensor over ``axis_name``.  Returns (the sum
    in ``g``'s dtype, the new f32 error)."""
    x = g.float() + error
    scale = torch.clamp(x.abs().amax(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_error = x - q.float() * scale
    del x
    qs = all_gather(q, axis_name)                   # int8 on the wire
    ss = all_gather(scale, axis_name)               # one f32 scalar per pod
    # sum_p qs[p] * ss[p], elementwise: as a product over the pod dim it
    # is a GEMM of inner size P, which cuBLAS runs far below the bytes' rate
    total = qs[0].float() * ss[0]
    for p in range(1, qs.shape[0]):
        total += qs[p].float() * ss[p]
    return total.to(g.dtype), new_error


def _sum_leaf(g: torch.Tensor, e: torch.Tensor, axis_name: str):
    if g.numel() * g.element_size() < SMALL_BYTES:
        return psum(g, axis_name), e
    return ef_int8_psum(g, e, axis_name)


def tree_ef_int8_psum(grads, errors, axis_name: str):
    """:func:`ef_int8_psum` over a tree; leaves under ``SMALL_BYTES`` are
    summed uncompressed (compressing a scalar costs more than it saves)
    and keep their error.  Returns (sums, errors), trees like ``grads``."""
    pairs = tree_map(lambda g, e: _sum_leaf(g, e, axis_name), grads, errors)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def init_error_state(abstract_params, npods: int = 1):
    """The EF memory: an f32 zero buffer per parameter leaf with a leading
    ``npods`` dim, on the leaf's device.  The dim is sharded over ``pod``,
    so the rank's block, which each rank holds, is ``npods=1``."""
    return tree_map(lambda p: torch.zeros((npods,) + tuple(p.shape), dtype=torch.float32,
                                          device=p.device), abstract_params)


def make_hierarchical_train_step(model, opt, mesh, *, compress: bool = True):
    """``step(state, ef_error, batch) -> (state, ef_error, metrics)``: the
    loss and grads of this pod's batch, the grads averaged over ``pod``
    (the compressed sum over ``npods`` with ``compress``, else ``pmean``),
    then ``opt.update``; state (replicated over ``pod``) and ``ef_error``
    (this pod's block, see :func:`init_error_state`; without ``compress``
    it is not read and may be None) are updated in place.  Metrics: ``loss`` (the pods' mean), ``grad_norm``, ``lr``."""
    sizes = mesh_shape(mesh)
    if "pod" not in sizes:
        raise ValueError("hierarchical step needs a 'pod' mesh axis")
    inner = {a: n for a, n in sizes.items() if a != "pod" and n > 1}
    if inner:
        raise NotImplementedError(f"mesh axes {inner} within a pod: the int8 cross-pod sum "
                                  f"beside tensor-parallel and FSDP layers is a remaining part "
                                  f"of ROADMAP.md Queue 1 item 8c")
    npods = sizes["pod"]

    def per_pod(state: dict, ef_error, batch: dict):
        params = state["params"]
        leaves = [p.requires_grad_() for _, p in tree_items(params)]
        loss = model.loss(params, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            loss = pmean(loss.detach(), "pod")
            # a leaf at a time, each grad freed as its sum replaces it: the
            # step holds one tree of grads and one leaf's temporaries
            if compress:
                errs = [e[0] for _, e in tree_items(ef_error)]      # this pod's slice
                for i, e in enumerate(errs):
                    total, new_err = _sum_leaf(grads[i], e, "pod")
                    if new_err is not e:
                        e.copy_(new_err)
                    grads[i] = total / npods
            else:
                for i in range(len(grads)):
                    grads[i] = pmean(grads[i], "pod")
        it = iter(grads)
        state, metrics = opt.update(state, tree_map(lambda _: next(it), params))
        return state, ef_error, dict(metrics, loss=loss)

    return shard_map(per_pod, mesh=mesh)
