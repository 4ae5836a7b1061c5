"""AdamW with fp32 master weights over low-precision compute params.

Counterpart of ``repro/optim/adamw.py``, with its state layout:

    params : compute dtype (bf16 in production)
    master : fp32 master copy
    m, v   : fp32 moments
    step   : int32 scalar

Update: global-norm clip -> AdamW on master -> params = master cast to
the params' dtype, in the reference's order.  The port updates the state
in place (the reference's jit donates it): ``master``, ``m`` and ``v``
through ``torch._foreach_*`` over the leaves a chunk at a time, then each
param leaf of the chunk is overwritten from its master.  A chunk holds
leaves up to ``CHUNK_BYTES`` of f32 (at least one leaf), so the update's
f32 temporaries (the grads widened, the denominator, the step) stay a
few chunks instead of f32 copies of the whole tree, 14.4 GB each for
full-width xlstm-1.3b's 3.6 B elements.  Every operation
is elementwise (the grad norm is each leaf's norm, then their norm), so
the result does not depend on the chunking, bit for bit.  The clip scale
stays on the device (no host sync); the learning rate is the schedule's
value at the new step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.common import tree_items, tree_map
from repro_torch.sharding import psum

__all__ = ["AdamW", "TrainState"]

CHUNK_BYTES = 1 << 30     # f32 bytes of the leaves one pass of the update takes

TrainState = dict  # {"params", "master", "m", "v", "step"}


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: dict) -> TrainState:
        """A fresh state around ``params`` (kept as they are): an f32 copy
        of each leaf as its master, zero moments, step 0."""
        dev = next(iter(_leaves(params))).device
        return {
            "params": params,
            "master": tree_map(lambda p: p.detach().float().clone(), params),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def _lr(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)

    @staticmethod
    def _chunks(leaves: list) -> list[range]:
        """Consecutive ranges of leaf indices, each up to ``CHUNK_BYTES`` of
        f32 (a larger leaf alone)."""
        out, start, size = [], 0, 0
        for i, leaf in enumerate(leaves):
            n = 4 * leaf.numel()
            if i > start and size + n > CHUNK_BYTES:
                out.append(range(start, i))
                start, size = i, 0
            size += n
        if start < len(leaves):
            out.append(range(start, len(leaves)))
        return out

    @torch.no_grad()
    def update(self, state: TrainState, grads, *, world=None) -> tuple[TrainState, dict]:
        """One step from ``grads`` (a tree like ``state["params"]``); the
        state is updated in place and returned with ``{"grad_norm",
        "lr"}``.

        On a mesh the leaves are the rank's blocks and ``world`` is (every
        axis of the mesh, the number of ranks that hold each leaf's block):
        the global norm is then each leaf's local sum of squares over its
        number of holders, ``psum``'d over the world, so the clip scale is
        the same on every rank and ``grad_norm`` is the value without a
        mesh."""
        grads = _leaves(grads)
        m, v, w = _leaves(state["m"]), _leaves(state["v"]), _leaves(state["master"])
        params = _leaves(state["params"])
        chunks = self._chunks(grads)
        norms = []
        for c in chunks:
            norms += torch._foreach_norm([grads[i].float() for i in c])
        if world is None:
            gnorm = torch.linalg.vector_norm(torch.stack(norms))
        else:
            axes, holders = world
            share = torch.stack(norms).square() / torch.tensor(holders, dtype=torch.float32,
                                                               device=norms[0].device)
            gnorm = psum(share.sum(), axes).sqrt()
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        # the step sets the learning rate and the bias corrections, Python
        # numbers; a meta state (the dry run) holds no value, and any step
        # gives the same count
        step = (0 if state["step"].is_meta else int(state["step"])) + 1
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** step
        c2 = 1 - b2 ** step
        for c in chunks:
            g = [grads[i].float() for i in c]
            mc, vc, wc = [m[i] for i in c], [v[i] for i in c], [w[i] for i in c]
            torch._foreach_mul_(g, scale)
            torch._foreach_mul_(mc, b1)
            torch._foreach_add_(mc, g, alpha=1 - b1)
            torch._foreach_mul_(vc, b2)
            torch._foreach_addcmul_(vc, g, g, value=1 - b2)
            del g
            denom = torch._foreach_div(vc, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mc, c1)
            torch._foreach_div_(upd, denom)
            del denom
            torch._foreach_add_(upd, wc, alpha=self.weight_decay)
            torch._foreach_add_(wc, upd, alpha=-lr)
            del upd
            for i in c:
                params[i].copy_(w[i])
        state["step"].fill_(step)
        return state, {"grad_norm": gnorm, "lr": lr}
