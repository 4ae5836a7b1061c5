"""AdamW with fp32 master weights over low-precision compute params.

Counterpart of ``repro/optim/adamw.py``, with its state layout:

    params : compute dtype (bf16 in production)
    master : fp32 master copy
    m, v   : fp32 moments
    step   : int32 scalar

Update: global-norm clip -> AdamW on master -> params = master cast to
the params' dtype, in the reference's order.  The port updates the state
in place (the reference's jit donates it): ``master``, ``m`` and ``v``
through ``torch._foreach_*`` over all leaves at once, then each param
leaf is overwritten from its master.  The clip scale stays on the device
(no host sync); the learning rate is the schedule's value at the new step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.common import tree_items, tree_map

__all__ = ["AdamW", "TrainState"]

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

    @torch.no_grad()
    def update(self, state: TrainState, grads) -> tuple[TrainState, dict]:
        """One step from ``grads`` (a tree like ``state["params"]``); the
        state is updated in place and returned with ``{"grad_norm",
        "lr"}``."""
        g = [x.float() for x in _leaves(grads)]
        m, v, w = _leaves(state["m"]), _leaves(state["v"]), _leaves(state["master"])
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = int(state["step"]) + 1
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** step
        c2 = 1 - b2 ** step
        torch._foreach_mul_(g, scale)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        del g
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, c1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, w, alpha=self.weight_decay)
        torch._foreach_add_(w, upd, alpha=-lr)
        del upd
        for p, master in zip(_leaves(state["params"]), w):
            p.copy_(master)
        state["step"].fill_(step)
        return state, {"grad_norm": gnorm, "lr": lr}
