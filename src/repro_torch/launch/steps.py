"""The training step.

Counterpart of ``repro/launch/steps.py``'s ``make_train_step``; its
sharding helpers (partition specs, shardings for a mesh, the dry-run's
batch specs) wait for the trainer's mesh (ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_items, tree_map

__all__ = ["make_train_step"]


def make_train_step(model, opt):
    """``train_step(state, batch) -> (state, metrics)``: the loss, its
    gradient through ``backward`` of every param leaf, then ``opt.update``
    on the state in place; metrics hold ``loss``, ``grad_norm`` and
    ``lr``."""

    def train_step(state: dict, batch: dict):
        params = state["params"]
        leaves = [p.requires_grad_() for _, p in tree_items(params)]
        loss = model.loss(params, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
        state, metrics = opt.update(state, tree_map(lambda _: next(grads), params))
        return state, dict(metrics, loss=loss.detach())

    return train_step
