"""The step builders for train, prefill and decode.

Counterpart of ``repro/launch/steps.py``'s ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``; its sharding helpers
(partition specs, shardings for a mesh) wait for the trainer's mesh
(ROADMAP.md, Queue 1 item 8b).  Each builder returns a plain function of
tensors, run as it is on the card, the CPU or ``meta`` (the dry run,
``launch/dryrun.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_items, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


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
