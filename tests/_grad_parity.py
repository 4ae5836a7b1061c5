"""Training parity helpers shared by the port's family tests: one loss and
every gradient leaf of ``Model.loss`` against ``jax.value_and_grad`` of the
reference's loss, on the same bridged weights and batch."""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro_torch.models.common import tree_items, tree_map
from repro_torch.models.weights import params_from_numpy


def plain_kernel_forwards(monkeypatch) -> None:
    """The K1 and K2 autograd Functions' forward launches replaced by the
    plain versions, so the Functions run on CPU tensors (their backward
    wrappers take the plain backwards there by themselves)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops

    monkeypatch.setattr(rops, "_launch_fwd", lambda x, r, s, eps, gemma, want: rops.rmsnorm_ref(
        x, r, s, eps=eps, gemma=gemma, want_residual=want))
    monkeypatch.setattr(fops, "_launch_fwd", lambda q, k, v, causal, scale, lse:
                        fops.flash_attention_ref(q, k, v, causal=causal, scale=scale))


def port_loss_and_grads(model, params: dict, batch: dict):
    """(loss, {path: grad}) of ``model.loss`` at a copy of ``params`` whose
    leaves are new autograd leaves."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = model.loss(params, batch)
    paths, leaves = zip(*tree_items(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, {p: (torch.zeros_like(l) if g is None else g)
                  for p, l, g in zip(paths, leaves, grads)}


def assert_grads_match_jax(jloss, jparams, model, params: dict, batch: dict,
                           tol: float = 3e-5) -> int:
    """``jloss(jparams)`` and its gradient against the port's; every leaf
    within atol = rtol = ``tol``.  Returns the number of leaves compared."""
    jl, jg = jax.value_and_grad(jloss)(jparams)
    want = dict(tree_items(params_from_numpy(jax.tree.map(np.asarray, jg), model.cfg, "cpu")))
    loss, got = port_loss_and_grads(model, params, batch)
    np.testing.assert_allclose(loss.item(), float(jl), atol=tol, rtol=tol)
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path].float().numpy()
        assert np.abs(w).max() > 0 or "bias" in path or path.endswith(("/bk", "/bq", "/bv")), \
            f"{path}: the reference's gradient is 0"
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol, rtol=tol, err_msg=path)
    return len(got)
