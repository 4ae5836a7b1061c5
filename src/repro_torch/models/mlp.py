"""Feed-forward layers: the gated dense MLP.

Counterpart of ``init_mlp`` / ``gated_mlp`` in ``repro/models/mlp.py``.
The matmuls stay ``torch.matmul``, as the reference leaves them to XLA.
The MoE layer comes with its family (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init

__all__ = ["gated_mlp", "init_mlp"]


def _act(name: str):
    if name == "swiglu":
        return F.silu
    if name == "geglu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    }


def gated_mlp(params: dict, x: torch.Tensor, *, act: str = "swiglu") -> torch.Tensor:
    a = _act(act)
    h = a(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
