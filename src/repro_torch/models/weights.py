"""Carry a parameter tree of the JAX reference across to the port.

The two packages cannot share weights through their random generators, so
the parity tests initialise the reference, turn its pytree into numpy
arrays (``jax.tree.map(np.asarray, params)``) and map it here.  Nothing in
this module imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sharding import local_blocks

from . import mllama_model, transformer, whisper_model, xlstm_model, zamba2_model
from .common import ModelConfig

__all__ = ["params_from_numpy", "state_from_numpy"]


def _tensor(a, device: torch.device | str) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is refused by torch.from_numpy; bf16 -> f32 -> bf16
        # is exact
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(node, spec, path: str, device, layer: int | None):
    if isinstance(spec, dict):
        if not isinstance(node, dict) or set(node) != set(spec):
            got = sorted(node) if isinstance(node, dict) else type(node).__name__
            raise KeyError(f"{path or '/'}: leaves {got}, expected {sorted(spec)}")
        return {k: _map(node[k], spec[k], f"{path}/{k}", device, layer) for k in spec}
    a = np.asarray(node)
    if layer is not None:
        a = a[layer]
    if tuple(a.shape) != tuple(spec):
        raise ValueError(f"{path}: shape {tuple(a.shape)}, expected {tuple(spec)}")
    return _tensor(a, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device: torch.device | str) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's parameters,
    every leaf mapped by name.

    Dense and MoE: the ``layers`` axis is unstacked into a list of
    per-layer dicts (an MoE layer's ``moe`` subtree, shared experts
    included, leaf by leaf).
    xLSTM: the port keeps the reference's stacked leaves as they are — the
    ``(ng, nm)`` axes of ``mlstm``/``ln_m``, the ``(ng,)`` axis of
    ``slstm`` (with its ``mlp``), ``ln_s`` and ``ln_s2``, and an untied
    ``lm_head``.
    Zamba2: the stacked leaves as they are too — the ``(ng, per)`` axes of
    ``mamba`` and ``ln_m``, one ``shared`` block (``attn``, ``mlp``,
    ``ln1``, ``ln2``) and an untied ``lm_head``.
    Whisper: the stacked leaves as they are too — ``encoder`` (``pos_embed``,
    ``layers`` with a leading layer axis, ``final_ln``) and ``decoder``
    (``tok_embed``, ``pos_embed``, ``layers``, ``final_ln``).
    mLLaMA: ``self_layers`` with leading ``(ng, ns)`` axes, ``cross_layers``
    with ``(ng,)`` (the gates ``(ng,)``), ``final_norm`` and, where untied,
    ``lm_head``.

    Under a mesh (``sharding.use_mesh``, the rank placed on it) each leaf is
    the rank's block (``sharding.local_blocks``): a test bridges the
    reference's tree onto any mesh."""
    stacked = {"xlstm": xlstm_model, "zamba2": zamba2_model, "whisper": whisper_model,
               "mllama": mllama_model}
    if cfg.family in stacked:
        return local_blocks(_map(tree, stacked[cfg.family].param_shapes(cfg), "", device, None))
    spec = transformer.param_shapes(cfg)
    if set(tree) != set(spec):
        raise KeyError(f"top-level leaves {sorted(tree)}, expected {sorted(spec)}")
    out = {}
    for key, sub in spec.items():
        if key == "layers":
            out[key] = [_map(tree[key], sub[i], f"/layers[{i}]", device, i)
                        for i in range(cfg.num_layers)]
        else:
            out[key] = _map(tree[key], sub, f"/{key}", device, None)
    return local_blocks(out)


def state_from_numpy(state: dict, cfg: ModelConfig, device: torch.device | str) -> dict:
    """The reference's AdamW state (``params``, ``master``, ``m``, ``v``,
    ``step``; numpy leaves) as the port's: each tree mapped by
    :func:`params_from_numpy` (the master and moments keep their f32), the
    step an int32 scalar.  A gradient tree maps the same way, through
    ``params_from_numpy``."""
    out = {k: params_from_numpy(state[k], cfg, device) for k in ("params", "master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                               device=device)
    return out
