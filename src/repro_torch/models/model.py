"""Unified model API for the port.

Counterpart of ``repro/models/model.py``.  The ``dense`` and ``xlstm``
families are ported; the others raise, naming their ROADMAP item.  A
``Model`` lives on one device: ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import torch

from . import transformer, xlstm_model
from .common import ModelConfig

__all__ = ["Model", "resolve_device"]

_NOT_PORTED = {
    "moe": "ROADMAP.md Queue 1 item 4 (MoE family)",
    "zamba2": "ROADMAP.md Queue 1 item 5 (Mamba2 / Zamba2)",
    "whisper": "ROADMAP.md Queue 1 item 6 (Whisper and mLLaMA)",
    "mllama": "ROADMAP.md Queue 1 item 6 (Whisper and mLLaMA)",
}
_FAMILIES = {"dense": transformer, "xlstm": xlstm_model}


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``cuda`` unless ``device`` names another; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; this package runs on the GPU "
                           "unless the caller passes device='cpu'")
    return dev


class Model:
    """``plain=True`` runs the kernels' plain PyTorch versions instead of the
    kernels (on any device), to hold the kernel path against them."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str | None = None,
                 plain: bool = False):
        if cfg.family not in _FAMILIES:
            if cfg.family in _NOT_PORTED:
                raise NotImplementedError(
                    f"family {cfg.family!r} is not ported yet: {_NOT_PORTED[cfg.family]}")
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        self._m = _FAMILIES[cfg.family]
        self.device = resolve_device(device)
        self.plain = plain

    # -- parameters -----------------------------------------------------------

    def init(self, seed: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self._m.init_params(self.cfg, gen)

    # -- steps ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, *, max_seq: int | None = None):
        return self._m.prefill(params, batch["tokens"], self.cfg, max_seq=max_seq,
                               plain=self.plain)

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        return self._m.decode_step(params, cache, tokens, self.cfg, plain=self.plain)

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> dict:
        return self._m.init_cache(self.cfg, batch, max_seq, dtype, device=self.device)

    @torch.no_grad()
    def splice_cache(self, cache: dict, single: dict, slot: int, length: int) -> None:
        """Copy the one-request cache ``single`` (from :meth:`prefill`) into
        slot ``slot`` of the batched ``cache``, in place, and set its
        length: K/V rows for the dense family, every state leaf along its
        batch axis for xLSTM."""
        self._m.splice_cache(cache, single, slot, length)
