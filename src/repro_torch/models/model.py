"""Unified model API for the port.

Counterpart of ``repro/models/model.py``.  Every family of the reference is
ported: ``dense``, ``moe``, ``xlstm``, ``zamba2``, ``whisper`` and
``mllama``.  Whisper's and mLLaMA's ``prefill``, ``forward`` and
``loss`` take the whole batch, as the reference's do: beside ``tokens``,
the input named in ``EXTRA_INPUTS`` (audio frames, vision patch
embeddings).  ``loss`` and ``forward`` run with grad (training); the
serving calls run under ``no_grad``.  A ``Model`` lives on one device:
``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from . import mllama_model, transformer, whisper_model, xlstm_model, zamba2_model
from .common import ModelConfig

__all__ = ["Model", "resolve_device", "EXTRA_INPUTS"]

# the families whose prefill needs an input beside the tokens, and its key
EXTRA_INPUTS = {"whisper": "frames", "mllama": "vision"}
_FAMILIES = {"dense": transformer, "moe": transformer, "xlstm": xlstm_model,
             "zamba2": zamba2_model, "whisper": whisper_model, "mllama": mllama_model}


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

    def _batch_input(self, batch: dict, what: str):
        """The family's input: the tokens, or the whole batch where it needs
        the ``EXTRA_INPUTS`` key too (raises if that is missing)."""
        key = EXTRA_INPUTS.get(self.cfg.family)
        if key is None:
            return batch["tokens"]
        if key not in batch:
            raise ValueError(f"{self.cfg.name}: the {self.cfg.family} family's {what} needs "
                             f"batch[{key!r}] beside 'tokens'; got keys {sorted(batch)}")
        return batch

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """The training loss (a scalar with grad), as the reference's ``loss``."""
        self._batch_input(batch, "loss")          # raises if the family's input is missing
        return self._m.loss_fn(params, batch, self.cfg, plain=self.plain)

    def forward(self, params: dict, batch: dict):
        """(logits at every position (B, S, V), auxiliary loss), with grad."""
        return self._m.forward(params, self._batch_input(batch, "forward"), self.cfg,
                               plain=self.plain)

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, *, max_seq: int | None = None):
        return self._m.prefill(params, self._batch_input(batch, "prefill"), self.cfg,
                               max_seq=max_seq, plain=self.plain)

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
        batch axis for xLSTM, both for Zamba2.  Whisper and mLLaMA have
        none: the serving plane's requests carry tokens alone, which their
        prefill cannot take."""
        key = EXTRA_INPUTS.get(self.cfg.family)
        if key is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: no slot splicing for the {self.cfg.family} family: a "
                f"request carries tokens alone and its prefill needs {key!r} (the "
                f"reference's server cannot serve it either); run it through prefill and "
                f"decode_step")
        self._m.splice_cache(cache, single, slot, length)
