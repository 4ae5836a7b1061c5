"""Unified model API for the port.

Counterpart of ``repro/models/model.py``.  Every family of the reference is
ported: ``dense``, ``moe``, ``xlstm``, ``zamba2``, ``whisper`` and
``mllama``.  Whisper's and mLLaMA's ``prefill``, ``forward`` and
``loss`` take the whole batch, as the reference's do: beside ``tokens``,
the input named in ``EXTRA_INPUTS`` (audio frames, vision patch
embeddings).  ``loss`` and ``forward`` run with grad (training); the
serving calls run under ``no_grad``.  A ``Model`` lives on one device:
``cuda`` unless the caller passes ``device="cpu"`` (or ``"meta"``, the
dry run's: every tensor a shape and a dtype, nothing allocated).

The dry run's surface is the reference's: the ``WORKLOADS`` table,
``abstract_params`` and ``abstract_cache`` (``meta`` tensors where the
reference has ``jax.eval_shape``), ``input_specs`` (each workload's model
inputs as ``meta`` tensors) and ``supports``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.sharding import local_blocks

from . import mllama_model, transformer, whisper_model, xlstm_model, zamba2_model
from .common import ModelConfig

__all__ = ["Model", "resolve_device", "EXTRA_INPUTS", "WORKLOADS", "Workload"]


@dataclass(frozen=True)
class Workload:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# the reference's table (repro/models/model.py), entry for entry
WORKLOADS: dict[str, Workload] = {
    "train_4k": Workload("train_4k", 4_096, 256, "train"),
    "prefill_32k": Workload("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Workload("decode_32k", 32_768, 128, "decode"),
    "long_500k": Workload("long_500k", 524_288, 1, "decode"),
}


class _OnMeta(TorchFunctionMode):
    """Every tensor a torch function makes lands on ``meta`` and draws
    nothing: ``device=`` is rewritten and ``generator=`` dropped, so a
    family's ``init_params`` builds its tree from shapes and dtypes alone."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        kwargs.pop("generator", None)
        return func(*args, **kwargs)

# the families whose prefill needs an input beside the tokens, and its key
EXTRA_INPUTS = {"whisper": "frames", "mllama": "vision"}
_FAMILIES = {"dense": transformer, "moe": transformer, "xlstm": xlstm_model,
             "zamba2": zamba2_model, "whisper": whisper_model, "mllama": mllama_model}


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``cuda`` unless ``device`` names another (``cpu``, or ``meta`` for the
    dry run); a CUDA device must exist."""
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
        """Random parameters drawn from ``seed``.  Under a mesh
        (``sharding.use_mesh``, the rank placed on it) each leaf is the
        rank's block of the same global draw (``sharding.local_blocks``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return local_blocks(self._m.init_params(self.cfg, gen))

    def abstract_params(self, *, whole: bool = False) -> dict:
        """The parameter tree as ``meta`` tensors of each leaf's shape and
        dtype, allocating nothing (the reference's ``jax.eval_shape`` of
        ``init``): the family's ``init_params`` run with every factory on
        ``meta`` and no generator drawn from.  Under a mesh, the rank's
        blocks (the dry run counts one device's step on them), unless
        ``whole`` asks for the global shapes the specs read."""
        with _OnMeta():
            tree = self._m.init_params(self.cfg, torch.Generator())
        return tree if whole else local_blocks(tree)

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

    def abstract_cache(self, batch: int, max_seq: int) -> dict:
        """The serving cache as ``meta`` tensors (``jax.eval_shape`` of
        ``init_cache`` in the reference)."""
        return self._m.init_cache(self.cfg, batch, max_seq, None, device="meta")

    # -- dry-run inputs ------------------------------------------------------------

    def input_specs(self, wl: Workload) -> dict:
        """One workload's model inputs as ``meta`` tensors, as the
        reference's ``input_specs``: the tokens (B, S) int32 (with Whisper's
        frames or mLLaMA's vision embeddings) for train and prefill; for
        decode one token (B, 1) and a cache whose capacity is S + 1 rounded
        up to a multiple of 256, as the reference rounds it."""
        cfg = self.cfg
        b, s = wl.global_batch, wl.seq_len
        meta = dict(device="meta")
        if wl.kind in ("train", "prefill"):
            batch = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta)}
            if cfg.family == "whisper":
                batch["frames"] = torch.empty((b, cfg.encoder_positions, cfg.d_model),
                                              dtype=cfg.cdt, **meta)
            if cfg.family == "mllama":
                batch["vision"] = torch.empty((b, cfg.vision_tokens, cfg.d_model),
                                              dtype=cfg.cdt, **meta)
            return batch
        cap = -(-(s + 1) // 256) * 256
        cache = self.abstract_cache(b, cap)
        cache["len"] = torch.empty((b,), dtype=torch.int32, **meta)
        return {"tokens": torch.empty((b, 1), dtype=torch.int32, **meta), "cache": cache}

    def supports(self, wl: Workload) -> tuple[bool, str]:
        """Arch x shape applicability, the reference's rule and reason."""
        if wl.name == "long_500k" and self.cfg.family not in ("xlstm", "zamba2"):
            return False, "500k decode needs sub-quadratic attention (SSM/hybrid only)"
        return True, ""

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
