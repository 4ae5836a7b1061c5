"""Shared model substrate: config, init helper, RMSNorm, LayerNorm, RoPE,
the loss and the per-layer remat policy.

Counterpart of ``repro/models/common.py``.  ``ModelConfig`` mirrors the
reference field for field; ``pdt``/``cdt`` return torch dtypes.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["ModelConfig", "rms_norm", "layer_norm", "apply_rope", "rope_freqs", "dense_init",
           "cross_entropy", "remat", "stack_shapes", "stack_draws", "tree_at", "tree_items",
           "tree_map"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | xlstm | zamba2 | whisper | mllama
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention / mlp features
    mlp_act: str = "swiglu"          # swiglu | geglu
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    embed_scale: bool = False        # gemma: inputs scaled by sqrt(d_model)
    gemma_norm: bool = False         # RMSNorm with (1 + scale)
    # moe
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_aux_weight: float = 0.001
    moe_capacity_factor: float = 0.0
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0
    # xlstm
    slstm_every: int = 8
    # enc-dec / vlm
    encoder_layers: int = 0
    encoder_positions: int = 0
    cross_attn_every: int = 0
    vision_tokens: int = 0
    # numerics / system
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "block"             # none | block | dots; training only (``remat``)
    seq_shard_activations: bool = False
    attn_chunk: int = 0              # reference's XLA attention strategy; the
                                     # port's prefill always runs the flash kernel
    attn_scores_bf16: bool = False
    use_pallas: bool = False         # reference's TPU switch; the port's dense
                                     # path always goes through its kernels' ops
    max_seq: int = 0                 # learned-pos-embed capacity (0 -> 4096)

    def max_positions(self) -> int:
        return self.max_seq or 4096

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def pdt(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def scaled(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)

    # -- analytics (the reference's, formula for formula) ----------------------

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.family == "moe":
            ffn = 3 * d * self.d_ff * self.num_experts
            if self.num_shared_experts:
                ffn += 3 * d * self.d_ff_shared + d
        elif self.family in ("xlstm", "zamba2"):
            ffn = 0  # accounted inside block_params below
        else:
            ffn = 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "xlstm":
            di = self.ssm_expand * d
            m = 4 * d * di + 2 * di * d  # mLSTM-ish in/out + gates
            return self.num_layers * m + emb
        if self.family == "zamba2":
            di = self.ssm_expand * d
            mamba = d * (2 * di + 2 * self.ssm_state) + di * d
            shared = attn + 3 * d * self.d_ff  # ONE shared block
            return self.num_layers * mamba + shared + emb
        layers = self.num_layers * (attn + ffn)
        if self.family == "whisper":
            layers += self.encoder_layers * (attn + 3 * d * self.d_ff)
            layers += self.num_layers * attn  # decoder cross-attention
        if self.family == "mllama":
            n_cross = self.num_layers // max(self.cross_attn_every, 1)
            layers = (self.num_layers - n_cross) * (attn + ffn) + n_cross * (attn + ffn)
        return layers + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        ffn = 3 * d * self.d_ff * self.top_k
        if self.num_shared_experts:
            ffn += 3 * d * self.d_ff_shared + d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * (attn + ffn) + emb


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
             gemma: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim.  ``scale`` is whole: under FSDP (its
    ``embed`` dim split over ``data``) the caller gathers it first, as the
    dense layers do (``transformer._Plan.weight``)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if gemma else scale.float()
    return (xf * s).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``layer_norm``: mean, variance and the affine in f32,
    cast back to ``x.dtype``."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> (sin, cos) of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); sin/cos: (..., S, hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    s = sin[..., None, :]
    c = cos[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype, *,
               fan_in: int | None = None, scale: float = 1.0) -> torch.Tensor:
    """Normal(0, scale/sqrt(fan_in)) on the generator's device, cast to dtype."""
    fan = fan_in if fan_in is not None else shape[0]
    std = scale / (fan ** 0.5)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * std).to(dtype)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  z_loss: float = 0.0, vocab_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """Token-mean CE over (B, S, V) logits, f32 logsumexp; optional z-loss.

    Vocab-parallel where ``vocab_axes`` (mesh axes larger than 1) split the
    logits' last dim: ``logits`` are then the rank's block of the vocab,
    ``targets`` global ids, and the rank's share is found from its index
    over the axes.  The row max is a ``pmax`` (no gradient: the
    log-sum-exp does not depend on the shift), the exp-sums a ``psum``, and
    the gold logit is taken on the rank that holds it (0 elsewhere) and
    ``psum``'d; the z-loss reads the same global log-sum-exp.  No rank
    builds whole-vocab logits, and every rank joins every collective, its
    block holding targets or not."""
    logits = logits.float()
    if not vocab_axes:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    else:
        from repro_torch.sharding import axis_index, pmax, psum

        n = logits.shape[-1]
        local = targets.long() - axis_index(vocab_axes) * n
        mine = (local >= 0) & (local < n)
        shift = pmax(logits.detach().amax(dim=-1), vocab_axes)
        sums = psum(torch.exp(logits - shift[..., None]).sum(dim=-1), vocab_axes)
        lse = shift + torch.log(sums)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = psum(torch.where(mine, gold, torch.zeros_like(gold)), vocab_axes)
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


# ---------------------------------------------------------------------------
# remat (the reference's ``_maybe_remat``)
# ---------------------------------------------------------------------------

_SAVED_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                        torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    """``dots``: keep matrix products' outputs, recompute the rest (the
    reference's ``checkpoint_dots``)."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _save_dots)


def remat(fn, policy: str, *args):
    """``fn(*args)`` under the per-layer remat policy:

    * ``none``  — run it, keeping every activation for the backward;
    * ``block`` — keep only its inputs and recompute it in the backward
      (``torch.utils.checkpoint``, non-reentrant);
    * ``dots``  — the same, but matrix products' outputs are kept and not
      recomputed (a selective checkpoint).

    All three give the same gradients.  Without grad (serving, or a
    forward under ``no_grad``) it just runs ``fn``."""
    if policy not in ("none", "block", "dots"):
        raise ValueError(f"remat policy {policy!r}: expected none, block or dots")
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_DOTS_CONTEXT)
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# stacked parameter trees (the reference's scanned layers)
# ---------------------------------------------------------------------------


def stack_shapes(spec: dict, lead: tuple[int, ...]) -> dict:
    """A layer's shape tree with ``lead`` axes in front of every leaf."""
    return {k: stack_shapes(v, lead) if isinstance(v, dict) else lead + tuple(v)
            for k, v in spec.items()}


def tree_at(tree: dict, *idx) -> dict:
    """Views of one layer's parameters in a tree of stacked leaves."""
    return {k: tree_at(v, *idx) if isinstance(v, dict) else v[idx] for k, v in tree.items()}


def stack_draws(draw, lead: tuple[int, ...]) -> dict:
    """A tree of stacked leaves of shape ``lead + shape``: ``draw()`` gives
    one layer's tree, drawn on its own for each index and copied in, so the
    peak is one layer above the stacked tree."""
    out = None
    for idx in itertools.product(*map(range, lead)):
        layer = draw()
        if out is None:
            out = _empty_like_stacked(layer, lead)
        _copy_at(out, layer, idx)
    return out


def _empty_like_stacked(tree: dict, lead: tuple[int, ...]) -> dict:
    return {k: _empty_like_stacked(v, lead) if isinstance(v, dict)
            else torch.empty(lead + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def _copy_at(out: dict, tree: dict, idx: tuple) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _copy_at(out[k], v, idx)
        else:
            out[k][idx].copy_(v)


def tree_items(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists, dict keys in sorted
    order as ``jax.tree_util`` flattens them; a path reads like the
    reference's ``keystr`` (``['params']['layers'][0]['attn']['wq']``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    in a tree of the same structure, visited in :func:`tree_items`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
