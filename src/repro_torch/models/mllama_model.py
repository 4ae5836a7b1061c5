"""Llama-3.2-Vision-style decoder: self-attention layers with a gated
cross-attention layer every ``cross_attn_every`` layers (vision frontend
stubbed).

Counterpart of ``repro/models/mllama_model.py``: ``forward``, ``loss_fn``
and ``prefill`` take precomputed patch embeddings (B, vision_tokens, D)
beside the tokens, as the reference does.  Training runs each self layer
under the config's remat policy (the reference's ``jax.checkpoint`` of
its self-layer body); the cross layers run as they are, as there.  Groups of [``cross_attn_every`` -
1 self-attention layers + 1 gated cross-attention layer]; GQA, SwiGLU,
RoPE on the text self-attention only; the cross-attention output and its
MLP are scaled by ``tanh`` of their gates, which initialise to zero as in
the reference (so freshly initialised cross layers add nothing).

The parameter tree and the cache keep the reference's layout: stacked
leaves ``self_layers`` ``(ng, ns, ...)`` and ``cross_layers`` ``(ng,
...)`` (the gates ``(ng,)``), and a cache of the self K/V ``(ng, ns, B,
Smax, KV, hd)``, the cross K/V from the vision input ``(ng, B,
vision_tokens, KV, hd)`` and ``len (B,)``.  Python loops replace the
nested ``lax.scan``, each layer reading views of the stacked leaves.

Three places go through the Hopper kernels (``plain=True`` takes their
plain versions instead):

* attention: the self layers through ``transformer.layer_body`` (causal
  flash attention at prefill; at decode the step's k/v appended in place,
  then decode attention: the reference's ``decode_attention_plus`` and
  ``_cache_scatter`` under the port's contract); the cross layers through
  non-causal flash attention over the vision K/V at prefill and decode
  attention over all of it at decode;
* every RMSNorm, each with the residual add in front of it, through the
  fused residual-add + RMSNorm kernel: a self layer's ``ln1`` takes the
  previous layer's FFN output, its ``ln2`` the attention output; a cross
  layer's ``ln1`` takes the previous FFN output, its ``ln2`` the gated
  attention output ``tanh(gate_attn) * a``; its gated MLP output
  ``tanh(gate_mlp) * mlp`` goes into the next layer's ``ln1`` or the final
  norm.  A call is 2L + 1 launches: 21 at 10 layers, 201 at 100.

``decode_step`` updates ``cache`` in place and returns it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref

from .attention import attention, cross_attention_decode
from .common import (ModelConfig, cross_entropy, dense_init, remat, rope_freqs, stack_draws,
                     stack_shapes, tree_at)
from .mlp import gated_mlp, init_mlp
from .transformer import _proj, _train_layer, init_attn, layer_body
from .transformer import param_shapes as transformer_shapes

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "prefill", "decode_step",
           "init_cache", "layout"]


def layout(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, self layers per group); raises unless ``cross_attn_every``
    (> 1) tiles the depth."""
    if cfg.cross_attn_every <= 1 or cfg.num_layers % cfg.cross_attn_every:
        raise ValueError(f"mllama: {cfg.num_layers} layers are not whole groups of "
                         f"cross_attn_every={cfg.cross_attn_every} layers (> 1: at least one "
                         f"self layer before each cross layer)")
    return cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's structure with each leaf's shape."""
    ng, ns = layout(cfg)
    d = cfg.d_model
    layer = transformer_shapes(cfg.scaled(num_layers=1))["layers"][0]
    tree = {
        "tok_embed": (cfg.vocab_size, d),
        "self_layers": stack_shapes(layer, (ng, ns)),
        "cross_layers": stack_shapes({**layer, "gate_attn": (), "gate_mlp": ()}, (ng,)),
        "final_norm": {"scale": (d,)},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.vocab_size, d)
    return tree


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn from ``gen``; the cross
    layers' gates are zeros, as the reference's."""
    ng, ns = layout(cfg)
    dev, d = gen.device, cfg.d_model
    ones = lambda: torch.ones((d,), dtype=torch.float32, device=dev)  # noqa: E731
    zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa: E731

    def self_layer():
        return {"attn": init_attn(gen, cfg), "mlp": init_mlp(gen, d, cfg.d_ff, cfg.pdt),
                "ln1": {"scale": ones()}, "ln2": {"scale": ones()}}

    params = {
        "tok_embed": dense_init(gen, (cfg.vocab_size, d), cfg.pdt, fan_in=d),
        "self_layers": stack_draws(self_layer, (ng, ns)),
        "cross_layers": stack_draws(lambda: {**self_layer(), "gate_attn": zero(),
                                             "gate_mlp": zero()}, (ng,)),
        "final_norm": {"scale": ones()},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.vocab_size, d), cfg.pdt)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _vision_kv(p: dict, vision: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _proj(vision, p["attn"]["wk"]), _proj(vision, p["attn"]["wv"])


def _gate(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``tanh`` of a gate in f32, cast to the stream's dtype (the
    reference's rounding, ``mllama_model.py:79``)."""
    return torch.tanh(g).to(dtype)


def _cross_block(p: dict, x: torch.Tensor, m: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, cfg: ModelConfig, *, cross_len: torch.Tensor | None,
                 plain: bool):
    """The gated cross-attention layer on the stream ``x`` plus the previous
    layer's FFN output ``m``, not yet added.  ``cross_len`` (B,) int32, the
    vision K/V's length in every row, at decode; None at prefill.  Returns
    (x, m) with ``x`` the stream after the gated attention and ``m`` the
    gated MLP output, not yet added."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    h, x = norm(x, m, p["ln1"]["scale"], eps=cfg.norm_eps)
    q = _proj(h, p["attn"]["wq"])
    if cross_len is not None:
        a = cross_attention_decode(q, ck, cv, cross_len, plain=plain)
    else:
        a = attention(q, ck, cv, causal=False, plain=plain)
    b, s, nh, hd = a.shape
    a = a.reshape(b, s, nh * hd) @ p["attn"]["wo"].reshape(nh * hd, -1).to(a.dtype)
    h, x = norm(x, _gate(p["gate_attn"], x.dtype) * a, p["ln2"]["scale"], eps=cfg.norm_eps)
    return x, _gate(p["gate_mlp"], x.dtype) * gated_mlp(p["mlp"], h, act=cfg.mlp_act)


def _stack(params: dict, x: torch.Tensor, sin, cos, cfg: ModelConfig, cache: dict, *,
           vision: torch.Tensor | None = None, plain: bool = False):
    """Every group on ``x``; returns (x, m) with the last layer's gated MLP
    output ``m`` not yet added.  Prefill (``vision`` given): each self
    layer's K/V and each cross layer's vision K/V are written into
    ``cache``.  Decode: each self layer appends the step's k/v at ``len``,
    each cross layer reads its cached vision K/V."""
    ng, ns = layout(cfg)
    decode = vision is None
    cross_len = None
    if decode:
        pos = cache["len"]
        write_pos = pos.clamp(max=cache["k"].shape[3] - 1).long()
        lengths = pos + 1
        cross_len = torch.full_like(pos, cache["ck"].shape[2])
    s = x.shape[1]
    m = None
    for g in range(ng):
        for i in range(ns):
            kv = (cache["k"][g, i], cache["v"][g, i], write_pos, lengths) if decode else None
            x, m, kv_out, _ = layer_body(tree_at(params["self_layers"], g, i), x, m, sin,
                                         cos, cfg, cache=kv, plain=plain)
            if not decode:
                cache["k"][g, i, :, :s] = kv_out[0]
                cache["v"][g, i, :, :s] = kv_out[1]
        pc = tree_at(params["cross_layers"], g)
        if decode:
            ck, cv = cache["ck"][g], cache["cv"][g]
        else:
            ck, cv = _vision_kv(pc, vision)
            cache["ck"][g] = ck
            cache["cv"][g] = cv
        x, m = _cross_block(pc, x, m, ck, cv, cfg, cross_len=cross_len, plain=plain)
    return x, m


def _head(params: dict, x: torch.Tensor, m: torch.Tensor, cfg: ModelConfig,
          plain: bool) -> torch.Tensor:
    """Logits of rms_norm(x + m): the last layer's add fused into the final norm."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    xn, _ = norm(x, m, params["final_norm"]["scale"], eps=cfg.norm_eps, want_residual=False)
    table = params.get("lm_head", params["tok_embed"])
    return xn @ table.to(xn.dtype).T


# ---------------------------------------------------------------------------
# training: forward + loss
# ---------------------------------------------------------------------------


def forward(params: dict, batch: dict, cfg: ModelConfig, *, plain: bool = False):
    """``batch``: ``tokens`` (B, S) and ``vision`` (B, T, D).  Logits at
    every position (B, S, V), and 0 (no auxiliary loss)."""
    ng, ns = layout(cfg)
    tokens, vision = batch["tokens"], batch["vision"].to(cfg.cdt)
    x = params["tok_embed"][tokens].to(cfg.cdt)
    sin, cos = rope_freqs(torch.arange(tokens.shape[1], device=tokens.device), cfg.head_dim,
                          cfg.rope_theta)
    m = None
    for g in range(ng):
        for i in range(ns):
            x, m, _ = remat(_train_layer, cfg.remat, tree_at(params["self_layers"], g, i), x,
                            m, sin, cos, cfg, plain)
        pc = tree_at(params["cross_layers"], g)
        ck, cv = _vision_kv(pc, vision)
        x, m = _cross_block(pc, x, m, ck, cv, cfg, cross_len=None, plain=plain)
    return _head(params, x, m, cfg, plain), torch.zeros((), device=tokens.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *, plain: bool = False):
    logits, _ = forward(params, batch, cfg, plain=plain)
    return cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device: torch.device | str) -> dict:
    ng, ns = layout(cfg)
    dt = dtype or cfg.cdt
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    self_kv = (ng, ns, batch, max_seq, kv, hd)
    cross_kv = (ng, batch, cfg.vision_tokens, kv, hd)
    return {
        "k": torch.zeros(self_kv, dtype=dt, device=device),
        "v": torch.zeros(self_kv, dtype=dt, device=device),
        "ck": torch.zeros(cross_kv, dtype=dt, device=device),
        "cv": torch.zeros(cross_kv, dtype=dt, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(params: dict, batch: dict, cfg: ModelConfig, *, max_seq: int | None = None,
            plain: bool = False):
    """``batch``: ``tokens`` (B, S) and ``vision`` (B, T, D).  Returns
    (last-position logits (B, 1, V), cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["tok_embed"][tokens].to(cfg.cdt)
    sin, cos = rope_freqs(torch.arange(s, device=tokens.device), cfg.head_dim,
                          cfg.rope_theta)
    cache = init_cache(cfg, b, max_seq or s, device=tokens.device)
    x, m = _stack(params, x, sin, cos, cfg, cache, vision=batch["vision"].to(cfg.cdt),
                  plain=plain)
    cache["len"].fill_(s)
    # the norm is per position, so only the last one is computed
    return _head(params, x[:, -1:], m[:, -1:], cfg, plain), cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                plain: bool = False):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache), with
    ``cache`` updated in place (k/v at each row's ``len``, then ``len +=
    1``) and returned."""
    x = params["tok_embed"][tokens].to(cfg.cdt)
    sin, cos = rope_freqs(cache["len"][:, None], cfg.head_dim, cfg.rope_theta)
    x, m = _stack(params, x, sin, cos, cfg, cache, plain=plain)
    cache["len"].add_(1)
    return _head(params, x, m, cfg, plain), cache
