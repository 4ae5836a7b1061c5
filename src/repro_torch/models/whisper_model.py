"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Counterpart of ``repro/models/whisper_model.py``: ``forward``, ``loss_fn``
and ``prefill`` take precomputed frame embeddings (B, encoder_positions,
D) beside the tokens, as the reference does.  Training runs each encoder
and decoder layer under the config's remat policy, where the reference
wraps each in ``jax.checkpoint``.  Pre-LayerNorm blocks, GELU MLPs
(tanh approximation), learned positional embeddings, no bias on q/k/v/o,
a decoder with causal self-attention and cross-attention to the encoder
output, tied unembedding.

The parameter tree and the cache keep the reference's layout: the encoder's
and the decoder's ``layers`` are stacked leaves with a leading layer axis
(each layer reads views of them), and the cache is the decoder's self K/V
``(L, B, Smax, H, hd)``, its cross K/V ``(L, B, encoder_positions, H, hd)``
and ``len (B,)``.  Python loops replace the ``lax.scan`` over layers.

Attention goes through the Hopper kernels (``plain=True`` takes their
plain versions instead): the encoder's (non-causal, Sq = Sk), the
decoder's self-attention (causal) and its cross-attention (non-causal, Sq
the prompt, Sk the encoder's positions) through the flash-attention
kernel at prefill; at decode the self-attention appends the step's k/v in
place and attends through the decode-attention kernel, and the
cross-attention runs the same kernel over the whole cached encoder K/V.
LayerNorm and the GELU MLP are plain torch: the reference computes them in
XLA, outside any Pallas kernel.  ``decode_step`` updates ``cache`` in place
and returns it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import attention, cross_attention_decode, decode_attention_append
from .common import (ModelConfig, cross_entropy, dense_init, layer_norm, remat, stack_draws,
                     stack_shapes, tree_at)
from .transformer import _proj

__all__ = ["init_params", "param_shapes", "encode", "forward", "loss_fn", "prefill",
           "decode_step", "init_cache"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _shapes(cfg: ModelConfig) -> tuple[dict, dict, dict]:
    d, h, hd, f = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    attn = {"wq": (d, h, hd), "wk": (d, h, hd), "wv": (d, h, hd), "wo": (h, hd, d)}
    return attn, {"w_in": (d, f), "w_out": (f, d)}, {"scale": (d,), "bias": (d,)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's structure with each leaf's shape."""
    attn, mlp, ln = _shapes(cfg)
    d = cfg.d_model
    enc_layer = {"attn": attn, "mlp": mlp, "ln1": ln, "ln2": ln}
    dec_layer = {"self_attn": attn, "cross_attn": attn, "mlp": mlp, "ln1": ln, "ln2": ln,
                 "ln3": ln}
    return {
        "encoder": {"pos_embed": (cfg.encoder_positions, d),
                    "layers": stack_shapes(enc_layer, (cfg.encoder_layers,)),
                    "final_ln": ln},
        "decoder": {"tok_embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_positions(), d),
                    "layers": stack_shapes(dec_layer, (cfg.num_layers,)),
                    "final_ln": ln},
    }


def _init_ln(cfg: ModelConfig, dev) -> dict:
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
            "bias": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev)}


def _init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {"wq": dense_init(gen, (d, h, hd), cfg.pdt),
            "wk": dense_init(gen, (d, h, hd), cfg.pdt, fan_in=d),
            "wv": dense_init(gen, (d, h, hd), cfg.pdt, fan_in=d),
            "wo": dense_init(gen, (h, hd, d), cfg.pdt, fan_in=h * hd)}


def _init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"w_in": dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.pdt),
            "w_out": dense_init(gen, (cfg.d_ff, cfg.d_model), cfg.pdt, fan_in=cfg.d_ff)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn from ``gen``."""
    dev, d = gen.device, cfg.d_model

    def enc_layer():
        return {"attn": _init_attn(gen, cfg), "mlp": _init_mlp(gen, cfg),
                "ln1": _init_ln(cfg, dev), "ln2": _init_ln(cfg, dev)}

    def dec_layer():
        return {"self_attn": _init_attn(gen, cfg), "cross_attn": _init_attn(gen, cfg),
                "mlp": _init_mlp(gen, cfg), "ln1": _init_ln(cfg, dev),
                "ln2": _init_ln(cfg, dev), "ln3": _init_ln(cfg, dev)}

    return {
        "encoder": {"pos_embed": dense_init(gen, (cfg.encoder_positions, d), cfg.pdt, fan_in=d),
                    "layers": stack_draws(enc_layer, (cfg.encoder_layers,)),
                    "final_ln": _init_ln(cfg, dev)},
        "decoder": {"tok_embed": dense_init(gen, (cfg.vocab_size, d), cfg.pdt, fan_in=d),
                    "pos_embed": dense_init(gen, (cfg.max_positions(), d), cfg.pdt, fan_in=d),
                    "layers": stack_draws(dec_layer, (cfg.num_layers,)),
                    "final_ln": _init_ln(cfg, dev)},
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _ln(x: torch.Tensor, p: dict) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"])


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]


def _out(a: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """a (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    b, s, h, hd = a.shape
    return a.reshape(b, s, h * hd) @ wo.reshape(h * hd, -1).to(a.dtype)


def _enc_layer(p: dict, x: torch.Tensor, plain: bool) -> torch.Tensor:
    h = _ln(x, p["ln1"])
    q, k, v = (_proj(h, p["attn"][w]) for w in ("wq", "wk", "wv"))
    x = x + _out(attention(q, k, v, causal=False, plain=plain), p["attn"]["wo"])
    return x + _mlp(p["mlp"], _ln(x, p["ln2"]))


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           plain: bool = False) -> torch.Tensor:
    """frames: (B, P, D) stub embeddings -> the encoder's output (B, P, D).
    With grad, each layer runs under the config's remat policy."""
    enc = params["encoder"]
    x = frames.to(cfg.cdt) + enc["pos_embed"][: frames.shape[1]].to(cfg.cdt)
    for i in range(cfg.encoder_layers):
        x = remat(_enc_layer, cfg.remat, tree_at(enc["layers"], i), x, plain)
    return _ln(x, enc["final_ln"])


def _dec_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict, *,
               enc_out: torch.Tensor | None = None, plain: bool = False) -> torch.Tensor:
    """Every decoder layer on ``x``.  Prefill (``enc_out`` given): the self
    K/V and the cross K/V from ``enc_out`` are written into ``cache``.
    Decode: the step's k/v are appended to ``cache`` at ``len`` and the
    cross-attention reads the cached cross K/V."""
    dec = params["decoder"]
    decode = enc_out is None
    if decode:
        pos = cache["len"]
        write_pos = pos.clamp(max=cache["k"].shape[2] - 1).long()
        lengths = pos + 1
        cross_len = torch.full_like(pos, cache["ck"].shape[2])
    s = x.shape[1]
    for i in range(cfg.num_layers):
        p = tree_at(dec["layers"], i)
        sa, ca = p["self_attn"], p["cross_attn"]
        h = _ln(x, p["ln1"])
        q, k, v = (_proj(h, sa[w]) for w in ("wq", "wk", "wv"))
        if decode:
            a = decode_attention_append(q, cache["k"][i], cache["v"][i], k, v, write_pos,
                                        lengths, plain=plain)
        else:
            a = attention(q, k, v, causal=True, plain=plain)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        x = x + _out(a, sa["wo"])
        qx = _proj(_ln(x, p["ln2"]), ca["wq"])
        if decode:
            a = cross_attention_decode(qx, cache["ck"][i], cache["cv"][i], cross_len,
                                       plain=plain)
        else:
            ck, cv = _proj(enc_out, ca["wk"]), _proj(enc_out, ca["wv"])
            a = attention(qx, ck, cv, causal=False, plain=plain)
            cache["ck"][i] = ck
            cache["cv"][i] = cv
        x = x + _out(a, ca["wo"])
        x = x + _mlp(p["mlp"], _ln(x, p["ln3"]))
    return x


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    dec = params["decoder"]
    return _ln(x, dec["final_ln"]) @ dec["tok_embed"].to(x.dtype).T


# ---------------------------------------------------------------------------
# training: forward + loss
# ---------------------------------------------------------------------------


def _dec_layer(p: dict, x: torch.Tensor, enc_out: torch.Tensor, plain: bool) -> torch.Tensor:
    """One decoder layer for training, the unit of remat: causal
    self-attention, cross-attention to ``enc_out``, the MLP."""
    sa, ca = p["self_attn"], p["cross_attn"]
    h = _ln(x, p["ln1"])
    q, k, v = (_proj(h, sa[w]) for w in ("wq", "wk", "wv"))
    x = x + _out(attention(q, k, v, causal=True, plain=plain), sa["wo"])
    qx = _proj(_ln(x, p["ln2"]), ca["wq"])
    ck, cv = _proj(enc_out, ca["wk"]), _proj(enc_out, ca["wv"])
    x = x + _out(attention(qx, ck, cv, causal=False, plain=plain), ca["wo"])
    return x + _mlp(p["mlp"], _ln(x, p["ln3"]))


def forward(params: dict, batch: dict, cfg: ModelConfig, *, plain: bool = False):
    """``batch``: ``tokens`` (B, S) and ``frames`` (B, P, D).  Logits at
    every position (B, S, V), and 0 (no auxiliary loss)."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frames"], cfg, plain=plain)
    dec = params["decoder"]
    x = dec["tok_embed"][tokens].to(cfg.cdt) + dec["pos_embed"][: tokens.shape[1]].to(cfg.cdt)
    for i in range(cfg.num_layers):
        x = remat(_dec_layer, cfg.remat, tree_at(dec["layers"], i), x, enc_out, plain)
    return _head(params, x), torch.zeros((), device=tokens.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *, plain: bool = False):
    logits, _ = forward(params, batch, cfg, plain=plain)
    return cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device: torch.device | str) -> dict:
    dt = dtype or cfg.cdt
    L, h, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    self_kv = (L, batch, max_seq, h, hd)
    cross_kv = (L, batch, cfg.encoder_positions, h, hd)
    return {
        "k": torch.zeros(self_kv, dtype=dt, device=device),
        "v": torch.zeros(self_kv, dtype=dt, device=device),
        "ck": torch.zeros(cross_kv, dtype=dt, device=device),
        "cv": torch.zeros(cross_kv, dtype=dt, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(params: dict, batch: dict, cfg: ModelConfig, *, max_seq: int | None = None,
            plain: bool = False):
    """``batch``: ``tokens`` (B, S) and ``frames`` (B, P, D).  Encodes the
    frames, runs the prompt; returns (last-position logits (B, 1, V), cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    enc_out = encode(params, batch["frames"], cfg, plain=plain)
    dec = params["decoder"]
    x = dec["tok_embed"][tokens].to(cfg.cdt) + dec["pos_embed"][:s].to(cfg.cdt)
    cache = init_cache(cfg, b, max_seq or s, device=tokens.device)
    x = _dec_stack(params, x, cfg, cache, enc_out=enc_out, plain=plain)
    cache["len"].fill_(s)
    # the norm is per position, so only the last one is computed
    return _head(params, x[:, -1:]), cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                plain: bool = False):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache), with
    ``cache`` updated in place (k/v at each row's ``len``, then ``len +=
    1``).  The position is clipped to the last row of the positional table,
    as the reference does."""
    dec = params["decoder"]
    pos = cache["len"].clamp(0, dec["pos_embed"].shape[0] - 1).long()
    x = dec["tok_embed"][tokens].to(cfg.cdt) + dec["pos_embed"][pos][:, None].to(cfg.cdt)
    x = _dec_stack(params, x, cfg, cache, plain=plain)
    cache["len"].add_(1)
    return _head(params, x), cache
