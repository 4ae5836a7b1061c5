"""Decoder-only LM, dense and MoE families: init, training forward and
loss, prefill and decode.

Counterpart of ``repro/models/transformer.py``.  The MoE family differs
only in its FFN: each layer holds a ``moe`` subtree in place of ``mlp``
and runs :func:`.mlp.moe_ffn` (plain torch, as in the reference).  The
reference stacks layer parameters and runs ``lax.scan``; here ``params
["layers"]`` is a list of per-layer dicts walked by a Python loop.  The
reference's sharding ``constrain`` calls have no counterpart on one card.

Three places go through the Hopper kernels (``plain=True`` takes their
plain versions instead):

* prefill attention -> flash-attention kernel (:func:`.attention.attention`);
* decode attention -> in-place cache append + decode-attention kernel
  (:func:`.attention.decode_attention_append`), which also replaces the
  reference's top-level ``_cache_scatter``;
* every full-width RMSNorm, each with the residual add in front of it ->
  one fused residual-add + RMSNorm kernel call: ``ln1`` takes the previous
  layer's MLP output (layer 0's is the norm alone), ``ln2`` the attention
  output, and the final norm the last layer's MLP output, so a call is
  2L + 1 launches.  The layer loop therefore carries each layer's MLP
  (or MoE) output into the next one un-added.  With ``qk_norm`` the
  per-head norms of q and k go through the same kernel, norm alone, one
  call each over rows of ``head_dim``: 2L more launches a call.

Training (``forward``, ``loss_fn``) runs the same layers with grad: the
kernels then go through their ``torch.autograd.Function``s, whose
backwards are the K1-bwd and K2-bwd kernels, and each layer runs under
the config's remat policy (``common.remat``; with ``block`` a layer's
forward kernels run twice a step).  The MoE family adds its load-balance
loss, summed over layers, as the reference does.

Serving state is updated in place where the reference's jit donates it:
``decode_step`` writes the new token's k/v into ``cache`` and bumps
``cache["len"]`` in place, and returns the same dict.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref

from .attention import attention, decode_attention_append
from .common import ModelConfig, apply_rope, cross_entropy, dense_init, remat, rope_freqs
from .mlp import gated_mlp, init_mlp, init_moe, moe_ffn

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "prefill", "decode_step",
           "init_cache", "splice_cache"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's structure with each leaf's shape."""
    d, h, kv, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    attn = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd), "wo": (h, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(h, hd), bk=(kv, hd), bv=(kv, hd))
    if cfg.qk_norm:
        attn.update(q_norm=(hd,), k_norm=(hd,))
    layer = {"attn": attn, "ln1": {"scale": (d,)}, "ln2": {"scale": (d,)}}
    if cfg.family == "moe":
        e = cfg.num_experts
        layer["moe"] = {"router": (d, e), "e_gate": (e, d, f), "e_up": (e, d, f),
                        "e_down": (e, f, d)}
        if cfg.num_shared_experts:
            fs = cfg.d_ff_shared
            layer["moe"]["shared"] = {"w_gate": (d, fs), "w_up": (d, fs), "w_down": (fs, d),
                                      "shared_gate": (d,)}
    else:
        layer["mlp"] = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    tree = {"tok_embed": (cfg.vocab_size, d), "layers": [layer] * cfg.num_layers,
            "final_norm": {"scale": (d,)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.vocab_size, d)
    return tree


def init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h, hd), cfg.pdt),
        "wk": dense_init(gen, (d, kv, hd), cfg.pdt),
        "wv": dense_init(gen, (d, kv, hd), cfg.pdt),
        "wo": dense_init(gen, (h, hd, d), cfg.pdt, fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=cfg.pdt, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=cfg.pdt, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=cfg.pdt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=torch.float32, device=gen.device)  # noqa: E731
    layer = {"attn": init_attn(gen, cfg), "ln1": {"scale": ones()}, "ln2": {"scale": ones()}}
    if cfg.family == "moe":
        layer["moe"] = init_moe(gen, cfg)
    else:
        layer["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdt)
    return layer


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn from ``gen``."""
    params = {
        "tok_embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdt,
                                fan_in=cfg.d_model),
        "layers": [_init_layer(gen, cfg) for _ in range(cfg.num_layers)],
        "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                           device=gen.device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdt)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, N, hd) -> (B, S, N, hd)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd).to(x.dtype)).view(*x.shape[:2], n, hd)


def attn_block(p: dict, x: torch.Tensor, sin, cos, cfg: ModelConfig, *, cache=None,
               plain: bool = False):
    """Self-attention sublayer.

    Prefill (``cache`` None): returns (out, (k, v)), this call's K/V.
    Decode: ``cache`` is ``(k_layer, v_layer, write_pos, lengths)``; the new
    token's k/v are appended in place and (out, None) is returned.
    """
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:   # per head: rows of hd, the norm alone (no gemma flag, as the reference)
        norm = rmsnorm_ref if plain else fused_rmsnorm
        q = norm(q, None, p["q_norm"], eps=cfg.norm_eps, want_residual=False)[0]
        k = norm(k, None, p["k_norm"], eps=cfg.norm_eps, want_residual=False)[0]
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if cache is not None:
        k_c, v_c, write_pos, lengths = cache
        out = decode_attention_append(q, k_c, v_c, k, v, write_pos, lengths, plain=plain)
        kv_out = None
    else:
        out = attention(q, k, v, causal=True, plain=plain)
        kv_out = (k, v)
    b, s, h, hd = out.shape
    y = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, -1).to(out.dtype)
    return y, kv_out


def layer_body(p: dict, x: torch.Tensor, m: torch.Tensor | None, sin, cos, cfg: ModelConfig,
               *, cache=None, plain: bool = False, aux: bool = False):
    """One layer on the residual stream ``x`` plus the previous layer's FFN
    output ``m``, not yet added (None before layer 0).  Returns (x, m,
    kv_out, aux_loss): the stream before this layer's FFN output, that
    output (the dense MLP's or the MoE layer's), and, when ``aux`` asks
    for it on the MoE family, the layer's load-balance loss (else None)."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    h1, x = norm(x, m, p["ln1"]["scale"], eps=cfg.norm_eps, gemma=cfg.gemma_norm)
    h, kv_out = attn_block(p["attn"], h1, sin, cos, cfg, cache=cache, plain=plain)
    h2, x = norm(x, h, p["ln2"]["scale"], eps=cfg.norm_eps, gemma=cfg.gemma_norm)
    if cfg.family == "moe":
        out, loss = moe_ffn(p["moe"], h2, cfg=cfg, aux=aux)
        return x, out, kv_out, loss
    return x, gated_mlp(p["mlp"], h2, act=cfg.mlp_act), kv_out, None


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = params["tok_embed"][tokens].to(cfg.cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=torch.float32).to(cfg.cdt)
    return x


def _unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = params.get("lm_head", params["tok_embed"])
    return x @ table.to(x.dtype).T


def _final_norm(params: dict, x: torch.Tensor, m: torch.Tensor, cfg: ModelConfig,
                plain: bool) -> torch.Tensor:
    """rms_norm(x + m): the last layer's add fused into the final norm."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    return norm(x, m, params["final_norm"]["scale"], eps=cfg.norm_eps, gemma=cfg.gemma_norm,
                want_residual=False)[0]


# ---------------------------------------------------------------------------
# training: forward + loss
# ---------------------------------------------------------------------------


def _train_layer(p: dict, x: torch.Tensor, m: torch.Tensor | None, sin, cos,
                 cfg: ModelConfig, plain: bool):
    """One layer for training, the unit of remat: (x, m, aux loss or None)."""
    x, m, _, aux = layer_body(p, x, m, sin, cos, cfg, plain=plain, aux=cfg.family == "moe")
    return x, m, aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, plain: bool = False):
    """Logits at every position (B, S, V) and the MoE load-balance loss
    summed over layers (0 on the dense family)."""
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    sin, cos = rope_freqs(torch.arange(s, device=tokens.device), cfg.head_dim,
                          cfg.rope_theta)
    m = None
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for p in params["layers"]:
        x, m, a = remat(_train_layer, cfg.remat, p, x, m, sin, cos, cfg, plain)
        if a is not None:
            aux = aux + a
    return _unembed(params, _final_norm(params, x, m, cfg, plain), cfg), aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *, plain: bool = False):
    """Next-token CE over the batch's tokens (plus, on the MoE family,
    ``router_aux_weight * aux / num_layers``)."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg, plain=plain)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    if cfg.family == "moe":
        loss = loss + cfg.router_aux_weight * aux / cfg.num_layers
    return loss


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device: torch.device | str) -> dict:
    dt = dtype or cfg.cdt
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def splice_cache(cache: dict, single: dict, slot: int, length: int) -> None:
    """Copy the first ``length`` K/V rows of the one-request cache ``single``
    into slot ``slot`` of ``cache`` in place, and set ``len[slot]``."""
    cache["k"][:, slot, :length] = single["k"][:, 0, :length]
    cache["v"][:, slot, :length] = single["v"][:, 0, :length]
    cache["len"][slot] = length


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_seq: int | None = None, plain: bool = False):
    """Run the prompt; returns (last-position logits (B, 1, V), cache)."""
    b, s = tokens.shape
    max_seq = max_seq or s
    x = _embed(params, tokens, cfg)
    sin, cos = rope_freqs(torch.arange(s, device=tokens.device), cfg.head_dim,
                          cfg.rope_theta)
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    m = None
    for i, p in enumerate(params["layers"]):
        x, m, (k, v), _ = layer_body(p, x, m, sin, cos, cfg, plain=plain)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["len"].fill_(s)
    # the norm is per position, so only the last one is computed
    logits = _unembed(params, _final_norm(params, x[:, -1:], m[:, -1:], cfg, plain), cfg)
    return logits, cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                plain: bool = False):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).

    ``cache`` is updated in place (k/v at each row's ``len``, then
    ``len += 1``) and returned."""
    x = _embed(params, tokens, cfg)
    pos = cache["len"]  # (B,) per-request positions
    sin, cos = rope_freqs(pos[:, None], cfg.head_dim, cfg.rope_theta)
    write_pos = pos.clamp(max=cache["k"].shape[2] - 1).long()
    lengths = pos + 1
    m = None
    for i, p in enumerate(params["layers"]):
        x, m, _, _ = layer_body(p, x, m, sin, cos, cfg, plain=plain,
                             cache=(cache["k"][i], cache["v"][i], write_pos, lengths))
    cache["len"].add_(1)
    logits = _unembed(params, _final_norm(params, x, m, cfg, plain), cfg)
    return logits, cache
