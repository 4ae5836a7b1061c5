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
from repro_torch.sharding import (active, all_gather, axis_index, check_on_mesh, copy_to,
                                  leaf_spec, psum, split_axes, use_mesh)

from .attention import attention, decode_attention_append, kv_heads_for
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


class _Plan:
    """How the dense family's training step runs on the active mesh, read
    from each leaf's spec (``sharding.leaf_spec`` of its name and global
    shape under the rules in force), never from the arch.

    * ``weight``: the rank's block of a leaf with the dims split over the
      batch axes (FSDP: ``embed`` over ``data``) gathered back
      (``all_gather``, whose backward is the reduce-scatter of the
      gradient); what stays split is the tensor-parallel block.
    * ``split``: the mesh axes (larger than 1, not batch axes) that split a
      leaf's dim: heads, KV heads, FFN columns, vocab rows.  A dim the rule
      leaves whole (gemma's 8 heads on a 16-way ``model`` axis) is computed
      whole on every rank.

    ``_plan`` gives None where no mesh is active or every axis is 1: the
    step is then the one without a mesh, op for op."""

    def __init__(self, cfg: ModelConfig, ctx):
        self.cfg, self.ctx = cfg, ctx
        self.batch = ctx.rule("batch")
        shapes = param_shapes(cfg)
        self.shapes = {**{(k,): v for k, v in shapes.items() if isinstance(v, tuple)},
                       ("final_norm", "scale"): shapes["final_norm"]["scale"]}
        for sub, leaves in shapes["layers"][0].items():
            self.shapes.update({(sub, k): v for k, v in leaves.items()})
        self.specs = {k: leaf_spec(k[-1], v, ctx) for k, v in self.shapes.items()}

    def split(self, path: tuple, dim: int) -> tuple[str, ...]:
        return tuple(a for a in split_axes(self.specs[path], dim, self.ctx)
                     if a not in self.batch)

    def weight(self, w: torch.Tensor, path: tuple) -> torch.Tensor:
        spec = self.specs[path]
        for dim in range(len(self.shapes[path])):
            fsdp = tuple(a for a in split_axes(spec, dim, self.ctx) if a in self.batch)
            if not fsdp:
                continue
            if len(fsdp) != len(split_axes(spec, dim, self.ctx)):
                raise NotImplementedError(f"{path}: dim {dim} split over {spec.axes(dim)}, "
                                          f"batch and model axes together")
            w = all_gather(w, fsdp, axis=dim, tiled=True)
        return w

    def layer(self, p: dict) -> dict:
        """Every leaf of one layer, gathered (:meth:`weight`)."""
        return {sub: {k: self.weight(v, (sub, k)) for k, v in leaves.items()}
                for sub, leaves in p.items()}


def _plan(cfg: ModelConfig, kind: str) -> _Plan | None:
    """The active mesh's plan for the ``kind`` step, None without a split
    axis; raises for a family or a step a later part of ROADMAP.md Queue 1
    item 8c brings (``sharding.check_on_mesh``)."""
    ctx = active()
    if ctx is None or ctx.axes_size(ctx.axis_names) == 1:
        return None
    check_on_mesh(cfg, kind, ctx.mesh)
    return _Plan(cfg, ctx)


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
               plain: bool = False, tp: _Plan | None = None):
    """Self-attention sublayer.

    Prefill (``cache`` None): returns (out, (k, v)), this call's K/V.
    Decode: ``cache`` is ``(k_layer, v_layer, write_pos, lengths)``; the new
    token's k/v are appended in place and (out, None) is returned.

    With a plan ``tp`` (training on a mesh; the leaves gathered over the
    batch axes): where ``wq``'s spec splits the heads, ``x`` enters through
    ``copy_to`` and q/k/v are column-parallel on the rank's heads (``bq``,
    ``bk``, ``bv`` split alike); where ``wk``'s spec leaves the KV heads
    whole, the rank slices the KV heads its query heads read, so the
    attention kernel sees an integral group; where ``wo``'s spec splits
    its rows, the product is row-parallel and one ``psum`` joins it.
    """
    heads = tp.split(("attn", "wq"), 1) if tp else ()
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    if heads:
        x = copy_to(x, heads)
        if not tp.split(("attn", "wk"), 1):   # KV heads whole: the ones these heads read
            lo, n = kv_heads_for(axis_index(heads), p["wq"].shape[1], cfg.num_heads,
                                 cfg.num_kv_heads)
            wk, wv = wk[:, lo:lo + n], wv[:, lo:lo + n]
            if cfg.qkv_bias:
                bk, bv = bk[lo:lo + n], bv[lo:lo + n]
    q = _proj(x, p["wq"])
    k = _proj(x, wk)
    v = _proj(x, wv)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
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
    rows = tp.split(("attn", "wo"), 0) if tp else ()
    return (psum(y, rows) if rows else y), kv_out


def layer_body(p: dict, x: torch.Tensor, m: torch.Tensor | None, sin, cos, cfg: ModelConfig,
               *, cache=None, plain: bool = False, aux: bool = False, tp: _Plan | None = None):
    """One layer on the residual stream ``x`` plus the previous layer's FFN
    output ``m``, not yet added (None before layer 0).  Returns (x, m,
    kv_out, aux_loss): the stream before this layer's FFN output, that
    output (the dense MLP's or the MoE layer's), and, when ``aux`` asks
    for it on the MoE family, the layer's load-balance loss (else None)."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    h1, x = norm(x, m, p["ln1"]["scale"], eps=cfg.norm_eps, gemma=cfg.gemma_norm)
    h, kv_out = attn_block(p["attn"], h1, sin, cos, cfg, cache=cache, plain=plain, tp=tp)
    h2, x = norm(x, h, p["ln2"]["scale"], eps=cfg.norm_eps, gemma=cfg.gemma_norm)
    if cfg.family == "moe":
        out, loss = moe_ffn(p["moe"], h2, cfg=cfg, aux=aux)
        return x, out, kv_out, loss
    cols = tp.split(("mlp", "w_gate"), 1) if tp else ()
    return x, gated_mlp(p["mlp"], h2, act=cfg.mlp_act, tp=cols), kv_out, None


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           tp: _Plan | None = None, table: torch.Tensor | None = None) -> torch.Tensor:
    """The embedding rows of ``tokens``.  With a plan whose spec splits the
    vocab, vocab-parallel: each rank looks up the ids in its rows, 0 for
    the rest, and a ``psum`` joins them.  ``table``: ``tok_embed`` already
    gathered (:meth:`_Plan.weight`)."""
    vocab = tp.split(("tok_embed",), 0) if tp else ()
    if table is None:
        table = params["tok_embed"]
        if tp:
            table = tp.weight(table, ("tok_embed",))
    if vocab:
        n = table.shape[0]
        ids = tokens.long() - axis_index(vocab) * n
        mine = ((ids >= 0) & (ids < n))[..., None]
        rows = table[ids.clamp(0, n - 1)]
        x = psum(torch.where(mine, rows, torch.zeros_like(rows)), vocab).to(cfg.cdt)
    else:
        x = table[tokens].to(cfg.cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=torch.float32).to(cfg.cdt)
    return x


def _unembed(params: dict, x: torch.Tensor, cfg: ModelConfig,
             tp: _Plan | None = None, table: torch.Tensor | None = None) -> torch.Tensor:
    """Logits over the vocab; with a plan whose spec splits the vocab, over
    the rank's block of it (``x`` through ``copy_to``: each block gives a
    part of its gradient), never the whole vocab on one rank.  ``table``:
    the unembedding already gathered."""
    key = "lm_head" if "lm_head" in params else "tok_embed"
    if table is None:
        table = params[key]
        if tp:
            table = tp.weight(table, (key,))
    if tp:
        vocab = tp.split((key,), 0)
        if vocab:
            x = copy_to(x, vocab)
    return x @ table.to(x.dtype).T


def _final_norm(params: dict, x: torch.Tensor, m: torch.Tensor, cfg: ModelConfig,
                plain: bool, tp: _Plan | None = None) -> torch.Tensor:
    """rms_norm(x + m): the last layer's add fused into the final norm."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    scale = params["final_norm"]["scale"]
    if tp:
        scale = tp.weight(scale, ("final_norm", "scale"))
    return norm(x, m, scale, eps=cfg.norm_eps, gemma=cfg.gemma_norm, want_residual=False)[0]


# ---------------------------------------------------------------------------
# training: forward + loss
# ---------------------------------------------------------------------------


def _train_layer(p: dict, x: torch.Tensor, m: torch.Tensor | None, sin, cos,
                 cfg: ModelConfig, plain: bool, tp: _Plan | None = None):
    """One layer for training, the unit of remat: (x, m, aux loss or None).
    With a plan the layer's leaves are gathered over the batch axes here,
    inside the remat'd unit: the gathered weights are not kept for the
    backward and the gathers run again in the recompute (which may run on
    autograd's device thread, so the mesh is entered here too)."""
    if tp is None:
        x, m, _, aux = layer_body(p, x, m, sin, cos, cfg, plain=plain,
                                  aux=cfg.family == "moe")
        return x, m, aux
    with use_mesh(tp.ctx.mesh, tp.ctx.rules):
        x, m, _, aux = layer_body(tp.layer(p), x, m, sin, cos, cfg, plain=plain, tp=tp)
    return x, m, aux


def _forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, plain: bool,
             tp: _Plan | None):
    s = tokens.shape[1]
    # tied embeddings under a plan: one gather of the table serves both ends
    # (one reduce-scatter of its summed gradient)
    tied = tp.weight(params["tok_embed"], ("tok_embed",)) \
        if tp and "lm_head" not in params else None
    x = _embed(params, tokens, cfg, tp, tied)
    sin, cos = rope_freqs(torch.arange(s, device=tokens.device), cfg.head_dim,
                          cfg.rope_theta)
    m = None
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for p in params["layers"]:
        x, m, a = remat(_train_layer, cfg.remat, p, x, m, sin, cos, cfg, plain, tp)
        if a is not None:
            aux = aux + a
    return _unembed(params, _final_norm(params, x, m, cfg, plain, tp), cfg, tp, tied), aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, plain: bool = False):
    """Logits at every position (B, S, V) and the MoE load-balance loss
    summed over layers (0 on the dense family).  On a mesh (the leaves the
    rank's blocks, ``tokens`` its rows) the logits are the rank's block of
    the vocab where the spec splits it."""
    return _forward(params, tokens, cfg, plain, _plan(cfg, "train"))


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *, plain: bool = False):
    """Next-token CE over the batch's tokens (plus, on the MoE family,
    ``router_aux_weight * aux / num_layers``).  On a mesh it is the mean
    over the rank's rows, the same on every rank of the ``model`` axis
    (the CE vocab-parallel where the logits are split);
    ``launch.steps.loss_and_grads`` takes its mean over the batch axes."""
    tokens = batch["tokens"]
    tp = _plan(cfg, "train")
    logits, aux = _forward(params, tokens, cfg, plain, tp)
    key = "lm_head" if "lm_head" in params else "tok_embed"
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:],
                         vocab_axes=tp.split((key,), 0) if tp else ())
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
    _plan(cfg, "prefill")
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
    _plan(cfg, "decode")
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
