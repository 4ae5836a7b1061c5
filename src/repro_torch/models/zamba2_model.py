"""Zamba2 hybrid: Mamba2 backbone + ONE shared attention block.

Counterpart of ``repro/models/zamba2_model.py``.  Groups of ``attn_every``
Mamba2 blocks are each followed by an invocation of a single weight-shared
attention + MLP block.  The parameter tree and the cache keep the
reference's layout, stacked leaves and all: the Mamba leaves carry leading
``(n_groups, attn_every)`` axes (``ln_m`` too), ``shared`` holds one
``attn``/``mlp``/``ln1``/``ln2``, and the cache is the Mamba states
``(ng, per, B, ...)``, the shared block's K/V per invocation ``(ng, B,
Smax, KV, hd)`` and ``len (B,)``.  Python loops over groups and blocks
replace the nested ``lax.scan``, each block reading its parameters as
views of the stacked leaves; training (``forward``, ``loss_fn``) runs each
Mamba2 block under the config's remat policy, where the reference wraps
it in ``jax.checkpoint``.  The reference's ``constrain`` calls have no
counterpart here.

Three places go through the Hopper kernels (``plain=True`` takes their
plain versions instead):

* prefill attention -> flash-attention kernel, once per invocation of the
  shared block;
* decode attention -> in-place append of the step's k/v to the
  invocation's cache layer, then the decode-attention kernel (the
  reference's ``cache_write=True``);
* every RMSNorm, each with the residual add in front of it -> one fused
  residual-add + RMSNorm kernel call: each Mamba block's pre-norm
  (``ln_m``) takes the previous block's output, or the shared MLP's at a
  group boundary (block 0's is the norm alone); the shared ``ln1`` takes
  the group's last Mamba output, ``ln2`` the attention output, and the
  final norm the last group's MLP output.  The stack therefore carries
  each sublayer's output into the next norm un-added.  The Mamba blocks'
  inner norms go through the same kernel (``mamba2.py``).  At full width a
  call is 127 launches: 54 ``ln_m``, 54 inner norms, 9 ``ln1``, 9 ``ln2``
  and the final norm.

``decode_step`` writes the new states and k/v into ``cache`` in place
(where the reference's jit donates it) and returns the same dict.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref

from .common import (ModelConfig, cross_entropy, dense_init, remat, rope_freqs, stack_draws,
                     tree_at)
from .mamba2 import init_mamba, init_mamba_state, mamba_block, mamba_decode, mamba_shapes
from .mlp import gated_mlp, init_mlp
from .transformer import attn_block, init_attn
from .transformer import param_shapes as transformer_shapes

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "prefill",
           "prefill_sequential", "decode_step", "init_cache", "splice_cache", "layout"]


def layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, blocks per group); raises unless ``attn_every`` tiles the
    depth."""
    if cfg.attn_every <= 0 or cfg.num_layers % cfg.attn_every:
        raise ValueError(f"zamba2: {cfg.num_layers} layers are not whole groups of "
                         f"attn_every={cfg.attn_every} Mamba2 blocks")
    return cfg.num_layers // cfg.attn_every, cfg.attn_every


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's structure with each leaf's shape."""
    ng, per = layout(cfg)
    d = cfg.d_model
    dense = transformer_shapes(cfg.scaled(num_layers=1))["layers"][0]
    tree = {
        "tok_embed": (cfg.vocab_size, d),
        "mamba": {k: (ng, per) + shape for k, (shape, _) in mamba_shapes(cfg).items()},
        "ln_m": {"scale": (ng, per, d)},
        "shared": {"attn": dense["attn"], "mlp": dense["mlp"], "ln1": {"scale": (d,)},
                   "ln2": {"scale": (d,)}},
        "final_norm": {"scale": (d,)},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.vocab_size, d)
    return tree


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn from ``gen``.  Each Mamba
    block is drawn on its own and copied into the stacked leaves, so the
    peak is one block above the tree itself."""
    ng, per = layout(cfg)
    dev = gen.device
    ones = lambda *lead: torch.ones(lead + (cfg.d_model,), dtype=torch.float32,  # noqa: E731
                                    device=dev)
    mamba = stack_draws(lambda: init_mamba(gen, cfg), (ng, per))
    params = {
        "tok_embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdt,
                                fan_in=cfg.d_model),
        "mamba": mamba,
        "ln_m": {"scale": ones(ng, per)},
        "shared": {"attn": init_attn(gen, cfg),
                   "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdt),
                   "ln1": {"scale": ones()}, "ln2": {"scale": ones()}},
        "final_norm": {"scale": ones()},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdt)
    return params


def _stack(params: dict, x: torch.Tensor, sin, cos, cfg: ModelConfig, cache: dict, *,
           decode: bool, collect: bool = False, plain: bool = False):
    """Run every group on the residual stream ``x``; returns (x, h) with the
    last group's MLP output ``h`` not yet added to ``x``.

    Decode: each Mamba block steps its slot states in ``cache`` in place,
    and each invocation of the shared block appends the step's k/v to its
    cache layer at ``len`` and attends over it.  Prefill: each invocation's
    k/v are written into ``cache`` and, with ``collect``, each Mamba
    block's final recurrent state too."""
    ng, per = layout(cfg)
    eps = cfg.norm_eps
    norm = rmsnorm_ref if plain else fused_rmsnorm
    shared = params["shared"]
    s = x.shape[1]
    if decode:
        pos = cache["len"]
        write_pos = pos.clamp(max=cache["k"].shape[2] - 1).long()
        lengths = pos + 1
    leaves = cache["mamba"]
    h = None
    for g in range(ng):
        for j in range(per):
            p = tree_at(params["mamba"], g, j)
            xn, x = norm(x, h, params["ln_m"]["scale"][g, j], eps=eps)
            if decode:
                h, st = mamba_decode(p, xn, {k: v[g, j] for k, v in leaves.items()}, cfg,
                                     plain=plain)
            elif collect:
                h, st = mamba_block(p, xn, cfg, return_state=True, plain=plain)
            else:
                h, st = mamba_block(p, xn, cfg, plain=plain), None
            if st is not None:
                for k, v in st.items():
                    leaves[k][g, j].copy_(v)
        # the shared block: x = x + attn(ln1(x)); h = mlp(ln2(x)), the adds fused
        xn, x = norm(x, h, shared["ln1"]["scale"], eps=eps)
        kv_cache = (cache["k"][g], cache["v"][g], write_pos, lengths) if decode else None
        a, kv_out = attn_block(shared["attn"], xn, sin, cos, cfg, cache=kv_cache, plain=plain)
        if not decode:
            cache["k"][g, :, :s] = kv_out[0]
            cache["v"][g, :, :s] = kv_out[1]
        xn, x = norm(x, a, shared["ln2"]["scale"], eps=eps)
        h = gated_mlp(shared["mlp"], xn, act=cfg.mlp_act)
    return x, h


def _head(params: dict, x: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
          plain: bool) -> torch.Tensor:
    """Logits of rms_norm(x + h): the last group's add fused into the final norm."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    xn, _ = norm(x, h, params["final_norm"]["scale"], eps=cfg.norm_eps, want_residual=False)
    table = params.get("lm_head", params["tok_embed"])
    return xn @ table.T


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["tok_embed"][tokens].to(cfg.cdt)


# -- training -------------------------------------------------------------------


def _mamba_layer(p: dict, ln: torch.Tensor, x: torch.Tensor, h: torch.Tensor | None,
                 cfg: ModelConfig, plain: bool):
    """One Mamba2 block on ``x`` plus the previous sublayer's output ``h``,
    the unit of remat: (x, this block's output, not yet added)."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    xn, x = norm(x, h, ln, eps=cfg.norm_eps)
    return x, mamba_block(p, xn, cfg, plain=plain)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, plain: bool = False):
    """Logits at every position (B, S, V), and 0 (no auxiliary loss)."""
    ng, per = layout(cfg)
    eps = cfg.norm_eps
    norm = rmsnorm_ref if plain else fused_rmsnorm
    shared = params["shared"]
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    sin, cos = rope_freqs(torch.arange(s, device=tokens.device), cfg.head_dim,
                          cfg.rope_theta)
    h = None
    for g in range(ng):
        for j in range(per):
            x, h = remat(_mamba_layer, cfg.remat, tree_at(params["mamba"], g, j),
                         params["ln_m"]["scale"][g, j], x, h, cfg, plain)
        xn, x = norm(x, h, shared["ln1"]["scale"], eps=eps)
        a, _ = attn_block(shared["attn"], xn, sin, cos, cfg, plain=plain)
        xn, x = norm(x, a, shared["ln2"]["scale"], eps=eps)
        h = gated_mlp(shared["mlp"], xn, act=cfg.mlp_act)
    return _head(params, x, h, cfg, plain), torch.zeros((), device=tokens.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *, plain: bool = False):
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens, cfg, plain=plain)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


# -- serving -------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device: torch.device | str) -> dict:
    ng, per = layout(cfg)
    dt = dtype or cfg.cdt
    mamba = {k: v.expand((ng, per) + v.shape).clone()
             for k, v in init_mamba_state(cfg, batch, dt, device=device).items()}
    kv_shape = (ng, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "mamba": mamba,
        "k": torch.zeros(kv_shape, dtype=dt, device=device),
        "v": torch.zeros(kv_shape, dtype=dt, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def splice_cache(cache: dict, single: dict, slot: int, length: int) -> None:
    """Copy a one-request cache ``single`` into slot ``slot`` of ``cache``, in
    place: every Mamba state leaf along its own batch axis (axis 2 of the
    ``(ng, per, B, ...)`` ``ssm`` and ``conv`` leaves), whole, so a reused
    slot keeps nothing of its last request; the first ``length`` K/V rows
    of each invocation (axis 1 of ``(ng, B, Smax, KV, hd)``); then
    ``len[slot]``.

    This is where the port deliberately differs from the reference's
    ``_splice_cache`` (``repro/runtime/server.py``), which splices a leaf
    only when its axis 1 has size 1 in the one-request cache: the
    ``(ng, per, B, ...)`` Mamba leaves, with per = attn_every > 1, are never
    spliced there, so a slot decodes from the zero state or from the
    previous request's (ROADMAP.md, Queue 3)."""
    for k, v in cache["mamba"].items():
        v[:, :, slot] = single["mamba"][k][:, :, 0]
    cache["k"][:, slot, :length] = single["k"][:, 0, :length]
    cache["v"][:, slot, :length] = single["v"][:, 0, :length]
    cache["len"][slot] = length


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_seq: int | None = None, plain: bool = False):
    """One parallel pass: last-position logits (B, 1, V), and a cache holding
    the attention K/V and every Mamba block's chunk-final SSD state and
    conv tail."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, device=tokens.device)
    x = _embed(params, tokens, cfg)
    sin, cos = rope_freqs(torch.arange(s, device=tokens.device), cfg.head_dim,
                          cfg.rope_theta)
    x, h = _stack(params, x, sin, cos, cfg, cache, decode=False, collect=True, plain=plain)
    cache["len"].fill_(s)
    # the norm is per position, so only the last one is computed
    return _head(params, x[:, -1:], h[:, -1:], cfg, plain), cache


def prefill_sequential(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                       max_seq: int | None = None, plain: bool = False):
    """The reference's replay oracle for :func:`prefill`: logits and K/V from
    the parallel pass, the Mamba states from replaying the prompt as decode
    steps from the zero state."""
    b, s = tokens.shape
    max_seq = max_seq or s
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    x = _embed(params, tokens, cfg)
    sin, cos = rope_freqs(torch.arange(s, device=tokens.device), cfg.head_dim,
                          cfg.rope_theta)
    x, h = _stack(params, x, sin, cos, cfg, cache, decode=False, plain=plain)
    cache["len"].fill_(s)
    logits = _head(params, x[:, -1:], h[:, -1:], cfg, plain)
    replay = init_cache(cfg, b, max_seq, device=tokens.device)
    for t in range(s):
        _, replay = decode_step(params, replay, tokens[:, t : t + 1], cfg, plain=plain)
    cache["mamba"] = replay["mamba"]
    return logits, cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                plain: bool = False):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache), with
    ``cache`` updated in place (states, k/v at each row's ``len``, then
    ``len += 1``) and returned."""
    x = _embed(params, tokens, cfg)
    sin, cos = rope_freqs(cache["len"][:, None], cfg.head_dim, cfg.rope_theta)
    x, h = _stack(params, x, sin, cos, cfg, cache, decode=True, plain=plain)
    cache["len"].add_(1)
    return _head(params, x, h, cfg, plain), cache
