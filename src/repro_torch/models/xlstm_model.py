"""xLSTM language model: [7 mLSTM : 1 sLSTM] grouped stack.

Counterpart of ``repro/models/xlstm_model.py``.  The parameter tree and the
cache keep the reference's layout, stacked leaves and all: mLSTM leaves
carry leading ``(n_groups, mlstm_per_group)`` axes, sLSTM leaves a leading
``(n_groups,)`` axis, and the cache's mLSTM state leaves are
``(ng, nm, B, ...)``, its sLSTM leaves ``(ng, B, D)``, and ``len (B,)``.
Python loops over groups and blocks replace the nested ``lax.scan``, each
block reading its parameters as views of the stacked leaves; training
(``forward``, ``loss_fn``) runs each mLSTM block under the config's remat
policy, where the reference wraps it in ``jax.checkpoint``.  The
reference's ``constrain`` calls have no counterpart here.

Training on the card goes through the same kernels: under grad the sLSTM
scan is K5 in save mode with K5-bwd as its gradient
(``kernels/slstm_scan/ops.py:_SlstmScanFn``); the sLSTM blocks are not
under remat, so each runs its forward once a step.

Two places go through the Hopper kernels (``plain=True`` takes their plain
versions instead):

* the sLSTM time recurrence -> the sLSTM scan kernel, once per sLSTM block
  in prefill (S = the prompt length) and in decode (S = 1, resuming from
  the slot states);
* every RMSNorm, each with the residual add in front of it -> one fused
  residual-add + RMSNorm kernel call: each block's pre-norm (``ln_m``,
  ``ln_s``) takes the previous block's output (block 0's is the norm
  alone), ``ln_s2`` the sLSTM output and ``final_norm`` the last block's
  output, so the stack carries each block's output into the next one
  un-added; the blocks' inner norms go through the same kernel
  (``xlstm.py``).  At full width a call is 103 launches: 48 pre-norms, 6
  ``ln_s2``, the final norm and 48 inner norms.

``decode_step`` writes the new states into ``cache`` in place (where the
reference's jit donates it) and returns the same dict.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref

from .common import ModelConfig, cross_entropy, dense_init, remat, stack_draws, tree_at
from .mlp import gated_mlp
from .xlstm import (
    init_mlstm,
    init_mlstm_state,
    init_slstm,
    init_slstm_state,
    mlstm_block,
    mlstm_decode,
    mlstm_shapes,
    slstm_block,
    slstm_decode,
    slstm_shapes,
)

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "prefill",
           "prefill_sequential", "decode_step", "init_cache", "splice_cache"]


def _layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, mlstm_per_group). slstm_every == 0 -> pure mLSTM."""
    if cfg.slstm_every <= 0:
        return 1, cfg.num_layers
    if cfg.num_layers % cfg.slstm_every:
        raise ValueError(f"{cfg.num_layers} layers do not tile the pattern of "
                         f"slstm_every={cfg.slstm_every}")
    return cfg.num_layers // cfg.slstm_every, cfg.slstm_every - 1


def _stacked(lead: tuple, tree: dict) -> dict:
    """``tree`` of (shape, dtype) leaves with ``lead`` prepended to each shape."""
    return {k: _stacked(lead, v) if isinstance(v, dict) else (lead + v[0], v[1])
            for k, v in tree.items()}


def _spec(cfg: ModelConfig) -> dict:
    """The parameter tree as (shape, dtype) leaves."""
    ng, nm = _layout(cfg)
    d = cfg.d_model
    tree = {
        "tok_embed": ((cfg.vocab_size, d), cfg.pdt),
        "mlstm": _stacked((ng, nm), mlstm_shapes(cfg)),
        "ln_m": {"scale": ((ng, nm, d), torch.float32)},
        "final_norm": {"scale": ((d,), torch.float32)},
    }
    if cfg.slstm_every > 0:
        tree["slstm"] = _stacked((ng,), slstm_shapes(cfg))
        tree["ln_s"] = {"scale": ((ng, d), torch.float32)}
        tree["ln_s2"] = {"scale": ((ng, d), torch.float32)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((cfg.vocab_size, d), cfg.pdt)
    return tree


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's structure with each leaf's shape."""
    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else v[0] for k, v in t.items()}
    return shapes(_spec(cfg))


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn from ``gen``.  Each block
    is drawn on its own and copied into the stacked leaves, so the peak is
    one block above the tree itself."""
    ng, nm = _layout(cfg)
    dev = gen.device
    params = {
        "tok_embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdt,
                                fan_in=cfg.d_model),
        "mlstm": stack_draws(lambda: init_mlstm(gen, cfg), (ng, nm)),
        "ln_m": {"scale": torch.ones((ng, nm, cfg.d_model), dtype=torch.float32, device=dev)},
        "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)},
    }
    if cfg.slstm_every > 0:
        params["slstm"] = stack_draws(lambda: init_slstm(gen, cfg), (ng,))
        params["ln_s"] = {"scale": torch.ones((ng, cfg.d_model), dtype=torch.float32,
                                              device=dev)}
        params["ln_s2"] = {"scale": torch.ones((ng, cfg.d_model), dtype=torch.float32,
                                               device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdt)
    return params


def _stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *, cache: dict | None = None,
           collect: bool = False, plain: bool = False):
    """Run all groups on the residual stream ``x``.  Each block's output is
    carried un-added into the next norm, which adds it: returns (x, h,
    states) with the last block's output ``h`` not yet added to ``x``.
    Decode (``cache`` given): each block steps its slot states and writes
    them back into ``cache`` in place; states is None.  Prefill with
    ``collect``: states are every block's final recurrent state, stacked
    into the ``init_cache`` layout (mlstm, slstm)."""
    ng, nm = _layout(cfg)
    has_s = cfg.slstm_every > 0
    b = x.shape[0]
    eps = cfg.norm_eps
    norm = rmsnorm_ref if plain else fused_rmsnorm
    stm = [[None] * nm for _ in range(ng)]
    sts = [None] * ng
    h = None
    for g in range(ng):
        for i in range(nm):
            p = tree_at(params["mlstm"], g, i)
            xn, x = norm(x, h, params["ln_m"]["scale"][g, i], eps=eps)
            if cache is not None:
                leaves = cache["mlstm"]
                h, st = mlstm_decode(p, xn, {k: v[g, i] for k, v in leaves.items()}, cfg,
                                     plain=plain)
                for k, v in st.items():
                    leaves[k][g, i].copy_(v)
            elif collect:
                h, stm[g][i] = mlstm_block(p, xn, cfg, return_state=True, plain=plain)
            else:
                h = mlstm_block(p, xn, cfg, plain=plain)
        if not has_s:
            sts[g] = init_slstm_state(cfg, b, device=x.device)
            continue
        ps = tree_at(params["slstm"], g)
        xn, x = norm(x, h, params["ln_s"]["scale"][g], eps=eps)
        if cache is not None:
            leaves = cache["slstm"]
            h, st = slstm_decode(ps, xn, {k: v[g] for k, v in leaves.items()}, cfg, plain=plain)
            for k, v in st.items():
                leaves[k][g].copy_(v)
        else:
            h, sts[g] = slstm_block(ps, xn, cfg, return_state=True, plain=plain)
        # x = x + h; h = mlp(rms_norm(x, ln_s2)), the add fused into the norm
        h2, x = norm(x, h, params["ln_s2"]["scale"][g], eps=eps)
        h = gated_mlp(ps["mlp"], h2, act="geglu")
    if cache is not None or not collect:
        return x, h, None
    mlstm = {k: torch.stack([torch.stack([stm[g][i][k] for i in range(nm)])
                             for g in range(ng)]) for k in stm[0][0]}
    slstm = {k: torch.stack([sts[g][k] for g in range(ng)]) for k in sts[0]}
    return x, h, (mlstm, slstm)


def _head(params: dict, x: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
          plain: bool) -> torch.Tensor:
    """Logits of rms_norm(x + h): the last block's add fused into the final norm."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    xn, _ = norm(x, h, params["final_norm"]["scale"], eps=cfg.norm_eps, want_residual=False)
    table = params.get("lm_head", params["tok_embed"])
    return xn @ table.T


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["tok_embed"][tokens].to(cfg.cdt)


# -- training -------------------------------------------------------------------


def _mlstm_layer(p: dict, ln: torch.Tensor, x: torch.Tensor, h: torch.Tensor | None,
                 cfg: ModelConfig, plain: bool):
    """One mLSTM block on ``x`` plus the previous block's output ``h``, the
    unit of remat: (x, this block's output, not yet added)."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    xn, x = norm(x, h, ln, eps=cfg.norm_eps)
    return x, mlstm_block(p, xn, cfg, plain=plain)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, plain: bool = False):
    """Logits at every position (B, S, V), and 0 (no auxiliary loss)."""
    ng, nm = _layout(cfg)
    eps = cfg.norm_eps
    norm = rmsnorm_ref if plain else fused_rmsnorm
    x = _embed(params, tokens, cfg)
    h = None
    for g in range(ng):
        for i in range(nm):
            x, h = remat(_mlstm_layer, cfg.remat, tree_at(params["mlstm"], g, i),
                         params["ln_m"]["scale"][g, i], x, h, cfg, plain)
        if cfg.slstm_every <= 0:
            continue
        ps = tree_at(params["slstm"], g)
        xn, x = norm(x, h, params["ln_s"]["scale"][g], eps=eps)
        h = slstm_block(ps, xn, cfg, plain=plain)
        h2, x = norm(x, h, params["ln_s2"]["scale"][g], eps=eps)
        h = gated_mlp(ps["mlp"], h2, act="geglu")
    return _head(params, x, h, cfg, plain), torch.zeros((), device=tokens.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *, plain: bool = False):
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens, cfg, plain=plain)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


# -- recurrent serving --------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device: torch.device | str) -> dict:
    """State cache; its size does not depend on ``max_seq``."""
    ng, nm = _layout(cfg)
    mlstm = {k: v.expand((ng, nm) + v.shape).clone()
             for k, v in init_mlstm_state(cfg, batch, dtype or cfg.cdt, device=device).items()}
    slstm = {k: v.expand((ng,) + v.shape).clone()
             for k, v in init_slstm_state(cfg, batch, device=device).items()}
    return {"mlstm": mlstm, "slstm": slstm,
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def splice_cache(cache: dict, single: dict, slot: int, length: int) -> None:
    """Copy a one-request cache ``single`` into slot ``slot`` of ``cache``, in
    place: every state leaf along its own batch axis (axis 2 of the mLSTM
    leaves, axis 1 of the sLSTM leaves), then ``len[slot]``.

    This is where the port deliberately differs from the reference's
    ``_splice_cache`` (``repro/runtime/server.py``), which splices a leaf
    only when its axis 1 is the batch axis: the reference leaves the
    ``(ng, nm, B, ...)`` mLSTM leaves unspliced when nm > 1 (decode starts
    from the zero state) and broadcasts or drops them when nm == 1."""
    for k, v in cache["mlstm"].items():
        v[:, :, slot] = single["mlstm"][k][:, :, 0]
    for k, v in cache["slstm"].items():
        v[:, slot] = single["slstm"][k][:, 0]
    cache["len"][slot] = length


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_seq: int | None = None, plain: bool = False):
    """Parallel prefill: one pass over the prompt that also emits every
    block's closed-form final recurrent state.  Returns (last-position
    logits (B, 1, V), cache).  ``max_seq`` is unused: the state does not
    grow with the sequence."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    x, h, (mlstm, slstm) = _stack(params, x, cfg, collect=True, plain=plain)
    # the norm is per position, so only the last one is computed
    logits = _head(params, x[:, -1:], h[:, -1:], cfg, plain)
    return logits, {"mlstm": mlstm, "slstm": slstm,
                    "len": torch.full((b,), s, dtype=torch.int32, device=tokens.device)}


def prefill_sequential(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                       plain: bool = False):
    """Replay-of-decode-steps prefill: the reference's own oracle for
    :func:`prefill`."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, 0, device=tokens.device)
    logits = None
    for t in range(s):
        logits, cache = decode_step(params, cache, tokens[:, t : t + 1], cfg, plain=plain)
    return logits, cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                plain: bool = False):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache), with
    ``cache`` updated in place and returned."""
    x = _embed(params, tokens, cfg)
    x, h, _ = _stack(params, x, cfg, cache=cache, plain=plain)
    cache["len"].add_(1)
    return _head(params, x, h, cfg, plain), cache
