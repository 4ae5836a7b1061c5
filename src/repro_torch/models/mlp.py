"""Feed-forward layers: the gated dense MLP and the token-choice MoE.

Counterpart of ``repro/models/mlp.py``.  The matmuls stay ``torch.matmul``
and ``torch.bmm``, as the reference leaves them (and ``lax.ragged_dot``)
to XLA: the MoE layer has no Pallas kernel in the reference.

The MoE layer is the reference's no-mesh branch of ``moe_ffn``: token-choice
top-k routing in f32 (:func:`_route`), then either the dropless path
(:func:`_moe_local`: pairs sorted by expert, one GEMM triple per expert that
was routed to) or, once experts see at least 64 rows each, the capacity path
(:func:`_moe_local_capacity`: a fixed 128-aligned row budget per expert,
three batched GEMMs over all experts).  ``n_local``, ``offset`` and
``e_valid`` keep the reference's signature (a shard's experts, their first
global id, phantom experts past ``e_valid``) so the overflow bucket and the
phantom mask can be held against it; nothing here reduces across shards.
The mesh branches (``_moe_serving``, expert parallelism under
``shard_map``) wait for the sharding item (ROADMAP.md Queue 1 item 8).

The dropless path reads the group sizes to the host once per call, to run
only the experts that were routed to (as ``ragged_dot`` does on a backend
with grouped GEMM).  That sync (one per layer per model call) rules out
CUDA-graph capture of the step, and each active expert costs about three
GEMM launches plus two elementwise ones: the grouped GEMM item of ROADMAP.md
Queue 2 removes both.

On ``meta`` (the dry run, ``launch/cost_analysis``) there is nothing to
read: the rule is that the T·k routed rows spread evenly over the experts,
as a batch of T·k >= E pairs routes to every expert.  The GEMMs' FLOPs are
the same for any split of the T·k rows; their bytes are the card's when
every expert is routed to.  The read itself is not counted.  Segment
starts come from ``searchsorted`` over the sorted expert ids and the
load-balance counts from ``scatter_add_``, which have ``meta`` kernels
(``bincount`` has none); the integers are the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._device import uncounted

from .common import dense_init

__all__ = ["gated_mlp", "init_mlp", "init_moe", "moe_ffn"]


def _act(name: str):
    if name == "swiglu":
        return F.silu
    if name == "geglu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    }


def gated_mlp(params: dict, x: torch.Tensor, *, act: str = "swiglu") -> torch.Tensor:
    a = _act(act)
    h = a(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg) -> dict:
    """The reference's tree: ``router`` (d, E) f32; ``e_gate``/``e_up`` (E,
    d, f) and ``e_down`` (E, f, d); with shared experts ``shared`` holding
    a gated MLP of ``d_ff_shared`` and its ``shared_gate`` (d,) f32."""
    d, e, fe = cfg.d_model, cfg.num_experts, cfg.d_ff
    p = {
        "router": dense_init(gen, (d, e), torch.float32),
        "e_gate": dense_init(gen, (e, d, fe), cfg.pdt),
        "e_up": dense_init(gen, (e, d, fe), cfg.pdt),
        "e_down": dense_init(gen, (e, fe, d), cfg.pdt, fan_in=fe),
    }
    if cfg.num_shared_experts:
        p["shared"] = {**init_mlp(gen, d, cfg.d_ff_shared, cfg.pdt),
                       "shared_gate": dense_init(gen, (d,), torch.float32)}
    return p


def _route(x2d: torch.Tensor, router: torch.Tensor, k: int, e_valid: int | None):
    """Token-choice routing in f32: softmax over the router's logits (experts
    past ``e_valid`` masked out), the top ``k`` in descending order, their
    probabilities renormalised to sum to 1.  Returns (probs (T, E), top_p
    (T, k), top_e (T, k) int64)."""
    logits = x2d.float() @ router
    if e_valid is not None and e_valid < router.shape[-1]:
        phantom = torch.arange(router.shape[-1], device=x2d.device) >= e_valid
        logits = logits.masked_fill(phantom, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, top_p, top_e


def _dispatch(x2d, router, *, cfg, n_local: int, offset: int, e_valid):
    """Routing, then the selected (token, expert) pairs sorted (stably) by
    local expert id; pairs of experts outside ``[offset, offset +
    n_local)`` go to the overflow bucket ``n_local``.  Returns (probs,
    flat_e, sorted token ids, sorted local ids, sorted weights)."""
    t, k = x2d.shape[0], cfg.top_k
    probs, top_p, top_e = _route(x2d, router, k, e_valid)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    flat_t = torch.arange(t, device=x2d.device).repeat_interleave(k)
    mine = (flat_e >= offset) & (flat_e < offset + n_local)
    local_e = torch.where(mine, flat_e - offset, torch.full_like(flat_e, n_local))
    order = torch.argsort(local_e, stable=True)
    return probs, flat_e, flat_t[order], local_e[order], flat_p[order]


def _segment_starts(se: torch.Tensor, n: int) -> torch.Tensor:
    """Where each of the ids ``0 .. n-1`` starts in the sorted ids ``se``."""
    return torch.searchsorted(se, torch.arange(n, dtype=se.dtype, device=se.device))


def _aux_loss(probs: torch.Tensor, flat_e: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    e = probs.shape[-1]
    ce = torch.zeros(e, dtype=torch.float32, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones(flat_e.shape, dtype=torch.float32, device=flat_e.device)) / (t * k)
    return e * (probs.mean(0) * ce).sum()


def _moe_local(x2d, router, e_gate, e_up, e_down, *, cfg, n_local: int, offset: int = 0,
               e_valid: int | None = None, aux: bool = True):
    """Dropless token-choice top-k over experts ``[offset, offset + n_local)``.

    x2d: (T, D).  The sorted pairs run through one GEMM triple per expert
    that was routed to, over its slice of the sorted rows; the overflow
    bucket's rows stay 0 (the reference's zero-weight group).  Returns
    (out (T, D), aux loss or None)."""
    t, d = x2d.shape
    probs, flat_e, st, se, sp = _dispatch(x2d, router, cfg=cfg, n_local=n_local,
                                          offset=offset, e_valid=e_valid)
    starts = _segment_starts(se, n_local + 1)
    if se.is_meta:      # the dry run's rule (module docstring): every expert routed to
        n = se.shape[0]
        sizes = [n // n_local + (e < n % n_local) for e in range(n_local)] + [0]
    else:
        with uncounted():
            bounds = starts.tolist() + [se.shape[0]]      # the one host sync
        sizes = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    xs = x2d[st]
    act = _act(cfg.mlp_act)
    # serving writes each expert's rows in place; autograd cannot take an
    # out= product, so training joins the pieces instead
    grad = torch.is_grad_enabled()
    y = None if grad else xs.new_zeros(xs.shape)
    pieces = []
    start = 0
    for e, n in enumerate(sizes[:n_local]):
        if n:
            xe = xs[start:start + n]
            h = act(xe @ e_gate[e].to(xe.dtype)) * (xe @ e_up[e].to(xe.dtype))
            if grad:
                pieces.append(h @ e_down[e].to(h.dtype))
            else:
                torch.matmul(h, e_down[e].to(h.dtype), out=y[start:start + n])
        start += n
    if grad:   # the overflow bucket's rows stay 0
        y = torch.cat(pieces + [xs.new_zeros((sizes[n_local], d))])
    out = torch.zeros((t, d), dtype=y.dtype, device=y.device)
    out.index_add_(0, st, y * sp[:, None].to(y.dtype))
    return out, (_aux_loss(probs, flat_e, t, cfg.top_k) if aux else None)


def _moe_local_capacity(x2d, router, e_gate, e_up, e_down, *, cfg, n_local: int,
                        offset: int = 0, e_valid: int | None = None, aux: bool = True):
    """Capacity-based gather -> batched GEMMs -> scatter.

    Every local expert gets ``cap`` rows (expected rows per expert times
    ``moe_capacity_factor``, rounded up to 128); pairs beyond it, and the
    overflow bucket's, go to a drop row that reads back 0.  The three
    expert GEMMs are ``torch.bmm`` over (n_local, cap, .); no host sync.
    A dropped pair's weight is zeroed and the kept weights are not
    renormalised, as the reference's code does (its docstring says
    "renormalize"; its arithmetic does not)."""
    t, d = x2d.shape
    k = cfg.top_k
    e_total = e_valid or router.shape[-1]       # capacity sized on real experts
    probs, flat_e, st, se, sp = _dispatch(x2d, router, cfg=cfg, n_local=n_local,
                                          offset=offset, e_valid=e_valid)
    cap = int(cfg.moe_capacity_factor * t * k / e_total) + 1
    cap = -(-cap // 128) * 128
    seg_start = _segment_starts(se, n_local + 1)
    pos = torch.arange(se.shape[0], device=x2d.device) - seg_start[se]
    keep = (se < n_local) & (pos < cap)
    dest = torch.where(keep, se * cap + pos, torch.full_like(se, n_local * cap))

    xbuf = x2d.new_zeros((n_local * cap + 1, d))
    xbuf[dest] = x2d[st]
    xg = xbuf[:-1].view(n_local, cap, d)
    act = _act(cfg.mlp_act)
    h = act(torch.bmm(xg, e_gate.to(xg.dtype))) * torch.bmm(xg, e_up.to(xg.dtype))
    y = torch.bmm(h, e_down.to(h.dtype)).reshape(n_local * cap, d)
    y = torch.cat([y, y.new_zeros((1, d))])    # the drop row reads 0
    contrib = y[dest] * (sp * keep).to(y.dtype)[:, None]
    out = torch.zeros((t, d), dtype=y.dtype, device=y.device)
    out.index_add_(0, st, contrib)
    return out, (_aux_loss(probs, flat_e, t, k) if aux else None)


def moe_ffn(params: dict, x: torch.Tensor, *, cfg, aux: bool = False):
    """x: (B, S, D) -> ((B, S, D), aux loss or None).

    The capacity path when ``moe_capacity_factor > 0`` and experts see at
    least 64 rows each on average (B * S * k / E), else the dropless path,
    as the reference decides.  The shared experts' output is added with
    ``sigmoid(x @ shared_gate)`` (f32) as its gate.  The load-balance loss
    is computed only when ``aux`` asks for it (serving never does)."""
    b, s, d = x.shape
    e = cfg.num_experts
    use_capacity = cfg.moe_capacity_factor > 0 and b * s * cfg.top_k / max(e, 1) >= 64
    local = _moe_local_capacity if use_capacity else _moe_local
    out, loss = local(x.reshape(-1, d), params["router"], params["e_gate"], params["e_up"],
                      params["e_down"], cfg=cfg, n_local=e, offset=0, aux=aux)
    out = out.reshape(b, s, d).to(x.dtype)
    if cfg.num_shared_experts:
        sh = params["shared"]
        gate = torch.sigmoid(x.float() @ sh["shared_gate"])
        out = out + gated_mlp(sh, x, act=cfg.mlp_act) * gate[..., None].to(x.dtype)
    return out, loss
