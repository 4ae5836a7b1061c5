"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) + sLSTM (scalar).

Counterpart of ``repro/models/xlstm.py``, with the same stabilised
formulation: ``m0 = -inf``, the intra-chunk exponent masked before ``exp``,
the denominator floored by ``exp(clip(-m, -60, 60))``, padded input gates
at ``-1e9`` and the conv tail padded for prompts shorter than the kernel.

The mLSTM cell has no kernel in the reference either: it is plain torch
(einsums, ``torch.cummax`` and a loop over chunks).  The sLSTM time
recurrence goes through the sLSTM scan kernel
(:func:`repro_torch.kernels.slstm_scan.ops.slstm_scan`) in prefill and in
decode, as the reference's TPU branch does in prefill.  Both blocks' inner
norms go through the fused residual-add + RMSNorm kernel
(:func:`repro_torch.kernels.rmsnorm.ops.fused_rmsnorm`), the mLSTM's with
its ``hcell + conv * skip`` add fused in.  ``plain=True`` takes the
kernels' plain versions instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref
from repro_torch.kernels.slstm_scan.ops import slstm_scan, slstm_scan_ref

from .common import ModelConfig, dense_init

__all__ = [
    "init_mlstm", "mlstm_block", "mlstm_decode", "init_mlstm_state", "mlstm_shapes",
    "init_slstm", "slstm_block", "slstm_decode", "init_slstm_state", "slstm_shapes",
    "xlstm_dims",
]

_CONV_K = 4
_NEG = -1.0e30


def xlstm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model  # pf=2 up-projection
    heads = cfg.num_heads
    dh = d_inner // heads
    return d_inner, heads, dh


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_shapes(cfg: ModelConfig) -> dict:
    """One mLSTM block's leaves: name -> (shape, dtype)."""
    d = cfg.d_model
    di, h, dh = xlstm_dims(cfg)
    return {
        "w_in": ((d, 2 * di), cfg.pdt),      # [gate | mlstm]
        "conv_w": ((_CONV_K, di), cfg.pdt),
        "conv_b": ((di,), cfg.pdt),
        "wq": ((di, h, dh), cfg.pdt),
        "wk": ((di, h, dh), cfg.pdt),
        "wv": ((di, h, dh), cfg.pdt),
        "w_gates": ((di, 2 * h), torch.float32),  # [i | f]
        "skip": ((di,), cfg.pdt),
        "norm_inner": ((di,), torch.float32),
        "w_out": ((di, d), cfg.pdt),
    }


def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, dh = xlstm_dims(cfg)
    dev = gen.device
    return {
        "w_in": dense_init(gen, (d, 2 * di), cfg.pdt),
        "conv_w": dense_init(gen, (_CONV_K, di), cfg.pdt, fan_in=_CONV_K),
        "conv_b": torch.zeros((di,), dtype=cfg.pdt, device=dev),
        "wq": dense_init(gen, (di, h, dh), cfg.pdt),
        "wk": dense_init(gen, (di, h, dh), cfg.pdt),
        "wv": dense_init(gen, (di, h, dh), cfg.pdt),
        "w_gates": dense_init(gen, (di, 2 * h), torch.float32),
        "skip": torch.ones((di,), dtype=cfg.pdt, device=dev),
        "norm_inner": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (di, d), cfg.pdt, fan_in=di),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(out + b)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, H, dh) -> (..., H, dh)."""
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).unflatten(-1, (h, dh))


def _mlstm_cell_chunked(q, k, v, i_gate, f_gate, chunk: int):
    """Stabilised mLSTM, chunkwise-parallel: one loop over chunks carries
    the (C, n, m) state; each chunk combines an intra-chunk masked quadratic
    with a read of the carried state (see the reference's docstring).

    q,k,v: (B,S,H,dh); i_gate,f_gate: (B,S,H) raw gates.  Returns
    (h: (B,S,H,dh) f32, final_state: dict(C, n, m))."""
    b, s, h, dh = q.shape
    q = q * (dh ** -0.5)
    logf = F.logsigmoid(f_gate.float())                # (B,S,H)
    ig = i_gate.float()

    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        logf = F.pad(logf, (0, 0, 0, pad))
        ig = F.pad(ig, (0, 0, 0, pad), value=-1e9)
    L = chunk
    ii = torch.arange(L, device=q.device)
    intra_mask = (ii[:, None] >= ii[None, :])[None, :, :, None]  # s<=τ

    C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), float("-inf"), dtype=torch.float32, device=q.device)
    hs = []
    for j in range(nc):
        sl = slice(j * L, (j + 1) * L)
        qb, kb, vb, lfb, igb = q[:, sl], k[:, sl], v[:, sl], logf[:, sl], ig[:, sl]
        G = torch.cumsum(lfb, dim=1)                   # (b,L,h) inclusive decay
        ig_G = igb - G
        A = torch.cummax(ig_G, dim=1).values
        M = torch.maximum(m[:, None], A)               # (b,L,h)
        m_t = G + M
        w_in = torch.exp(m[:, None] - M)               # ≤ 1
        # mask the exponent BEFORE exp: the dropped branch is exp(-1e30) = 0
        expo = ig_G[:, None, :, :] - M[:, :, None, :]  # (b,τ,s,h)
        w_s = torch.exp(torch.where(intra_mask, expo, torch.full_like(expo, _NEG)))
        qf, kf, vf = qb.float(), kb.float(), vb.float()
        a = torch.einsum("bihd,bjhd->bijh", qf, kf)    # q_τ·k_s in f32
        inter_num = torch.einsum("bihd,bhdv->bihv", qf, C)
        inter_den = torch.einsum("bihd,bhd->bih", qf, n)
        num = w_in[..., None] * inter_num + torch.einsum("bijh,bjhd->bihd", w_s * a, vf)
        r = w_in * inter_den + (w_s * a).sum(dim=2)
        den = torch.maximum(r.abs(), torch.exp(torch.clamp(-m_t, -60.0, 60.0)))
        hs.append(num / den[..., None])                # (b,L,h,dh)
        # chunk-end state (τ = L weights)
        ML = M[:, -1]                                  # (b,h)
        wL = torch.exp(ig_G - ML[:, None])             # (b,L,h) ≤ 1
        decay = torch.exp(m - ML)
        C = decay[..., None, None] * C + torch.einsum("blhk,blhv->bhkv", wL[..., None] * kf, vf)
        n = decay[..., None] * n + torch.einsum("blh,blhk->bhk", wL, kf)
        m = G[:, -1] + ML
    hcell = torch.cat(hs, dim=1)[:, :s]
    return hcell, {"C": C, "n": n, "m": m}


def _inner_norm(p: dict, y: torch.Tensor, r: torch.Tensor | None, cfg: ModelConfig,
                plain: bool) -> torch.Tensor:
    """rms_norm(y + r, norm_inner) (y alone when ``r`` is None), one kernel call."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    return norm(y, r, p["norm_inner"], eps=cfg.norm_eps, want_residual=False)[0]


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False,
                plain: bool = False):
    """x: (B,S,D) -> (B,S,D) [, final recurrent state (C, n, m, conv)]."""
    b, s, d = x.shape
    di, h, dh = xlstm_dims(cfg)
    up = x @ p["w_in"]
    gate, inner = up.split(di, dim=-1)
    conv = _causal_conv(inner, p["conv_w"], p["conv_b"])
    q = _proj(conv, p["wq"])
    k = _proj(conv, p["wk"])
    v = _proj(inner, p["wv"])
    gates = conv.float() @ p["w_gates"]
    ig, fg = gates.split(h, dim=-1)
    hcell, st = _mlstm_cell_chunked(q, k, v, ig, fg, cfg.ssm_chunk)
    # hcell is a view of the chunk-padded cell output: its rows, the fused
    # norm's input, are made contiguous (the bf16 cast already does that)
    hc = hcell.reshape(b, s, di).to(x.dtype).contiguous()
    y = _inner_norm(p, hc, conv * p["skip"], cfg, plain)
    y = y * F.silu(gate)
    out = y @ p["w_out"]
    if not return_state:
        return out
    tail = inner[:, -(_CONV_K - 1):]
    if s < _CONV_K - 1:
        tail = F.pad(inner, (0, 0, _CONV_K - 1 - s, 0))
    st = dict(st, conv=tail.to(cfg.cdt))
    return out, st


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device: torch.device | str = "cpu") -> dict:
    di, h, dh = xlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), float("-inf"), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, di), dtype=dtype, device=device),
    }


def mlstm_decode(p: dict, x1: torch.Tensor, state: dict, cfg: ModelConfig, *,
                 plain: bool = False):
    """x1: (B,1,D).  O(1) recurrent step; returns (out (B,1,D), new state)."""
    b = x1.shape[0]
    di, h, dh = xlstm_dims(cfg)
    up = x1[:, 0] @ p["w_in"]
    gate, inner = up.split(di, dim=-1)
    win = torch.cat([state["conv"], inner[:, None].to(state["conv"].dtype)], 1)
    # einsum leaves (B, C) transposed in memory; the fused norm reads rows
    conv = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]).contiguous()
    q = _proj(conv, p["wq"]).float() * (dh ** -0.5)
    k = _proj(conv, p["wk"]).float()
    v = _proj(inner, p["wv"]).float()
    gates = conv.float() @ p["w_gates"]
    ig, fg = gates.split(h, dim=-1)                    # (B,H)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + state["m"], ig)
    fprime = torch.exp(logf + state["m"] - m_new)
    iprime = torch.exp(ig - m_new)
    C = state["C"] * fprime[..., None, None] + \
        iprime[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = state["n"] * fprime[..., None] + iprime[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                        torch.exp(torch.clamp(-m_new, -60.0, 60.0)))
    hcell = num / den[..., None]
    y = _inner_norm(p, hcell.reshape(b, di).to(x1.dtype), conv * p["skip"], cfg, plain)
    y = y * F.silu(gate)
    out = (y @ p["w_out"])[:, None]
    return out, {"C": C, "n": n, "m": m_new, "conv": win[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_ff(cfg: ModelConfig) -> int:
    return max(64, int(round(cfg.d_model * 4 / 3 / 64)) * 64)


def slstm_shapes(cfg: ModelConfig) -> dict:
    """One sLSTM block's leaves: name -> (shape, dtype); ``mlp`` nested."""
    d, h = cfg.d_model, cfg.num_heads
    dh, ff = d // h, _slstm_ff(cfg)
    return {
        "w_ih": ((d, 4 * d), cfg.pdt),       # i,f,z,o
        "w_hh": ((h, dh, 4 * dh), cfg.pdt),
        "b_ih": ((4 * d,), torch.float32),
        "norm_inner": ((d,), torch.float32),
        "mlp": {"w_gate": ((d, ff), cfg.pdt), "w_up": ((d, ff), cfg.pdt),
                "w_down": ((ff, d), cfg.pdt)},
    }


def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    dh, ff = d // h, _slstm_ff(cfg)
    dev = gen.device
    return {
        "w_ih": dense_init(gen, (d, 4 * d), cfg.pdt),
        "w_hh": dense_init(gen, (h, dh, 4 * dh), cfg.pdt, fan_in=dh),
        "b_ih": torch.zeros((4 * d,), dtype=torch.float32, device=dev),
        "norm_inner": torch.ones((d,), dtype=torch.float32, device=dev),
        "mlp": {
            "w_gate": dense_init(gen, (d, ff), cfg.pdt),
            "w_up": dense_init(gen, (d, ff), cfg.pdt),
            "w_down": dense_init(gen, (ff, d), cfg.pdt, fan_in=ff),
        },
    }


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False,
                plain: bool = False):
    """sLSTM cell over the sequence: (B,S,D) -> (B,S,D) [, final state].
    The input projection is one sequence-wide product; the time loop is one
    sLSTM scan kernel launch from the zero state.  The block's FFN sublayer
    is applied by the stack in ``xlstm_model``."""
    b, s, d = x.shape
    xg = x @ p["w_ih"]                                 # (B,S,4D)
    st0 = init_slstm_state(cfg, b, device=x.device)
    scan = slstm_scan_ref if plain else slstm_scan
    hs, (h, c, n, m) = scan(xg, p["w_hh"], p["b_ih"], st0["h"], st0["c"], st0["n"], st0["m"])
    y = _inner_norm(p, hs.to(x.dtype), None, cfg, plain)
    if not return_state:
        return y
    return y, {"h": h, "c": c, "n": n, "m": m}


def init_slstm_state(cfg: ModelConfig, batch: int, *,
                     device: torch.device | str = "cpu") -> dict:
    z = lambda: torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)  # noqa: E731
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full((batch, cfg.d_model), float("-inf"), device=device)}


def slstm_decode(p: dict, x1: torch.Tensor, state: dict, cfg: ModelConfig, *,
                 plain: bool = False):
    """x1: (B,1,D).  One step of the recurrence: the sLSTM scan kernel with
    S = 1, resuming from ``state``; the new state is returned in new
    tensors (the kernel's outputs never alias its inputs)."""
    xg = x1 @ p["w_ih"]                                # (B,1,4D)
    scan = slstm_scan_ref if plain else slstm_scan
    _, (h, c, n, m) = scan(xg, p["w_hh"], p["b_ih"], state["h"], state["c"], state["n"],
                           state["m"])
    y = _inner_norm(p, h.to(x1.dtype), None, cfg, plain)
    return y[:, None], {"h": h, "c": c, "n": n, "m": m}
