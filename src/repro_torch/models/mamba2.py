"""Mamba2 (SSD, state space duality) blocks: chunked-parallel prefill and
recurrent decode.

Counterpart of ``repro/models/mamba2.py``, with its dtype steps: dt and A
in f32, each decay-weighted product cast to the activations' dtype before
it meets them, every SSD product accumulated in f32 (the reference's
``preferred_element_type``), the decode recurrence in f32, and the
conv tail kept in the compute dtype.  Padding to a whole chunk pads dt
with zeros AFTER the softplus, so a padded step neither decays nor adds
to the state and ``S_final`` is exact.

One step differs from the reference, in the masked entries only: the
intra-chunk decay ``exp(cs_i - cs_j)`` is masked BEFORE ``exp``.  The
reference multiplies ``exp(cs_i - cs_j)`` by the causal mask after it, and
above the diagonal that exponent is the positive sum of up to a chunk of
``-dt * A`` terms: at a chunk of 256 it passes f32's ``exp`` range, and
``inf * 0`` makes the block's output NaN (ROADMAP.md, Queue 3).  Wherever
the reference is finite the two agree.

The Mamba2 block has no kernel in the reference either: the SSD scan and
the decode step are plain torch (einsums and a loop over chunks), as they
are plain JAX there.  The block's inner norm, ``rms_norm(y * silu(z),
norm_inner)``, goes through the fused residual-add + RMSNorm kernel
(:func:`repro_torch.kernels.rmsnorm.ops.fused_rmsnorm`), the norm alone;
``plain=True`` takes its plain version instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref

from .common import ModelConfig, dense_init

__all__ = ["init_mamba", "mamba_block", "mamba_decode", "init_mamba_state", "mamba_dims",
           "mamba_shapes"]

_CONV_K = 4


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_state


def mamba_shapes(cfg: ModelConfig) -> dict:
    """One Mamba2 block's leaves: name -> (shape, dtype)."""
    d = cfg.d_model
    d_inner, nheads, n = mamba_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "in_proj": ((d, 2 * d_inner + 2 * n + nheads), cfg.pdt),   # [z | x B C | dt]
        "conv_w": ((_CONV_K, conv_dim), cfg.pdt),
        "conv_b": ((conv_dim,), cfg.pdt),
        "dt_bias": ((nheads,), torch.float32),
        "A_log": ((nheads,), torch.float32),       # A = -exp(A_log)
        "D_skip": ((nheads,), torch.float32),
        "norm_inner": ((d_inner,), torch.float32),
        "out_proj": ((d_inner, d), cfg.pdt),
    }


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, nheads, n = mamba_dims(cfg)
    conv_dim = d_inner + 2 * n
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d, 2 * d_inner + 2 * n + nheads), cfg.pdt),
        "conv_w": dense_init(gen, (_CONV_K, conv_dim), cfg.pdt, fan_in=_CONV_K),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.pdt, device=dev),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "D_skip": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "norm_inner": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, d), cfg.pdt, fan_in=d_inner),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    d_inner, nheads, n = mamba_dims(cfg)
    z, xbc, dt = proj.split([d_inner, d_inner + 2 * n, nheads], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, Cdim) with kernel (K, Cdim)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    # window sum: sum_k w[k] * x[t - (K-1) + k]
    out = sum(pad[:, i : i + xbc.shape[1]] * w[i] for i in range(k))
    return F.silu(out + b)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                 A: torch.Tensor, chunk: int):
    """x: (B,S,H,P); dt: (B,S,H) f32; B_/C_: (B,S,N); A: (H,) negative.

    Returns (y (B,S,H,P) in x's dtype, S_final (B,H,N,P) f32): the
    intra-chunk quadratic form plus the inter-chunk state scan (S/chunk
    sequential steps)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B_.reshape(b, nc, q, n)
    Cc = C_.reshape(b, nc, q, n)
    f32 = torch.float32

    log_a = dtc * A                                     # (b,nc,q,h), all <= 0
    cs = torch.cumsum(log_a, dim=2)                     # inclusive cumulative log-decay

    # intra-chunk: W[b,c,h,i,j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j, j <= i
    scores = torch.einsum("bcin,bcjn->bcij", Cc.to(f32), Bc.to(f32))
    cst = cs.transpose(2, 3)                            # (b,c,h,q)
    ii = torch.arange(q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    expo = cst[..., :, None] - cst[..., None, :]        # (b,c,h,i,j)
    decay = torch.exp(torch.where(causal, expo, torch.full_like(expo, -torch.inf)))
    W = scores[:, :, None] * decay * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", W.to(x.dtype).to(f32), xc.to(f32))

    # chunk-local end states: S_c = sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j
    dec_last = torch.exp(cs[:, :, -1:, :] - cs)         # (b,c,q,h)
    sl = torch.einsum("bcjh,bcjn,bcjhp->bchnp", (dec_last * dtc).to(x.dtype).to(f32),
                      Bc.to(f32), xc.to(f32))

    # inter-chunk recurrence over nc chunks
    chunk_decay = torch.exp(cs[:, :, -1, :])            # (b,c,h)
    S = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(S)
        S = S * chunk_decay[:, c, :, None, None] + sl[:, c]
    S_prev = torch.stack(prev, dim=1)                   # (b,c,h,n,p)

    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc.to(f32), S_prev.to(x.dtype).to(f32))
    y_inter = y_inter * torch.exp(cs)[..., None]

    y = (y_intra + y_inter).reshape(b, nc * q, h, p)
    # S is exact under padding: padded steps have dt = 0 (no decay, no
    # contribution), so the scan's final carry is the state at position s
    return y[:, :s].to(x.dtype), S


def _inner_norm(p: dict, y: torch.Tensor, cfg: ModelConfig, plain: bool) -> torch.Tensor:
    """rms_norm(y, norm_inner), the norm alone, one kernel call."""
    norm = rmsnorm_ref if plain else fused_rmsnorm
    return norm(y, None, p["norm_inner"], eps=cfg.norm_eps, want_residual=False)[0]


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False,
                plain: bool = False):
    """x: (B, S, D) -> (B, S, D) [, final recurrent state].

    ``return_state`` hands back the chunk scan's final SSD state and the
    causal conv's tail: decode-ready, from the parallel pass."""
    b, s, d = x.shape
    d_inner, nheads, n = mamba_dims(cfg)
    proj = x @ p["in_proj"]
    z, xbc_raw, dt_raw = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs, B_, C_ = xbc.split([d_inner, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, s, nheads, cfg.ssm_head_dim)
    y, S_final = _ssd_chunked(xh, dt, B_, C_, A, cfg.ssm_chunk)
    y = y + xh * p["D_skip"][:, None].to(x.dtype)
    y = y.reshape(b, s, d_inner)
    y = _inner_norm(p, y * F.silu(z), cfg, plain)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    tail = xbc_raw[:, -(_CONV_K - 1):]
    if s < _CONV_K - 1:
        tail = F.pad(xbc_raw, (0, 0, _CONV_K - 1 - s, 0))
    return out, {"ssm": S_final, "conv": tail.to(cfg.cdt)}


# ---------------------------------------------------------------------------
# recurrent decode
# ---------------------------------------------------------------------------


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device: torch.device | str = "cpu") -> dict:
    d_inner, nheads, n = mamba_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "ssm": torch.zeros((batch, nheads, n, cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba_decode(p: dict, x1: torch.Tensor, state: dict, cfg: ModelConfig, *,
                 plain: bool = False):
    """x1: (B, 1, D) one token; returns (y (B, 1, D), new state). O(1) in S."""
    b = x1.shape[0]
    d_inner, nheads, n = mamba_dims(cfg)
    proj = x1[:, 0] @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(proj, cfg)
    # conv over the stored window + this input
    win = torch.cat([state["conv"], xbc[:, None].to(state["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    xbc_t = F.silu(conv_out)
    xs, B_, C_ = xbc_t.split([d_inner, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                      # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))                          # (B,H)
    xh = xs.reshape(b, nheads, cfg.ssm_head_dim).float()
    # S' = a S + dt * B (x) x ; y = C . S' + D x
    S = state["ssm"] * a[..., None, None] + \
        dt[..., None, None] * torch.einsum("bn,bhp->bhnp", B_.float(), xh)
    y = torch.einsum("bn,bhnp->bhp", C_.float(), S)
    y = y + xh * p["D_skip"][:, None]
    y = y.reshape(b, d_inner).to(x1.dtype)
    y = _inner_norm(p, y * F.silu(z), cfg, plain)
    out = (y @ p["out_proj"])[:, None]
    return out, {"ssm": S, "conv": win[:, 1:]}
