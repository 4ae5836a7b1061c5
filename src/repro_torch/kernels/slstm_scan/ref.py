"""Plain PyTorch version of the sLSTM time scan (stabilised exponential
gating).

Mirrors ``repro/kernels/slstm_scan/ref.py``: gates laid out per head as
(..., 4*dh) = [i | f | z | o], block-diagonal recurrence through w_hh
(H, dh, 4dh), running-max stabiliser m, normaliser n.  The recurrent
product is taken in f32 (h is f32; a bf16 w_hh is widened), as JAX's type
promotion does in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["slstm_scan_ref", "slstm_step"]


def slstm_step(xg_t: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor, h_prev, c_prev,
               n_prev, m_prev):
    """One step: xg_t (B, 4D), state (B, D) f32 each -> new (h, c, n, m)."""
    bsz, d = h_prev.shape
    nh = w_hh.shape[0]
    dh = d // nh
    rec = torch.einsum("bhd,hdk->bhk", h_prev.reshape(bsz, nh, dh),
                       w_hh.float()).reshape(bsz, 4 * d)
    g = (xg_t.float() + rec) + b_ih.float()
    gi, gf, gz, go = (t.reshape(bsz, d) for t in g.reshape(bsz, nh, 4 * dh).split(dh, -1))
    logf = F.logsigmoid(gf)
    m = torch.maximum(logf + m_prev, gi)
    iprime = torch.exp(gi - m)
    fprime = torch.exp(logf + m_prev - m)
    c = fprime * c_prev + iprime * torch.tanh(gz)
    n = fprime * n_prev + iprime
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return h, c, n, m


def slstm_scan_ref(xg: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor):
    """xg: (B, S, 4D); w_hh: (H, dh, 4dh); b_ih: (4D,); h0/c0/n0/m0: (B, D).
    Returns (hs (B, S, D) f32, (h, c, n, m) each (B, D) f32)."""
    st = tuple(t.float() for t in (h0, c0, n0, m0))
    hs = []
    for t in range(xg.shape[1]):
        st = slstm_step(xg[:, t], w_hh, b_ih, *st)
        hs.append(st[0])
    if not hs:
        return xg.new_zeros((xg.shape[0], 0, xg.shape[2] // 4), dtype=torch.float32), st
    return torch.stack(hs, dim=1), st
