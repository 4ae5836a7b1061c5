"""Plain PyTorch version of the sLSTM time scan (stabilised exponential
gating).

Mirrors ``repro/kernels/slstm_scan/ref.py``: gates laid out per head as
(..., 4*dh) = [i | f | z | o], block-diagonal recurrence through w_hh
(H, dh, 4dh), running-max stabiliser m, normaliser n.  The recurrent
product is taken in f32 (h is f32; a bf16 w_hh is widened), as JAX's type
promotion does in the reference.

``slstm_scan_bwd_ref`` is the plain version of the backward kernel
(``csrc/slstm_scan_bwd.cu``): an explicit reverse-time loop with torch's
derivative rules for :func:`slstm_step`, from the gates and states the
forward saves, so it equals autograd of :func:`slstm_scan_ref` up to
rounding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["slstm_scan_bwd_ref", "slstm_scan_ref", "slstm_step"]


def _gates(xg_t: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor, h_prev):
    """A step's gate pre-activations (B, 4D) f32: (xg_t + h_{t-1} . w_hh) + b."""
    bsz, d = h_prev.shape
    nh = w_hh.shape[0]
    rec = torch.einsum("bhd,hdk->bhk", h_prev.reshape(bsz, nh, d // nh),
                       w_hh.float()).reshape(bsz, 4 * d)
    return (xg_t.float() + rec) + b_ih.float()


def _cell(g: torch.Tensor, nh: int, c_prev, n_prev, m_prev):
    """The gate math of one step from its gates g (B, 4D), laid out per head
    as [i | f | z | o]: new (h, c, n, m)."""
    bsz, d = c_prev.shape
    gi, gf, gz, go = (t.reshape(bsz, d) for t in g.reshape(bsz, nh, 4 * d // nh)
                      .split(d // nh, -1))
    logf = F.logsigmoid(gf)
    m = torch.maximum(logf + m_prev, gi)
    iprime = torch.exp(gi - m)
    fprime = torch.exp(logf + m_prev - m)
    c = fprime * c_prev + iprime * torch.tanh(gz)
    n = fprime * n_prev + iprime
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return h, c, n, m


def slstm_step(xg_t: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor, h_prev, c_prev,
               n_prev, m_prev):
    """One step: xg_t (B, 4D), state (B, D) f32 each -> new (h, c, n, m)."""
    return _cell(_gates(xg_t, w_hh, b_ih, h_prev), w_hh.shape[0], c_prev, n_prev, m_prev)


def slstm_scan_ref(xg: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor, *,
                   save_states: bool = False):
    """xg: (B, S, 4D); w_hh: (H, dh, 4dh); b_ih: (4D,); h0/c0/n0/m0: (B, D).
    Returns (hs (B, S, D) f32, (h, c, n, m) each (B, D) f32), and with
    ``save_states`` also every step's gates ((B, S, 4D) f32, as the gate
    math received them) and (c, n, m) ((B, S, D) f32 each): what the
    kernel's save mode writes for the backward."""
    nh = w_hh.shape[0]
    st = tuple(t.float() for t in (h0, c0, n0, m0))
    hs, saved = [], []
    for t in range(xg.shape[1]):
        g = _gates(xg[:, t], w_hh, b_ih, st[0])
        st = _cell(g, nh, *st[1:])
        hs.append(st[0])
        saved.append((g, *st[1:]))
    if not hs:
        empty = xg.new_zeros((xg.shape[0], 0, xg.shape[2] // 4), dtype=torch.float32)
        gates = xg.new_zeros((xg.shape[0], 0, xg.shape[2]), dtype=torch.float32)
        return (empty, st, (gates, empty, empty, empty)) if save_states else (empty, st)
    hs = torch.stack(hs, dim=1)
    if save_states:
        return hs, st, tuple(torch.stack(v, dim=1) for v in zip(*saved))
    return hs, st


def slstm_scan_bwd_ref(w_hh, h0, c0, n0, m0, hs, gates, cs, ns, ms, dhs, dh_T=None,
                       dc_T=None, dn_T=None, dm_T=None, *, x_dtype):
    """Gradient of :func:`slstm_scan_ref` at (xg, w_hh, b_ih, h0, c0, n0, m0),
    given its outputs ``hs``, every step's ``gates`` ((B, S, 4D) f32) and
    (c, n, m) (``cs``, ``ns``, ``ms``, (B, S, D) f32), the cotangent ``dhs``
    of hs (None: zero) and those of the final (h, c, n, m) (None: zero);
    ``x_dtype`` is xg's dtype.  Returns (dxg in ``x_dtype``, dw_hh in
    w_hh's dtype, db_ih f32, dh0, dc0, dn0, dm0 f32).

    A reverse-time loop with torch's derivative rules for :func:`slstm_step`:
    ``torch.maximum`` splits a tie in half, ``torch.clamp(n, min=1e-6)``
    passes the gradient only where n >= 1e-6, and ``F.logsigmoid``'s
    derivative is sigmoid(-f).  Each m-derivative is a product with f' (0
    at m_{t-1} = -inf) or an indicator, so the zero state's first step gives
    finite gradients and dm0 = 0.  The gates are the forward's own (no
    recurrent product is formed again), as the kernel reads them; hs gives
    dw_hh, and dw_hh and db_ih are sums over every step's gate gradient."""
    b, s, d = hs.shape
    d4 = 4 * d
    nh = w_hh.shape[0]
    dh = d // nh
    w = w_hh.float()
    f32 = [t.float() for t in (h0, c0, n0, m0)]
    hprev = torch.cat([f32[0][:, None], hs.float()[:, :-1]], dim=1)     # (B, S, D)
    gi, gf, gz, go = (t.reshape(b, s, d) for t in
                      gates.float().reshape(b, s, nh, 4 * dh).split(dh, -1))
    zero = torch.zeros((b, d), dtype=torch.float32, device=hs.device)
    carry = [zero if t is None else t.float() for t in (dh_T, dc_T, dn_T, dm_T)]
    dh_rec, dc, dn, dm = carry
    dhs = torch.zeros((b, s, d), dtype=torch.float32, device=hs.device) if dhs is None \
        else dhs.float()
    dg = torch.empty((b, s, nh, 4 * dh), dtype=torch.float32, device=hs.device)
    for t in range(s - 1, -1, -1):
        c, n, m = cs[:, t].float(), ns[:, t].float(), ms[:, t].float()
        if t > 0:
            cp, np_, mp = cs[:, t - 1].float(), ns[:, t - 1].float(), ms[:, t - 1].float()
        else:
            cp, np_, mp = f32[1:]
        i_, f_, z_, o_ = gi[:, t], gf[:, t], gz[:, t], go[:, t]
        dht = dhs[:, t] + dh_rec
        logf = F.logsigmoid(f_)
        a = logf + mp
        ip, fp = torch.exp(i_ - m), torch.exp(a - m)
        tz, so = torch.tanh(z_), torch.sigmoid(o_)
        nc = torch.clamp(n, min=1e-6)
        dq = dht / nc                                   # grad of sigmoid(o) c
        dgo = dq * c * (1 - so) * so
        dc = dc + dq * so
        dn = dn + torch.where(n >= 1e-6, -dht * ((so * c) / nc) / nc, 0.0)
        dfp = dc * cp + dn * np_
        dip = dc * tz + dn
        dgz = dc * ip * (1 - tz * tz)
        dxa = dfp * fp                                  # through f' = exp(a - m)
        dgia = dip * ip                                 # through i' = exp(i - m)
        dmt = dm - dgia - dxa
        half = torch.where(a == i_, 0.5 * dmt, 0.0)
        da = dxa + torch.where(a > i_, dmt, half)
        dgi = dgia + torch.where(a < i_, dmt, half)
        dgf = da * torch.sigmoid(-f_)
        dg[:, t] = torch.stack([v.reshape(b, nh, dh) for v in (dgi, dgf, dgz, dgo)],
                               dim=2).reshape(b, nh, 4 * dh)
        dh_rec = torch.einsum("bhk,hdk->bhd", dg[:, t], w).reshape(b, d)
        dc, dn, dm = dc * fp, dn * fp, da
    dgf32 = dg.reshape(b, s, d4)
    dw = torch.einsum("bshd,bshk->hdk", hprev.reshape(b, s, nh, dh), dg)
    return (dgf32.to(x_dtype), dw.to(w_hh.dtype), dgf32.sum((0, 1)), dh_rec, dc, dn, dm)
