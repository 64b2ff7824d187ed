"""xLSTM blocks (mLSTM + sLSTM), the port of ``repro/models/xlstm.py``:
xlstm-1.3b.

mLSTM: the matrix-memory cell with exponential gating.  Training runs the
chunkwise form of the stabilised recurrence: within a chunk of
``MCHUNK`` positions the decay is a lower-triangular matrix; across
chunks the (C, n, m) state is carried in a Python loop (the reference's
``lax.scan``).  Decode is the O(1) recurrence, written into the state it
is given.

sLSTM: the scalar-memory cell with a hidden-to-hidden recurrence,
sequential in time, so training loops over the positions one at a time
(about 20 small operations a position; no kernel: ROADMAP B lists it).

As in ``ssm.py``, each three-operand einsum is taken pairwise in the
order written beside it, the exponents are masked before ``exp``, and
the stabiliser's start value is ``-1e30`` (padded positions take
``li = -1e30`` so that they leave the carried state as it was).  The
carried C is (B, H, Pv, Pk): q contracts its last axis.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .layers import DTYPE, apply_norm, dense_init, norm_init

MCHUNK = 256
NEG = -1e30         # the reference's stabiliser start and padded log gate


# -------------------------------------------------------------------- mLSTM
def mlstm_init(gen, cfg) -> Dict:
    d = cfg.d_model
    di = cfg.xlstm_proj * d
    h = cfg.n_heads
    pp = di // h
    dev = gen.device

    def blockdiag():
        # per-head (block-diagonal) projection, as in the xLSTM paper
        return (torch.randn((h, pp, pp), generator=gen, device=dev)
                * (pp ** -0.5)).to(DTYPE)

    return dict(
        up=dense_init(gen, d, 2 * di),        # x-branch and o-gate branch
        wq=blockdiag(),
        wk=blockdiag(),
        wv=blockdiag(),
        wif=dense_init(gen, di, 2 * h, dtype=torch.float32, scale=0.02),
        gate_norm=norm_init(di, device=dev),
        down=dense_init(gen, di, d),
        norm=norm_init(d, with_bias=cfg.norm_bias, device=dev),
    )


def _mlstm_qkvif(p, x, cfg):
    b, s, d = x.shape
    di = cfg.xlstm_proj * d
    h = cfg.n_heads
    pp = di // h
    xn = apply_norm(p["norm"], x)
    up = xn @ p["up"]
    xb, og = up[..., :di], up[..., di:]
    xh = xb.reshape(b, s, h, pp)
    q = torch.einsum("bshp,hpq->bshq", xh, p["wq"])
    k = torch.einsum("bshp,hpq->bshq", xh, p["wk"]) * (pp ** -0.5)
    v = torch.einsum("bshp,hpq->bshq", xh, p["wv"])
    gif = xb.float() @ p["wif"]
    li = gif[..., :h]                                   # log input gate
    lf = F.logsigmoid(gif[..., h:])                     # log forget gate
    return xn, q, k, v, li, lf, og


def _out(p, x, y, og):
    """The gated output projection and the residual."""
    y = apply_norm(p["gate_norm"], y.to(x.dtype)) \
        * torch.sigmoid(og.float()).to(x.dtype)
    return x + y @ p["down"]


def mlstm_forward(p, x, cfg, state=None):
    """Chunkwise mLSTM.  Returns (y, state), state = (C (B, H, P, P),
    n (B, H, P), m (B, H)), all f32."""
    b, s, d = x.shape
    h = cfg.n_heads
    di = cfg.xlstm_proj * d
    pp = di // h
    xn, q, k, v, li, lf, og = _mlstm_qkvif(p, x, cfg)

    c = min(MCHUNK, s)
    s_pad = -(-s // c) * c
    if s_pad != s:
        def padf(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, s_pad - s))
        q, k, v, li, lf = map(padf, (q, k, v, li, lf))
        # padded forget gates (lf = 0) must not decay the carried state,
        # and padded input gates add nothing
        li = torch.cat([li[:, :s], torch.full_like(li[:, s:], NEG)], dim=1)
    nc = s_pad // c

    if state is None:
        c_st = torch.zeros((b, h, pp, pp), dtype=torch.float32,
                           device=x.device)
        n_st = torch.zeros((b, h, pp), dtype=torch.float32, device=x.device)
        m_st = torch.full((b, h), NEG, dtype=torch.float32, device=x.device)
    else:
        c_st, n_st, m_st = state
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for j in range(nc):
        sl = slice(j * c, (j + 1) * c)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        li_c, lf_c = li[:, sl], lf[:, sl]                 # (B, C, H)
        f_cs = torch.cumsum(lf_c, dim=1)                  # F_t
        # m_t = F_t + max(m0, cummax_{s<=t}(li_s - F_s))
        g = torch.maximum(m_st[:, None, :],
                          torch.cummax(li_c - f_cs, dim=1).values)
        m_t = f_cs + g                                    # (B, C, H)
        # intra decay w[t, s] = exp(F_t - F_s + li_s - m_t), s <= t
        dd = (f_cs[:, :, None] - f_cs[:, None, :]
              + li_c[:, None, :, :] - m_t[:, :, None, :])  # (B, t, s, H)
        sw = torch.einsum("bthp,bshp->btsh", qf, kf) \
            * torch.exp(torch.where(tri, dd, NEG))
        # "btsh,btsh,bshp->bthp" and "btsh,btsh->bth" as (scores w) first
        num = torch.einsum("btsh,bshp->bthp", sw, vf)
        den = sw.sum(dim=2)
        # inter: the carried state decayed to t; q contracts C's k-dim
        e_t = torch.exp(f_cs + m_st[:, None, :] - m_t)    # (B, C, H)
        # "bthk,bhpk,bth->bthp" as (q C) then times e_t
        num = num + torch.einsum("bthk,bhpk->bthp", qf, c_st) \
            * e_t[..., None]
        # "bthp,bhp,bth->bth" as (q n) then times e_t
        den = den + torch.einsum("bthp,bhp->bth", qf, n_st) * e_t
        ys.append(num / torch.clamp(torch.abs(den), min=1.0)[..., None])
        # the state at the chunk's end
        m_end = m_t[:, -1]                                # (B, H)
        dec = torch.exp(f_cs[:, -1] + m_st - m_end)       # (B, H)
        wk_end = torch.exp(f_cs[:, -1][:, None] - f_cs + li_c
                           - m_end[:, None])              # (B, C, H)
        # "bsh,bshp,bsho->bhpo" as (w v) then the sum over s with k
        c_st = dec[:, :, None, None] * c_st \
            + torch.einsum("bshp,bsho->bhpo", wk_end[..., None] * vf, kf)
        n_st = dec[:, :, None] * n_st \
            + torch.einsum("bsh,bshp->bhp", wk_end, kf)
        m_st = m_end
    y = torch.stack(ys, dim=1).reshape(b, s_pad, di)[:, :s]
    return _out(p, x, y, og), (c_st, n_st, m_st)


@torch.no_grad()
def mlstm_decode(p, x, state, cfg):
    """One step.  state = (C, n, m), written in place with the new state
    (the reference returns new arrays); returns (y, state)."""
    b, _, d = x.shape
    di = cfg.xlstm_proj * d
    c_st, n_st, m_st = state
    xn, q, k, v, li, lf, og = _mlstm_qkvif(p, x, cfg)
    qf = q[:, 0].float()
    kf = k[:, 0].float()
    vf = v[:, 0].float()
    li0, lf0 = li[:, 0], lf[:, 0]                      # (B, H)
    m_new = torch.maximum(lf0 + m_st, li0)
    a = torch.exp(lf0 + m_st - m_new)
    bgt = torch.exp(li0 - m_new)
    # "bhp,bho->bhpo": the outer product of v and k
    c_st.mul_(a[:, :, None, None]).add_(
        bgt[:, :, None, None] * (vf[..., None] * kf[:, :, None, :]))
    n_st.mul_(a[:, :, None]).add_(bgt[:, :, None] * kf)
    m_st.copy_(m_new)
    num = torch.einsum("bhpo,bho->bhp", c_st, qf)     # contract the k-dim
    den = torch.einsum("bhp,bhp->bh", n_st, qf)
    y = (num / torch.clamp(torch.abs(den), min=1.0)[..., None]).reshape(
        b, 1, di)
    return _out(p, x, y, og), state


# -------------------------------------------------------------------- sLSTM
def slstm_init(gen, cfg) -> Dict:
    d = cfg.d_model
    h = cfg.n_heads
    pp = d // h
    ff = int(d * 4 / 3)
    dev = gen.device
    return dict(
        wx=dense_init(gen, d, 4 * d),                  # i, f, z, o from x
        rh=torch.randn((h, pp, 4 * pp), generator=gen, device=dev)
        * (pp ** -0.5),
        norm=norm_init(d, with_bias=cfg.norm_bias, device=dev),
        gate_norm=norm_init(d, device=dev),
        ff_in=dense_init(gen, d, ff),
        ff_gate=dense_init(gen, d, ff),
        ff_out=dense_init(gen, ff, d),
        ff_norm=norm_init(d, with_bias=cfg.norm_bias, device=dev),
    )


def _slstm_cell(p, xg, carry, cfg):
    """One sLSTM time step.  xg: (B, 4d) gate preactivations from x;
    carry: (h, c, n, m), each (B, H, P) but m (B, H)."""
    b = xg.shape[0]
    h = cfg.n_heads
    pp = cfg.d_model // h
    h_prev, c_prev, n_prev, m_prev = carry
    rec = torch.einsum("bhp,hpq->bhq", h_prev, p["rh"])   # (B, H, 4P)
    g = xg.reshape(b, h, 4 * pp).float() + rec
    gi, gf, gz, go = torch.split(g, pp, dim=-1)           # (B, H, P) each
    # scalar-per-head exponential gating (the mean preactivation a head)
    li = torch.mean(gi, dim=-1)                           # (B, H)
    lf = F.logsigmoid(torch.mean(gf, dim=-1))
    m_new = torch.maximum(lf + m_prev, li)
    fg = torch.exp(lf + m_prev - m_new)[..., None]
    ig = torch.exp(li - m_new)[..., None]
    c_new = fg * c_prev + ig * torch.tanh(gz)
    n_new = fg * n_prev + ig
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1.0)
    return (h_new, c_new, n_new, m_new)


def slstm_forward(p, x, cfg, state=None):
    """Returns (y, state), state = (h, c, n, m) f32 after the last
    position."""
    b, s, d = x.shape
    h = cfg.n_heads
    pp = d // h
    xn = apply_norm(p["norm"], x)
    xg = xn @ p["wx"]                                   # (B, S, 4d)
    if state is None:
        zeros = torch.zeros((b, h, pp), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros,
                 torch.full((b, h), NEG, dtype=torch.float32,
                            device=x.device))
    hs = []
    for t in range(s):
        state = _slstm_cell(p, xg[:, t], state, cfg)
        hs.append(state[0])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    x = x + apply_norm(p["gate_norm"], y)
    # gated FFN (proj factor 4/3)
    xf = apply_norm(p["ff_norm"], x)
    mid = F.silu((xf @ p["ff_gate"]).float()).to(x.dtype) \
        * (xf @ p["ff_in"])
    return x + mid @ p["ff_out"], state


def slstm_decode(p, x, state, cfg):
    return slstm_forward(p, x, cfg, state=state)
