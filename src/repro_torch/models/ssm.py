"""Mamba2 (SSD) block, the port of ``repro/models/ssm.py``: zamba2-1.2b's
backbone.

Training runs the chunked state-space-dual form: quadratic,
attention-like products *within* a chunk of ``CHUNK`` positions and a
linear recurrence *across* chunks, carrying the (B, H, P, N) f32 state
in a Python loop (the reference's ``lax.scan``).  Decode is the O(1)
recurrent step.  No TPU kernel runs here.

The reference's three-operand einsums are taken pairwise, in the order
written beside each: an elementwise product first, then one contraction,
so the intermediates stay the size of an operand.  The exponent of the
intra-chunk decay is masked before ``exp`` (above the diagonal it would
overflow to inf, and inf x 0 is a NaN gradient under autograd).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import DTYPE, apply_norm, dense_init, norm_init

CONV_W = 4          # causal depthwise conv width
CHUNK = 256


def ssd_init(gen, cfg) -> Dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert h * p == di, (h, p, di)
    dev = gen.device
    return dict(
        in_proj=dense_init(gen, d, 2 * di + 2 * n + h),
        conv_w=(torch.randn((CONV_W, di), generator=gen, device=dev)
                * 0.2).to(DTYPE),
        a_log=torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        dt_bias=torch.zeros((h,), dtype=torch.float32, device=dev),
        d_skip=torch.ones((h,), dtype=torch.float32, device=dev),
        gate_norm=norm_init(di, device=dev),
        out_proj=dense_init(gen, di, d),
        norm=norm_init(d, with_bias=cfg.norm_bias, device=dev),
    )


def _split_proj(p, xn, cfg):
    """z, xc, B, C and dt out of one projection (``jnp.split``'s indices
    di, 2 di, 2 di + N, 2 di + 2 N as ``torch.split``'s sizes)."""
    di = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state, cfg.ssm_heads
    return torch.split(xn @ p["in_proj"], [di, di, n, n, h], dim=-1)


def _conv(xc, conv_w, state=None):
    """Causal depthwise conv.  xc: (B, S, di).  Without ``state``, the
    whole sequence (in xc's dtype) and the last ``CONV_W - 1`` inputs as
    the decode state; with ``state`` (B, CONV_W - 1, di), the single-step
    update in f32 (returns (out, new_state))."""
    if state is None:
        pad = F.pad(xc, (0, 0, CONV_W - 1, 0))
        s = xc.shape[1]
        out = 0
        for i in range(CONV_W):
            out = out + pad[:, i:i + s] * conv_w[i]
        return out, pad[:, -(CONV_W - 1):]
    win = torch.cat([state, xc], dim=1)                    # (B, CONV_W, di)
    out = torch.einsum("bwd,wd->bd", win.float(), conv_w.float())
    return out[:, None].to(xc.dtype), win[:, 1:]


def ssd_forward(p, x, cfg, state: Tuple | None = None):
    """Full-sequence SSD.  x: (B, S, d).  Returns (y, (ssm_state,
    conv_state)), ssm_state (B, H, P, N) f32: the decode-ready carry."""
    b, s, d = x.shape
    h, pp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = h * pp
    xn = apply_norm(p["norm"], x)
    z, xc, bc, cc, dt = _split_proj(p, xn, cfg)
    xc, conv_state = _conv(xc, p["conv_w"])
    xc = F.silu(xc.float())
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, S, H)
    la = -dt * torch.exp(p["a_log"])                           # log decay
    xh = xc.reshape(b, s, h, pp)
    bcf = bc.float()
    ccf = cc.float()

    # pad to a chunk multiple
    c = min(CHUNK, s)
    s_pad = -(-s // c) * c
    if s_pad != s:
        def z2(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, s_pad - s))
        xh, bcf, ccf, dt, la = map(z2, (xh, bcf, ccf, dt, la))
    nc = s_pad // c
    xh = xh.reshape(b, nc, c, h, pp)
    bcf = bcf.reshape(b, nc, c, n)
    ccf = ccf.reshape(b, nc, c, n)
    dt = dt.reshape(b, nc, c, h)
    la = la.reshape(b, nc, c, h)

    fcs = torch.cumsum(la, dim=2)                        # (B, nc, C, H) F_t
    s_prev = torch.zeros((b, h, pp, n), dtype=torch.float32,
                         device=x.device) if state is None else state[0]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for j in range(nc):
        xh_c, b_c, c_c = xh[:, j], bcf[:, j], ccf[:, j]
        dt_c, f_c = dt[:, j], fcs[:, j]
        # intra-chunk: w[t, s] = exp(F_t - F_s) dt_s, s <= t
        diff = f_c[:, :, None, :] - f_c[:, None, :, :]        # (B, t, s, H)
        w = torch.exp(torch.where(tri, diff, -1e30)) * dt_c[:, None, :, :]
        scores = torch.einsum("btn,bsn->bts", c_c, b_c)       # (B, t, s)
        # "bts,btsh,bshp->bthp" as (scores w) then the sum over s
        y = torch.einsum("btsh,bshp->bthp", scores[..., None] * w, xh_c)
        # inter-chunk: the carried state decayed to t
        # "btn,bhpn,bth->bthp" as (C . state) then times exp(F_t)
        et = torch.exp(f_c)                                   # (B, C, H)
        y = y + torch.einsum("btn,bhpn->bthp", c_c, s_prev) * et[..., None]
        ys.append(y)
        # the state at the chunk's end
        dec_end = torch.exp(f_c[:, -1])                       # (B, H)
        w_end = torch.exp(f_c[:, -1][:, None] - f_c) * dt_c   # (B, C, H)
        # "bch,bchp,bcn->bhpn" as (w_end x) then the sum over c with B
        s_prev = (dec_end[:, :, None, None] * s_prev
                  + torch.einsum("bchp,bcn->bhpn", w_end[..., None] * xh_c,
                                 b_c))
    y = torch.stack(ys, dim=1).reshape(b, s_pad, h, pp)[:, :s]
    y = y + xh.reshape(b, s_pad, h, pp)[:, :s] * p["d_skip"][None, None, :,
                                                             None]
    y = y.reshape(b, s, di)
    y = apply_norm(p["gate_norm"], y.to(x.dtype)) \
        * F.silu(z.float()).to(x.dtype)
    return x + y @ p["out_proj"], (s_prev, conv_state)


def ssd_decode(p, x, state, cfg):
    """One-token SSD step.  x: (B, 1, d); state: (ssm (B, H, P, N) f32,
    conv (B, CONV_W - 1, di)).  Returns (y, (ssm, conv)), new tensors."""
    b = x.shape[0]
    h, pp = cfg.ssm_heads, cfg.ssm_head_dim
    di = h * pp
    ssm_state, conv_state = state
    xn = apply_norm(p["norm"], x)
    z, xc, bc, cc, dt = _split_proj(p, xn, cfg)
    xc, conv_state = _conv(xc, p["conv_w"], conv_state)
    xc = F.silu(xc.float())[:, 0]                                # (B, di)
    dt = F.softplus(dt.float()[:, 0] + p["dt_bias"])             # (B, H)
    la = -dt * torch.exp(p["a_log"])
    alpha = torch.exp(la)                                        # (B, H)
    xh = xc.reshape(b, h, pp)
    bf = bc.float()[:, 0]                                        # (B, N)
    cf = cc.float()[:, 0]
    # "bh,bhp,bn->bhpn" as (dt x) then the outer product with B
    ssm_state = (alpha[:, :, None, None] * ssm_state
                 + (dt[..., None] * xh)[..., None] * bf[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cf, ssm_state) \
        + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, di)
    y = apply_norm(p["gate_norm"], y.to(x.dtype)) \
        * F.silu(z.float()).to(x.dtype)
    return x + y @ p["out_proj"], (ssm_state, conv_state)
