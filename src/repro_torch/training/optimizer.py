"""Optimizers over trees of tensors, the port of
``repro/training/optimizer.py``.

adamw      -- default for the <=15B dense archs.
adafactor  -- factored second moment, no first moment: its state stays
              sub-linear in the parameters.

The reference's functional protocol: ``init(params) -> state`` and
``update(grads, state, params, step) -> (params, state)``, with the same
leaves, shapes and dtypes (moments in f32) and the same order of
operations in f32.  Every leaf with ``ndim >= 2`` is treated as a matrix
(AdamW decays it, Adafactor factors it), as in the reference; on stacked
layers that includes the (L, d) norm scales and biases.

The update is in place: it writes the new parameters and moments into
the tensors it was given (under ``torch.no_grad()``) and returns them.
The reference's per-leaf update makes about six f32 temporaries the size
of a leaf; on starcoder2-3b's MLP stack (30 x 3,072 x 12,288) each is
4.5 GB, more than a full-width step can spare beside 38 GB of
parameters, gradients and moments.  So a stacked leaf (``ndim >= 3``) is
updated one layer slice at a time, which bounds the temporaries to one
slice's.  A caller that must keep the old state copies it first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..checkpoint.ckpt import flatten

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple]
    name: str = "opt"


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts ``trees`` (the structure of
    the first), in ``tree_leaves``' order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys in sorted order (the reference's
    ``jax.tree.leaves`` order)."""
    return list(flatten(tree).values())


def _slices(*ts):
    """Matching pieces of ``ts``: one layer slice at a time where the
    first is a stacked matrix (``ndim >= 3``), else the tensors whole."""
    if ts[0].dim() >= 3:
        return [tuple(t[i] for t in ts) for i in range(ts[0].shape[0])]
    return [ts]


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


# ------------------------------------------------------------------- adamw
def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup: int = 100) -> Optimizer:
    """``warmup`` is a linear lr ramp from 0 (step 0 runs at lr 0);
    callers running short smoke loops must size it well below the step
    budget (launch/train.py does this automatically)."""
    warmup = max(warmup, 1)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return dict(mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def schedule(step):
        w = torch.clamp(_step_f32(step) / warmup, max=1.0)
        return lr * w

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = schedule(step)
        t = _step_f32(step) + 1.0
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)

        def one(g, m, v, p):
            decay = p.dim() >= 2                  # decay matrices only
            for gs, ms, vs, ps in _slices(g, m, v, p):
                gf = gs.float()
                ms.mul_(b1).add_(gf * (1 - b1))
                vs.mul_(b2).add_((1 - b2) * gf * gf)
                del gf
                step_ = (ms / bc1) / (torch.sqrt(vs / bc2) + eps)
                pf = ps.float()
                if decay:
                    step_ += weight_decay * pf
                ps.copy_(pf - lr_t * step_)

        tree_map(one, grads, state["mu"], state["nu"], params)
        return params, state

    return Optimizer(init=init, update=update, name="adamw")


# --------------------------------------------------------------- adafactor
def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, warmup: int = 100) -> Optimizer:
    """Factored RMS optimizer (Shazeer & Stern): O(rows+cols) state for
    matrices, O(n) for vectors; no momentum."""
    warmup = max(warmup, 1)

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return dict(vr=torch.zeros(p.shape[:-1], **f32),
                            vc=torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           **f32))
            return dict(v=torch.zeros(p.shape, **f32))

        return tree_map(one, params)

    def factored(gf, s):
        """The update of a matrix (slice) from its row and column
        factors."""
        vr, vc = s["vr"], s["vc"]
        rfac = torch.rsqrt(vr / torch.clamp(
            torch.mean(vr, dim=-1, keepdim=True), min=eps))
        cfac = torch.rsqrt(vc)
        return gf * rfac[..., None] * cfac[..., None, :]

    @torch.no_grad()
    def update(grads, state, params, step):
        t = _step_f32(step) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr * torch.clamp(t / warmup, max=1.0)

        def moved(gs, s):
            """Moves the piece's second moment (``s``, in place) and
            returns its unclipped update."""
            gf = gs.float()
            g2 = gf * gf + eps
            if "vr" in s:
                s["vr"].mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
                s["vc"].mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))
                return factored(gf, s)
            s["v"].mul_(beta).add_((1 - beta) * g2)
            return gf * torch.rsqrt(s["v"])

        def one(g, s, p):
            if p.dim() < 3:
                u = moved(g, s)
                rms = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                p.copy_(p.float() - lr_t * u)
                return
            # a stacked leaf, a layer at a time; the clip's RMS is over
            # the whole leaf, so a first pass moves the factors and sums
            # u^2, and a second makes each slice's u again from them
            pieces = [(g[i], {k: x[i] for k, x in s.items()}, p[i])
                      for i in range(p.shape[0])]
            usq = torch.zeros((), dtype=torch.float32, device=p.device)
            for gs, ss, _ in pieces:
                u = moved(gs, ss)
                usq += torch.sum(u * u)
            rms = torch.sqrt(usq / p.numel())
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            for gs, ss, ps in pieces:
                u = factored(gs.float(), ss) / scale
                ps.copy_(ps.float() - lr_t * u)

        # grads is a structural prefix of state (state has a dict per
        # leaf): tree_map walks the grads' structure
        tree_map(one, grads, state, params)
        return params, state

    return Optimizer(init=init, update=update, name="adafactor")

