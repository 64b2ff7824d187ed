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
4.5 GB, and one layer of deepseek-v3's expert stack (256 x 7,168 x
2,048) is 15 GB in f32.  So a leaf with ``ndim >= 3`` is updated as its
(rows, cols) matrices over all leading axes, in runs of at most
``SLICE_ELEMS`` elements (``matrix_runs``), which bounds the temporaries
to one run's.  That is exact: AdamW is elementwise, Adafactor factors
over the last two axes, and its clip's RMS is summed run by run.  A
caller that must keep the old state copies it first.
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
    # each element's update reads only that element of the gradient,
    # state and parameter (AdamW), so a block updates alone
    elementwise: bool = False


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


SLICE_ELEMS = 1 << 26    # a run's elements: ~256 MB of each f32 temporary


def matrix_runs(shape) -> list:
    """The runs a leaf of ``shape`` is updated in: for ``ndim >= 3``,
    slices of its matrices over all leading axes flattened into one, each
    run at most ``SLICE_ELEMS`` elements (at least one matrix); else one
    ``None`` (the leaf whole)."""
    if len(shape) < 3:
        return [None]
    n = 1
    for a in shape[:-2]:
        n *= a
    per = max(1, SLICE_ELEMS // max(shape[-2] * shape[-1], 1))
    return [slice(i, min(i + per, n)) for i in range(0, n, per)]


def flat_run(t, trailing: int, run):
    """``t``'s leading axes flattened into one, keeping its last
    ``trailing``, and cut to ``run`` (``t`` itself for ``None``): a view,
    so an in-place update reaches ``t``."""
    if run is None:
        return t
    return t.view((-1,) + tuple(t.shape[t.dim() - trailing:]))[run]


def _slices(*ts):
    """Matching runs of ``ts`` (``matrix_runs`` of the first's shape);
    the first, read only, may be a non-contiguous gradient (flattened by
    a copy)."""
    runs = matrix_runs(ts[0].shape)
    if runs == [None]:
        return [ts]
    first = ts[0] if ts[0].is_contiguous() else ts[0].contiguous()
    return [tuple(flat_run(t, 2, r) for t in (first,) + ts[1:])
            for r in runs]


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

    return Optimizer(init=init, update=update, name="adamw",
                     elementwise=True)


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
            # the factors' means and the clip's RMS sum in memory order:
            # a contiguous gradient makes them the same for any layout
            # autograd hands over (``lm_head``'s comes transposed)
            g = g if g.is_contiguous() else g.contiguous()
            if p.dim() < 3:
                u = moved(g, s)
                rms = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                p.copy_(p.float() - lr_t * u)
                return
            # a stacked leaf, a run of matrices at a time; the clip's RMS
            # is over the whole leaf, so a first pass moves the factors
            # and sums u^2, and a second makes each run's u again from
            # them
            pieces = [(flat_run(g, 2, r),
                       {k: flat_run(x, 1, r) for k, x in s.items()},
                       flat_run(p, 2, r)) for r in matrix_runs(p.shape)]
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

