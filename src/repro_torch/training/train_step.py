"""The training step, the port of ``repro/training/train_step.py``.

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``:
  * the loss and its gradient (``torch.autograd.grad`` of the family's
    forward and ``lm_loss``; the dense forward remats every block),
  * microbatched accumulation in f32 over the batch's leading axis,
  * global-norm gradient clipping,
  * the optimizer's update, in place (``training/optimizer.py``).

A step touches nothing of ``state`` until the loss and every gradient
exist: the forward and backward run on detached aliases of the
parameters, so a failure raised there leaves ``state`` as it was and
``runtime.fault.FaultTolerantLoop`` can retry the step with it.  Then
the clip scales the step's own gradients and the optimizer writes the
new parameters and moments into ``state``'s tensors, and the returned
state holds those same tensors with ``step + 1``.

With ``shardings=`` the step is the counterpart of the reference's
``jax.jit(step, in_shardings=(state, batch), out_shardings=(state,
None))``: the state holds this rank's blocks of every leaf, laid out by
``launch/shardings.py``'s rules over a grid, and the batch this rank's
block along the grid's batch axes (``data.shard_batch``).  The step
  (a) all-gathers each parameter over its spec's axes (the FSDP gather,
      the intent of the reference's ``wload``), except ``model`` for a
      leaf the family computes on in its ``model`` block
      (``models.lm.TP_LEAVES``: the dense family's column, row,
      embedding and head weights, when the grid has ``model``),
  (b) runs the loss and its gradient on this rank's batch block, with
      the MoE layer's batch grid set (``models.layers.batch_grid``) and,
      for a family with such leaves, the ``model`` grid
      (``models.layers.model_grid``): tensor-parallel compute, Megatron's
      column- and row-parallel attention and MLP, vocab-parallel
      embedding, head and cross-entropy, whose collectives over
      ``model`` sit in the forward and backward (*f*, *g*), so the
      gradients come out as the ``model`` blocks,
  (c) averages the gradients (and the loss) over the batch axes with
      ``core.collectives.proxy_psum_tree`` (region ``data``, cross
      ``pod`` where the grid has it),
  (d) clips by the global norm of the full averaged gradient (a
      ``model`` block's squares summed over ``model``, a replicated
      leaf's counted once), and
  (e) updates this rank's blocks of the parameters and the optimizer
      state only: an elementwise optimizer (AdamW) on the blocks; one
      whose update couples elements (Adafactor's factored moments and
      its clip over a whole leaf) on the full leaves, its state and the
      ``model`` blocks gathered first, keeping the blocks.
Compute is data-parallel over the batch axes; over ``model`` it is
tensor-parallel for the dense family and replicated for the others
(ROADMAP A.10e-2, A.10e-3); storage is sharded as the rules say.
Microbatches under shardings are A.10f.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..checkpoint.ckpt import flatten, unflatten
from ..core.collectives import proxy_psum, proxy_psum_tree
from ..launch import shardings as sh
from ..models import layers
from ..models.lm import TP_LEAVES, lm_loss
from .optimizer import Optimizer, flat_run, matrix_runs, tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass
class TrainState:
    params: Tree
    opt_state: Tree
    step: torch.Tensor            # 0-d int32 on the parameters' device

    @staticmethod
    def create(params, optimizer: Optimizer) -> "TrainState":
        dev = tree_leaves(params)[0].device
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))


def _sum_sq(x) -> torch.Tensor:
    """sum(x^2) in f32; a leaf with ``ndim >= 3`` a run of matrices at a
    time (``optimizer.matrix_runs``), so the f32 temporaries stay one
    run's."""
    x = x if x.is_contiguous() else x.contiguous()
    out = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in matrix_runs(x.shape):
        out += torch.sum(torch.square(flat_run(x, 2, r).float()))
    return out


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sum_sq(x) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm).
    In place, as the optimizer's update is (the step clips its own
    gradients): a bf16 leaf times the f32 scale is computed in f32 and
    rounded once, as the reference's cast back to the leaf's dtype is."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for x in tree_leaves(tree):
        x.mul_(scale)
    return tree, norm


def make_loss_fn(cfg, fam, mtp_weight: float = 0.1):
    def loss_fn(params, batch):
        logits, aux = fam["forward"](params, batch, cfg)
        labels = batch["labels"]
        if isinstance(logits, tuple):              # deepseek-v3 MTP head
            main, mtp = logits
            # MTP predicts token t+2: shift labels one extra step.
            mtp_labels = torch.roll(labels, -1, dims=1)
            return (lm_loss(main, labels, cfg, aux)
                    + mtp_weight * lm_loss(mtp, mtp_labels, cfg))
        return lm_loss(logits, labels, cfg, aux)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, grads of ``params``): the loss on detached aliases of the
    parameters that require grad (the same storage; ``params`` and their
    ``.grad`` are not touched)."""
    leaves = tree_leaves(params)
    alias = [p.detach().requires_grad_() for p in leaves]
    it = iter(alias)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(tree, batch)
        # a leaf the loss does not reach (``tok_emb`` under an
        # embeddings batch) gets zeros, as the reference's grad does
        grads = torch.autograd.grad(loss, alias, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


@dataclasses.dataclass(frozen=True)
class Shardings:
    """Where a ``TrainState`` lives: a grid (``core.collectives.Grid``)
    and the spec of every leaf by its key string
    (``launch.shardings.train_state_specs`` of the full state)."""

    grid: Any
    specs: dict


def _sharded_train_step(loss_fn, optimizer: Optimizer, clip_norm: float,
                        shardings: Shardings, tp_names=()) -> Callable:
    grid, specs = shardings.grid, shardings.specs
    axes = sh.batch_axes(grid)
    if [a for a in grid.names if a in axes] != list(axes):
        raise ValueError(f"the batch axes {axes} must lie in the grid's "
                         f"order {grid.names}")
    n = grid.size(axes) if axes else 1
    region = axes[-1] if axes else None
    cross = axes[0] if len(axes) == 2 else None
    tp = bool(tp_names) and "model" in grid.names

    def on_blocks(key) -> bool:
        """Whether the step computes on ``key``'s ``model`` block."""
        return (tp and sh._name(key) in tp_names
                and sh.names_axis(specs[key], "model"))

    def spec_of(key):
        """The axes the forward gathers ``key`` over."""
        return (sh.drop_axis(specs[key], "model") if on_blocks(key)
                else specs[key])

    def blocks_of(tree, prefix):
        """{key: this rank's block} of a tree of leaves as the forward
        sees them (views)."""
        return {k: t[sh.block_index(spec_of(prefix + k), t.shape, grid)]
                for k, t in flatten(tree).items()}

    def gathered(tree, prefix, spec=spec_of):
        """({key: block}, {key: leaf gathered over ``spec``'s axes}) of a
        tree of blocks; a leaf no axis cuts is its block itself."""
        blocks = flatten(tree)
        return blocks, {k: sh.gather_leaf(b, spec(prefix + k), grid)
                        for k, b in blocks.items()}

    def whole(tree, prefix):
        """{key: full leaf} of a tree as the forward sees it: the
        ``model`` blocks gathered over ``model``."""
        return {k: (sh.gather_leaf(t, tuple(
                    "model" if sh.names_axis((e,), "model") else None
                    for e in specs[prefix + k]), grid)
                    if on_blocks(prefix + k) else t)
                for k, t in flatten(tree).items()}

    @torch.no_grad()
    def keep_blocks(blocks, full, prefix):
        for k, b in blocks.items():
            if full[k] is not b:
                b.copy_(full[k][sh.block_index(specs[prefix + k],
                                               full[k].shape, grid)])

    def clip(grads):
        """``clip_by_global_norm``, where a ``model`` block's squares are
        summed over ``model`` (one all-reduce of the leaves' vector, then
        added in the tree's order, as ``global_norm`` adds them) and a
        replicated leaf's counted once."""
        keys = list(flatten(grads))
        leaves = tree_leaves(grads)
        sq = torch.stack([_sum_sq(x) for x in leaves])
        cut = [on_blocks(".params" + k) for k in keys]
        if any(cut):
            mask = torch.tensor(cut, device=sq.device)
            summed = proxy_psum(torch.where(mask, sq, 0.0), "model", None,
                                grid=grid)
            sq = torch.where(mask, summed, sq)
        norm = torch.sqrt(sum(sq.unbind(0)))
        scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-9),
                            max=1.0)
        for x in leaves:
            x.mul_(scale)
        return grads, norm

    def train_step(state: TrainState, batch):
        pblocks, pfwd = gathered(state.params, ".params")          # (a)
        params = unflatten(state.params, pfwd)
        ctx = (layers.model_grid(grid) if tp
               else contextlib.nullcontext())
        with ctx:                                                   # (b)
            if axes:
                with layers.batch_grid(grid, axes):
                    loss, grads = value_and_grad(loss_fn, params, batch)
                grads = proxy_psum_tree(grads, region, cross, grid=grid)  # (c)
                loss = proxy_psum(loss, region, cross, grid=grid) / n
                for g in tree_leaves(grads):
                    g.div_(n)
            else:
                loss, grads = value_and_grad(loss_fn, params, batch)
        grads, gnorm = clip(grads)                                  # (d)
        if optimizer.elementwise:                                   # (e)
            optimizer.update(unflatten(grads, blocks_of(grads, ".params")),
                             state.opt_state, state.params, state.step)
        else:
            oblocks, ofull = gathered(state.opt_state, ".opt_state",
                                      lambda k: specs[k])
            pfull = whole(params, ".params")
            optimizer.update(unflatten(grads, whole(grads, ".params")),
                             unflatten(state.opt_state, ofull),
                             unflatten(state.params, pfull), state.step)
            keep_blocks(pblocks, pfull, ".params")
            keep_blocks(oblocks, ofull, ".opt_state")
        metrics = dict(loss=loss, grad_norm=gnorm,
                       step=state.step.to(torch.float32))
        return TrainState(params=state.params, opt_state=state.opt_state,
                          step=state.step + 1), metrics

    return train_step


def make_train_step(cfg, fam, optimizer: Optimizer,
                    microbatches: int = 1,
                    clip_norm: float = 1.0,
                    mtp_weight: float = 0.1,
                    shardings: Optional[Shardings] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch leaves are (B, ...) tensors; with microbatches > 1 the leading
    axis is split (B = microbatches * micro_bs) and the gradients
    accumulate in f32, one microbatch after another, then are divided by
    the count.  Metrics are 0-d tensors: ``loss``, ``grad_norm`` (before
    the clip) and ``step`` (f32).  With ``shardings``, the sharded step
    of the module's docstring: ``state`` holds this rank's blocks and
    ``batch`` this rank's block of the global batch, whose mean loss the
    metrics report."""
    loss_fn = make_loss_fn(cfg, fam, mtp_weight)
    if shardings is not None:
        if microbatches != 1:
            # the reference splits the *global* batch's rows; a per-rank
            # split holds other rows, and so other MoE groups
            raise NotImplementedError(
                "microbatches under shardings are not ported yet (ROADMAP "
                "A.10f)")
        return _sharded_train_step(loss_fn, optimizer, clip_norm, shardings,
                                   TP_LEAVES.get(cfg.family, ()))

    def train_step(state: TrainState, batch):
        params = state.params
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            micro = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                     for i in range(microbatches)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for mb in micro:
                mloss, mgrads = value_and_grad(loss_fn, params, mb)
                loss = loss + mloss
                tree_map(lambda a, g: a.add_(g.float()), grads, mgrads)
                del mgrads
            loss = loss / microbatches
            for g in tree_leaves(grads):
                g.div_(microbatches)

        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               params, state.step)
        metrics = dict(loss=loss, grad_norm=gnorm,
                       step=state.step.to(torch.float32))
        return TrainState(params=new_params, opt_state=new_opt,
                          step=state.step + 1), metrics

    return train_step
