"""The training step, the port of ``repro/training/train_step.py``
(single device; the sharded and manual-collective forms wait for ROADMAP
A.10d).

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.lm import lm_loss
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


def make_train_step(cfg, fam, optimizer: Optimizer,
                    microbatches: int = 1,
                    clip_norm: float = 1.0,
                    mtp_weight: float = 0.1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch leaves are (B, ...) tensors; with microbatches > 1 the leading
    axis is split (B = microbatches * micro_bs) and the gradients
    accumulate in f32, one microbatch after another, then are divided by
    the count.  Metrics are 0-d tensors: ``loss``, ``grad_norm`` (before
    the clip) and ``step`` (f32)."""
    loss_fn = make_loss_fn(cfg, fam, mtp_weight)

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
