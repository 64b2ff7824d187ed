"""Elastic restart: resume a checkpoint on another set of devices.

The checkpoint stores plain host arrays; each leaf is placed as it
streams from storage, so a lost device ("continue on the survivors") or
a grown job is a pure restore: no resharding step, because each block
lands directly where it now lives.  Two forms: the target grid's
sharding rule (the reference's ``reshard_checkpoint(directory, template,
mesh, rule)``), under which a rank keeps only its block of each leaf, or
a ``placement`` that names each leaf's device (and, on ranks, its
block) itself.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ..checkpoint.ckpt import restore_checkpoint
from ..launch.shardings import block_index

Tree = Any


def reshard_checkpoint(directory: str, template: Tree, target,
                       rule: Optional[Callable] = None,
                       step: Optional[int] = None, device=None) -> Tree:
    """Restore ``directory`` into ``template``'s structure.

    With ``rule``, ``target`` is a grid (``core.collectives.Grid``) and
    ``rule(path, shape) -> spec`` (``launch/shardings.py``'s rules,
    which return specs that divide) says how each leaf is cut: this
    rank keeps its block, on ``device`` (None: the CPU).  Without it,
    ``target`` is ``placement(path, shape)``: a ``torch.device`` (or None
    for the CPU), or a ``(device, index)`` pair that keeps the leaf's
    ``index`` only (rows, or a tuple of slices, one a dim)."""
    if rule is None:
        return restore_checkpoint(directory, template, step=step,
                                  placement=target)

    def placement(path, shape):
        return device, block_index(rule(path, shape), shape, target)

    return restore_checkpoint(directory, template, step=step,
                              placement=placement)
