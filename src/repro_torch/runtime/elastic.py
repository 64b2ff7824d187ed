"""Elastic restart: resume a checkpoint on another set of devices.

The checkpoint stores plain host arrays; each leaf is placed on the
device the caller's ``placement`` names as it streams from storage, and
on ranks only the rank's own rows of it.  A lost device ("continue on
the survivors") or a grown job is then a pure restore: no resharding
step, because each block lands directly where it now lives.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ..checkpoint.ckpt import restore_checkpoint

Tree = Any


def reshard_checkpoint(directory: str, template: Tree, placement: Callable,
                       step: Optional[int] = None) -> Tree:
    """Restore ``directory`` with every leaf on ``placement(key, shape)``:
    a ``torch.device`` (or None for the CPU), or a ``(device, rows)``
    pair that keeps the leaf's ``rows`` only."""
    return restore_checkpoint(directory, template, step=step,
                              placement=placement)
