"""Elastic restart: resume a checkpoint on another set of devices.

The checkpoint stores plain host arrays; each leaf is placed on the
device the caller's ``placement`` names as it streams from storage.  A
lost device ("continue on the survivors") or a grown job is then a pure
restore: no resharding step, because leaves land directly where they now
live.  In one process every leaf lands on the engine's device; more than
one rank is ROADMAP A.5c.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ..checkpoint.ckpt import restore_checkpoint

Tree = Any


def reshard_checkpoint(directory: str, template: Tree, placement: Callable,
                       step: Optional[int] = None) -> Tree:
    """Restore ``directory`` with every leaf on ``placement(key, shape)``,
    a ``torch.device`` (or None for the CPU)."""
    return restore_checkpoint(directory, template, step=step,
                              placement=placement)
