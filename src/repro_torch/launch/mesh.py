"""Production grids, the port of ``repro/launch/mesh.py``.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the 'pod' axis is
the paper's proxy-region boundary -- cheap wide links inside, expensive
links across, exactly the cost structure proxy regions exploit.

Each grid is a ``core.collectives.make_grid`` over the ranks of the
default process group, which must be initialised and of the grid's
size (``make_grid`` raises ``ValueError`` on another).  Functions, never
module-level state: importing this module makes no group.
"""
from __future__ import annotations

import torch.distributed as dist

from ..core.collectives import make_grid
from .shardings import batch_axes

__all__ = ["make_production_mesh", "make_host_mesh", "mesh_axis_sizes",
           "batch_axes"]


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_grid(shape, axes)


def make_host_mesh(model: int = 1):
    """(world // model, model) over the default group (tests /
    examples)."""
    n = dist.get_world_size()
    data = max(1, n // model)
    return make_grid((data, model), ("data", "model"))


def mesh_axis_sizes(grid) -> dict:
    return dict(zip(grid.names, grid.shape))
