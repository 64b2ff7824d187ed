"""ExecMesh: where the chips of a partition run, over the ranks of a
``torch.distributed`` process group.

The port of ``repro.distrib.mesh``.  A mesh names a placement -- ``ndev``
ranks x ``per`` chips a rank, each rank holding one contiguous block of
chips, so rank r runs chips ``r*per .. r*per + per - 1`` -- and the
collective vocabulary the distributed superstep needs: ``axis_index``
(this process's rank in the mesh's group), ``chip_ids``, ``psum``,
``pmax``, ``all_gather`` and ``gather_records``.

With no process group every helper is the identity, as on the
reference's one-device mesh: ``axis_index`` is 0, ``per`` is every chip,
and the engine's single-process window runs exactly the ops it ran before
ranks existed.  A mesh built on a group runs the helpers as real
collectives (``all_reduce`` and one all-gather of a fixed-length tensor)
at every size, one rank included, so a one-rank group exercises the rank
path on a single card.  That is a deliberate difference from the
reference, whose one-device mesh never runs a collective.

Placement is chosen by :meth:`ExecMesh.build`: any rank count that
divides the chip count works, and when the group's size does not divide
it the mesh runs on the largest dividing subset of its ranks with the
reference's warning; the ranks left out hold no chip.  A group's
backend must carry the engine's tensors where they live: NCCL for a CUDA
device, gloo for the CPU.  Anything else raises; nothing is staged
through the host.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the groups' timeout, the backend rule and the fixed-length all-gather
# are the collectives'
from ..core.collectives import (GROUP_TIMEOUT, _all_gather_single,
                                check_carrier)


class LeftMesh(Exception):
    """This process was left out of the mesh (a chip loss rebuilt it on
    fewer ranks): it holds no chip and leaves the run."""


def largest_dividing_devices(num_chips: int, device_count: int) -> int:
    """The largest ``ndev <= device_count`` with ``num_chips % ndev == 0``
    (>= 1 always: one device trivially divides any chip count)."""
    ndev = max(1, min(int(device_count), int(num_chips)))
    while num_chips % ndev:
        ndev -= 1
    return ndev


def new_group(ranks: Sequence[int]):
    """A process group of the (global) ``ranks``, or None on a process
    outside them.  Every process of the parent group calls it; local
    synchronisation needs no call from the processes that already
    left."""
    return dist.new_group(list(ranks), timeout=GROUP_TIMEOUT,
                          use_local_synchronization=True)


@dataclasses.dataclass(frozen=True)
class ExecMesh:
    """A ``num_chips = ndev * per`` placement over the ranks of
    ``group``: this process is rank ``rank`` of it, or, where
    ``member`` is False, a process of the parent group that holds no
    chip."""

    num_chips: int
    ndev: int
    group: Any = dataclasses.field(default=None, compare=False)
    rank: int = 0
    member: bool = True

    def __post_init__(self):
        if self.ndev < 1 or self.num_chips % self.ndev:
            raise ValueError(
                f"{self.ndev} devices do not divide {self.num_chips} chips")

    # ------------------------------------------------------------ geometry
    @property
    def per(self) -> int:
        """Chips per rank (the window of each rank)."""
        return self.num_chips // self.ndev

    @property
    def is_sharded(self) -> bool:
        return self.ndev > 1

    @property
    def collective(self) -> bool:
        """Whether the helpers run real collectives (a group is bound)."""
        return self.group is not None

    @property
    def backend_name(self) -> str:
        """The reference driver's label for this placement."""
        return "shard_map" if self.collective else "vmap"

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The global ranks of the mesh's group, in mesh order."""
        if self.group is None:
            return (0,)
        return tuple(dist.get_process_group_ranks(self.group))

    # ------------------------------------------------------------- factory
    @classmethod
    def build(cls, num_chips: int, backend: str = "auto",
              device_count: Optional[int] = None, group=None,
              device=None) -> "ExecMesh":
        """Choose a placement for ``num_chips`` chips.

        ``backend``: 'auto' (more than one rank when more than one can
        divide the chips), 'vmap' (one process, no collectives) or
        'shard_map' (ranks; falls back with a warning).  ``group`` is
        the process group to place the chips on: given, the mesh runs
        real collectives even on one rank; None takes the default group
        when ``torch.distributed`` is initialised, and then runs
        collectives only across more than one rank.  ``device_count``
        (default: the group's size, 1 without one) caps the ranks; when
        it does not divide the chip count, the mesh takes the largest
        dividing subset of the group's first ranks and warns.
        ``device`` (the engine's) must be one the group's backend
        carries, or the call raises."""
        if backend not in ("auto", "vmap", "shard_map"):
            raise ValueError(f"unknown distributed backend {backend!r}")
        explicit = group is not None
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        size = 1 if group is None else dist.get_world_size(group)
        dc = size if device_count is None else int(device_count)
        if backend == "vmap" or num_chips == 1:
            return cls(num_chips, 1)
        ndev = largest_dividing_devices(num_chips, dc)
        if backend == "shard_map" and ndev < dc:
            warnings.warn(
                f"{num_chips} chips do not divide {dc} devices; falling "
                f"back to the largest dividing subset ({ndev} device"
                f"{'s' if ndev != 1 else ''}, {num_chips // ndev} chips "
                f"per device)", RuntimeWarning, stacklevel=2)
        if ndev == 1 and not explicit:
            return cls(num_chips, 1)
        if group is None:
            # a placement only: it runs nothing across ranks
            return cls(num_chips, ndev)
        check_carrier(group, device)
        ranks = dist.get_process_group_ranks(group)
        if ndev < size:
            group = new_group(ranks[:ndev])
            if group is None:
                return cls(num_chips, ndev, member=False)
        return cls(num_chips, ndev, group=group, rank=dist.get_rank(group))

    def shrink(self, lost_rank: int) -> "ExecMesh":
        """The mesh after the rank ``lost_rank`` (in mesh order) lost a
        chip: the largest dividing subset of the other ranks, in order,
        on a new group every rank of this mesh makes.  On one rank the
        mesh stays (nothing can take the chips over)."""
        if not self.is_sharded:
            return self
        ndev = largest_dividing_devices(self.num_chips, self.ndev - 1)
        ranks = [r for i, r in enumerate(self.ranks) if i != lost_rank]
        sub = new_group(ranks[:ndev])
        if sub is None:
            return ExecMesh(self.num_chips, ndev, member=False)
        return ExecMesh(self.num_chips, ndev, group=sub,
                        rank=dist.get_rank(sub))

    # ---------------------------------------------- collective helpers
    # Each is the identity without a group, so the single-process window
    # runs no op of them.
    def axis_index(self) -> int:
        return self.rank

    def chip_ids(self, device=None) -> torch.Tensor:
        """Global chip ids of this rank's ``per`` chips."""
        return (self.rank * self.per
                + torch.arange(self.per, dtype=torch.int32, device=device))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def _all_reduce(self, x, op):
        if self.group is None:
            return x
        y = x.clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order (chip
        order for per-chip blocks); the identity without a group."""
        if self.group is None:
            return x
        x = x.contiguous()
        out = x.new_empty((self.ndev * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single(out, x, group=self.group)
        return out

    def gather_records(self, parts, lengths: Sequence[int]):
        """The board exchange's record stream across ranks: ``parts`` are
        1-D tensors of 4-byte dtypes, one field of the records each, all
        the concatenation of sub-streams of ``lengths`` (each chip-major
        over this rank's chips).  Every rank gets each field with each
        sub-stream in chip order over all ranks, sub-stream after
        sub-stream: the stream one process would make from every chip.
        One all-gather of a fixed-length tensor; the identity without a
        group."""
        if self.group is None:
            return tuple(parts)
        n = sum(lengths)
        packed = torch.stack([p.view(torch.int32) for p in parts])
        got = self.all_gather(packed).reshape(self.ndev, len(parts), n)
        subs = [s.transpose(0, 1).reshape(len(parts), -1)
                for s in got.split(list(lengths), dim=2)]
        out = subs[0] if len(subs) == 1 else torch.cat(subs, dim=1)
        return tuple(out[i].view(p.dtype) for i, p in enumerate(parts))

    def barrier(self, device=None) -> None:
        """Wait for every rank of the mesh (an all-reduce of one value on
        ``device``, which the group's backend carries)."""
        if self.group is not None:
            self.psum(torch.zeros((1,), device=device))
