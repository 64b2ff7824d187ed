"""Tile-grid geometry for the DCRA data-local execution model.

The PyTorch rendering of ``repro.core.tilegrid``: the same dataclasses and
closed-form index maps.  The routing helpers take integer tensors (any
shape, any device) and return tensors of the same shape; the arithmetic is
the reference's, term for term, so hop and crossing counts are identical.

A DCRA system is a 2D grid of ``ny x nx`` tiles.  Tiles are grouped into
dies (default 16x16 per the paper), dies into packages (default 64x64
tiles per package, i.e. 4x4 dies), packages onto a board.  Every dataset
array of global length N is scattered across tiles as equal-sized chunks
(``chunk = ceil(N / num_tiles)``), and the *owner* of global index ``i``
is ``i // chunk``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Geometry of a DCRA tile grid.

    Attributes:
      ny, nx: grid dimensions in tiles.
      die_ny, die_nx: tiles per die (tapeout-time; paper uses 16x16).
      pkg_ny, pkg_nx: tiles per package (packaging-time; paper uses 64x64).
      torus: whether the tile network is configured as a (folded) 2D torus.
    """

    ny: int
    nx: int
    die_ny: int = 16
    die_nx: int = 16
    pkg_ny: int = 64
    pkg_nx: int = 64
    torus: bool = True

    def __post_init__(self):
        if self.ny <= 0 or self.nx <= 0:
            raise ValueError("grid dims must be positive")

    # ------------------------------------------------------------------ ids
    @property
    def num_tiles(self) -> int:
        return self.ny * self.nx

    @property
    def dies(self) -> Tuple[int, int]:
        return (max(1, self.ny // self.die_ny), max(1, self.nx // self.die_nx))

    @property
    def packages(self) -> Tuple[int, int]:
        return (max(1, self.ny // self.pkg_ny), max(1, self.nx // self.pkg_nx))

    @property
    def num_packages(self) -> int:
        py, px = self.packages
        return py * px

    def coords(self, tid):
        """tile id -> (y, x). Row-major, matching the paper's logical ids."""
        return tid // self.nx, tid % self.nx

    def tid(self, y, x):
        return y * self.nx + x

    # -------------------------------------------------------------- regions
    def region_id(self, tid, region_ny: int, region_nx: int):
        """Id of the (region_ny x region_nx) region containing ``tid``
        (regions tile the grid from the origin in row-major order)."""
        y, x = self.coords(tid)
        cols = -(-self.nx // region_nx)
        return (y // region_ny) * cols + x // region_nx

    def region_crossings(self, src_tid, dst_tid, region_ny: int,
                         region_nx: int):
        """Proxy-region boundary crossings along the XY route src -> dst."""
        sy, sx = self.coords(src_tid)
        dy, dx = self.coords(dst_tid)
        return (self._axis_crossings(sx, dx, self.nx, region_nx)
                + self._axis_crossings(sy, dy, self.ny, region_ny))

    # ------------------------------------------------------------- partition
    def chunk_size(self, n: int) -> int:
        """Equal-chunk size for a global array of length n."""
        return -(-n // self.num_tiles)

    def owner(self, idx, n: int):
        """Owner tile of global array index tensor ``idx`` (length n)."""
        return torch.clamp(idx // self.chunk_size(n), max=self.num_tiles - 1)

    # -------------------------------------------------------------- routing
    def _axis_hops(self, a, b, period: int):
        """Hops along one axis under XY dimension-ordered routing."""
        d = torch.abs(a - b)
        if self.torus and period > 1:
            return torch.minimum(d, period - d)
        return d

    def hops(self, src_tid, dst_tid):
        """Total router-to-router hops for a message src -> dst (XY/DOR)."""
        sy, sx = self.coords(src_tid)
        dy, dx = self.coords(dst_tid)
        return self._axis_hops(sx, dx, self.nx) + self._axis_hops(sy, dy, self.ny)

    def _axis_crossings(self, a, b, period: int, cell: int):
        """Number of ``cell``-boundaries crossed travelling a -> b along one
        axis, taking the shorter torus direction when configured.

        Boundary between coordinate c and c+1 exists iff (c+1) % cell == 0.
        """
        lo = torch.minimum(a, b)
        hi = torch.maximum(a, b)
        direct = hi // cell - lo // cell
        if not (self.torus and period > 1):
            return direct
        # the wrap seam is a cell boundary only with >= 2 cells on the axis
        seam = 1 if (period % cell == 0 and period > cell) else 0
        wrap = (period - 1) // cell - hi // cell + lo // cell + seam
        d = hi - lo
        use_wrap = (period - d) < d
        return torch.where(use_wrap, wrap, direct)

    def link_levels(self, src_tid, dst_tid):
        """Decompose the XY route into (intra_die_hops, die_crossings,
        package_crossings); package crossings are not also counted as die
        crossings."""
        sy, sx = self.coords(src_tid)
        dy, dx = self.coords(dst_tid)
        die_x = self._axis_crossings(sx, dx, self.nx, self.die_nx)
        die_y = self._axis_crossings(sy, dy, self.ny, self.die_ny)
        pkg_x = self._axis_crossings(sx, dx, self.nx, self.pkg_nx)
        pkg_y = self._axis_crossings(sy, dy, self.ny, self.pkg_ny)
        total = self.hops(src_tid, dst_tid)
        die = die_x + die_y
        pkg = pkg_x + pkg_y
        die_only = torch.clamp(die - pkg, min=0)
        intra = torch.clamp(total - die, min=0)
        return intra, die_only, pkg

    # ---------------------------------------------------------------- misc
    def describe(self) -> str:
        dy, dx = self.dies
        py, px = self.packages
        return (f"TileGrid {self.ny}x{self.nx} ({self.num_tiles} tiles), "
                f"{dy}x{dx} dies of {self.die_ny}x{self.die_nx}, "
                f"{py}x{px} packages of {self.pkg_ny}x{self.pkg_nx}, "
                f"{'torus' if self.torus else 'mesh'}")


def square_grid(num_tiles: int, **kw) -> TileGrid:
    """The paper always evaluates square grids (16x16 .. 1024x1024)."""
    side = int(round(num_tiles ** 0.5))
    if side * side != num_tiles:
        raise ValueError(f"num_tiles={num_tiles} is not a perfect square")
    return TileGrid(side, side, **kw)


# --------------------------------------------------------------------------
# Chip partitioning (the distributed runtime's unit of execution)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChipPartition:
    """A (chips_y x chips_x) block partition of a tile grid into chips.

    Each chip is a rectangular subgrid of ``sub_ny x sub_nx`` tiles.
    Tiles keep the monolithic engine's global row-major ids, so hop
    charging and numerics are unchanged; the partition only decides
    which messages ride the board between supersteps.  The index maps
    are closed-form arithmetic on integer tensors (``global_tile`` also
    on the numpy arrays of the host-side ``tile_ids``)."""

    grid: TileGrid
    chips_y: int
    chips_x: int

    def __post_init__(self):
        if self.chips_y <= 0 or self.chips_x <= 0:
            raise ValueError("chip grid dims must be positive")
        if self.grid.ny % self.chips_y or self.grid.nx % self.chips_x:
            raise ValueError(
                f"chip grid {self.chips_y}x{self.chips_x} does not divide "
                f"the {self.grid.ny}x{self.grid.nx} tile grid")

    @property
    def num_chips(self) -> int:
        return self.chips_y * self.chips_x

    @property
    def sub_ny(self) -> int:
        return self.grid.ny // self.chips_y

    @property
    def sub_nx(self) -> int:
        return self.grid.nx // self.chips_x

    @property
    def tiles_per_chip(self) -> int:
        return self.sub_ny * self.sub_nx

    def chip_of_tile(self, tid):
        """Chip id (row-major on the chip grid) owning global tile ``tid``."""
        y, x = self.grid.coords(tid)
        return (y // self.sub_ny) * self.chips_x + x // self.sub_nx

    def local_tile(self, tid):
        """Row-major index of global tile ``tid`` within its own chip."""
        y, x = self.grid.coords(tid)
        return (y % self.sub_ny) * self.sub_nx + x % self.sub_nx

    def global_tile(self, chip, ltid):
        """Global tile id of local tile ``ltid`` on chip ``chip``."""
        cy = chip // self.chips_x
        cx = chip % self.chips_x
        ly = ltid // self.sub_nx
        lx = ltid % self.sub_nx
        return self.grid.tid(cy * self.sub_ny + ly, cx * self.sub_nx + lx)

    def chip_hops(self, src_tid, dst_tid):
        """Manhattan hops on the chip grid for a message src -> dst: the
        board-level (IO-die to IO-die) legs it traverses."""
        return self.chip_grid_hops(self.chip_of_tile(src_tid),
                                   self.chip_of_tile(dst_tid))

    def chip_grid_hops(self, src_chip, dst_chip):
        """Hops between chips on the chip grid, wrapping as the tile
        network does (on a one-chip axis the wrap changes nothing)."""
        hx = torch.abs(src_chip % self.chips_x - dst_chip % self.chips_x)
        hy = torch.abs(src_chip // self.chips_x - dst_chip // self.chips_x)
        if self.grid.torus:
            hx = torch.minimum(hx, self.chips_x - hx)
            hy = torch.minimum(hy, self.chips_y - hy)
        return hx + hy

    def tile_ids(self, chip: int) -> np.ndarray:
        """Global tile ids of chip ``chip`` in local row-major order
        (numpy, host-side: the chip-major window's permutation)."""
        return np.asarray(self.global_tile(chip,
                                           np.arange(self.tiles_per_chip)))

    def describe(self) -> str:
        return (f"ChipPartition {self.chips_y}x{self.chips_x} chips of "
                f"{self.sub_ny}x{self.sub_nx} tiles over "
                f"{self.grid.ny}x{self.grid.nx}")


def partition_grid(grid: TileGrid, num_chips: int) -> ChipPartition:
    """Factor ``num_chips`` into the most square chip grid that divides
    ``grid`` (read by ``costmodel.chip_partition_dims``)."""
    best = None
    for cy in range(1, num_chips + 1):
        if num_chips % cy:
            continue
        cx = num_chips // cy
        if grid.ny % cy or grid.nx % cx:
            continue
        score = abs(cy - cx)
        if best is None or score < best[0]:
            best = (score, cy, cx)
    if best is None:
        raise ValueError(
            f"cannot partition {grid.ny}x{grid.nx} into {num_chips} chips")
    return ChipPartition(grid, best[1], best[2])
