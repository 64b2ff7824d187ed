"""The package-time product design space (paper §IV, Fig. 9/10).

A verbatim copy of ``repro.products.space`` over the port's
``core.costmodel`` and ``core.tilegrid``: the same configs under the
same names (``hbm-vert/net-c/sram1.5/c16/bl4``).

One silicon design — the DCRA die — becomes many chip *products* at
packaging time: memory style (SRAM-only, interposer HBM, 3D-stacked
HBM), the Fig. 6 network options (intra-die link width, inter-die link
width x count), SRAM capacity per tile, and — the multi-node regime —
the chip partitioning (how many separately packaged chips the tile grid
splits into at board level) together with the per-axis board-link
provisioning between them.  ``product_space`` spans the cross-product as
concrete :class:`PackageConfig` objects the cost model prices directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from ..core.costmodel import NETWORK_OPTIONS, PackageConfig
from ..core.tilegrid import partition_grid, square_grid

# Memory integration styles (Fig. 5): name -> (hbm_gb_per_die, vertical)
MEMORY_STYLES: Dict[str, tuple] = {
    "sram": (0.0, False),
    "hbm-horiz": (8.0, False),
    "hbm-vert": (8.0, True),
}

DEFAULT_SRAM_MIB = (1.5,)
FULL_SRAM_MIB = (0.75, 1.5, 3.0)

# Chip-partitioning axis (paper §V multi-node regime): block
# partitionings the sweep explores, and the default per-axis board-link
# provisioning (2 matches the distributed runtime's historical value).
CHIP_COUNTS = (1, 4, 16, 64)
DEFAULT_BOARD_LINKS = (2,)


def product_space(memory: Sequence[str] = tuple(MEMORY_STYLES),
                  network: Sequence[str] = tuple(NETWORK_OPTIONS),
                  sram_mib: Sequence[float] = DEFAULT_SRAM_MIB,
                  chips: Sequence[int] = (0,),
                  board_links: Sequence[int] = DEFAULT_BOARD_LINKS,
                  ) -> List[PackageConfig]:
    """Cross-product of package-time decisions as PackageConfigs.

    Names encode the decisions (``hbm-vert/net-c/sram1.5/c16/bl4``) so
    sweep tables are self-describing.  Defaults give the 3 x 4 =
    12-config space of the paper's evaluation; pass
    ``sram_mib=FULL_SRAM_MIB`` for the 36-config full sweep, and
    ``chips=CHIP_COUNTS`` (x ``board_links`` provisioning values) to add
    the chip-partitioning axis — each chip count is priced as a
    board-level product of separately packaged chips, and
    :meth:`ProductSearch.sweep` measures it on the distributed runtime.
    Unpartitioned configs (``chips`` 0, the default) carry no name
    suffix, keeping the historical 12-config names stable.
    """
    configs = []
    for mem in memory:
        hbm_gb, vertical = MEMORY_STYLES[mem]
        for netkey in network:
            net = NETWORK_OPTIONS[netkey]
            for mib in sram_mib:
                for n in chips:
                    for bl in (board_links if n > 1
                               else DEFAULT_BOARD_LINKS[:1]):
                        suffix = f"/c{n}" if n >= 1 else ""
                        if n > 1 and bl != DEFAULT_BOARD_LINKS[0]:
                            suffix += f"/bl{bl}"
                        configs.append(dataclasses.replace(
                            net,
                            name=f"{mem}/net-{net.name}/sram{mib:g}"
                                 f"{suffix}",
                            sram_per_tile_mib=mib,
                            hbm_gb_per_die=hbm_gb,
                            hbm_vertical=vertical,
                            chips=n,
                            board_links_y=bl,
                            board_links_x=bl,
                        ))
    return configs


def chip_counts_for(tiles: int,
                    counts: Sequence[int] = CHIP_COUNTS) -> List[int]:
    """The subset of ``counts`` that block-partitions a square grid of
    ``tiles`` tiles, deduplicated (chips<=1 all normalize to 1, which
    always qualifies)."""
    grid = square_grid(tiles)
    out: List[int] = []
    for n in counts:
        n = max(n, 1)
        if n in out:
            continue
        if n > 1:
            try:
                partition_grid(grid, n)
            except ValueError:
                continue
        out.append(n)
    return out
