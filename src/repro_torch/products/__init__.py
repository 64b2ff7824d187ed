"""Package-time product search (paper §IV, Fig. 9/10).

One silicon design, many chip products: measure an application's traffic
once on the engine, cache the per-superstep counter vectors, and
analytically re-price them across the packaging design space (memory
style x network option x SRAM capacity) to select Pareto-optimal
products per target metric.

The port of ``repro.products``: the measurements run on the port's
engine (on the card by default, ``ProductSearch(device=...)``).
"""
from .cache import CounterCache, stable_hash
from .search import (OBJECTIVES, Measurement, MeasureSpec, ProductSearch,
                     pareto_front, product_row, select_products)
from .space import (CHIP_COUNTS, DEFAULT_BOARD_LINKS, DEFAULT_SRAM_MIB,
                    FULL_SRAM_MIB, MEMORY_STYLES, chip_counts_for,
                    product_space)

__all__ = [
    "CounterCache", "stable_hash",
    "OBJECTIVES", "Measurement", "MeasureSpec", "ProductSearch",
    "pareto_front", "product_row", "select_products",
    "CHIP_COUNTS", "DEFAULT_BOARD_LINKS", "DEFAULT_SRAM_MIB",
    "FULL_SRAM_MIB", "MEMORY_STYLES", "chip_counts_for", "product_space",
]
