"""The engine, its geometry, traffic accounting, P$ and cost model."""
