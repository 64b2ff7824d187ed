"""Disk cache of measured counter vectors (measure-once / price-many).

A verbatim copy of ``repro.products.cache`` (numpy and stdlib only): the
port imports nothing of the JAX package.  The file layout and
``SCHEMA_VERSION`` are the reference's, so either package reads the
other's entries; the keys differ (``search.MeasureSpec.key``).

A 16384-tile engine run takes minutes; re-pricing it under a package
config takes microseconds.  The cache stores everything ``price()``
needs — whole-run :class:`TrafficCounters`, the per-superstep
:class:`SuperstepTrace`, and the memory-traffic totals — as one JSON
file per measurement, keyed by a stable hash of the measurement spec
(app, dataset, grid, cascade config, ...).  Product sweeps then re-price
the cached traffic across the whole package design space without ever
re-running the engine.

Files are written atomically (tmp + rename) so an interrupted sweep
never leaves a corrupt entry; unreadable entries are treated as misses.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, Optional

# v2: SuperstepTrace payloads carry the measured chip-partition geometry
# (chips_y / chips_x) — v1 entries predate the chips packaging axis and
# are rejected as misses (re-measured), never silently re-priced without
# their partition geometry.
SCHEMA_VERSION = 2


def stable_hash(obj) -> str:
    """Deterministic short hash of a JSON-serializable spec."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class CounterCache:
    """One-JSON-file-per-measurement store under ``root``."""

    def __init__(self, root: str):
        self.root = root

    def path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def get(self, key: str) -> Optional[Dict]:
        try:
            with open(self.path(key)) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(payload, dict) or \
                payload.get("schema") != SCHEMA_VERSION:
            return None
        return payload

    def put(self, key: str, payload: Dict) -> str:
        payload = dict(payload, schema=SCHEMA_VERSION)
        os.makedirs(self.root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.path(key)
