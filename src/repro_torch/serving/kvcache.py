"""KV-cache helpers: the port of ``repro/serving/kvcache.py``.

Cache *structure* is family-specific and owned by the model modules
(``fam['init_cache']``); this module adds the serving-level concerns:
capacity planning (bytes a device) and the growth of a prefill-built
cache.  The dense, moe and encdec caches' ``k`` / ``v`` (and hybrid's
``shared`` ones) are (L, B, Hkv, T, D), time on axis 3; MLA's latent
``dc`` / ``dkr`` / ``mc`` / ``mkr`` are (L, B, T, r), time on axis 2
(the reference's layout).  Recurrent states (hybrid's ``ssm`` /
``conv``, the xlstm tuple) and whisper's cross ``ck`` / ``cv`` have no
time axis to grow.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CachePlan:
    arch: str
    batch: int
    cache_len: int
    bytes_total: int
    bytes_per_device: int
    ring: bool


TIME_AXIS = dict(k=3, v=3, dc=2, dkr=2, mc=2, mkr=2)


def _grow(out, extra):
    for key, axis in TIME_AXIS.items():
        if key in out:
            leaf = out[key]
            pad = [0, 0] * (leaf.dim() - 1 - axis) + [0, extra]
            out[key] = F.pad(leaf, pad)
    return out


def pad_cache(cfg, cache, extra: int):
    """Grow a prefill-built cache's time axis by ``extra`` decode slots
    (zeros): the leaves of ``TIME_AXIS``, at the top and in ``shared``.
    Recurrent caches (not a dict) and ring (sliding-window) caches never
    grow."""
    if not isinstance(cache, dict) or cfg.swa_window:
        return cache
    out = _grow(dict(cache), extra)
    if isinstance(out.get("shared"), dict):
        out["shared"] = _grow(dict(out["shared"]), extra)
    return out


def cache_leaves(cache) -> list:
    """The tensors of a cache of nested dicts and tuples."""
    if isinstance(cache, dict):
        cache = list(cache.values())
    if isinstance(cache, (tuple, list)):
        return [t for c in cache for t in cache_leaves(c)]
    assert isinstance(cache, torch.Tensor), type(cache)
    return [cache]


def plan_cache(cfg, fam, batch: int, cache_len: int,
               n_devices: int = 1) -> CachePlan:
    """Size the decode cache without allocating it (on the meta device)."""
    cache = fam["init_cache"](cfg, batch, cache_len, device="meta")
    total = sum(t.numel() * t.element_size() for t in cache_leaves(cache))
    return CachePlan(arch=cfg.arch, batch=batch, cache_len=cache_len,
                     bytes_total=total,
                     bytes_per_device=total // max(n_devices, 1),
                     ring=cfg.swa_window > 0)
