"""Assigned input shapes x architecture -> abstract input specs, the port
of ``repro/launch/shapes.py``.

Every (arch, shape) cell resolves to a step kind and a tree of abstract
inputs:

  train_4k     train_step   seq=4096    global_batch=256
  prefill_32k  prefill      seq=32768   global_batch=32
  decode_32k   serve_step   cache=32768 global_batch=128
  long_500k    serve_step   cache=524288 global_batch=1 (sub-quadratic only)

Whisper note: the assigned seq_len is the *audio frame* length (encoder);
the decoder runs its native 448-token context.

The reference's ``ShapeDtypeStruct`` / ``jax.eval_shape`` become fake
tensors of a ``FakeTensorMode`` the caller holds (entered around the
call), on the device the caller names: they carry shapes, dtypes and
devices and allocate nothing.  Every function here raises unless such a
mode is active.  ``param_specs`` is the counterpart of ``jax.eval_shape``
of a family's ``init``: the family draws its parameters from a
``torch.Generator`` on the parameters' device, and a CUDA generator
cannot be made without a card, so the parameters' shapes and dtypes are
taken once per config from ``init`` on the CPU under a private fake mode
(``_param_layout``) and made again as fake empties on the caller's
device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..checkpoint.ckpt import flatten, unflatten

BF16 = torch.bfloat16
I32 = torch.int32

WHISPER_DEC = 448


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def applicable(cfg, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def _require_fake_mode(who: str) -> None:
    mode = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    if mode is None:
        raise RuntimeError(f"{who}: abstract specs are made under a "
                           f"FakeTensorMode the caller holds (none is "
                           f"active: a spec would allocate)")


def _spec(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def batch_specs(cfg, cell: ShapeCell, device) -> dict:
    """Abstract train/prefill batch for an architecture."""
    _require_fake_mode("batch_specs")
    b, s = cell.batch, cell.seq
    if cfg.family == "encdec":
        d = min(WHISPER_DEC, s)
        out = dict(embeds=_spec((b, s, cfg.d_model), BF16, device),
                   tokens=_spec((b, d), I32, device))
        if cell.kind == "train":
            out["labels"] = _spec((b, d), I32, device)
        return out
    if cfg.input_embeds:
        out = dict(embeds=_spec((b, s, cfg.d_model), BF16, device))
        if cell.kind == "train":
            out["labels"] = _spec((b, s), I32, device)
        return out
    out = dict(tokens=_spec((b, s), I32, device))
    if cell.kind == "train":
        out["labels"] = _spec((b, s), I32, device)
    return out


def cache_specs(cfg, fam, cell: ShapeCell, device):
    """Abstract decode cache: the family's ``init_cache`` under the
    caller's fake mode."""
    _require_fake_mode("cache_specs")
    return fam["init_cache"](cfg, cell.batch, cell.seq, device=device)


def decode_specs(cfg, fam, cell: ShapeCell, device):
    """(cache, tokens (B, 1) int32, pos, gen): the serve step's inputs at
    the cache's last position; ``gen`` None (greedy), where the
    reference passes an abstract PRNG key."""
    cache = cache_specs(cfg, fam, cell, device)
    tokens = _spec((cell.batch, 1), I32, device)
    return cache, tokens, cell.seq - 1, None


@functools.lru_cache(maxsize=None)
def _param_layout(cfg, init) -> tuple:
    """(tree of (shape, dtype) leaves, keys) of ``init(cfg, gen, "cpu")``
    drawn under a private fake mode: nothing is allocated."""
    with FakeTensorMode():
        params = init(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = {k: (tuple(t.shape), t.dtype) for k, t in flatten(params).items()}
    skeleton = unflatten(params, {k: 0 for k in leaves})
    return skeleton, tuple(leaves.items())


def param_specs(cfg, fam, device):
    """Abstract parameters of ``fam["init"]``: fake empties of its leaves'
    shapes and dtypes on ``device`` under the caller's fake mode (the
    counterpart of ``jax.eval_shape`` of ``init``)."""
    _require_fake_mode("param_specs")
    skeleton, leaves = _param_layout(cfg, fam["init"])
    return unflatten(skeleton, {k: _spec(shape, dtype, device)
                                for k, (shape, dtype) in leaves})
