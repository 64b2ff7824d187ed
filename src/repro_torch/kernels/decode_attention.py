"""Flash-decode GQA attention kernel (``ops.decode_attention``).

Replaces ``repro/kernels/decode_attention.py`` ``decode_attention``.  The
TPU kernel walked a sequential (batch, head, kv_block) grid and carried
the online-softmax state in VMEM from one KV block to the next; this one
(``csrc/decode_attention.cu``) is split-KV flash-decoding: a block of
threads per (split, KV head, batch row) reads each K/V row once for the
whole group of query heads that shares it and writes a partial (max,
sum, weighted V) to an f32 workspace, and a second launch merges the
splits.  bf16 inputs take the tensor-core kernel (``mma.sync`` for Q.K^T
and P.V), f32 inputs the CUDA-core one.  The function is the Pallas
kernel's, padding and finite mask included (see
``ref.decode_attention_ref``).  Bound by device-memory bytes: K and V
are read once, 4 flops per (head, position, dim).
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from .ref import decode_attention_ref as plain
from .ref import decode_geometry

DTYPES = (torch.float32, torch.bfloat16)
TILE = 64                 # positions per tile (kTcTile, kChunkUnit)
WAVE = 132                # blocks a wave at 132 SMs: one an SM (two are
                          # resident); the wrapper passes the card's count
WAVE_FILL = 0.9           # the share of the last wave to fill
MIN_TILES = 4             # tiles per split, at least (where S has them)
MAX_SPLITS = 1024         # kMaxSplits in the source
MAX_D = 128
MAX_GROUP = 64


@functools.lru_cache(maxsize=256)
def split_plan(pairs: int, s: int, wave: int = WAVE):
    """(splits, chunk) for ``pairs`` (batch, KV head) pairs over S
    positions: the fewest splits of whole tiles whose ``pairs * splits``
    blocks fill every wave of ``wave`` blocks (one an SM) to
    ``WAVE_FILL``, each split of at least ``MIN_TILES`` tiles (so that
    the partials stay small beside the K/V a split reads); the most such
    splits where none fills the waves.  No split is without a position.
    A wave of one block an SM, not of the two that fit: at one request
    of decode_32k, 64 splits of 512 positions beat 128 of 256 on the
    card (PERF.md)."""
    tiles = -(-s // TILE)
    most = min(-(-tiles // MIN_TILES), MAX_SPLITS)
    for n in range(1, most + 1):
        per = -(-tiles // n)            # tiles a split
        splits = -(-tiles // per)
        blocks = pairs * splits
        if blocks >= WAVE_FILL * wave * -(-blocks // wave):
            break
    return splits, per * TILE


def split_kernel(dtype: torch.dtype) -> str:
    """Which split kernel the launcher runs for inputs of ``dtype``: bf16
    on the tensor cores (``mma.sync``), f32 on the CUDA cores."""
    return "tensor cores" if dtype == torch.bfloat16 else "CUDA cores"


def decode_attention(q, k, v, lengths, scale=None, block_s: int = 512):
    """Hopper kernel.  q: (B, H, D); k, v: (B, Hkv, S, D), all f32 or all
    bf16, contiguous CUDA tensors, D a multiple of 8 up to 128 and
    H / Hkv up to 64; lengths: (B,) int32.  Returns (B, H, D) in q's
    dtype."""
    dev = q.device
    _build.check("decode_attention q", q, DTYPES, ndim=3)
    b, h, hkv, s, d, group = decode_geometry(q, k, v)
    _build.check("decode_attention k", k, (q.dtype,), device=dev, ndim=4)
    _build.check("decode_attention v", v, (q.dtype,), device=dev, ndim=4)
    _build.check("decode_attention lengths", lengths, (torch.int32,), b, dev)
    if d % 8 or d > MAX_D or group > MAX_GROUP:
        raise ValueError(f"decode_attention: D = {d} (a multiple of 8 up to "
                         f"{MAX_D}) and H / Hkv = {group} (up to "
                         f"{MAX_GROUP}) are outside the kernel's range")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: q, k and v must be 16-byte "
                         "aligned")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s_pad = -(-s // block_s) * block_s
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, chunk = split_plan(b * hkv, s, sms)
    ws_m = torch.empty((b, hkv, splits, group), dtype=torch.float32,
                       device=dev)
    ws_l = torch.empty_like(ws_m)
    ws_acc = torch.empty((b, hkv, splits, group, d), dtype=torch.float32,
                         device=dev)
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    fn = _build.bind("decode_attention", "decode_attention_launch", 8, 8, 1,
                     1)
    with torch.cuda.device(dev):
        _build.launch("decode_attention", fn, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                      ws_m.data_ptr(), ws_l.data_ptr(), ws_acc.data_ptr(),
                      b, h, hkv, s, d, splits, chunk, s_pad,
                      int(q.dtype == torch.bfloat16), float(scale),
                      torch.cuda.current_stream(dev).cuda_stream)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
__all__ = ["decode_attention", "plain", "split_kernel", "split_plan"]
