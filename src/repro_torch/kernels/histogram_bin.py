"""Histogram binning kernel (the Histo app's hot loop, standalone).

Replaces ``repro/kernels/histogram_bin.py`` ``histogram_bin``.  The TPU
kernel summed a one-hot (records x bins) block per grid step because
the TPU's vector unit has no scatter; this one is one pass of integer
atomics, each in a block's own shared memory where the block owns the
bin and in L2 otherwise (``csrc/histogram_bin.cu``), then an int32 ->
f32 conversion.  ``plan`` picks the path from ``num_bins`` and the
card's attributes alone: every block a private copy of the bins
(``private``), each block a slice of them (``sliced``), or device
memory only (``global``).  No path sends an atomic into another block's
shared memory: on an H100 that measured slower than L2's atomics
(``scripts/histogram_variants.py``).  Bound by device-memory bytes
(each id read once, each count written once).  Counts are integers
until the conversion, so the result is bitwise the plain version's in
any order.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from . import _build
from .ref import Case, histogram_ref as plain

MAX_IDS = 2**31           # int32 counters could wrap at or past this
PATHS = ("private", "sliced", "global")    # the launcher's path codes


@dataclass(frozen=True)
class Plan:
    """Where the bins live: ``path``; ``slices`` blocks hold one copy of
    them between them (1 on the private path, 0 on the global one),
    ``per_block`` bins each, in ``smem_bytes`` of dynamic shared memory."""
    path: str
    slices: int
    per_block: int
    smem_bytes: int


def plan(num_bins: int, sm_count: int, max_smem_per_block: int) -> Plan:
    """The path for ``num_bins`` bins on a card of ``sm_count`` SMs whose
    blocks may opt in to ``max_smem_per_block`` bytes of shared memory
    (232,448 on an H100): ``private`` while the int32 bins fit one block;
    ``sliced`` while the fewest power-of-two slices that each fit one
    block (a multiple of 4 bins) are no more than the SMs; ``global``
    beyond.  Raises for a card none of whose blocks could hold a
    slice."""
    if num_bins < 0:
        raise ValueError(f"histogram_bin: num_bins {num_bins} < 0")
    if num_bins <= max_smem_per_block // 4:
        return Plan("private", 1, num_bins, 4 * num_bins)
    cap = max_smem_per_block // 16 * 4
    if sm_count < 1 or cap < 4:
        raise ValueError(
            f"histogram_bin: a card of {sm_count} SMs and {max_smem_per_block}"
            f" B of shared memory a block has no resident block for a "
            f"slice of bins")
    slices = 2
    while -(-num_bins // slices) > cap:
        slices *= 2
    if slices > sm_count:
        return Plan("global", 0, 0, 0)
    per_block = 4 * -(-num_bins // (4 * slices))
    return Plan("sliced", slices, per_block, 4 * per_block)


def geometry(lib, num_bins: int, p: Plan = None) -> Tuple[Plan, int]:
    """(plan, resident blocks) of ``num_bins`` on the current device, with
    library ``lib`` (the package's or a variant's build of
    ``csrc/histogram_bin.cu``) and its own plan unless ``p`` is given.
    Raises when the card reports no resident block for the plan."""
    if p is None:
        sms, smem = ctypes.c_int(0), ctypes.c_int(0)
        card = lib.histogram_bin_card
        card.argtypes, card.restype = [ctypes.c_void_p] * 2, ctypes.c_int
        _build.launch("histogram_bin card query", card,
                      ctypes.addressof(sms), ctypes.addressof(smem))
        p = plan(num_bins, sms.value, smem.value)
    resident = ctypes.c_int(0)
    if p.path != "global":
        fn = lib.histogram_bin_resident
        fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _build.launch("histogram_bin occupancy query", fn, p.smem_bytes,
                      ctypes.addressof(resident))
        if resident.value < 1:
            raise RuntimeError(
                f"histogram_bin: the card reports 0 resident blocks of "
                f"{p.smem_bytes} B shared memory for {num_bins} bins "
                f"({p.path} path, {p.slices} slices of {p.per_block})")
    return p, resident.value


def launch(lib, idx, num_bins: int, p: Plan = None):
    """Count ``idx`` (checked as ``histogram_bin`` does) into ``num_bins``
    with library ``lib``'s launcher, by ``p`` or the card's own plan;
    returns (counts, plan, resident blocks)."""
    dev = idx.device
    cnt_i = torch.empty((num_bins,), dtype=torch.int32, device=dev)
    out = torch.empty((num_bins,), dtype=torch.float32, device=dev)
    fn = lib.histogram_bin_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        p, resident = geometry(lib, num_bins, p)
        _build.launch("histogram_bin", fn, idx.data_ptr(), cnt_i.data_ptr(),
                      out.data_ptr(), idx.numel(), num_bins,
                      PATHS.index(p.path), p.slices, p.per_block, resident,
                      torch.cuda.current_stream(dev).cuda_stream)
    return out, p, resident


def histogram_bin(idx, num_bins: int):
    """Hopper kernel.  idx: (N,) int32 CUDA tensor of bin ids, N < 2^31;
    ids < 0 (padding) or >= num_bins are skipped.  Returns (num_bins,)
    f32 counts.  ``histogram_bin.last`` is the (plan, resident blocks) of
    the last launch."""
    if idx.numel() >= MAX_IDS:
        raise ValueError(f"histogram_bin: {idx.numel()} ids; int32 counts "
                         f"could wrap at 2^31 or more")
    _build.check("histogram_bin idx", idx, (torch.int32,))
    out, p, resident = launch(_build.library("histogram_bin"), idx,
                              num_bins)
    histogram_bin.launches += 1
    histogram_bin.last = (p, resident)
    return out


def analysis_cases():
    """``analysis.kernel_races`` cases: the reference's
    (``histogram_bin.py`` ``analysis_cases``: six ids into eight bins)
    and 8,192 ids, some padding or past the last bin, into 100 bins; the
    counts must agree exactly."""
    from . import ops
    gen = torch.Generator().manual_seed(14)
    wide = torch.randint(-3, 105, (8192,), generator=gen, dtype=torch.int32)
    return [Case("histogram_bin", ops.histogram, plain,
                 (torch.tensor([0, 5, 5, 2, 7, 0], dtype=torch.int32), 8),
                 (0,), ("count",)),
            Case("histogram_bin:wide", ops.histogram, plain, (wide, 100),
                 (0,), ("count",))]


histogram_bin.launches = 0
histogram_bin.last = None
__all__ = ["histogram_bin", "plain", "plan", "Plan"]
