"""Fused owner-delivery kernel: fold records into the owner mailboxes and
count the arrivals, in one launch.

Replaces ``repro/kernels/deliver_fused.py`` ``deliver_fused``.  The TPU
kernel revisited each mailbox block once per record block with a one-hot
compare; this one (``csrc/engine_kernels.cu``) is one cooperative launch:
it copies the mailbox and zeroes the counts, waits at a grid barrier, and
scatters every record with L2 atomics, one for the value (min on
order-preserving bits touches only hit indices) and one for the count.
The counts are f32 atomics straight into the output below 2^24 records
(exact: every partial count is an integer below 2^24), int32 atomics
converted in place after a second barrier at or above it
(``counting_path``).  No warp fold: the engine's deliveries never repeat
an id within a warp.  Bound by device-memory bytes where the mailbox is
large (it is read once and written twice, values and counts), by the L2
atomics where the records outnumber it.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import Case, check_combine, deliver_fused_ref as plain

F32_COUNT_LIMIT = 1 << 24     # from here on an f32 count can lose a unit


def counting_path(n: int) -> str:
    """How the kernel counts the arrivals of ``n`` records: ``"f32"``
    (float atomics into the output; below 2^24 records every partial
    count is an integer below 2^24, so exact in any order) or ``"i32"``
    (int32 atomics, converted to f32 in place inside the same launch)."""
    return "f32" if n < F32_COUNT_LIMIT else "i32"


def deliver_fused(seg, val, mail_val, combine: str = "min"):
    """Hopper kernel.  seg: (N,) int32 CUDA tensor of mailbox indices,
    < 0 = padding; val: (N,) f32; mail_val: (Nd,) f32.  Returns
    ``(new_mail_val, counts)``, both (Nd,) f32."""
    check_combine(combine)
    n = seg.numel()
    nd = mail_val.numel()
    dev = seg.device
    _build.check("deliver_fused seg", seg, (torch.int32,))
    _build.check("deliver_fused val", val, (torch.float32,), n, dev)
    _build.check("deliver_fused mail_val", mail_val, (torch.float32,),
                 None, dev)
    out = torch.empty_like(mail_val)
    cnt = torch.empty((nd,), dtype=torch.float32, device=dev)
    fn = _build.bind("engine_kernels", "deliver_fused_launch", 5, 2, 2)
    with torch.cuda.device(dev):
        _build.launch("deliver_fused", fn, seg.data_ptr(), val.data_ptr(),
                      mail_val.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                      n, nd, int(combine == "min"),
                      int(counting_path(n) == "i32"),
                      torch.cuda.current_stream(dev).cuda_stream)
    deliver_fused.launches += 1
    return out, cnt


def analysis_cases():
    """``analysis.kernel_races`` cases: the reference's
    (``deliver_fused.py`` ``analysis_cases``: six records into an
    eight-entry mailbox, and a compacted window's stream) and 4,096
    records into 256 entries, each in both combines; the counts must
    agree exactly."""
    from . import ops
    gen = torch.Generator().manual_seed(13)
    mail = torch.full((8,), float("inf"))
    mail[1] = 0.5
    sets = (("", torch.tensor([0, 3, 3, 7, 1, 0], dtype=torch.int32),
             torch.arange(6.0)),
            ("compact:", torch.tensor([2, -1, 5, 2, -1, 1],
                                      dtype=torch.int32),
             torch.arange(6.0) + 0.25))
    cases = [Case(f"deliver_fused:{label}{c}", ops.deliver_fused, plain,
                  (seg, val, mail if c == "min" else torch.zeros(8), c),
                  (0, 1), (c, "count"))
             for label, seg, val in sets for c in ("min", "add")]
    seg = torch.randint(-1, 256, (4096,), generator=gen, dtype=torch.int32)
    val = torch.rand(4096, generator=gen)
    box = torch.rand(256, generator=gen)
    cases += [Case(f"deliver_fused:dense:{c}", ops.deliver_fused, plain,
                   (seg, val, box, c), (0, 1), (c, "count"))
              for c in ("min", "add")]
    return cases


deliver_fused.launches = 0
__all__ = ["deliver_fused", "plain", "counting_path"]
