"""Fused owner-delivery kernel: fold records into the owner mailboxes and
count the arrivals, in one launch sequence.

Replaces ``repro/kernels/deliver_fused.py`` ``deliver_fused``.  The TPU
kernel revisited each mailbox block once per record block with a one-hot
compare; this one copies the mailbox, scatters every record with float
atomics (min on order-preserving bits touches only hit indices) and
integer arrival counts, then converts the counts to f32
(``csrc/engine_kernels.cu``).  Bound by device-memory bytes: the mailbox
is read once and written twice (values and counts).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import check_combine, deliver_fused_ref as plain


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
    cnt_i = torch.empty((nd,), dtype=torch.int32, device=dev)
    cnt_f = torch.empty((nd,), dtype=torch.float32, device=dev)
    fn = _build.bind("engine_kernels", "deliver_fused_launch", 6, 2, 1)
    with torch.cuda.device(dev):
        _build.launch("deliver_fused", fn, seg.data_ptr(), val.data_ptr(),
                      mail_val.data_ptr(), out.data_ptr(), cnt_i.data_ptr(),
                      cnt_f.data_ptr(), n, nd, int(combine == "min"),
                      torch.cuda.current_stream(dev).cuda_stream)
    deliver_fused.launches += 1
    return out, cnt_f


deliver_fused.launches = 0
__all__ = ["deliver_fused", "plain"]
