"""Fused mailbox-drain / relaxation kernel (BFS/SSSP/WCC vertex update).

Replaces ``repro/kernels/relax_min.py`` ``relax``: for every owned item,
fold the pending mailbox record into the value array and report whether
it improved.  One elementwise pass (``csrc/engine_kernels.cu``
``relax_kernel``), bound by device-memory bytes: it reads 9 B and writes
5 B per element.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import check_combine, relax_ref as plain

_FLAG_DTYPES = (torch.bool, torch.int8, torch.uint8)


def relax(values, mail_val, mail_flag, combine: str = "min"):
    """Hopper kernel.  values/mail_val: (n,) f32 CUDA tensors; mail_flag:
    (n,) bool/int8/uint8.  Returns (new_values f32, improved int8)."""
    check_combine(combine)
    n = values.numel()
    dev = values.device
    _build.check("relax values", values, (torch.float32,))
    _build.check("relax mail_val", mail_val, (torch.float32,), n, dev)
    _build.check("relax mail_flag", mail_flag, _FLAG_DTYPES, n, dev)
    out_v = torch.empty_like(values)
    out_i = torch.empty((n,), dtype=torch.int8, device=dev)
    fn = _build.bind("engine_kernels", "relax_launch", 5, 1, 1)
    with torch.cuda.device(dev):
        _build.launch("relax", fn, values.data_ptr(), mail_val.data_ptr(),
                      mail_flag.data_ptr(), out_v.data_ptr(),
                      out_i.data_ptr(), n, int(combine == "min"),
                      torch.cuda.current_stream(dev).cuda_stream)
    relax.launches += 1
    return out_v, out_i


relax.launches = 0
__all__ = ["relax", "plain"]
