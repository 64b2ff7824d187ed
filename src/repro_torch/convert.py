"""Carry data across from the JAX reference to the port.

The two packages share no arrays: data passes between them as numpy.
``csr_to_device`` puts a CSR's engine arrays on a device;
``engine_state_from_numpy`` turns a reference engine state fetched as
numpy (``jax.device_get``) into the port's tensors, and
``engine_state_to_numpy`` goes back, so one mid-run state -- warm P$
included -- can be stepped by both engines.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph.csr import CSR

# every engine-state array, with the dtype both engines keep it in
STATE_DTYPES = dict(values=torch.float32, mail_val=torch.float32,
                    mail_flag=torch.bool, cur_lo=torch.int32,
                    cur_hi=torch.int32, cur_val=torch.float32,
                    p_tag=torch.int32, p_val=torch.float32)


def csr_to_device(csr: CSR, device) -> dict:
    """The CSR's engine arrays (``row_lo``, ``row_hi``, ``col_idx``,
    ``weights``) as tensors on ``device``; unweighted graphs get
    ``weights=None``, as ``DataLocalEngine`` takes them."""
    dev = torch.device(device)
    out = dict(row_lo=torch.as_tensor(csr.row_lo).to(dev),
               row_hi=torch.as_tensor(csr.row_hi).to(dev),
               col_idx=torch.as_tensor(csr.col_idx).to(dev, torch.int32),
               weights=None)
    if csr.weights is not None:
        out["weights"] = torch.as_tensor(csr.weights).to(dev, torch.float32)
    return out


def engine_state_from_numpy(np_state, device) -> dict:
    """A reference engine state (dict of numpy arrays) as port tensors."""
    unknown = set(np_state) - set(STATE_DTYPES)
    if unknown:
        raise ValueError(f"unknown engine-state arrays {sorted(unknown)}")
    dev = torch.device(device)
    return {k: torch.as_tensor(np.array(v)).to(dev, STATE_DTYPES[k])
            for k, v in np_state.items()}


def engine_state_to_numpy(state) -> dict:
    """A port engine state as a dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
