"""Carry data across from the JAX reference to the port.

The two packages share no arrays: data passes between them as numpy.
``csr_to_device`` puts a CSR's engine arrays on a device;
``engine_state_from_numpy`` turns a reference engine state fetched as
numpy (``jax.device_get``) into the port's tensors, and
``engine_state_to_numpy`` goes back, so one mid-run state -- warm P$
included -- can be stepped by both engines.  ``lm_params_from_numpy`` /
``lm_cache_from_numpy`` carry an LM's parameters and KV cache across
(and ``*_to_numpy`` back): the same keys, the cache's time and head
axes swapped between the reference's (L, B, T, Hkv, D) and the port's
(L, B, Hkv, T, D).  ``train_state_from_numpy`` / ``train_state_to_numpy``
carry a training state (parameters, the optimizer's f32 moments in the
parameters' structure -- AdamW's ``mu`` / ``nu``, Adafactor's ``vr`` /
``vc`` / ``v`` -- and the step), so both packages can start from one.
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


def _tensor_from_numpy(a, device):
    """A tensor of ``a``'s dtype; a bf16 array (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) goes across as its 16 bits.  Copied,
    so the tensor never shares a read-only buffer."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _numpy_from_tensor(t):
    """``t`` on the host as numpy; bf16 becomes f32, which holds every
    bf16 value exactly.  Always a copy: a CPU tensor's array would share
    its memory, and a training step updates its state in place."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(np_params, device) -> dict:
    """A reference LM's parameters (nested dict of numpy arrays, bf16 or
    f32, ``jax.device_get`` of ``fam["init"]``'s) as port tensors of the
    same dtypes on ``device``."""
    dev = torch.device(device)
    return _tree(lambda a: _tensor_from_numpy(a, dev), np_params)


def lm_params_to_numpy(params) -> dict:
    """Port LM parameters as a nested dict of numpy arrays (bf16 as
    f32)."""
    return _tree(_numpy_from_tensor, params)


def lm_cache_from_numpy(np_cache, device) -> dict:
    """A reference KV cache, dict(k, v) of (L, B, T, Hkv, D), as the
    port's contiguous (L, B, Hkv, T, D) tensors on ``device``."""
    dev = torch.device(device)
    return {k: _tensor_from_numpy(v, dev).transpose(2, 3).contiguous()
            for k, v in np_cache.items()}


def lm_cache_to_numpy(cache) -> dict:
    """A port KV cache as the reference's (L, B, T, Hkv, D) numpy arrays
    (bf16 as f32)."""
    return {k: _numpy_from_tensor(v.transpose(2, 3).contiguous())
            for k, v in cache.items()}


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def train_state_from_numpy(np_state, device):
    """A training state as numpy (a dict, or any object, with
    ``params``, ``opt_state`` and ``step``: the reference's
    ``TrainState`` after ``jax.device_get``) as the port's
    ``TrainState`` on ``device``: each leaf keeps its dtype, the step a
    0-d int32 tensor."""
    from .training.train_step import TrainState
    dev = torch.device(device)
    return TrainState(
        params=lm_params_from_numpy(_field(np_state, "params"), dev),
        opt_state=lm_params_from_numpy(_field(np_state, "opt_state"), dev),
        step=torch.tensor(int(np.asarray(_field(np_state, "step"))),
                          dtype=torch.int32, device=dev))


def train_state_to_numpy(state) -> dict:
    """The port's ``TrainState`` as dict(params, opt_state, step) of numpy
    arrays (bf16 as f32, the step an int32 scalar)."""
    return dict(params=lm_params_to_numpy(state.params),
                opt_state=lm_params_to_numpy(state.opt_state),
                step=np.asarray(int(state.step), np.int32))
