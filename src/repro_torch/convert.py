"""Carry data across from the JAX reference to the port.

The two packages share no arrays: data passes between them as numpy.
``csr_to_device`` puts a CSR's engine arrays on a device;
``engine_state_from_numpy`` turns a reference engine state fetched as
numpy (``jax.device_get``) into the port's tensors, and
``engine_state_to_numpy`` goes back, so one mid-run state -- warm P$
included -- can be stepped by both engines.  ``lm_params_from_numpy`` /
``lm_cache_from_numpy`` carry an LM's parameters and cache across (and
``*_to_numpy`` back), any tree of dicts and tuples: the same keys, and
the time and head axes swapped between the reference's (L, B, T, Hkv,
D) and the port's (L, B, Hkv, T, D) on the attention K / V leaves only
(keyed ``k`` / ``v``: the dense, moe and encdec self-attention caches,
hybrid's ``shared``).  Every other leaf keeps its layout: MLA's latent
(L, B, T, r), whisper's cross ``ck`` / ``cv``, and the recurrent states
(hybrid's ssm (L, B, H, P, N) and conv, xlstm's tuples), which have no
time axis.  ``train_state_from_numpy`` / ``train_state_to_numpy``
carry a training state (parameters, the optimizer's f32 moments in the
parameters' structure -- AdamW's ``mu`` / ``nu``, Adafactor's ``vr`` /
``vc`` / ``v`` -- and the step), so both packages can start from one;
on a grid, the state goes straight into this rank's blocks.
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


KV_KEYS = ("k", "v")       # attention K / V leaves: time and heads swap


def _swap_heads(t):
    """Time and head axes swapped, (L, B, T, Hkv, D) <-> (L, B, Hkv, T,
    D)."""
    return t.transpose(2, 3).contiguous()


def _is_kv(t, key) -> bool:
    return key in KV_KEYS and t.dim() == 5


def _cache_tree(fn, tree, key=None):
    """``fn(leaf, key)`` over a cache of nested dicts and tuples, ``key``
    the name of the dict entry a leaf sits in (None in a tuple)."""
    if isinstance(tree, dict):
        return {k: _cache_tree(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_cache_tree(fn, v) for v in tree)
    return fn(tree, key)


def lm_cache_from_numpy(np_cache, device):
    """A reference cache (a tree of numpy arrays) as the port's tensors on
    ``device``: K / V leaves (L, B, T, Hkv, D) as contiguous (L, B, Hkv,
    T, D), the others as they are."""
    dev = torch.device(device)

    def one(a, key):
        t = _tensor_from_numpy(a, dev)
        return _swap_heads(t) if _is_kv(t, key) else t
    return _cache_tree(one, np_cache)


def lm_cache_to_numpy(cache):
    """A port cache in the reference's layout as numpy arrays (bf16 as
    f32), a dict or tuple where the cache has one."""
    def one(t, key):
        return _numpy_from_tensor(_swap_heads(t) if _is_kv(t, key) else t)
    return _cache_tree(one, cache)


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def train_state_from_numpy(np_state, device, grid=None, specs=None):
    """A training state as numpy (a dict, or any object, with
    ``params``, ``opt_state`` and ``step``: the reference's
    ``TrainState`` after ``jax.device_get``) as the port's
    ``TrainState`` on ``device``: each leaf keeps its dtype, the step a
    0-d int32 tensor.  With ``grid`` and ``specs`` (by key string,
    ``launch.shardings.train_state_specs``) each leaf is cut to this
    rank's block on the host, and only the block goes to ``device``."""
    from .training.train_step import TrainState
    dev = torch.device(device)
    host = dev if grid is None else torch.device("cpu")
    state = TrainState(
        params=lm_params_from_numpy(_field(np_state, "params"), host),
        opt_state=lm_params_from_numpy(_field(np_state, "opt_state"), host),
        step=torch.tensor(int(np.asarray(_field(np_state, "step"))),
                          dtype=torch.int32, device=host))
    if grid is None:
        return state
    from .launch.shardings import place
    return place(state, specs, grid, dev)


def train_state_to_numpy(state) -> dict:
    """The port's ``TrainState`` as dict(params, opt_state, step) of numpy
    arrays (bf16 as f32, the step an int32 scalar)."""
    return dict(params=lm_params_to_numpy(state.params),
                opt_state=lm_params_to_numpy(state.opt_state),
                step=np.asarray(int(state.step), np.int32))
