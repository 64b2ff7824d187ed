"""Sharded, elastic checkpointing of trees of tensors.

Layout (the reference's, so that each package reads the other's
checkpoints): <dir>/step_<n>/
    manifest.json    per-leaf shape, logical dtype and shard, the step
                     and the caller's metadata
    shard_<k>.npz    leaf payloads (leaf key -> array), cut at 512 MiB

A tree is nested dicts, lists, tuples and dataclass instances whose
leaves are tensors, numpy arrays or numpy scalars (``None`` is an empty
subtree).  A leaf's key is the reference's key string (``jax``'s
``keystr``): ``['state']['values']`` for dict keys, ``[0]`` for list and
tuple positions, ``.params`` for a dataclass field; dict keys in sorted
order, fields in declaration order (``TrainState``: params, opt_state,
step).

Restore is *elastic*: leaves are read as host arrays and placed wherever
``placement(key, shape)`` says, whatever device wrote them.  Writes are
atomic (a ``.tmp`` directory, then a rename), so a failure during a save
never corrupts the latest checkpoint.  The shards' zip entries carry a
fixed timestamp, so a checkpoint's bytes depend on its contents alone.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

Tree = Any
_SHARD_BYTES = 512 * 1024 * 1024
# the date of every zip entry (the earliest a zip file can hold)
_ZIP_DATE = (1980, 1, 1, 0, 0, 0)

# npz cannot hold bf16 or fp8: they are stored as integer views, with the
# logical dtype named in the manifest (float16 is native to numpy)
_EXOTIC = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
           "float8_e5m2": np.uint8, "float16": None}
_TORCH_EXOTIC = {torch.bfloat16: "bfloat16",
                 torch.float8_e4m3fn: "float8_e4m3fn",
                 torch.float8_e5m2: "float8_e5m2"}
_LOGICAL_TORCH = {v: k for k, v in _TORCH_EXOTIC.items()}
# the signed integer type each view is read back through (torch's own
# unsigned types beyond uint8 are limited)
_VIEW_TORCH = {np.dtype(np.uint16): (np.int16, torch.int16),
               np.dtype(np.uint8): (np.uint8, torch.uint8)}


def _to_storable(leaf):
    """A leaf as (host numpy array npz can hold, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        logical = _TORCH_EXOTIC.get(t.dtype)
        if logical is None:
            return t.numpy(), t.numpy().dtype.name
        store = np.dtype(_EXOTIC[logical])
        signed, tdt = _VIEW_TORCH[store]
        return t.view(tdt).numpy().view(signed).view(store), logical
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if _EXOTIC.get(name) is not None:      # an ml_dtypes array
        return arr.view(_EXOTIC[name]), name
    return arr, name


def _from_storable(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype."""
    if _EXOTIC.get(logical) is not None:
        signed, tdt = _VIEW_TORCH[arr.dtype]
        return torch.from_numpy(np.ascontiguousarray(arr).view(signed)
                                ).view(tdt).view(_LOGICAL_TORCH[logical])
    return torch.from_numpy(np.array(arr))


def _is_node(tree) -> bool:
    """A dataclass instance (a pytree node, as the reference registers
    ``TrainState``), not a dataclass type."""
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def flatten(tree, prefix: str = "") -> dict:
    """{key string: leaf} of ``tree`` in the reference's leaf order."""
    if tree is None:
        return {}
    if _is_node(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(flatten(getattr(tree, f.name), f"{prefix}.{f.name}"))
        return out
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if tree is None:
        return None
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _unflatten(template, leaves: dict, prefix: str = ""):
    if template is None:
        return None
    if _is_node(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves,
                               f"{prefix}.{f.name}")
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    return leaves[prefix]


def to_host(tree: Tree) -> Tree:
    """``tree`` with every leaf copied to host memory (tensors to CPU
    tensors, which waits for the device; other leaves as numpy)."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return np.array(x)
    return tree_map(host, tree)


def save_checkpoint(directory: str, step: int, tree: Tree,
                    extra_meta: Optional[dict] = None) -> str:
    """Write ``tree`` atomically; returns the checkpoint path."""
    flat = flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = dict(step=step, leaves={}, extra=extra_meta or {})
    shard_idx, shard_bytes, shard_payload = 0, 0, {}

    def flush():
        nonlocal shard_idx, shard_bytes, shard_payload
        if shard_payload:
            _write_npz(os.path.join(tmp, f"shard_{shard_idx:04d}.npz"),
                       shard_payload)
            shard_idx += 1
            shard_bytes = 0
            shard_payload = {}

    for key, leaf in flat.items():
        arr, logical = _to_storable(leaf)
        manifest["leaves"][key] = dict(shape=list(arr.shape), dtype=logical,
                                       shard=shard_idx)
        shard_payload[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _SHARD_BYTES:
            flush()
    flush()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _write_npz(path: str, arrays: dict) -> None:
    """``np.savez``'s file (an uncompressed zip of ``.npy`` entries) with
    every entry dated ``_ZIP_DATE`` in place of the time of the write."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            info = zipfile.ZipInfo(f"{key}.npy", date_time=_ZIP_DATE)
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)


class AsyncCheckpointer:
    """Overlaps checkpoint writes with the work that follows them.

    ``save`` copies the tree to host memory synchronously (the copy waits
    for the device) and hands the disk write to a thread; ``wait`` joins
    the write in flight (call it before a restore or exit) and raises
    what the write raised.  At most one write is in flight: a new save
    waits for the previous one first, so checkpoints land in order.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree: Tree, extra_meta=None) -> None:
        self.wait()
        host_tree = to_host(tree)

        def _write():
            try:
                self.last_path = save_checkpoint(self.directory, step,
                                                 host_tree, extra_meta)
            except Exception as e:          # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Tree,
                       step: Optional[int] = None,
                       placement: Optional[Callable] = None) -> Tree:
    """Restore into the structure of ``template`` (whose leaves need only
    a ``shape``; ``torch.empty(..., device="meta")`` will do).

    Leaves come back as tensors of the logical dtype the manifest names,
    on the CPU, or on the device ``placement(key, shape)`` returns (None:
    the CPU): the device that wrote the checkpoint does not matter
    (elastic restart); a ``(device, rows)`` pair keeps the leaf's
    ``rows`` only (one rank's block).  The newest step when ``step`` is
    None."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shards: dict = {}
    out = {}
    try:
        for key, tleaf in flatten(template).items():
            if key not in manifest["leaves"]:
                raise KeyError(f"checkpoint missing leaf {key}")
            meta = manifest["leaves"][key]
            sid = meta["shard"]
            if sid not in shards:
                shards[sid] = np.load(
                    os.path.join(path, f"shard_{sid:04d}.npz"))
            arr = _from_storable(shards[sid][key], meta["dtype"])
            want = tuple(getattr(tleaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: ckpt shape {tuple(arr.shape)} != "
                                 f"template {want}")
            if placement is not None:
                dev = placement(key, tuple(arr.shape))
                if isinstance(dev, tuple):      # (device, rows): a block
                    dev, rows = dev
                    arr = arr[rows]
                if dev is not None:
                    arr = arr.to(dev)
            out[key] = arr
    finally:
        for npz in shards.values():
            npz.close()
    return _unflatten(template, out)
