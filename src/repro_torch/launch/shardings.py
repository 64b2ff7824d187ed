"""Rule-based sharding assignment, and the placement of trees by it.

The port of ``repro/launch/shardings.py``.  Parameters, optimizer state,
batches and caches get specs from name + shape rules.  Divisibility is
always checked against the grid: axes that do not divide fall back to
replication.

Scheme (Megatron/FSDP hybrid, the reference's):
  column-parallel weights (w_in, wq, ...):  (..., fsdp->'data', 'model')
  row-parallel weights (w_out, wo, ...):    (..., 'model', fsdp->'data')
  embeddings / lm_head (V, d):              ('model', fsdp->'data')
  MoE experts (E, d, ff):                   ('data' on E, ..., 'model')
  norms / scalars / small state:            replicated
  batch leaves:                             (('pod','data'), None, ...)
  KV caches (L, B, T, H, D):                B->('pod','data') else
                                            H->'model' else T->'model'
Scan-stacked leading layer axes are detected by path and skipped.
The port's K / V caches lie (L, B, H, T, D): ``port_cache_spec`` gives
them the spec of the reference's layout, its T and H entries swapped.

A spec is a plain tuple, one entry per leading dim: ``None``, an axis
name, or a tuple of two or more names; it is ``tuple()`` of the
reference's ``PartitionSpec``, which writes a one-name tuple as the name
and an empty one as ``None`` (``_entry``).  A rule's ``grid`` is
anything with ``names`` and ``shape``: a ``core.collectives.Grid`` or a
group-free :class:`MeshShape` (the counterpart of an abstract mesh), so
the rules run with no process group.  Paths are key strings, the form
``checkpoint.ckpt.flatten`` gives (``"['layers']['attn']['wq']"``).

Placement (the counterpart of ``tree_shardings`` / ``NamedSharding``):
a dim whose entry names axes (a, b) is cut into ``size_a * size_b``
blocks, and a rank holds block ``coord_a * size_b + coord_b``: JAX's
layout, over ``make_grid``'s row-major ranks.  ``place`` cuts full
leaves into this rank's blocks, ``gather`` all-gathers blocks back into
full leaves over each dim's axes.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Optional, Tuple

import numpy as np
import torch

from ..checkpoint.ckpt import flatten, unflatten
from ..core.collectives import all_gather, check_carrier

# trailing-name classes
_COL = ("w_in", "w_gate", "wq", "wk", "wv", "wq_a", "wq_b", "wkv_a",
        "wk_b", "wv_b", "up", "in_proj", "ff_in", "ff_gate", "wx",
        "router", "proj")
_ROW = ("w_out", "wo", "down", "out_proj", "ff_out")
_EMB = ("tok_emb", "lm_head")
# path components that carry stacked layer/group axes (skip leading dims)
_STACKS = ("layers", "moe_layers", "dense_layers", "mamba", "groups",
           "enc_layers", "dec_layers", "mlstm")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes without ranks or groups: what the rules
    read of a grid.  ``coords`` (default the origin) place a block."""

    names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]] = None


def _sizes(grid) -> dict:
    return dict(zip(grid.names, (int(s) for s in grid.shape)))


def _entry(axes):
    """A spec entry as ``PartitionSpec`` writes it: no name is None, one
    name the name, more a tuple."""
    if isinstance(axes, str) or axes is None:
        return axes
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _leading_stack_dims(path: str, ndim: int, trailing: int) -> int:
    """How many leading axes are layer stacks (not shardable weight dims)."""
    n = 0
    if any(f"'{s}'" in path for s in _STACKS):
        n = 1
        if "'mlstm'" in path:         # (G, m_per, ...) double stack
            n = 2
        elif "'groups'" in path and "'slstm'" in path:
            n = 1
    return min(n, max(ndim - trailing, 0))


def _name(path: str) -> str:
    parts = re.findall(r"\['([^']+)'\]", path)
    return parts[-1] if parts else path


def _div(size: int, mesh_sizes: dict, axis: Optional[str]) -> bool:
    return axis in mesh_sizes and size % mesh_sizes[axis] == 0


def param_spec(path: str, shape: tuple, grid, fsdp: bool = True) -> tuple:
    sizes = _sizes(grid)
    name = _name(path)
    nd = len(shape)
    if nd == 0:
        return ()
    spec = [None] * nd

    is_moe_expert = ("'moe'" in path or "'shared'" in path) and name in (
        "w_in", "w_gate", "w_out") and nd >= 3 and "'shared'" not in path

    if name in _EMB:
        if _div(shape[0], sizes, "model"):
            spec[0] = "model"
        if fsdp and nd > 1 and _div(shape[1], sizes, "data"):
            spec[1] = "data"
        return tuple(spec)

    skip = _leading_stack_dims(path, nd, 2)
    if is_moe_expert:
        # (L?, E, d_in, d_out): expert-parallel over as much of the grid
        # as divides -- ('data','model') for deepseek-v3's 256 experts,
        # 'model' for granite's 32.  Per-expert dims stay unsharded.
        e_ax = skip
        if e_ax < nd:
            both = sizes.get("data", 1) * sizes.get("model", 1)
            if "data" in sizes and "model" in sizes \
                    and shape[e_ax] % both == 0:
                spec[e_ax] = ("data", "model")
            elif _div(shape[e_ax], sizes, "model"):
                spec[e_ax] = "model"
            elif _div(shape[e_ax], sizes, "data"):
                spec[e_ax] = "data"
        return tuple(spec)

    if nd - skip >= 2:
        a_in, a_out = nd - 2, nd - 1
        if name in _COL:
            if _div(shape[a_out], sizes, "model"):
                spec[a_out] = "model"
            if fsdp and _div(shape[a_in], sizes, "data"):
                spec[a_in] = "data"
            return tuple(spec)
        if name in _ROW:
            if _div(shape[a_in], sizes, "model"):
                spec[a_in] = "model"
            if fsdp and _div(shape[a_out], sizes, "data"):
                spec[a_out] = "data"
            return tuple(spec)
    return ()                                    # norms, gates, small state


def opt_spec(path: str, shape: tuple, grid, fsdp: bool = True) -> tuple:
    """Optimizer-state leaves mirror their parameter's spec; factored
    adafactor rows/cols lose the last/second-to-last axis."""
    name = _name(path)

    def padded(base, n):
        lst = list(base)
        return lst + [None] * (n - len(lst))

    if name == "vr":           # param.shape[:-1] (reduced over cols)
        base = padded(param_spec(path.replace("['vr']", ""),
                                 shape + (1,), grid, fsdp),
                      len(shape) + 1)
        return tuple(base[: len(shape)])
    if name == "vc":           # param.shape[:-2] + param.shape[-1:]
        full = shape[:-1] + (1,) + shape[-1:]
        base = padded(param_spec(path.replace("['vc']", ""), full, grid,
                                 fsdp), len(full))
        return tuple(base[: len(shape) - 1] + [base[-1]])
    for k in ("mu", "nu", "v"):
        path = path.replace(f"['{k}']", "")
    return param_spec(path, shape, grid, fsdp)


def batch_axes(grid) -> tuple:
    """The grid's batch axes: ('pod', 'data') where it has them."""
    return tuple(a for a in ("pod", "data") if a in grid.names)


def batch_spec(path: str, shape: tuple, grid) -> tuple:
    axes = batch_axes(grid)
    sizes = _sizes(grid)
    n = int(np.prod([sizes[a] for a in axes]))
    if len(shape) >= 1 and shape[0] % n == 0:
        return (_entry(axes),)
    return ()


def cache_spec(path: str, shape: tuple, grid) -> tuple:
    """Decode caches: (L, B, T, H, D)-like stacks.  Prefer batch
    sharding, then heads over 'model', then sequence over 'model'."""
    sizes = _sizes(grid)
    axes = batch_axes(grid)
    nbatch = int(np.prod([sizes[a] for a in axes]))
    nd = len(shape)
    spec = [None] * nd
    # the batch axis: axis 1 for stacked caches, axis 0 for unstacked
    b_ax = 1 if nd >= 3 else 0
    if nd > b_ax and shape[b_ax] % nbatch == 0 and shape[b_ax] >= nbatch:
        spec[b_ax] = _entry(axes)
    if "model" in sizes and nd >= 2:
        m = sizes["model"]
        # prefer a head-like axis (between batch and last), else seq
        for ax in range(nd - 2, b_ax, -1):
            if spec[ax] is None and shape[ax] % m == 0 and shape[ax] >= m:
                spec[ax] = "model"
                break
    return tuple(spec)


# cache leaves the port lays out (L, B, Hkv, T, D) where the reference
# has (L, B, T, Hkv, D) (``convert.lm_cache_from_numpy`` swaps them)
KV_LEAVES = ("k", "v")


def port_cache_spec(path: str, shape: tuple, grid) -> tuple:
    """``cache_spec`` of a port cache leaf, placed as the reference places
    its counterpart: a K / V leaf (L, B, Hkv, T, D) gets the rule's spec
    of the reference's (L, B, T, Hkv, D) with its T and head entries
    swapped back, so that a rank holds the heads (or the positions) the
    reference's rank holds; every other leaf ``cache_spec`` as it is."""
    if _name(path) not in KV_LEAVES or len(shape) != 5:
        return cache_spec(path, shape, grid)
    ref = list(cache_spec(path, shape[:2] + (shape[3], shape[2])
                          + shape[4:], grid))
    ref[2], ref[3] = ref[3], ref[2]
    return tuple(ref)


def kv_cut(spec) -> str:
    """What a rank holds of a port K / V leaf (L, B, Hkv, T, D) under
    ``port_cache_spec``'s ``spec``: ``heads`` where it cuts the heads
    over ``model``, ``positions`` where it cuts T, else ``whole``
    (``models.layers.ModelBlock.kv_cut``)."""
    if names_axis(spec[2:3], "model"):
        return "heads"
    if names_axis(spec[3:4], "model"):
        return "positions"
    return "whole"


def tree_specs(tree, rule, grid, **kw) -> dict:
    """{key string: spec} of a rule over every leaf of ``tree`` (tensors,
    arrays or anything with a ``shape``), in ``flatten``'s order."""
    return {path: rule(path, tuple(leaf.shape), grid, **kw)
            for path, leaf in flatten(tree).items()}


def train_state_specs(state, grid, fsdp: bool = True) -> dict:
    """{key string: spec} of a ``TrainState`` of full leaves:
    ``param_spec`` on ``.params``, ``opt_spec`` on ``.opt_state``, the
    step replicated (the reference's ``in_shardings`` of a state)."""
    out = {}
    for path, leaf in flatten(state).items():
        shape = tuple(leaf.shape)
        if path.startswith(".params"):
            out[path] = param_spec(path, shape, grid, fsdp)
        elif path.startswith(".opt_state"):
            out[path] = opt_spec(path, shape, grid, fsdp)
        else:
            out[path] = ()
    return out


def serve_specs(params, grid, *, batch=None, cache=None,
                fsdp: bool = True) -> dict:
    """{key string: spec} of a served model's full leaves, the
    ``in_shardings`` of the reference's prefill and serve steps:
    ``param_spec`` on ``params`` (keys under ``.params``), and where
    given ``batch_spec`` on ``batch`` (``.batch``) and
    ``port_cache_spec`` on ``cache`` (``.cache``)."""
    out = {".params" + k: param_spec(".params" + k, tuple(v.shape), grid,
                                     fsdp)
           for k, v in flatten(params).items()}
    for name, tree, rule in (("batch", batch, batch_spec),
                             ("cache", cache, port_cache_spec)):
        out.update({f".{name}{k}": rule(f".{name}{k}", tuple(v.shape), grid)
                    for k, v in flatten(tree).items()})
    return out


# ---------------------------------------------------------------- placement
def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def names_axis(spec, axis: str) -> bool:
    """Whether any entry of ``spec`` names ``axis``."""
    return any(e is not None and axis in _axes(e) for e in spec)


def drop_axis(spec, axis: str) -> tuple:
    """``spec`` with ``axis`` taken out of every entry: the axes a leaf
    is gathered over when a step computes on its ``axis`` block.  An
    entry naming ``axis`` beside another axis cannot be split so and
    raises."""
    out = []
    for e in spec:
        if e is not None and axis in _axes(e):
            if _axes(e) != (axis,):
                raise ValueError(f"an entry {e} cuts one dim over {axis!r} "
                                 f"and other axes")
            e = None
        out.append(e)
    return tuple(out)


def names_only(entry, axes) -> bool:
    """Whether a spec entry names axes, all of them among ``axes``."""
    return entry is not None and set(_axes(entry)) <= set(axes)


def block_index(spec, shape, grid) -> tuple:
    """The slices (one per dim) of the block of a ``shape`` leaf that the
    grid's position (``grid.coords``; the origin of a ``MeshShape``
    without them) holds under ``spec``.  A named axis must divide its
    dim."""
    sizes = _sizes(grid)
    at = dict(zip(grid.names, grid.coords or (0,) * len(grid.names)))
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        idx, n = 0, 1
        for a in _axes(entry):
            idx, n = idx * sizes[a] + at[a], n * sizes[a]
        if size % n:
            raise ValueError(f"a dim of {size} does not divide into {n} "
                             f"blocks ({spec} over {_sizes(grid)})")
        blk = size // n
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":                # an ml_dtypes array
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def place(tree, specs: dict, grid, device=None):
    """``tree`` of full leaves (tensors or numpy arrays) as this rank's
    blocks: a contiguous copy of each on ``device`` (default each
    leaf's own)."""
    out = {}
    for path, leaf in flatten(tree).items():
        t = _as_tensor(leaf)
        block = t[block_index(specs[path], t.shape, grid)]
        out[path] = block.to(device if device is not None else t.device,
                             copy=True, memory_format=torch.contiguous_format)
    return unflatten(tree, out)


def _member_blocks(grid, axes) -> list:
    """The block index, under an entry naming ``axes`` in that order, of
    each member of this rank's group along them, in the group's order
    (row-major over the axes in the grid's order)."""
    sizes = _sizes(grid)
    in_grid = [a for a in grid.names if a in axes]
    out = []
    for c in itertools.product(*(range(sizes[a]) for a in in_grid)):
        at = dict(zip(in_grid, c))
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + at[a]
        out.append(idx)
    return out


def gather_leaf(block: torch.Tensor, spec, grid) -> torch.Tensor:
    """The full leaf of every rank's ``block`` under ``spec``: one
    all-gather over each sharded dim's axes (collective over those
    groups; every rank calls it, leaf by leaf in one order).  Each
    all-gather sends the block as it lies and stacks the members' blocks
    on a new leading axis; they are moved into ``dim`` by one copy (none
    for dim 0).  A dim whose axes hold one rank is the block's own (no
    gather, no copy; its group must still carry the block's device), and
    a leaf with no other sharded dim is returned as it is."""
    out = block
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes(entry)
        order = _member_blocks(grid, axes)
        n = len(order)
        if n == 1:
            check_carrier(grid.group(axes), out.device)
            continue
        shape = tuple(out.shape)
        parts = all_gather(out, axes, grid=grid).reshape((n,) + shape)
        if order != sorted(order):                # group order != blocks'
            parts = parts[torch.as_tensor(np.argsort(order))]
        if dim:
            out = torch.cat(tuple(parts), dim=dim)
        else:                                     # a view of the gather
            out = parts.movedim(0, dim).reshape(
                shape[:dim] + (n * shape[dim],) + shape[dim + 1:])
    return out.contiguous() if out is not block else out


def gather(tree, specs: dict, grid):
    """``tree`` of this rank's blocks as full leaves (``gather_leaf``
    each, in ``flatten``'s order)."""
    return unflatten(tree, {path: gather_leaf(leaf, specs[path], grid)
                            for path, leaf in flatten(tree).items()})
