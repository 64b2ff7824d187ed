"""Proxy-region collective schedules over ``torch.distributed`` groups.

The port of ``repro/core/collectives.py``.  The paper's core insight:
commutative updates are combined *hierarchically* -- reduced inside the
sender's region, then forwarded as one combined record to the owner.  On
a multi-node job the regions are nodes (cheap, wide intra-node links)
and the owners are shards:

  proxy_psum            hierarchical gradient sync:
                          reduce-scatter inside the region
                          -> all-reduce across regions on 1/N-size shards
                          -> all-gather inside the region
                        vs a flat all-reduce over every rank.  Same
                        result (a sum is associative and commutative:
                        the paper's proxy-coherence requirement); the
                        cross-region bytes drop by the region size.

  two_hop_all_to_all    MoE dispatch factored per grid axis: tokens cross
                        the region boundary once, pre-grouped by
                        destination.

  proxy_embedding_grad  vocab-sharded embedding-gradient scatter with a
                        regional combine before the cross-region reduce
                        (the paper's Histogram proxy).

  copy_to_region /      tensor-parallel compute over one axis
  reduce_from_region /  (``models.layers.model_grid``): Megatron's *f*
  gather_from_region    (identity forward, all-reduce backward), *g*
                        (all-reduce forward, identity backward) and an
                        all-gather whose backward is a reduce-scatter.

Axis names become process groups.  The reference runs inside
``shard_map`` over a mesh whose axes have names; here each rank holds its
own block and calls the functions eagerly, naming the axes of a
:class:`Grid` (``make_grid``, the stand-in for ``jax.make_mesh``), which
it passes as ``grid=``.  A grid of shape (C, R) lays ranks out row-major,
so rank ``c * R + r`` sits at (c, r), as ``jax.make_mesh`` lays out
devices.  Every function is collective over the groups it names: every
rank of them calls it, in the same order.

Tensors stay where they are.  A group whose backend does not carry the
tensors' device (gloo with CUDA tensors, NCCL with CPU ones) raises
``ValueError``; nothing is staged through the host.  No function writes
into its input.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the timeout of every group a grid makes (a stuck collective raises)
GROUP_TIMEOUT = datetime.timedelta(seconds=300)
# the backend that carries each device type's tensors
_CARRIER = {"cuda": "nccl", "cpu": "gloo"}
# the tiled collectives: newer torch names them *_single
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


# --------------------------------------------------------------------------
# the grid: named axes over the ranks of the default group
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a named grid of ranks and its group along
    every set of axes (``groups``, keyed by sorted axis-name tuples)."""

    shape: Tuple[int, ...]
    names: Tuple[str, ...]
    coords: Tuple[int, ...]
    groups: Any = dataclasses.field(repr=False, compare=False)

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.names:
                raise ValueError(f"no axis {a!r} in the grid {self.names}")
        return tuple(sorted(set(axes)))

    def group(self, axes):
        """The group of this rank along ``axes`` (a name or names): the
        ranks that share its coordinates on every other axis, in
        row-major order of the named axes."""
        return self.groups[self._key(axes)]

    def size(self, axes) -> int:
        return int(np.prod([self.shape[self.names.index(a)]
                            for a in self._key(axes)]))


def make_grid(shape: Sequence[int] = (2, 4),
              names: Sequence[str] = ("pod", "data")) -> Grid:
    """The grid of shape ``shape`` over every rank of the default group
    (its size must be the grid's), with a group for every non-empty set
    of axes, the whole grid included.  ``dist.new_group`` is collective
    over the world: every rank makes every group, in the same order, the
    ones it is not a member of included."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"grid shape {shape} and names {names} do not match")
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} grid needs {n} ranks, the group has "
                         f"{world}")
    rank = dist.get_rank()
    ids = np.arange(n).reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), k):
            rest = [a for a in range(len(names)) if a not in axes]
            rows = np.transpose(ids, rest + list(axes)).reshape(
                -1, int(np.prod([shape[a] for a in axes])))
            key = tuple(sorted(names[a] for a in axes))
            for row in rows:
                g = dist.new_group([int(r) for r in row],
                                   timeout=GROUP_TIMEOUT)
                if rank in row:
                    groups[key] = g
    return Grid(shape, names, coords, groups)


def _group_backends(group) -> dict:
    """{device type: backend name} of ``group`` ("gloo", or
    "cpu:gloo,cuda:nccl" for a group with a backend per device)."""
    name = str(dist.get_backend(group)).lower()
    if ":" not in name:
        return {"cpu": name, "cuda": name}
    return dict(part.split(":") for part in name.split(","))


def check_carrier(group, device) -> None:
    """Refuse a group whose backend does not carry ``device``'s tensors
    (gloo with CUDA tensors, NCCL with CPU tensors); None checks
    nothing.  The ``fake`` backend (``launch/dryrun.py``'s) carries any
    device's tensors and moves nothing."""
    if device is None:
        return
    kind = torch.device(device).type
    got = _group_backends(group).get(kind)
    want = _CARRIER.get(kind)
    if got != want and got != "fake":
        raise ValueError(f"a {got} process group cannot carry {kind} "
                         f"tensors (they need a {want} group)")


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    check_carrier(group, x.device)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def _reduce_scatter(x, group):
    """psum_scatter along dim 0, tiled: this rank's 1/n of the sum."""
    check_carrier(group, x.device)
    n = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _reduce_scatter_single(out, x.contiguous(), group=group)
    return out


def _all_gather(x, group):
    """all_gather along dim 0, tiled, in group-rank order."""
    check_carrier(group, x.device)
    n = dist.get_world_size(group)
    out = torch.empty((x.shape[0] * n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_single(out, x.contiguous(), group=group)
    return out


def _all_to_all(x, group):
    """all_to_all along dim 0, tiled: chunk j goes to group rank j, and
    chunk j of the result came from it."""
    check_carrier(group, x.device)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


# --------------------------------------------------------------------------
# hierarchical (proxy) psum
# --------------------------------------------------------------------------
def proxy_psum(x, region_axis: str, cross_axis: Optional[str], *,
               grid: Grid):
    """Hierarchical sum over the grid of this rank's partial ``x``.

    region_axis: the intra-region axis (e.g. 'data' inside a pod).
    cross_axis:  the cross-region axis (e.g. 'pod'); None => flat sum
                 over ``region_axis``.

    Uses RS -> AR -> AG when the leading dim divides by the region size,
    else a flat all-reduce over both axes (correctness first; the
    schedule is an optimization, not a semantic change).
    """
    if cross_axis is None:
        return _all_reduce(x, grid.group(region_axis))
    region = grid.size(region_axis)
    if x.ndim == 0 or x.shape[0] % region != 0:
        return _all_reduce(x, grid.group((region_axis, cross_axis)))
    # 1. regional combine: each region member ends up owning 1/region of
    #    the fully-combined regional value (the proxy tile's P$ content).
    shard = _reduce_scatter(x, grid.group(region_axis))
    # 2. one cross-region record per shard (write-through to the owner).
    group = grid.group(cross_axis)
    check_carrier(group, shard.device)
    dist.all_reduce(shard, group=group)
    # 3. redistribute inside the region.
    return _all_gather(shard, grid.group(region_axis))


def flat_psum(x, axes, *, grid: Grid):
    return _all_reduce(x, grid.group(tuple(axes)))


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples, dict keys
    in sorted order (``training.optimizer.tree_leaves``' walk, the
    reference's ``jax.tree.map``), so every rank issues its collectives
    in the same order."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def proxy_psum_tree(tree, region_axis: str, cross_axis: Optional[str], *,
                    grid: Grid):
    return _tree_map(
        lambda g: proxy_psum(g, region_axis, cross_axis, grid=grid), tree)


def hierarchical_psum(x, grid: Grid, region_axis: str = "data",
                      cross_axis: Optional[str] = "pod"):
    """Standalone wrapper (for tests / benchmarks): each rank passes its
    partial ``x`` and gets the replicated hierarchical sum.  (The
    reference's ``x`` carries a leading per-device axis laid out over
    ``batch_axes``; here each rank already holds its own block.)"""
    return proxy_psum(x, region_axis, cross_axis, grid=grid)


# --------------------------------------------------------------------------
# two-hop all-to-all (MoE dispatch across regions)
# --------------------------------------------------------------------------
def two_hop_all_to_all(x, region_axis: str, cross_axis: Optional[str], *,
                       grid: Grid):
    """All-to-all over the product (cross x region) grid, factored into
    one intra-region hop followed by one cross-region hop.

    x: (n_cross, n_region, m, d) per-rank send buffer -- slot [c, r, ...]
    goes to rank (c, r) of the grid.  Returns the same-shaped receive
    buffer.

    The factorization sends each payload once over cheap intra-region
    links and exactly once over the expensive cross-region hop, already
    grouped by destination region -- the proxy-region routing rule.
    """
    if cross_axis is None:
        shp = x.shape
        xx = x.reshape((shp[0] * shp[1],) + tuple(shp[2:]))
        return _all_to_all(xx, grid.group(region_axis)).reshape(shp)
    # hop 1 (regional): exchange along the region slot, axis 1 (the
    # collective splits dim 0: the slot goes first and back)
    x = _all_to_all(x.movedim(1, 0), grid.group(region_axis)).movedim(0, 1)
    # hop 2 (cross): one boundary crossing, pre-grouped.
    return _all_to_all(x, grid.group(cross_axis))


def one_hop_all_to_all(x, region_axis: str, cross_axis: Optional[str], *,
                       grid: Grid):
    """Flat reference: the all-to-all over the combined grid as cross
    first, then region -- the same result, but every payload crosses the
    region boundary ungrouped."""
    if cross_axis is None:
        return two_hop_all_to_all(x, region_axis, None, grid=grid)
    x = _all_to_all(x, grid.group(cross_axis))
    return _all_to_all(x.movedim(1, 0),
                       grid.group(region_axis)).movedim(0, 1).contiguous()


# --------------------------------------------------------------------------
# proxy embedding-gradient scatter (the Histogram proxy)
# --------------------------------------------------------------------------
def proxy_embedding_grad(ids, gvals, vocab_pad: int, region_axis: str,
                         cross_axis: Optional[str], *, grid: Grid):
    """Vocab-dense embedding gradient from sparse (token-id, grad) pairs,
    with the paper's proxy schedule.

    ids: (n,) int local token ids; gvals: (n, d) local grads.
    Returns this rank's (vocab_pad / region, d) owner shard.

    Regional combine first (a segment sum = P$ coalescing), then the
    cross-region reduce touches only combined records.  On a card the
    ``index_add_`` sums in any order.
    """
    d = gvals.shape[-1]
    dense = torch.zeros((vocab_pad, d), dtype=gvals.dtype,
                        device=gvals.device)
    dense.index_add_(0, ids, gvals)
    shard = _reduce_scatter(dense, grid.group(region_axis))
    if cross_axis is not None:
        group = grid.group(cross_axis)
        check_carrier(group, shard.device)
        dist.all_reduce(shard, group=group)
    return shard


# --------------------------------------------------------------------------
# compressed cross-region sync (gradient compression on the expensive link)
# --------------------------------------------------------------------------
def _blocks(x, block: int):
    """``x`` flattened, zero-padded to whole blocks, as (n_blocks, block)
    f32."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return flat.reshape(-1, block).to(torch.float32)


def _round_int8(blocks, scale):
    """``round(blocks / max(scale, 1e-12))`` as int8 (half to even, as
    ``jnp.round``)."""
    return torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)


def _quantize_int8(x, block: int = 256):
    """Blockwise-scaled symmetric int8 quantization.  Returns (q, scales)."""
    blocks = _blocks(x, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # a true division, as the reference's: by a Python number the CUDA
    # kernel multiplies by its reciprocal, one ulp off now and then
    scale = amax / amax.new_tensor(127.0)
    return _round_int8(blocks, scale), scale[:, 0]


def _dequantize_int8(q, scale, shape):
    out = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    return out[: int(np.prod(shape))].reshape(shape)


def compressed_proxy_psum(x, region_axis: str, cross_axis: Optional[str],
                          block: int = 256, *, grid: Grid):
    """proxy_psum with the *cross-region* hop int8-compressed.

    The regional combine runs at full precision (cheap links); only the
    combined shard crosses the expensive boundary quantized -- 4x fewer
    cross-region bytes on top of proxy_psum's 1/region reduction.  The
    intra-region stages stay exact, so the error is bounded by one int8
    rounding of the regional sums.
    """
    if cross_axis is None:
        return _all_reduce(x, grid.group(region_axis))
    region = grid.size(region_axis)
    if x.ndim == 0 or x.shape[0] % region != 0:
        return _all_reduce(x, grid.group((region_axis, cross_axis)))
    shard = _reduce_scatter(x, grid.group(region_axis))
    cross = grid.group(cross_axis)
    # share one scale per block across regions (a small f32 max first) so
    # the int32 sum of int8 payloads dequantizes exactly by that scale.
    _, scale_local = _quantize_int8(shard, block)
    scale = _all_reduce(scale_local, cross, dist.ReduceOp.MAX)
    q = _round_int8(_blocks(shard, block), scale[:, None])
    qsum = _all_reduce(q.to(torch.int32), cross)
    deq = _dequantize_int8(qsum, scale, shard.shape).to(shard.dtype)
    return _all_gather(deq, grid.group(region_axis))


# --------------------------------------------------------------------------
# off-chip record exchange (the distributed tile-grid runtime's boundary leg)
# --------------------------------------------------------------------------
def all_gather(x, axes, *, grid: Grid):
    """``x`` of every rank along ``axes`` (a name or names), concatenated
    along dim 0 in the group's row-major order of those axes."""
    return _all_gather(x, grid.group(axes))


def gather_records(parts, axis: str, *, grid: Grid):
    """Exchange compact off-chip record buffers across ``axis``.

    ``parts`` is a tuple of same-length per-rank record tensors (e.g.
    dst, val, mask).  Every rank all-gathers the full record stream and
    filters the records it owns on the receive side -- an all-to-all
    without per-destination packing, which cannot overflow a send buffer
    however skewed the destinations are.  Returns the flattened
    (n_ranks * R, ...) tensors in rank order.
    """
    return tuple(_all_gather(p, grid.group(axis)) for p in parts)


# --------------------------------------------------------------------------
# tensor-parallel regions over one axis (Megatron's f, g and all-gather)
# --------------------------------------------------------------------------
class _CopyToRegion(torch.autograd.Function):
    """Megatron's *f*: the identity forward; the backward sums the
    cotangents of every rank of the group (each rank's share of the
    work downstream gave it a part of the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    """Megatron's *g*: the forward sums every rank's partial ``x``; the
    backward is the identity (each rank's partial carries the whole
    cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``dim`` in group order; the
    backward sums the cotangents over the group and keeps this rank's
    block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        out = _reduce_scatter(g.movedim(ctx.dim, 0), ctx.group)
        return out.movedim(0, ctx.dim), None, None


def _alone(x, axis, grid: Optional[Grid]) -> bool:
    """Whether this rank is alone along ``axis``: no grid (a single
    device), or a group of one rank, which must still carry ``x``'s
    device.  The region functions below are then the identity."""
    if grid is None:
        return True
    if grid.size(axis) > 1:
        return False
    check_carrier(grid.group(axis), x.device)
    return True


def copy_to_region(x, axis, *, grid: Optional[Grid]):
    """``x`` entering work split over ``axis``: the identity forward, an
    all-reduce of its gradient (Megatron's *f*)."""
    if _alone(x, axis, grid):
        return x
    return _CopyToRegion.apply(x, grid.group(axis))


def reduce_from_region(x, axis, *, grid: Optional[Grid]):
    """The sum over ``axis`` of every rank's partial ``x``, whose gradient
    passes to each rank as it is (Megatron's *g*)."""
    if _alone(x, axis, grid):
        return x
    return _ReduceFromRegion.apply(x, grid.group(axis))


def gather_from_region(x, dim: int, axis, *, grid: Optional[Grid]):
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in the
    group's order; the gradient is reduce-scattered back."""
    if _alone(x, axis, grid):
        return x
    return _GatherFromRegion.apply(x, dim, grid.group(axis))


def max_over(x, axis, *, grid: Optional[Grid]):
    """The elementwise max of ``x`` over ``axis`` (no gradient)."""
    if _alone(x, axis, grid):
        return x.detach()
    return _all_reduce(x.detach(), grid.group(axis), dist.ReduceOp.MAX)


# --------------------------------------------------------------------------
# analytic byte accounting
# --------------------------------------------------------------------------
def allreduce_bytes(n_bytes: float, n_dev: int) -> float:
    """Ring all-reduce wire bytes per device: 2 (N-1)/N * payload."""
    return 2.0 * (n_dev - 1) / n_dev * n_bytes


def proxy_sync_bytes(n_bytes: float, region: int, cross: int):
    """Per-device (intra, cross) wire bytes of RS+AR+AG vs flat AR over
    region*cross devices."""
    intra = 2.0 * (region - 1) / region * n_bytes          # RS + AG
    crossb = 2.0 * (cross - 1) / cross * (n_bytes / region)  # AR on shards
    flat = allreduce_bytes(n_bytes, region * cross)
    return dict(proxy_intra=intra, proxy_cross=crossb, flat=flat,
                cross_reduction=(flat / max(crossb, 1e-12)))
