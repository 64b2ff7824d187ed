"""Op-level cost analysis of one step: the intent of the reference's
``launch/hloanalysis.py`` for an eager port that has no HLO.

``StepCount`` is a ``TorchDispatchMode``: every op a call dispatches
(forward, backward and the optimizer's, on real or fake tensors) passes
through it once and is counted:

  flops        ``torch.utils.flop_counter``'s formula of the op (products,
               convolutions, attention; the custom op
               ``repro_torch::decode_attention`` registers its own),
               0 for an op it has none for.  An op with a
               ``CompositeImplicitAutograd`` decomposition and no formula
               (``matmul`` under ``inference_mode``) is decomposed and
               its parts counted, as ``FlopCounterMode`` does.
  hbm_bytes    the bytes of each tensor the op reads and writes: its
               tensor arguments' and its outputs' (a view's own elements,
               not its storage's).  An eager op is the port's kernel
               boundary, the counterpart of XLA's fusion boundary.  A view
               or an alias (an output that aliases an input without
               writing it), an ``empty`` and a collective count 0.  An op
               that writes into an argument counts that argument once,
               as written and not read (``add_``), or, where it takes
               the values from a source (``copy_``, ``index_put_``,
               ``index_copy_``), counts the source's bytes as written: a
               write into a slice of a larger buffer counts the slice
               (the reference's dynamic-update-slice rule).
  collectives  per the reference's five classes, from the ``c10d`` ops:
               each op's **operand** bytes (what this rank sends; the
               reference's convention) and a count; ``send`` and ``recv``
               are collective-permutes.  Each is also charged to its
               group's link: within one node of ``node_size`` consecutive
               ranks, or across nodes; ``collective_log`` keeps each one's
               class, group size and operand shapes, in order.
  peak_bytes   the high-water mark of the bytes of the storages the call
               allocates and still holds (each output storage made during
               the call, tracked by a weak reference until it is freed),
               above what was live before the call.
  ops          the ops dispatched (metadata queries such as ``prim.device``,
               which only a tensor subclass dispatches, are not ops).

There is no while loop to multiply: the port's Python loops dispatch
every layer's ops.  What the mode cannot see: the ops inside a custom
op's implementation (the decode kernel's workspaces), allocations of a
library outside PyTorch's allocator, the allocator's rounding, and when
a process group's own thread lets go of a collective's operand (gloo's
worker, NCCL's watchdog): on fake tensors the operand is freed as soon
as the step drops it, on real ones now and then a little later.
"""
from __future__ import annotations

import threading
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d op -> the reference's class; barriers move no bytes
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
_BARRIERS = ("barrier", "monitored_barrier_")
# the argument that holds a c10d op's operand
_OPERAND = ("tensors", "input_tensor", "input_tensors", "input_list",
            "inputs", "input")
NODE_SIZE = 8       # ranks a node: 8 GPUs joined by NVLink
# queries of a tensor's metadata: not ops, not counted
_METADATA = {getattr(getattr(ns, op), overload)
             for ns, names in (
                 (torch.ops.prim, ("device", "layout")),
                 (torch.ops.aten, ("sym_size", "sym_stride", "sym_numel",
                                   "sym_storage_offset", "is_contiguous",
                                   "sym_is_contiguous",
                                   "is_strides_like_format",
                                   "is_non_overlapping_and_dense", "size",
                                   "stride", "storage_offset", "numel",
                                   "dim")))
             for op in names if hasattr(ns, op)
             for overload in getattr(ns, op).overloads()}
# the argument an in-place write takes its values from
_SOURCE = ("src", "source", "values")
# factories whose output holds no data yet
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}
_INFO = {}          # op -> _OpInfo


def _tensors(x) -> list:
    """The tensors in an op's arguments or outputs (lists of them
    nested)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpInfo:
    """What the counter reads of an op's schema, worked out once."""

    def __init__(self, func):
        schema = func._schema
        self.name = schema.name.split("::")[-1]
        self.c10d = func.namespace == "c10d"
        self.flops = flop_registry.get(func._overloadpacket)
        self.decomposes = (
            self.flops is None and not self.c10d
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))
        self.view = any(r.alias_info is not None and not r.alias_info.is_write
                        for r in schema.returns)
        names = [a.name for a in schema.arguments]
        self.names = names
        self.written = [i for i, a in enumerate(schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write]
        self.written_names = {names[i] for i in self.written}
        self.source = next((a for a in _SOURCE if a in names), None)
        self.empty = self.name in _EMPTY


def _group_ranks(obj) -> tuple:
    """The global ranks of a c10d op's process group argument."""
    pg = dist.ProcessGroup.unbox(obj) if isinstance(obj, torch.ScriptObject) \
        else obj
    return tuple(dist.get_process_group_ranks(pg))


class StepCount(TorchDispatchMode):
    """While entered, counts every dispatched op (see the module's
    docstring); ``summary()`` gives the totals.  Enter it inside a
    ``FakeTensorMode`` to count a step on fake tensors."""

    def __init__(self, node_size: int = NODE_SIZE):
        super().__init__()
        self.node_size = node_size
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.link_bytes = dict(within_node=0, across_nodes=0)
        # (class, ranks in the group, operand shapes) of each collective
        self.collective_log = []
        self.live = 0
        self.peak = 0
        # a storage can be freed on a process group's thread (its
        # collective's operand): the live count is shared with it
        self._lock = threading.Lock()
        self._held = {}            # storage key -> weak reference
        self._spans = {}           # group ranks -> spans a node boundary

    # ------------------------------------------------------------ memory
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        with self._lock:
            self.live += n
            self.peak = max(self.peak, self.live)

        def freed(_ref, key=key, n=n, held=self._held):
            with self._lock:
                self.live -= n
            held.pop(key, None)
        self._held[key] = weakref.ref(st, freed)

    # ------------------------------------------------------- collectives
    def _collective(self, info, args, kwargs) -> None:
        if info.name in _BARRIERS:
            return
        if info.name not in _C10D:
            raise ValueError(f"StepCount: no class for the collective "
                             f"c10d::{info.name}")
        cls = _C10D[info.name]
        bound = dict(zip(info.names, args))
        bound.update(kwargs)
        operand = next(bound[a] for a in _OPERAND if a in bound)
        nbytes = sum(_nbytes(t) for t in _tensors(operand))
        self.coll[cls] += nbytes
        self.coll_counts[cls] += 1
        ranks = _group_ranks(bound["process_group"])
        self.collective_log.append(
            (cls, len(ranks), [tuple(t.shape) for t in _tensors(operand)]))
        if ranks not in self._spans:
            self._spans[ranks] = len({r // self.node_size
                                      for r in ranks}) > 1
        self.link_bytes["across_nodes" if self._spans[ranks]
                        else "within_node"] += nbytes

    # --------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _OpInfo(func)
        if info.decomposes:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops += 1
        if info.c10d:
            self._collective(info, args, kwargs)
            return out
        if info.flops is not None:
            self.flops += int(info.flops(*args, **kwargs, out_val=out))
        if not info.view:
            self._bytes_and_memory(info, args, kwargs, out)
        return out

    def _bytes_and_memory(self, info, args, kwargs, out) -> None:
        """Bytes moved and storages made (see the module's docstring)."""
        written = [args[i] for i in info.written if i < len(args)]
        written += [v for k, v in kwargs.items() if k in info.written_names]
        written = {id(t) for t in _tensors(written)}
        reads = [t for t in _tensors(args) + _tensors(kwargs)
                 if id(t) not in written]
        outs = _tensors(out)
        if written and info.source is not None:
            # an indexed or copying write writes its source's bytes
            i = info.names.index(info.source)
            src = args[i] if i < len(args) else kwargs.get(info.source)
            if isinstance(src, torch.Tensor):
                outs = [src]
        if not info.empty:
            self.hbm_bytes += sum(_nbytes(t) for t in reads)
            self.hbm_bytes += sum(_nbytes(t) for t in outs)
        if written:
            return                                  # outputs are arguments
        inputs = {t.untyped_storage()._cdata for t in reads}
        for t in outs:
            if t.untyped_storage()._cdata not in inputs:
                self._track(t)

    def summary(self) -> dict:
        """The reference's ``analyze_hlo`` keys, plus ``peak_bytes``,
        ``ops`` and the collective bytes by link."""
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    collective_bytes=dict(self.coll),
                    collective_counts=dict(self.coll_counts),
                    collective_total_bytes=sum(self.coll.values()),
                    collective_link_bytes=dict(self.link_bytes),
                    peak_bytes=self.peak, ops=self.ops)


def analyze_step(fn, *args, **kw) -> dict:
    """``StepCount().summary()`` of one call ``fn(*args, **kw)``."""
    with StepCount() as count:
        fn(*args, **kw)
    return count.summary()
