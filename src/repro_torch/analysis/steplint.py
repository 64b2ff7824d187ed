"""Step linter: hazards of one superstep, read from the aten ops it runs.

The counterpart of ``repro.analysis.jaxprlint``.  The reference traces
its chunk step to a jaxpr and walks the equations; the port's superstep
is eager PyTorch (captured into CUDA graphs on the card), so the walk is
a :class:`~torch.utils._python_dispatch.TorchDispatchMode` around one
real superstep: every aten op the step dispatches passes through
:class:`StepWalk`, with its arguments and its result.  Two steps are
walked: the chunked loop's ``ChunkRunner.step`` (eager on the CPU, and
outside any capture on the card) and the per-step loop's
``DataLocalEngine._superstep``; a compaction cell walks each window of
its ladder, a write-back cell the flush step too.  Rules:

``host-sync``
    An op inside the step that makes the host wait for the device:
    ``_local_scalar_dense`` (``.item()``, ``bool()``, ``int()`` of a
    tensor), ``is_nonzero``, ``nonzero``, ``masked_select``, the
    ``unique`` family, ``bincount``, ``equal``, boolean-mask indexing
    (its output is sized on the host) and a copy from the device to the
    CPU.  On the card the capture itself runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (``core/chunk.py``),
    which stays; this rule holds the CPU path to the same discipline.

``scatter-mode``
    An overwrite index op (``index_put`` / ``index_put_`` without
    ``accumulate``, ``index_copy`` / ``index_copy_``, ``scatter`` /
    ``scatter_`` of a tensor without ``reduce``) whose index tuples
    repeat on a row that survives: which duplicate wins is undefined.
    The engine's P$ install sends every non-writer to a spare row past
    the end and cuts that row off (``_proxy_stage``); the walk accepts
    repeats that a later ``slice`` of the result cuts off before any
    other op reads it, and nothing else.  Reading the indices makes the
    walk itself wait for the device: it never runs inside a capture.

``bucket-coverage``
    Compaction cells only, on the cell's run: the run must step at least
    one window below the dense one (``engine.window_occupancy.<W>``)
    wherever its own fetched stats say the loop's pick rule would have
    chosen one (a chunk, not the run's first, whose first superstep's
    busiest-chip count, bounded by its ``bucket_cap`` and its
    ``active_tiles``, times ``CHUNK_HEADROOM`` fits a smaller rung; on
    the per-step loop that bound itself).  A silently dense engine passes every
    other rule while never stepping the compacted code.  On the card,
    every (flush, window) key a chunk runner stepped must also have
    exactly one captured graph.

``int-stat-f32-row``
    The chunk's stats buffer must be f64 (``core/chunk.py``): exact for
    every f32 charge and every integer count, which is why the
    reference's int32 side channel has no counterpart.  A narrower
    buffer makes each integer-dtype stat a finding.

``backend-dtype-drift``
    The names, dtypes and shapes of one superstep's (state, stats) under
    ``backend="torch"`` and ``backend="kernels"`` must agree: the
    kernels are held bitwise (min apps) against the torch path, and a
    silent promotion on one side turns that into a cast comparison.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.chunk import ChunkRunner
from .findings import Finding

PASS = "steplint"

# ops that make the host wait for the device (their result, or its size,
# is read on the host)
HOST_SYNC_OPS = frozenset({
    "_local_scalar_dense", "is_nonzero", "nonzero", "masked_select",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive", "bincount", "equal",
})
# overwrite index ops: the result of duplicate indices is undefined
OVERWRITE_OPS = frozenset({"index_put", "index_put_", "index_copy",
                           "index_copy_", "scatter", "scatter_"})


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def _is_mask(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype in (torch.bool,
                                                      torch.uint8)


def _host_sync(name: str, args, kwargs) -> Optional[str]:
    """Why the op waits for the host, or None."""
    if name in HOST_SYNC_OPS:
        return f"`aten.{name}` reads a device value on the host"
    if name in ("index", "index_put", "index_put_") and any(
            _is_mask(t) for t in (args[1] if len(args) > 1 else ())):
        return (f"`aten.{name}` with a boolean mask sizes its output on "
                f"the host")
    if name == "_to_copy":
        dst = kwargs.get("device")
        if (dst is not None and torch.device(dst).type == "cpu"
                and args[0].device.type != "cpu"):
            return "`aten._to_copy` copies a device tensor to the CPU"
    if name == "copy_" and args[0].device.type == "cpu" \
            and args[1].device.type != "cpu":
        return "`aten.copy_` copies a device tensor into a CPU one"
    return None


def _repeated_rows(name: str, args, kwargs):
    """(dim, rows) of an overwrite op: the coordinates along ``dim`` of
    the positions it writes more than once (None when every position is
    written at most once, or the op combines)."""
    self = args[0]
    if name.startswith("index_put"):
        accumulate = args[3] if len(args) > 3 else kwargs.get(
            "accumulate", False)
        if accumulate:
            return None
        indices = list(args[1])
        if not indices or indices[0] is None:
            # a full slice leads: every row along dim 0 gets the writes
            return _repeats_all(self, indices)
        idx = []
        for t in indices:
            if t is None:
                break
            if _is_mask(t):
                idx.extend(torch.nonzero(t).unbind(1))
            else:
                idx.append(t)
        idx = torch.broadcast_tensors(*idx)
        sizes = self.shape[:len(idx)]
        lin = torch.zeros_like(idx[0], dtype=torch.int64)
        for t, n in zip(idx, sizes):
            lin = lin * n + torch.remainder(t.to(torch.int64), n)
        inner = 1
        for n in sizes[1:]:
            inner *= n
        return _repeats(lin.reshape(-1), inner, 0)
    if name.startswith("index_copy"):
        dim = args[1] % max(self.dim(), 1)
        lin = torch.remainder(args[2].to(torch.int64).reshape(-1),
                              self.shape[dim])
        return _repeats(lin, 1, dim)
    # scatter / scatter_: only the tensor-src form without ``reduce``
    if len(args) < 4 or not isinstance(args[3], torch.Tensor) \
            or "reduce" in kwargs or len(args) > 4:
        return None
    dim = args[1] % max(self.dim(), 1)
    index = args[2].to(torch.int64)
    coords = list(torch.meshgrid(*[torch.arange(n, device=index.device)
                                   for n in index.shape], indexing="ij"))
    coords[dim] = torch.remainder(index, self.shape[dim])
    lin = torch.zeros_like(index)
    for c, n in zip(coords, self.shape):
        lin = lin * n + c
    inner = 1
    for n in self.shape[dim + 1:]:
        inner *= n
    lin = lin.reshape(-1)
    return _repeats(lin, inner, dim, self.shape[dim])


def _repeats(lin, inner: int, dim: int, size: Optional[int] = None):
    """Rows (``lin // inner``, modulo ``size``) of the linear positions
    that occur more than once in ``lin``; None if none does."""
    if lin.numel() < 2:
        return None
    s, _ = torch.sort(lin)
    dup = s[1:][s[1:] == s[:-1]]
    if dup.numel() == 0:
        return None
    rows = dup // inner
    if size is not None:
        rows = rows % size
    return dim, frozenset(torch.unique(rows).tolist())


def _repeats_all(self, indices):
    """An index_put led by a full slice: any repeat among the index
    tuples writes every row of dim 0 twice."""
    idx = [t for t in indices if t is not None]
    if not idx:
        return None
    idx = torch.broadcast_tensors(*idx)
    lin = torch.zeros_like(idx[0], dtype=torch.int64)
    for t in idx:
        lin = lin * (int(t.max()) + 1) + t.to(torch.int64)
    if _repeats(lin.reshape(-1), 1, 0) is None:
        return None
    return 0, frozenset(range(self.shape[0]))


@dataclasses.dataclass
class _Pending:
    """An overwrite op's result with repeated rows, until a slice cuts
    them off or another op reads them."""
    tensor: torch.Tensor
    op: str
    dim: int
    rows: frozenset


class StepWalk(TorchDispatchMode):
    """While entered, checks every aten op the code dispatches against
    the ``host-sync`` and ``scatter-mode`` rules; ``findings`` holds what
    it found once it has exited, ``ops`` the ops by name."""

    def __init__(self, where: str, label: str = "step"):
        super().__init__()
        self.where = where
        self.label = label
        self.ops: Counter = Counter()
        self.findings: List[Finding] = []
        self.cut: List[Tuple[str, Tuple[int, ...]]] = []
        self._pending: Dict[int, _Pending] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        why = _host_sync(name, args, kwargs)
        if why is not None:
            self._add("host-sync", f"{why} inside the {self.label}: a host "
                      f"round trip a superstep, and a failed CUDA-graph "
                      f"capture on the card")
        if self._pending:
            self._reads(name, args, kwargs)
        out = func(*args, **kwargs)
        if name in OVERWRITE_OPS:
            rep = _repeated_rows(name, args, kwargs)
            if rep is not None:
                target = args[0] if name.endswith("_") else out
                self._pending[id(target)] = _Pending(target, name, *rep)
        return out

    def _reads(self, name: str, args, kwargs) -> None:
        """An op that takes a pending result: a ``slice`` along its dim
        that drops every repeated row resolves it (the spare-row
        discipline); anything else reads a duplicate write."""
        for t in _tensors(args):
            p = self._pending.get(id(t))
            if p is None or p.tensor is not t:
                continue
            del self._pending[id(t)]
            if name == "slice" and t is args[0]:
                dim, start, end, step = (list(args[1:]) + [
                    kwargs.get(k, d) for k, d in (
                        ("dim", 0), ("start", None), ("end", None),
                        ("step", 1))][len(args) - 1:])
                start, end, step = slice(start, end, step).indices(
                    t.shape[p.dim])
                kept = range(start, end, step)
                if dim % t.dim() == p.dim and not any(r in kept
                                                      for r in p.rows):
                    self.cut.append((p.op, tuple(sorted(p.rows))[:4]))
                    continue
            self._overwrite(p, f"read by `aten.{name}`")

    def _overwrite(self, p: _Pending, how: str) -> None:
        rows = sorted(p.rows)
        self._add("scatter-mode", (
            f"`aten.{p.op}` writes {len(rows)} row(s) along dim {p.dim} more "
            f"than once (rows {rows[:4]}{' ...' if len(rows) > 4 else ''}) "
            f"and the row is {how} inside the {self.label}: which duplicate "
            f"wins is undefined; the engine's discipline sends non-writers "
            f"to a spare row that is cut off"))

    def _add(self, rule: str, message: str) -> None:
        self.findings.append(Finding(PASS, rule, self.where, message))

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        for p in self._pending.values():
            self._overwrite(p, "live at the end of the step")
        self._pending.clear()
        return out


# ------------------------------------------------------------- the steps
def _kernel(eng):
    """The ``DataLocalEngine`` of an engine (itself, or the partitioned
    engine's window)."""
    return getattr(eng, "kernel", None) or eng


def _window_state(eng, state):
    return eng._flat(state) if hasattr(eng, "_flat") else state


def step_plan(eng) -> List[Tuple[bool, Optional[int]]]:
    """The (flush, window) steps a walk takes: dense, the flush step of a
    write-back engine, and each window below the dense one."""
    k = _kernel(eng)
    plan = [(False, None)]
    if k._write_back:
        plan.append((True, None))
    plan += [(False, w) for w in k._ladder[1:]]
    return plan


def lint_steps(eng, state, where: str,
               plan: Optional[Sequence[Tuple[bool, Optional[int]]]] = None
               ) -> Tuple[List[Finding], dict]:
    """Walk one superstep of each of ``plan``'s (flush, window) steps
    (default :func:`step_plan`) from ``state``, on both loops: the
    chunked loop's ``ChunkRunner.step`` (a one-superstep runner over a
    copy of the state) and the per-step loop's ``_superstep``.  Also
    holds the runner's stats buffer to ``int-stat-f32-row``.  Returns
    (findings, readings): ops a walk, the spare-row cuts seen."""
    k = _kernel(eng)
    flat = _window_state(eng, state)
    findings: List[Finding] = []
    ops, cuts = {}, 0
    for flush, window in plan or step_plan(eng):
        tag = f"flush={flush}, window={window or k.Tl}"
        runner = k.chunk_runner(flat, 1)
        runner.left.fill_(1)
        with StepWalk(where, f"chunked loop's step ({tag})") as chunk:
            runner.step(flush, window)
        with StepWalk(where, f"per-step loop's superstep ({tag})") as step:
            stats = k._superstep(flat, flush, window)[1]
        for w, loop in ((chunk, "chunk"), (step, "step")):
            findings += w.findings
            ops[f"{loop} {tag}"] = sum(w.ops.values())
            cuts += len(w.cut)
    findings += lint_stats_buffer(runner, stats, where)
    return findings, dict(ops=ops, spare_row_cuts=cuts)


def lint_stats_buffer(runner: ChunkRunner, stats: dict,
                      where: str) -> List[Finding]:
    """``int-stat-f32-row``: every integer-dtype stat a chunk row holds
    needs the f64 buffer (f32 holds integers exactly only to 2**24)."""
    if runner.rows.dtype == torch.float64:
        return []
    return [Finding(
        PASS, "int-stat-f32-row", f"{where}:{k}",
        f"stat '{k}' is {stats[k].dtype} on the device but rides the "
        f"chunk's {runner.rows.dtype} stats buffer: counts past "
        f"2**{1 - round(math.log2(torch.finfo(runner.rows.dtype).eps))} "
        f"lose low bits")
        for k in runner.keys
        if k in stats and not stats[k].dtype.is_floating_point]


# --------------------------------------------------------- backend drift
def step_shapes(eng, state) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """Name -> (dtype, shape) of one dense superstep's (state, stats)."""
    new_state, stats = _kernel(eng)._superstep(_window_state(eng, state))
    out = {f"state.{k}": v for k, v in new_state.items()}
    out.update({f"stats.{k}": v for k, v in stats.items()})
    return {k: (str(v.dtype).replace("torch.", ""), tuple(v.shape))
            for k, v in out.items()}


def lint_backend_drift(shapes_torch: dict, shapes_kernels: dict,
                       where: str) -> List[Finding]:
    """``backend-dtype-drift`` between two :func:`step_shapes`."""
    findings = []
    for k in sorted(set(shapes_torch) | set(shapes_kernels)):
        a, b = shapes_torch.get(k), shapes_kernels.get(k)
        if a is None or b is None:
            side = "kernels" if a is None else "torch"
            findings.append(Finding(PASS, "backend-dtype-drift",
                                    f"{where}:{k}",
                                    f"'{k}' exists only on the {side} path"))
        elif a != b:
            findings.append(Finding(
                PASS, "backend-dtype-drift", f"{where}:{k}",
                f"the torch path computes {a[0]}{list(a[1])} but the "
                f"kernels path {b[0]}{list(b[1])}: the bitwise comparison "
                f"silently becomes a cast"))
    return findings


# ------------------------------------------------------- bucket coverage
class RunRecord:
    """Observer of a cell's runs (``run(observer=)``), and, while
    entered, a recorder of the windows they stepped
    (``engine.window_occupancy.<W>``) and of every chunk runner's
    supersteps and captures by (flush, window) key."""

    def __init__(self):
        self.runs: List[dict] = []
        self.windows: Dict[int, float] = {}
        self.graphs: List[dict] = []

    # the observer protocol
    def on_run_start(self, meta) -> None:
        self.runs.append(dict(chunk=meta.chunk, caps=[]))

    def on_chunk(self, span) -> None:
        """Keep a bound on the busiest chip's active tiles at the span's
        first superstep: its rung (``bucket_cap``), or the active tiles
        of every chip (``active_tiles``) where fewer."""
        caps = span.stats.get("bucket_cap")
        if caps is not None and len(caps):
            self.runs[-1]["caps"].append(
                min(float(caps[0]), float(span.stats["active_tiles"][0])))

    def on_run_end(self, result) -> None:
        pass

    def __enter__(self):
        from ..obs.metrics import default_registry
        self._reg = default_registry()
        self._before = self._occupancy()
        self._real = (ChunkRunner._superstep, ChunkRunner._capture)
        real_step, real_capture = self._real
        graphs = self.graphs

        def entry(runner):
            got = runner.__dict__.get("_steplint_keys")
            if got is None:
                got = runner._steplint_keys = dict(steps=Counter(),
                                                   captures=Counter())
                graphs.append(got)
            return got

        def superstep(runner, flush, window):
            entry(runner)["steps"][(flush, window)] += 1
            return real_step(runner, flush, window)

        def capture(runner, key):
            entry(runner)["captures"][key] += 1
            return real_capture(runner, key)
        ChunkRunner._superstep, ChunkRunner._capture = superstep, capture
        return self

    def __exit__(self, *exc):
        ChunkRunner._superstep, ChunkRunner._capture = self._real
        after = self._occupancy()
        self.windows = {w: n - self._before.get(w, 0.0)
                        for w, n in after.items()
                        if n - self._before.get(w, 0.0) > 0}

    def _occupancy(self) -> Dict[int, float]:
        prefix = "engine.window_occupancy."
        snap = self._reg.snapshot()["counters"]
        return {int(k[len(prefix):]): v for k, v in snap.items()
                if k.startswith(prefix)}


def lint_bucket_coverage(rec: RunRecord, dense: int, levels: int,
                         where: str, on_card: bool) -> List[Finding]:
    """``bucket-coverage`` of a compaction cell's recorded runs: ``dense``
    is the per-chip tile count (the dense window), ``levels`` the
    cell's ``compaction``."""
    # the engine imports this package (the sanitizer's ``invariants``)
    from ..core.engine import CHUNK_HEADROOM, bucket_index, capacity_ladder
    findings = []
    ladder = capacity_ladder(dense, levels)
    if levels and len(ladder) > 1:
        if not rec.windows:
            findings.append(Finding(
                PASS, "bucket-coverage", where,
                "the compacted run counted no window at all "
                "(engine.window_occupancy.<W>): compaction is off"))
        expect = None
        for run in rec.runs:
            for c in run["caps"][1:]:       # the run's first is dense
                want = (min(c * CHUNK_HEADROOM, dense) if run["chunk"]
                        else c)
                w = ladder[int(bucket_index(int(want), ladder))]
                if w < dense:
                    expect = w if expect is None else min(expect, w)
        below = {w: n for w, n in rec.windows.items() if w < dense}
        if expect is not None and not below:
            findings.append(Finding(
                PASS, "bucket-coverage", where,
                f"the run's own counts put a chunk in window {expect} (of "
                f"{list(ladder)}) by the loop's pick rule, yet it stepped "
                f"only {sorted(rec.windows)}: the engine is silently "
                f"running the dense path"))
    if on_card:
        for g in rec.graphs:
            for key in sorted(g["steps"], key=str):
                n = g["captures"].get(key, 0)
                if n != 1:
                    findings.append(Finding(
                        PASS, "bucket-coverage", where,
                        f"(flush, window) key {key} stepped "
                        f"{g['steps'][key]} times with {n} captured "
                        f"graphs, expected exactly one"))
    return findings
