"""Kernel race check: a kernel's outputs must not depend on the order in
which its records are written.

The counterpart of ``repro.analysis.pallas_races``.  The reference
proves, from each ``pl.pallas_call``'s ``BlockSpec`` index maps, that no
two programs of the sequential TPU grid overwrite one output window.
The port's kernels have no such grid: they scatter with atomics (L2 or
shared memory) from threads that run in any order, so disjointness is
not a property of a map but of the combine each output uses.  This pass
therefore runs each case (``kernels.ref.Case``; every kernel module's
``analysis_cases``, collected by ``kernels.ops.analysis_cases``) three
times in its records' own order, three times reversed and three times
in a seeded permutation, and holds every result to the first one and to
the plain version on the first order:

  * ``min``, ``count`` and ``overwrite`` outputs bit for bit;
  * ``add`` outputs within the case's f32 re-association tolerance (the
    kernel tests' own: rtol 1e-5 / atol 1e-6, 1e-4 for spmv_bcsr and
    decode_attention).

A difference is an ``order-dependent-write`` finding.  On the CPU the
cases run the plain versions (``kernels.ops`` dispatches on the
tensor's device), on the card the kernels.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .findings import Finding

PASS = "kernel_races"
REPEATS = 3          # runs in each order
SEED = 0             # of the permuted order
EXACT = ("min", "count", "overwrite")


def _to(a, device):
    return a.to(device) if isinstance(a, torch.Tensor) else a


def _permuted(case, order):
    args = list(case.args)
    for i in case.records:
        args[i] = torch.index_select(args[i], case.axis, order)
    return args


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _same_bits(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        a = a.contiguous().view(torch.uint8)
        b = b.contiguous().view(torch.uint8)
    return torch.equal(a, b)


def _agree(kind: str, a, b, tol) -> bool:
    if kind in EXACT:
        return _same_bits(a, b)
    return a.shape == b.shape and torch.allclose(
        a.float(), b.float(), rtol=tol[0], atol=tol[1], equal_nan=True)


def orders(n: int):
    """(label, permutation) of the orders a case runs in."""
    gen = torch.Generator().manual_seed(SEED)
    return (("own", torch.arange(n)),
            ("reversed", torch.arange(n - 1, -1, -1)),
            (f"permuted (seed {SEED})", torch.randperm(n, generator=gen)))


def check_case(case, device=None) -> List[Finding]:
    """Run ``case`` in every order ``REPEATS`` times on ``device``
    (default: where its tensors are) and compare."""
    if device is not None:
        case = case._replace(args=tuple(_to(a, device) for a in case.args))
    n = case.args[case.records[0]].shape[case.axis]
    findings: List[Finding] = []
    first = None
    plain = _outputs(case.plain(*case.args))
    for label, order in orders(n):
        order = order.to(case.args[case.records[0]].device)
        back = torch.argsort(order)
        args = _permuted(case, order)
        for r in range(REPEATS):
            got = _outputs(case.fn(*args))
            if case.positional:
                got = tuple(torch.index_select(g, 0, back) for g in got)
            if first is None:
                first = got
                checks = (("the plain version", plain),)
            else:
                checks = (("the first run", first),)
            for what, want in checks:
                for i, (kind, a, b) in enumerate(zip(case.outs, got, want)):
                    if not _agree(kind, a, b, case.tol):
                        findings.append(Finding(
                            PASS, "order-dependent-write",
                            f"kernels/{case.name}[out{i}]",
                            f"{kind} output {i} in the {label} order, run "
                            f"{r + 1}, differs from {what} (max |diff| "
                            f"{_max_diff(a, b):.3g}): the kernel's writes "
                            f"depend on their order"))
    return findings


def _max_diff(a, b) -> float:
    if a.shape != b.shape:
        return float("nan")
    return float(torch.max(torch.abs(a.double() - b.double()))) \
        if a.numel() else 0.0


def check_kernels(device=None,
                  cases: Optional[Sequence] = None) -> List[Finding]:
    """Race-check ``cases`` (default: ``kernels.ops.analysis_cases()``) on
    ``device``; findings dedupe by key, one for each output that ever
    disagreed."""
    if cases is None:
        from ..kernels import ops
        cases = ops.analysis_cases()
    seen, findings = set(), []
    for case in cases:
        for f in check_case(case, device):
            if f.key not in seen:
                seen.add(f.key)
                findings.append(f)
    return findings
