"""Shared runs of the port's and the reference's faulted and unfailed
partitioned runs for ``tests/test_torch_fault_parity.py`` and
``tests/test_torch_fault_matrix.py`` (``tests/test_fault.py``'s sizes:
RMAT-8, edge factor 8, 16 tiles, 4 chips, ``oq_cap=16``,
``ckpt_every_supersteps=3``), cached per process."""
import numpy as np
import torch

from repro.core.tilegrid import square_grid as jsquare_grid
from repro.graph import rmat_edges as jrmat_edges
from repro.graph.apps import engine_and_state as jengine_and_state
from repro.graph.rmat import histogram_input as jhistogram_input
from repro.runtime import FaultInjector as JFaultInjector

from repro_torch.core.tilegrid import square_grid
from repro_torch.graph import apps, rmat_edges
from repro_torch.graph.rmat import histogram_input
from repro_torch.runtime import FaultInjector

GRID = square_grid(16)
CHIPS = 4
ALL_APPS = ("bfs", "sssp", "wcc", "pagerank", "spmv", "histo")
MIN_APPS = ("bfs", "sssp", "wcc")
REF_RTOL, REF_ATOL = 1e-5, 1e-6          # tests/test_distrib.py _match


def make_graphs():
    """RMAT-8 at edge factor 8 for the port and for the reference."""
    return (rmat_edges(8, edge_factor=8, seed=1),
            jrmat_edges(8, edge_factor=8, seed=1))


def _engine(name, g, jax_side=False, **kw):
    """``tests/test_fault.py``'s ``_engine``, for either package."""
    if jax_side:
        make, grid, hist = jengine_and_state, jsquare_grid(16), \
            jhistogram_input
    else:
        make, grid, hist = apps.engine_and_state, GRID, histogram_input
        kw.setdefault("device", "cpu")
    kw.setdefault("chips", CHIPS)
    kw.setdefault("oq_cap", 16)
    kw.setdefault("ckpt_every_supersteps", 3)
    if name in ("bfs", "sssp"):
        kw.setdefault("root", int(np.argmax(g.out_degree())))
    if name == "histo":
        bins = g.n_rows // 8
        return make(name, g, grid, histo_values=hist(g, bins), bins=bins,
                    **kw)
    return make(name, g, grid, **kw)


_CACHE = {}


def faulted(graphs, name, jax_side, *, chunk, seed=None, at=None, chip=1,
            **kw):
    """(state, run, engine) of a faulted run, cached; with ``seed`` the
    loss point is drawn over the reference's unfailed run, as
    ``tests/test_fault.py`` draws it, else it is ``at`` on ``chip``."""
    key = (name, jax_side, chunk, seed, at, chip, tuple(sorted(kw.items())))
    if key not in _CACHE:
        g = graphs[1] if jax_side else graphs[0]
        if seed is not None:
            base = base_run(graphs, name, True, chunk=chunk, **kw)[1]
            inj = (JFaultInjector if jax_side else FaultInjector).seeded(
                seed, max_superstep=base.supersteps, num_chips=CHIPS)
        else:
            inj = (JFaultInjector if jax_side else FaultInjector)(
                at_superstep=at, chip=chip)
        eng, state, _ = _engine(name, g, jax_side, **kw)
        out = eng.run(dict(state), chunk=chunk, fault_injector=inj)
        assert inj.fired, "injector never fired: loss point past drain"
        _CACHE[key] = out + (eng,)
    return _CACHE[key]


def base_run(graphs, name, jax_side, *, chunk, **kw):
    """(state, run, engine) of the unfailed run, cached."""
    key = ("base", name, jax_side, chunk, tuple(sorted(kw.items())))
    if key not in _CACHE:
        g = graphs[1] if jax_side else graphs[0]
        eng, state, _ = _engine(name, g, jax_side, **kw)
        _CACHE[key] = eng.run(dict(state), chunk=chunk) + (eng,)
    return _CACHE[key]


def _values(state):
    v = state["values"]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_matches_reference(got, want, name, events=True):
    """A port run against the reference's: values (min apps bitwise),
    counters, supersteps, the trace and, with ``events``, its recovery
    events and ``time_s``."""
    (gs, g, _), (ws, w, _) = got, want
    if name in MIN_APPS:
        assert np.array_equal(_values(gs), _values(ws)), name
    else:
        np.testing.assert_allclose(_values(gs), _values(ws), rtol=REF_RTOL,
                                   atol=REF_ATOL, err_msg=name)
    assert g.counters.as_dict() == w.counters.as_dict(), name
    assert g.supersteps == w.supersteps, name
    tg, tw = g.trace.to_dict(), w.trace.to_dict()
    if not events:
        tg.pop("recovery_events", None), tw.pop("recovery_events", None)
    assert tg == tw, name
    if events:
        assert g.time_s == w.time_s, name


def assert_same_run(base, f):
    """The faulted port run against its unfailed run, bitwise."""
    (bs, b, _), (fs, ff, _) = base, f
    assert torch.equal(bs["values"], fs["values"])
    assert b.counters.as_dict() == ff.counters.as_dict()
    assert b.supersteps == ff.supersteps
    tb, tf = b.trace.to_dict(), ff.trace.to_dict()
    tb.pop("recovery_events", None), tf.pop("recovery_events", None)
    assert tb == tf
