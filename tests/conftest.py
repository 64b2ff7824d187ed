# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device.
# Multi-device tests spawn subprocesses that set
# --xla_force_host_platform_device_count themselves (tests/_subproc.py).
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # The five hypothesis-based modules carry `pytestmark =
    # pytest.mark.property` and guard their import with
    # pytest.importorskip("hypothesis"), so environments without
    # hypothesis still collect and run the rest of the suite, and
    # `pytest -m property` selects exactly the property suites.
    config.addinivalue_line(
        "markers", "property: hypothesis property-based tests "
                   "(skipped when hypothesis is not installed)")
    # The slow marker splits nightly-style suites out of the per-PR lane:
    # scripts/tier1.sh runs `-m "not slow"` by default and everything
    # under `--full` (the CI workflow's per-PR job uses the default).
    config.addinivalue_line(
        "markers", "slow: nightly-style tests (property sweeps that run "
                   "the engine repeatedly); excluded by scripts/tier1.sh "
                   "unless invoked with --full")
    # Tests of the PyTorch port's Hopper kernels: they decide inside the
    # test whether there is a CUDA card and skip without one; on a
    # machine with one: python -m pytest -m gpu tests/test_torch_gpu.py
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def small_graph():
    from repro.graph import rmat_edges
    return rmat_edges(9, edge_factor=8, seed=1)      # 512 vertices


@pytest.fixture(scope="session")
def grid8():
    from repro.core.tilegrid import square_grid
    return square_grid(64)                           # 8x8 tiles


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
