"""Runtime sanitation for the engine: copies of ``repro.analysis``'s
``findings`` and ``invariants`` (numpy only).

  ``findings``    the ``Finding`` / ``Report`` currency of the checks.
  ``invariants``  post-run counter/trace conservation checks, plus the
                  ``EngineConfig.sanitize=True`` runtime sanitizer's
                  host-side error type.

The reference's static passes (``jaxprlint``, ``pallas_races``,
``deadcode``) read JAX programs and Pallas kernels; their counterparts
for the port are ROADMAP A.9.
"""
from .findings import Finding, Report, load_baseline  # noqa: F401
from .invariants import SanitizerError, check_run  # noqa: F401
