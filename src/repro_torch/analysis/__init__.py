"""Static analysis and runtime sanitation for the port's engine.

The counterparts of ``repro.analysis``'s passes (``findings``,
``invariants`` and ``deadcode`` are copies, numpy or AST only):

  ``steplint``      walks one superstep's aten ops under a
                    ``TorchDispatchMode`` (host syncs, overwrite index
                    ops with repeated indices, bucket coverage of a
                    compacted run, the f64 stats buffer, torch/kernels
                    step drift): ``jaxprlint``'s rules.
  ``kernel_races``  runs every kernel's cases with their records in
                    other orders (``pallas_races``' counterpart).
  ``invariants``    post-run counter/trace conservation checks, plus
                    the ``EngineConfig.sanitize=True`` runtime
                    sanitizer's host-side error type.
  ``deadcode``      import-graph reachability report from the repo's
                    entry points.
  ``runner``        runs every pass over the six apps x {torch, kernels}
                    x {monolithic, 4-chip, 4-chip double-buffered} x
                    {dense, compaction=2} matrix
                    (``scripts/lint_engine_torch.py`` is the CLI; it
                    fails on findings not in ``analysis_baseline_torch.json``).
"""
from . import deadcode, kernel_races, steplint  # noqa: F401
from .findings import Finding, Report, load_baseline  # noqa: F401
from .invariants import SanitizerError, check_run  # noqa: F401
