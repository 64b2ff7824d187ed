#!/usr/bin/env python
"""The port's lint gate: run the ``repro_torch.analysis`` passes over the
app matrix.

Runs the step walk (host syncs, overwrite index ops with repeated
indices, bucket coverage of the compacted runs, the f64 stats buffer,
torch/kernels step drift), the kernel race check (every kernel's cases
in three record orders, three times each), the dead-code report and the
executed invariant checks (counter conservation, trace sanity, reprice
contract) over six apps x {torch, kernels} x {monolithic, 4-chip,
4-chip double-buffered, monolithic compaction=2, 4-chip double-buffered
compaction=2}, and compares the findings against the committed baseline
(``analysis_baseline_torch.json`` at the repo root).  A finding whose
key is not baselined fails the run; update the baseline deliberately
with ``--update-baseline``.  ``--device`` defaults to the CUDA card (the
kernels and their CUDA-graph captures); ``--device cpu`` runs the
kernels' plain versions.

  scripts/lint_engine_torch.py --device cpu --ci   # the CPU gate
  scripts/lint_engine_torch.py --apps bfs,sssp --passes steplint
  scripts/lint_engine_torch.py --backends kernels  # one backend's cells
  scripts/lint_engine_torch.py --update-baseline
"""
import argparse
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.analysis import load_baseline  # noqa: E402
from repro_torch.analysis.findings import summarize  # noqa: E402
from repro_torch.analysis.runner import (APP_NAMES, BACKENDS,  # noqa: E402
                                         PASSES, run_all)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--apps", default=None,
                    help=f"comma-separated subset of {','.join(APP_NAMES)}")
    ap.add_argument("--passes", default=None,
                    help=f"comma-separated subset of {','.join(PASSES)}")
    ap.add_argument("--backends", default=None,
                    help=f"comma-separated subset of {','.join(BACKENDS)}")
    ap.add_argument("--device", default=None,
                    help="torch device of the runs (default: the CUDA card, "
                         "which must be present); 'cpu' for the CPU")
    ap.add_argument("--baseline",
                    default=str(REPO / "analysis_baseline_torch.json"),
                    help="committed baseline of accepted finding keys")
    ap.add_argument("--out", default=None,
                    help="write the full JSON report here")
    ap.add_argument("--ci", action="store_true",
                    help="CI mode: write --out (default "
                         "lint_report_torch.json), exit 1 on non-baselined "
                         "findings")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from this run's finding keys")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-cell progress lines")
    args = ap.parse_args(argv)

    def split(v):
        return v.split(",") if v else None
    say = (lambda _m: None) if args.quiet else \
        (lambda m: print(f"  [lint] {m}", flush=True))

    report = run_all(REPO, app_names=split(args.apps),
                     passes=split(args.passes), progress=say,
                     device=args.device, backends=split(args.backends))
    baseline = load_baseline(args.baseline)

    out = args.out or ("lint_report_torch.json" if args.ci else None)
    if out:
        pathlib.Path(out).write_text(report.to_json())
        print(f"report: {out} ({len(report.findings)} finding(s), "
              f"{len(report.matrix)} matrix cell(s))")

    if args.update_baseline:
        pathlib.Path(args.baseline).write_text(report.baseline_json())
        print(f"baseline updated: {args.baseline} "
              f"({len(set(report.keys()))} key(s))")
        return 0

    print(summarize(report.findings, baseline))
    new = report.new_vs_baseline(baseline)
    if new:
        print(f"\nFAIL: {len(new)} non-baselined finding(s) "
              f"(baseline: {args.baseline})")
        return 1
    print(f"\nOK: {len(report.findings)} finding(s), all baselined; "
          f"{len(report.matrix)} matrix cell(s) analyzed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
