"""Findings and reports: the common currency of the analysis passes.

A copy of ``repro.analysis.findings`` (numpy only): the port imports nothing of
the JAX package, whose package ``__init__`` pulls JAX in.
``tests/test_torch_obs.py`` holds the copy against the original.

A :class:`Finding` is one violated property at one site.  Its identity
for baseline comparison is ``(pass_name, rule, where)`` — deliberately
excluding the human-readable message, so cosmetic message changes (or
counts embedded in them) do not churn the committed baseline.

A :class:`Report` is the JSON document ``scripts/lint_engine.py`` emits:
the full finding list plus the matrix that produced it.  CI compares the
report against the committed baseline (``analysis_baseline.json``) and
fails on findings whose key is not baselined.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated property at one site."""

    pass_name: str        # 'jaxprlint' | 'pallas_races' | 'invariants' | 'deadcode'
    rule: str             # e.g. 'host-sync', 'scatter-mode', 'reprice-ratio'
    where: str            # site: 'bfs/jnp/mono', 'segment_combine:add', module
    message: str          # human-readable detail (not part of the key)
    severity: str = "error"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")

    @property
    def key(self) -> str:
        """Baseline identity: pass:rule:where (message excluded)."""
        return f"{self.pass_name}:{self.rule}:{self.where}"

    def as_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "Finding":
        return cls(pass_name=d["pass_name"], rule=d["rule"],
                   where=d["where"], message=d.get("message", ""),
                   severity=d.get("severity", "error"))


@dataclasses.dataclass
class Report:
    """A lint run's full output: findings + what was analyzed."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    matrix: List[str] = dataclasses.field(default_factory=list)
    passes: List[str] = dataclasses.field(default_factory=list)

    def extend(self, findings: Sequence[Finding]) -> "Report":
        self.findings.extend(findings)
        return self

    def keys(self) -> List[str]:
        return [f.key for f in self.findings]

    def new_vs_baseline(self, baseline_keys) -> List[Finding]:
        """Findings not covered by the baseline (what fails CI)."""
        base = set(baseline_keys)
        return [f for f in self.findings if f.key not in base]

    def to_json(self) -> str:
        return json.dumps(
            dict(findings=[f.as_dict() for f in self.findings],
                 matrix=list(self.matrix), passes=list(self.passes)),
            indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "Report":
        d = json.loads(text)
        return cls(findings=[Finding.from_dict(f) for f in d["findings"]],
                   matrix=list(d.get("matrix", ())),
                   passes=list(d.get("passes", ())))

    def baseline_json(self) -> str:
        """The committed-baseline form: sorted finding keys only."""
        return json.dumps(dict(keys=sorted(set(self.keys()))),
                          indent=2) + "\n"


def load_baseline(path) -> List[str]:
    """Read a committed baseline file -> finding keys.  A missing file is
    an empty baseline (every finding fails CI)."""
    try:
        with open(path) as fh:
            d = json.load(fh)
    except FileNotFoundError:
        return []
    return list(d.get("keys", ()))


def summarize(findings: Sequence[Finding],
              baseline_keys: Optional[Sequence[str]] = None) -> str:
    """One human-readable block per finding, baseline-annotated."""
    base = set(baseline_keys or ())
    if not findings:
        return "no findings"
    lines = []
    for f in sorted(findings, key=lambda f: f.key):
        mark = " [baselined]" if f.key in base else ""
        lines.append(f"{f.severity.upper():7s} {f.pass_name}:{f.rule} "
                     f"@ {f.where}{mark}\n        {f.message}")
    return "\n".join(lines)
