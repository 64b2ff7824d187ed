"""Import-graph dead-code report.

A copy of ``repro.analysis.deadcode`` (AST only): the port imports nothing of
the JAX package, whose package ``__init__`` pulls JAX in, and its lint
runner needs the pass in-package.  ``tests/test_torch_analysis.py`` holds
the copy against the original.

Walks ``import``/``from ... import`` statements (AST only — nothing is
executed) from the repo's entry points — ``tests/``, ``benchmarks/``,
``scripts/`` — and reports every module under ``src/repro/`` that no
entry point reaches.  Importing a submodule marks its ancestor packages
(their ``__init__`` runs), and package ``__init__`` re-exports propagate
reachability to what they import.

A module may opt out of the report by carrying a ``# seed: unused``
marker near the top of the file: that is the documented quarantine for
seed-time scaffolding that is intentionally kept but not wired up
(deleting it would lose reference value; importing it would hide real
dead code).  Quarantined modules are listed in the report's metadata but
produce no finding; an *unmarked* unreachable module is a
``dead-module`` finding.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Set, Tuple

from .findings import Finding

MARKER = "# seed: unused"
ENTRY_DIRS = ("tests", "benchmarks", "scripts")


def module_map(src_root: Path) -> Dict[str, Path]:
    """Dotted module name -> file for everything under ``src/``."""
    out: Dict[str, Path] = {}
    for p in sorted(src_root.rglob("*.py")):
        rel = p.relative_to(src_root).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts:
            out[".".join(parts)] = p
    return out


def _parents(name: str) -> List[str]:
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(1, len(parts))]


def imports_of(path: Path, modname: str, known: Set[str]) -> Set[str]:
    """Modules from ``known`` that ``path`` imports (absolute and
    relative forms; ``from X import a`` marks both X and X.a)."""
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return set()
    pkg_parts = modname.split(".")
    found: Set[str] = set()

    def note(name: str):
        if name in known:
            found.add(name)
        for par in _parents(name):
            if par in known:
                found.add(par)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                note(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative: level 1 = this package, 2 = parent, ...
                base_parts = pkg_parts[:len(pkg_parts) - node.level + 1] \
                    if path.name == "__init__.py" \
                    else pkg_parts[:len(pkg_parts) - node.level]
                base = ".".join(base_parts + ([node.module]
                                              if node.module else []))
            else:
                base = node.module or ""
            if base:
                note(base)
            for alias in node.names:
                if base and alias.name != "*":
                    note(f"{base}.{alias.name}")
    return found


def reachable_from(roots: List[Path], known: Dict[str, Path]) -> Set[str]:
    """Transitive closure of the import graph from the entry files."""
    names = set(known)
    seen: Set[str] = set()
    frontier: Set[str] = set()
    for root in roots:
        frontier |= imports_of(root, "", names)
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        seen.update(p for p in _parents(name) if p in names)
        frontier |= imports_of(known[name], name, names) - seen
    return seen


def is_quarantined(path: Path) -> bool:
    """True if a line near the top of the file IS the ``# seed: unused``
    marker (a whole comment line, so prose *mentioning* the marker — like
    this module's docstring — does not quarantine anything)."""
    try:
        head = path.read_text()[:2048]
    except OSError:
        return False
    return any(line.strip().startswith(MARKER)
               for line in head.splitlines())


def check_repo(repo_root) -> Tuple[List[Finding], Dict[str, List[str]]]:
    """Dead-module findings + {'dead': [...], 'quarantined': [...]}."""
    repo_root = Path(repo_root)
    known = module_map(repo_root / "src")
    roots = [p for d in ENTRY_DIRS
             for p in sorted((repo_root / d).rglob("*.py"))]
    live = reachable_from(roots, known)
    findings: List[Finding] = []
    dead, quarantined = [], []
    for name in sorted(set(known) - live):
        if is_quarantined(known[name]):
            quarantined.append(name)
            continue
        dead.append(name)
        findings.append(Finding(
            "deadcode", "dead-module", name,
            f"module '{name}' ({known[name].relative_to(repo_root)}) is "
            f"unreachable from tests/, benchmarks/ and scripts/: delete "
            f"it or quarantine with '{MARKER}'"))
    return findings, dict(dead=dead, quarantined=quarantined)
