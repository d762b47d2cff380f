"""File walking, suppressions and baseline bookkeeping for the port's
reprolint (``repro/analysis/linter.py``).

Suppressions:

  x = np.random.randn(3)        # reprolint: disable=RP5
  # reprolint: disable=RP4,RP6      (several rules, same line)
  # reprolint: disable                (every rule, that line)
  # reprolint: disable-file=RP6      (anywhere in the file: whole file)

Baseline: a JSON file of accepted findings keyed by a line-number-free
fingerprint (rule, path, stripped source text), so unrelated edits above a
baselined site don't resurrect it. ``--check`` fails on findings not in the
baseline and on stale entries, so the file shrinks as debt is paid down.
The baseline is written atomically (a temporary file, then ``os.replace``).
"""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.rules import RULES, FileContext, Finding
from repro_torch.common.io import atomic_write_text

__all__ = [
    "Finding", "lint_source", "lint_paths", "iter_python_files",
    "fingerprint", "load_baseline", "write_baseline", "apply_baseline",
]

_SUPPRESS_RE = re.compile(r"#\s*reprolint:\s*disable(?:=([A-Z0-9,\s]+))?")
_SUPPRESS_FILE_RE = re.compile(r"#\s*reprolint:\s*disable-file=([A-Z0-9,\s]+)")

_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "node_modules",
              ".venv", "venv", "build", "dist"}


def _parse_suppressions(source: str) -> Tuple[Dict[int, Optional[Set[str]]], Set[str]]:
    """Returns (line -> suppressed rule ids or None for "all", file-wide set)."""
    per_line: Dict[int, Optional[Set[str]]] = {}
    file_wide: Set[str] = set()
    for i, line in enumerate(source.splitlines(), start=1):
        if "reprolint" not in line:
            continue
        m = _SUPPRESS_FILE_RE.search(line)
        if m:
            file_wide |= {r.strip() for r in m.group(1).split(",") if r.strip()}
            continue
        m = _SUPPRESS_RE.search(line)
        if m:
            per_line[i] = ({r.strip() for r in m.group(1).split(",") if r.strip()}
                           if m.group(1) else None)  # None: all rules
    return per_line, file_wide


def _suppressed(f: Finding, per_line: Dict[int, Optional[Set[str]]],
                file_wide: Set[str]) -> bool:
    if f.rule in file_wide:
        return True
    if f.line in per_line:
        rules = per_line[f.line]
        return rules is None or f.rule in rules
    return False


def lint_source(source: str, path: str = "<string>",
                only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one module's source. ``only`` restricts to a subset of rule ids.
    Syntax errors yield a single synthetic ``SYNTAX`` finding rather than
    raising, so one broken file can't take down a sweep."""
    try:
        ctx = FileContext(path, source)
    except SyntaxError as e:
        return [Finding("SYNTAX", path, e.lineno or 1, e.offset or 0,
                        f"file does not parse: {e.msg}")]
    per_line, file_wide = _parse_suppressions(source)
    findings: List[Finding] = []
    for rule_id, rule in RULES.items():
        if only and rule_id not in only:
            continue
        findings.extend(f for f in rule.check(ctx) if not _suppressed(f, per_line, file_wide))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        root = Path(p)
        if root.is_file() and root.suffix == ".py":
            out.append(root)
        elif root.is_dir():
            out.extend(f for f in sorted(root.rglob("*.py")) if not (_SKIP_DIRS & set(f.parts)))
    return out


def lint_paths(paths: Iterable[str], only: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        try:
            source = f.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        findings.extend(lint_source(source, str(f), only=only))
    return findings


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def fingerprint(f: Finding) -> str:
    """Line-number-free identity: survives edits elsewhere in the file."""
    return hashlib.sha1(f"{f.rule}|{f.path}|{f.source}".encode()).hexdigest()[:16]


def load_baseline(path: str) -> Dict[str, dict]:
    p = Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = [
        {"fingerprint": fingerprint(f), "rule": f.rule, "path": f.path,
         "line": f.line, "message": f.message, "source": f.source}
        for f in findings
    ]
    # stable order + dedup (several findings can share one source line)
    seen: Set[str] = set()
    unique = []
    for e in sorted(entries, key=lambda e: (e["path"], e["line"], e["rule"])):
        if e["fingerprint"] not in seen:
            seen.add(e["fingerprint"])
            unique.append(e)
    atomic_write_text(path, json.dumps(
        {"comment": "reprolint accepted findings of the port — shrink me, don't grow me",
         "findings": unique}, indent=2) + "\n")


def apply_baseline(findings: Sequence[Finding],
                   baseline: Dict[str, dict]) -> Tuple[List[Finding], List[dict]]:
    """Split into (new findings, stale baseline entries)."""
    current = {fingerprint(f) for f in findings}
    new = [f for f in findings if fingerprint(f) not in baseline]
    stale = [e for fp, e in baseline.items() if fp not in current]
    return new, stale
