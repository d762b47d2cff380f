"""Terminal and JSON reporters for the port's reprolint findings."""
from __future__ import annotations

import json
from collections import Counter
from typing import Sequence, TextIO

from repro_torch.analysis.rules import RULES, Finding


def render_terminal(findings: Sequence[Finding], stale: Sequence[dict], out: TextIO) -> None:
    last_path = None
    for f in findings:
        if f.path != last_path:
            out.write(f"\n{f.path}\n")
            last_path = f.path
        out.write(f"  {f.line}:{f.col}  {f.rule}  {f.message}\n")
        if f.source:
            out.write(f"      | {f.source}\n")
    if stale:
        out.write("\nstale baseline entries (fixed or moved — remove them):\n")
        for e in stale:
            out.write(f"  {e['path']}:{e.get('line', '?')}  {e['rule']}  "
                      f"{e.get('source', '')}\n")
    by_rule = Counter(f.rule for f in findings)
    if findings:
        parts = ", ".join(f"{r}×{n}" for r, n in sorted(by_rule.items()))
        out.write(f"\n{len(findings)} finding(s): {parts}\n")
    else:
        out.write("reprolint: clean\n")


def render_json(findings: Sequence[Finding], stale: Sequence[dict], out: TextIO) -> None:
    payload = {
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
             "message": f.message, "source": f.source}
            for f in findings
        ],
        "stale_baseline": list(stale),
        "counts": dict(Counter(f.rule for f in findings)),
        "total": len(findings),
    }
    out.write(json.dumps(payload, indent=2) + "\n")


def render_rule_list(out: TextIO) -> None:
    for rule_id, rule in sorted(RULES.items(), key=lambda kv: int(kv[0][2:])):
        out.write(f"{rule_id}  {rule.title}\n")
        for line in rule.doc.splitlines():
            out.write(f"      {line.strip()}\n")
        out.write("\n")
