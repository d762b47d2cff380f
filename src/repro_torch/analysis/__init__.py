"""reprolint for the port: static executor and timing discipline, and
runtime executor budgets.

The port's performance claims rest on invariants nothing checks by itself:
one executor per bucket, a consumed state rebound, no host sync inside a
round, single-seed determinism, honest timing of asynchronous CUDA work.
``reprolint`` checks the lexical half at review time (``rules.py``, one
rule per bug class), and ``compile_guard`` the runtime half: exact counts
of executors built, by name.

Usage:

  python -m repro_torch.analysis src/repro_torch chip_smoke.py           # lint
  python -m repro_torch.analysis --check src/repro_torch chip_smoke.py   # CI
  python -m repro_torch.analysis --write-baseline src/repro_torch ...    # accept

  from repro_torch.analysis import compile_guard
  with compile_guard(track=r"hsgd_round", exact=1):
      runner.round_fn(4, 2)(state, data, w, 0.05)
"""
from repro_torch.analysis.compile_guard import CompileBudgetError, CompileGuard, compile_guard
from repro_torch.analysis.linter import Finding, lint_paths, lint_source
from repro_torch.analysis.rules import RULES

__all__ = [
    "CompileBudgetError",
    "CompileGuard",
    "compile_guard",
    "Finding",
    "lint_paths",
    "lint_source",
    "RULES",
]
