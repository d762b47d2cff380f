"""Runtime executor budgets: the dynamic half of the port's reprolint.

The static rules check lexical discipline; ``compile_guard`` checks what
matters at run time — **how many executors each named cache built** inside
a region. The port has no compiler of its own to listen to: every executor
cache (``HSGDRunner``'s round caches, ``LLMRoundRunner``'s, the serving
engine's) reports each miss on one logger, ``common/executors.py``'s
``repro_torch.executors``, under the executor's name (``hsgd_round``,
``hsgd_cohort_round``, ``hsgd_robust_round``, ``llm_round``,
``serve_decode``, ...), as the reference's XLA logs each compile. The guard
listens there, so it needs no cache internals.

    with compile_guard(track=r"hsgd_cohort_round") as g:
        for A in (2, 4, 8, 4, 2):
            runner.cohort_round_fn(2, 1, A)
    assert g.total == 3          # one executor per cohort bucket

Budgets can be declared up front and enforced at region exit:

    with compile_guard(track=r"serve_", exact={"serve_decode": 1}):
        engine.generate(prompts, 8)   # raises CompileBudgetError on a miss
"""
from __future__ import annotations

import logging
import re
import threading
from collections import Counter
from typing import Dict, List, Optional, Union

from repro_torch.common.executors import LOGGER

__all__ = ["CompileBudgetError", "CompileGuard", "compile_guard"]


class CompileBudgetError(AssertionError):
    """A compile_guard region built more (or other) executors than budgeted."""


class _BuildLogHandler(logging.Handler):
    """Fans each executor build out to every active guard (guards nest)."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.guards: List["CompileGuard"] = []

    def emit(self, record: logging.LogRecord) -> None:
        name = getattr(record, "executor", None)
        if name is None:
            return
        for g in list(self.guards):
            g._record(name)


_lock = threading.Lock()
_handler = _BuildLogHandler()
_saved: Optional[dict] = None


def _install() -> None:
    """First guard in: let DEBUG records through the executor logger, attach
    the handler, and keep the records off the console for the region
    (restored on the last guard out)."""
    global _saved
    _saved = {"level": LOGGER.level, "propagate": LOGGER.propagate}
    LOGGER.setLevel(logging.DEBUG)
    LOGGER.addHandler(_handler)
    LOGGER.propagate = False


def _uninstall() -> None:
    global _saved
    if _saved is None:
        return
    LOGGER.removeHandler(_handler)
    LOGGER.setLevel(_saved["level"])
    LOGGER.propagate = _saved["propagate"]
    _saved = None


class CompileGuard:
    """Context manager counting executor builds by name.

    Parameters
    ----------
    track:
        Regex; only builds whose executor name matches are counted. Without
        it every build in the region counts.
    exact:
        Budget enforced at region exit. An int pins the total tracked
        count; a dict maps name-regexes to pinned counts. Violations raise
        :class:`CompileBudgetError` (an AssertionError, so pytest reports
        it as a plain failure).
    max_compiles:
        Upper bound on the total tracked count, enforced at exit.

    After exit, ``total``, ``names``, ``by_name`` and ``count(pattern)``
    remain readable for ≤-style assertions the budgets can't express.
    """

    def __init__(self, track: Optional[str] = None,
                 exact: Optional[Union[int, Dict[str, int]]] = None,
                 max_compiles: Optional[int] = None):
        self._track = re.compile(track) if track else None
        self._exact = exact
        self._max = max_compiles
        self.names: List[str] = []

    # -- recording ----------------------------------------------------------

    def _record(self, name: str) -> None:
        if self._track is not None and not self._track.search(name):
            return
        self.names.append(name)

    @property
    def total(self) -> int:
        return len(self.names)

    @property
    def by_name(self) -> Counter:
        return Counter(self.names)

    def count(self, pattern: str) -> int:
        pat = re.compile(pattern)
        return sum(1 for n in self.names if pat.search(n))

    # -- context protocol ---------------------------------------------------

    def __enter__(self) -> "CompileGuard":
        with _lock:
            if not _handler.guards:
                _install()
            _handler.guards.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _lock:
            if self in _handler.guards:
                _handler.guards.remove(self)
            if not _handler.guards:
                _uninstall()
        if exc_type is not None:
            return False
        self._enforce()
        return False

    # -- budgets ------------------------------------------------------------

    def _enforce(self) -> None:
        seen = dict(self.by_name)
        if self._max is not None and self.total > self._max:
            raise CompileBudgetError(
                f"executor budget exceeded: {self.total} built > "
                f"max_compiles={self._max}; saw {seen}")
        if self._exact is None:
            return
        if isinstance(self._exact, int):
            if self.total != self._exact:
                raise CompileBudgetError(
                    f"executor budget missed: expected exactly {self._exact} "
                    f"built, saw {self.total}: {seen}")
            return
        for pattern, want in self._exact.items():
            got = self.count(pattern)
            if got != want:
                raise CompileBudgetError(
                    f"executor budget missed for /{pattern}/: expected "
                    f"{want}, saw {got}; all tracked builds: {seen}")


def compile_guard(track: Optional[str] = None,
                  exact: Optional[Union[int, Dict[str, int]]] = None,
                  max_compiles: Optional[int] = None) -> CompileGuard:
    """Build a :class:`CompileGuard` region. See the class for semantics."""
    return CompileGuard(track=track, exact=exact, max_compiles=max_compiles)
