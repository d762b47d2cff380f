"""The port's spans: named stretches of its training path, timed on the
device while a profiler traces.

``span(name)`` is a context manager. With no ``torch.profiler`` session
active it reads the profiler's enabled flag and does nothing else: no
``record_function`` (which costs far more than the flag, even with no
profiler), no CUDA event, no record. While a session is active it

  * enters ``torch.profiler.record_function(name)``, so every trace holds
    the span on its own clock (``launch/profile_serve.annotated_kernels``
    gives such a range the kernels launched inside it);
  * on a CUDA device, records a start and an end
    ``torch.cuda.Event(enable_timing=True)`` on the current stream, and
    never synchronizes;
  * takes the host's start and end from ``time.perf_counter_ns``;
  * notes its parent, the innermost span open when it entered, and its
    round, the id of the enclosing ``hsgd.round`` span, which every span of
    that round shares;
  * counts the port's own kernel launches inside it, the change of
    ``kernels.launch_counts`` over the span.

Records stay in memory until ``clear()``. ``rounds()`` waits on the events
and gives one entry per traced round, in the order traced; an entry maps
each span name to its ``count``, ``device_ms``, ``self_device_ms`` (its own
device time less its children's), ``host_ms`` and ``launches``, summed over
the spans of that name. ``outside()`` is the same table for the spans of no
round (the MoE ranges while serving). Device times are None where CUDA was
not in use.

Backward passes: on a CUDA device ``torch.autograd.grad`` launches the
backward's kernels from the autograd engine's own thread while the caller
waits. The event pair brackets the whole call on the stream, so
``device_ms`` covers the backward. In a trace the range lies on the calling
thread and holds only that thread's launch calls; the engine thread's
launches fall inside the range's time, on their own thread. The stack of
open spans is one for the process: a span entered on the engine thread
(a forward recomputed in the backward) nests under the caller's.
"""
from __future__ import annotations

import itertools
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import launch_counts

ROUND = "hsgd.round"

_profiling = torch._C._autograd._profiler_enabled
_records: List["_Record"] = []  # every span entered while tracing, in entry order
_open: List["_Record"] = []  # the spans open now, innermost last
_round_ids = itertools.count(1)


class _Record:
    __slots__ = ("name", "parent", "round", "range", "start", "end", "t0", "t1", "n0", "n1")

    def __init__(self, name: str, parent: Optional["_Record"]):
        self.name, self.parent = name, parent
        if name == ROUND:
            self.round = next(_round_ids)
        else:
            self.round = parent.round if parent is not None else None
        self.range = torch.profiler.record_function(name)
        self.range.__enter__()
        self.start = self.end = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t1 = self.n1 = None
        self.n0 = sum(launch_counts.values())
        self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        self.t1 = time.perf_counter_ns()
        self.n1 = sum(launch_counts.values())
        if self.end is not None:
            self.end.record()
        self.range.__exit__(None, None, None)

    def device_ms(self) -> Optional[float]:
        if self.end is None:
            return None
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


class span:
    """``with span(name):`` -- a span of the port; see the module's docstring."""

    __slots__ = ("name", "_rec")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self):
        if _profiling():
            self._rec = _Record(self.name, _open[-1] if _open else None)
            _records.append(self._rec)
            _open.append(self._rec)
        return self

    def __exit__(self, *exc) -> bool:
        rec, self._rec = self._rec, None
        if rec is not None:
            rec.close()
            _open.remove(rec)
        return False


def clear() -> None:
    """Forget every record (spans open now keep running, unrecorded)."""
    _records.clear()


def _tables() -> Dict[Optional[int], Dict[str, Dict]]:
    """{round id or None: {name: totals}} of the closed spans."""
    done = [r for r in _records if r.t1 is not None]
    own = {id(r): r.device_ms() for r in done}
    children = defaultdict(float)
    for r in done:
        if r.parent is not None and own[id(r)] is not None:
            children[id(r.parent)] += own[id(r)]
    out: Dict[Optional[int], Dict[str, Dict]] = {}
    for r in done:
        row = out.setdefault(r.round, {}).setdefault(r.name, {
            "count": 0, "device_ms": None, "self_device_ms": None, "host_ms": 0.0,
            "launches": 0})
        row["count"] += 1
        row["host_ms"] += (r.t1 - r.t0) / 1e6
        row["launches"] += r.n1 - r.n0
        ms = own[id(r)]
        if ms is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + ms
            row["self_device_ms"] = (row["self_device_ms"] or 0.0) + ms - children[id(r)]
    return out


def rounds() -> List[Dict[str, Dict]]:
    """One {span name: {count, device_ms, self_device_ms, host_ms,
    launches}} a traced round, in the order traced."""
    tables = _tables()
    return [tables[k] for k in sorted(k for k in tables if k is not None)]


def outside() -> Dict[str, Dict]:
    """The same totals for the spans outside any round."""
    return _tables().get(None, {})


def summed(entries: List[Dict[str, Dict]]) -> Dict[str, Dict]:
    """The totals of several rounds' entries, by span name."""
    out: Dict[str, Dict] = {}
    for entry in entries:
        for name, row in entry.items():
            acc = out.setdefault(name, dict.fromkeys(row))
            for key, value in row.items():
                if value is not None:
                    acc[key] = (acc[key] or 0) + value
    return out
