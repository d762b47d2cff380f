"""Crash-safe small-file IO: write-to-temp + ``os.replace`` commit
(``repro/common/io.py``).

A coordinator preemption mid-write must never leave a torn manifest or a
half-serialized JSON file behind: ``os.replace`` is atomic on POSIX, so
readers observe either the old file or the complete new one, never a prefix.
"""
from __future__ import annotations

import json
import os
from typing import Any


def atomic_write_bytes(path: str, payload: bytes) -> None:
    """Write ``payload`` to ``path`` atomically (temp file + ``os.replace``)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj: Any, indent: int = 1) -> None:
    """Serialize ``obj`` and commit it to ``path`` in one atomic rename."""
    atomic_write_text(path, json.dumps(obj, indent=indent))
