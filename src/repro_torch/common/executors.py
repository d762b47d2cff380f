"""The port's executor-build log.

Every executor cache of the port (the HSGD runner's round caches, the LLM
round runner's, the serving engine's) reports each miss, one record per
executor built, on ``LOGGER`` under the executor's name (``hsgd_round``,
``hsgd_cohort_round``, ``llm_round``, ``serve_decode``, ...), as the
reference's XLA logs one record per compile. ``analysis.compile_guard``
counts these records. The records are at DEBUG level, so outside a guard
a build costs one level check.
"""
from __future__ import annotations

import logging

LOGGER = logging.getLogger("repro_torch.executors")


def built(name: str, key=None) -> None:
    """Report that the executor ``name`` was built for the bucket ``key``."""
    LOGGER.debug("built %s for bucket %r", name, key, extra={"executor": name})
