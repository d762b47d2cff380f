"""A whole run, the card's look skipped, with the timed path broken
underneath: ``correct`` has to come out false for each fault a training
cell can have, and true with nothing broken. The cell's own limits, at the
port's smoke widths on the CPU."""
import pytest

from repro_torch.launch import steps
from hsgd_bench.tests.conftest import CELLS, smoke_cell


def unchanged_state(monkeypatch):
    """Every step returns its state as it got it."""
    monkeypatch.setattr(steps, "_apply_update", lambda params, grads, lr: params)


def half_batch(monkeypatch):
    """Each step's loss and gradients over half its batch, the mean over the rest."""
    grads = steps.hybrid_grads

    def half(model, params, stale, batch):
        h = batch["y"].shape[0] // 2
        stale = {"theta0": stale["theta0"], "z1": stale["z1"][:h], "z2": stale["z2"][:h]}
        return grads(model, params, stale, {k: v[:h] for k, v in batch.items()})

    monkeypatch.setattr(steps, "hybrid_grads", half)


def exchange_uncompressed(monkeypatch):
    """The exchange sends its message without compression."""
    monkeypatch.setattr(steps, "compress_pytree", lambda tree, *a, **k: tree)


def token_altered(monkeypatch):
    """One token of every step's hospital input altered where the step reads it."""
    grads = steps.hybrid_grads

    def altered(model, params, stale, batch):
        x1 = batch["x1"].clone()
        x1[0, 0] = (x1[0, 0] + 1) % 2
        return grads(model, params, stale, {**batch, "x1": x1})

    monkeypatch.setattr(steps, "hybrid_grads", altered)


FAULTS = {"none": None, "unchanged_state": unchanged_state, "half_batch": half_batch,
          "exchange_uncompressed": exchange_uncompressed, "token_altered": token_altered}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(cpu_run, monkeypatch, cell, fault):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    out = cpu_run(smoke_cell(cell))
    assert out["correct"] is (fault == "none"), out["checks"]
