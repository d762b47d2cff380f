"""``ssm_discretize_ms_per_step`` reads the program's ``mamba1.discretize``
spans from the first ``ctx["rounds"]`` rounds recorded (the device-only
pass) per local step, and nothing from a program that records no such
span, as a parent without the discretize kernels does."""
import pytest

from hsgd_bench import spec
from hsgd_bench.tests.test_span_metrics import _ctx, _round, _row

METRIC = "ssm_discretize_ms_per_step"


def _with_discretize(scale, count=136):
    """A round of P 4 with ``count`` discretize spans of 0.4 ms × ``scale``."""
    return {**_round(scale), "mamba1.discretize": _row(count, 0.4 * count * scale)}


def test_reads_the_spans_per_local_step(monkeypatch):
    from repro_torch.common import spans
    mod = spec.metric_module(METRIC)
    assert mod.SPAN == "mamba1.discretize"
    monkeypatch.setattr(spans, "rounds", lambda: [_with_discretize(1.0), _with_discretize(2.0)])
    assert mod.read(_ctx()) == pytest.approx(0.4 * 136 / 4)
    monkeypatch.setattr(spans, "rounds", lambda: [_with_discretize(1.0), _with_discretize(3.0),
                                                  _with_discretize(2.0)])
    assert mod.read(_ctx(rounds=2)) == pytest.approx(0.4 * 136 * 4 / 8)


def test_reads_nothing_where_the_program_has_no_such_span(monkeypatch):
    from repro_torch.common import spans
    mod = spec.metric_module(METRIC)
    monkeypatch.setattr(spans, "rounds", lambda: [_round(1.0)])
    assert mod.read(_ctx()) is None
    monkeypatch.setattr(spans, "rounds", lambda: [_with_discretize(1.0)])
    assert mod.read({**_ctx(), "traced": {"device": [], "host": [], "busy_us": 0.0,
                                          "window_us": 1.0}}) is None
