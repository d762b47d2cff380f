"""The per-layer metrics that read the program's spans
(``repro_torch.common.spans``): each reads the first ``ctx["rounds"]``
rounds the program recorded, the pass traced with the device's activity
alone, and none of the host-traced pass after it; each reads nothing from
a trace without device activity or a table without device times."""
import pytest

from hsgd_bench import spec

SPAN_METRICS = {"exchange_ms_per_exchange": ("hsgd.exchange", 2),
                "global_agg_ms_per_round": ("hsgd.global_agg", 1),
                "hospital_grads_ms_per_step": ("hsgd.step.hospital", 4),
                "device_grads_ms_per_step": ("hsgd.step.device", 4),
                "sgd_update_ms_per_step": ("hsgd.step.update", 4)}


def _row(count, ms):
    return {"count": count, "device_ms": ms, "self_device_ms": ms, "host_ms": ms,
            "launches": 0}


def _round(scale, device=True):
    """One round of P 4, Q 2, two pods, its device times ``scale`` × a base."""
    base = {"hsgd.round": (1, 3360.0), "hsgd.global_agg": (1, 30.0), "hsgd.exchange": (2, 80.0),
            "hsgd.step": (8, 3200.0), "hsgd.step.hospital": (8, 1800.0),
            "hsgd.step.device": (8, 1200.0), "hsgd.step.update": (8, 160.0)}
    return {n: _row(c, ms * scale if device else None) for n, (c, ms) in base.items()}


def _ctx(rounds=1):
    traced = {"device": [{"cat": "kernel", "name": "k", "ts": 0.0, "dur": 1.0}], "host": [],
              "busy_us": 1.0, "window_us": 2.0}
    return {"traced": traced, "rounds": rounds, "steps": 4 * rounds, "exchanges": 2 * rounds}


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_reads_the_device_only_pass_alone(monkeypatch, metric):
    from repro_torch.common import spans
    name, per_round = SPAN_METRICS[metric]
    mod = spec.metric_module(metric)
    assert mod.SPAN == name
    # the device-only pass, then the host-traced pass at twice the time
    monkeypatch.setattr(spans, "rounds", lambda: [_round(1.0), _round(2.0)])
    want = _round(1.0)[name]["device_ms"] / per_round
    assert mod.read(_ctx()) == pytest.approx(want)
    monkeypatch.setattr(spans, "rounds", lambda: [_round(1.0), _round(3.0), _round(2.0),
                                                  _round(5.0)])
    assert mod.read(_ctx(rounds=2)) == pytest.approx(2 * want)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_reads_nothing_without_device_time(monkeypatch, metric):
    from repro_torch.common import spans
    mod = spec.metric_module(metric)
    monkeypatch.setattr(spans, "rounds", lambda: [_round(1.0, device=False)])
    assert mod.read(_ctx()) is None
    monkeypatch.setattr(spans, "rounds", lambda: [])
    assert mod.read(_ctx()) is None
    monkeypatch.setattr(spans, "rounds", lambda: [_round(1.0)])
    assert mod.read({**_ctx(), "traced": {"device": [], "host": [], "busy_us": 0.0,
                                          "window_us": 1.0}}) is None
