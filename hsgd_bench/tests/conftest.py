"""Smoke-size cells for the harness's CPU tests: a workload of
``BENCHMARK.json`` with its model cut to the port's smoke widths and a short
sequence, the rest (cadence, limits, metrics) as the benchmark has it."""
import dataclasses
import time

import pytest
import torch

from hsgd_bench import spec

CELLS = tuple(w["name"] for w in spec.benchmark()["workloads"])


def smoke_cell(name: str, seq: int = 8, root=spec.ROOT):
    from repro_torch.common.config import get_config
    cell = spec.load_cell(name, spec.benchmark(root), root)
    model = dataclasses.asdict(get_config(cell["config"]["model"]["name"], smoke=True))
    model["dtype"] = "float32"
    cell["config"] = {**cell["config"], "model": model}
    cell["traffic"] = {**cell["traffic"], "seq": seq, "pool_rounds": 1}
    return cell


@pytest.fixture
def cpu_run():
    """run(cell, seed, trace=False) -> the result line's object, on the CPU."""
    from hsgd_bench import harness
    torch.set_num_threads(4)

    def run(cell, seed=2 ** 33 + 5, trace=False):
        return harness.run(cell, seed, 0.01, trace, torch.device("cpu"), time.perf_counter(),
                           log=lambda msg: None)

    return run


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
