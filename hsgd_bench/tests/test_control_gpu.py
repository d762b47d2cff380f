"""The control on the card: the reference computed with TF32 products, where
the configurations state fp32 with TF32 off, put in the program's place,
has to fail the cell's limits; the program itself has to pass them. At the
cells' published widths with the depth cut to two layers and the sequence to
64 tokens, so that a test run holds it.

  python -m pytest hsgd_bench/tests -m gpu
"""
import pytest
import torch

from hsgd_bench import check, harness, spec, tokens
from hsgd_bench.tests.conftest import CELLS


def small_cell(name):
    cell = spec.load_cell(name, spec.benchmark())
    cell["config"] = {**cell["config"], "model": {**cell["config"]["model"], "num_layers": 2}}
    cell["traffic"] = {**cell["traffic"], "seq": 64}
    return cell


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3])
def test_control_fails_and_program_passes(cuda_device, name, seed):
    from repro_torch.common.backend import resolve_device
    resolve_device("cuda")
    cell = small_cell(name)
    tr = cell["traffic"]
    batches = tokens.rounds(tr, cell["config"]["model"]["vocab_size"], seed, tr["check_rounds"],
                            cuda_device)
    prog = harness.Program(cell, seed, cuda_device)
    got = prog.check_rounds(batches)
    del prog
    torch.cuda.empty_cache()
    ref = harness.reference_rounds(cell, seed, batches, cuda_device)
    ctl = harness.reference_rounds(cell, seed, batches, cuda_device, tf32=True)
    for side, want in ((got, True), (ctl, False)):
        values = check.numbers(side[0], ref[0], side[1], ref[1], tr["Q"])
        ok, checks = check.verdict(values, cell["limits"])
        assert ok is want, checks
