"""The plain reference against the port at smoke widths, on the CPU.

The reference imports nothing of the port; these tests import both and
feed them the same weights and tokens.
"""
import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from hsgd_bench import counts, tokens
from hsgd_bench import weights as W
from hsgd_bench.reference import compress as RC
from hsgd_bench.reference import model as RM
from hsgd_bench.reference import round as RR
from hsgd_bench.reference.scan import recurrence
from repro_torch.common.config import get_config
from repro_torch.core.compression import compress_rows_ref
from repro_torch.kernels.ssm_scan import ssm_scan_ref
from repro_torch.launch.steps import LLMRoundRunner
from repro_torch.models import ssm as S
from repro_torch.models.split_model import llm_hybrid

ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def smoke(arch):
    cfg = get_config(arch, smoke=True)
    d = dataclasses.asdict(cfg)
    d["dtype"] = "float32"
    return cfg, d


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_layout_is_the_programs(arch, size):
    cfg = get_config(arch, smoke=size == "smoke")
    if size == "full" and arch == "falcon-mamba-7b":
        cfg = cfg.replace(num_layers=16)
    ours = {path: spec[0] for path, spec in W.leaves(RM.param_layout(dataclasses.asdict(cfg)))}
    specs = llm_hybrid(cfg, n_tower=1, remat=False).specs()
    assert ours == {path: tuple(spec.shape) for path, spec in RR.leaves(specs)}


def test_recurrence_against_autograd_and_the_port():
    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 9, 3, 4, generator=g, dtype=torch.float64) * 0.9 + 0.05
    b = torch.randn(2, 9, 3, 4, generator=g, dtype=torch.float64)
    a.requires_grad_()
    b.requires_grad_()
    hs = recurrence(a, b)
    h, naive = torch.zeros(2, 3, 4, dtype=torch.float64), []
    for t in range(9):
        h = a[:, t] * h + b[:, t]
        naive.append(h)
    naive = torch.stack(naive, 1)
    w = torch.randn(naive.shape, generator=g, dtype=torch.float64)
    assert torch.equal(hs, naive)
    ga = torch.autograd.grad((hs * w).sum(), (a, b))
    gn = torch.autograd.grad((naive * w).sum(), (a, b))
    for x, y in zip(ga, gn):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
    af, bf = a.detach().float(), b.detach().float()
    port, _ = ssm_scan_ref(af.reshape(2, 9, 12), bf.reshape(2, 9, 12), torch.zeros(2, 12))
    ours = recurrence(af, bf)
    assert torch.equal(ours.reshape(2, 9, 12), port)


def test_broadcast_decay_gradient():
    """A per-head decay broadcast over the state sums its gradient."""
    g = torch.Generator().manual_seed(1)
    a = (torch.rand(2, 5, 3, 1, 1, generator=g, dtype=torch.float64) * 0.9).requires_grad_()
    b = torch.randn(2, 5, 3, 2, 4, generator=g, dtype=torch.float64)
    full = a.expand(2, 5, 3, 2, 4).clone().detach().requires_grad_()
    w = torch.randn(2, 5, 3, 2, 4, generator=g, dtype=torch.float64)
    (ga,) = torch.autograd.grad((recurrence(a, b) * w).sum(), (a,))
    (gf,) = torch.autograd.grad((recurrence(full, b) * w).sum(), (full,))
    torch.testing.assert_close(ga, gf.sum(dim=(3, 4), keepdim=True), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k_frac,levels", [(0.25, 128), (0.25, 0), (1.0, 16), (0.1, 2)])
def test_compress_is_the_ports_plain_version(k_frac, levels):
    g = torch.Generator().manual_seed(2)
    for shape in ((7, 33), (3, 4, 16), (5,), (2, 1024)):
        x = torch.randn(shape, generator=g) * torch.rand(shape, generator=g)
        x.view(-1)[::5] = 0.0
        n = shape[-1]
        k = RC.keep_count(k_frac, n)
        want = compress_rows_ref(x.reshape(-1, n), k, levels).reshape(shape)
        assert torch.equal(RC.compress_leaf(x, k_frac, levels), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_is_the_ports(arch):
    cfg, d = smoke(arch)
    layout = RM.param_layout(d)["theta0"]["layers"]["mamba"]
    p = {name: spec for name, spec in layout.items()}
    gen = torch.Generator().manual_seed(3)
    params = {name: (torch.randn(spec[0][1:], generator=gen) * 0.3 if spec[1] != "ones"
                     else torch.ones(spec[0][1:])) for name, spec in p.items()}
    params["a_log"] = params["a_log"].abs() * 0.1
    x = torch.randn(2, 21, cfg.d_model, generator=gen)
    port, _ = S.mamba_forward(params, x, cfg)
    ours = (RM.mamba1 if cfg.ssm_version == 1 else RM.mamba2)(params, x, RM.dims(d))
    torch.testing.assert_close(ours, port, rtol=1e-5, atol=1e-5)


def _batch(d, seq, seed, device="cpu"):
    tr = {"P": 4, "Q": 2, "pods": 2, "batch": 2, "seq": seq, "drift": 17, "p_drift": 0.7}
    return tr, tokens.rounds(tr, d["vocab_size"], seed, 2, device)


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_gradients_are_the_ports(arch):
    cfg, d = smoke(arch)
    layout = RM.param_layout(d)
    params = W.draw(layout, 7, 1, "cpu")
    pod = RR.tree_map(lambda x: x[0], params)
    _, rounds = _batch(d, 24, 7)
    b = {k: v[0, 0] for k, v in rounds[0].items()}
    model = llm_hybrid(cfg, n_tower=1, remat=False)

    def both(fn_port, fn_ref, tree):
        leaves = [(p, x.clone().requires_grad_()) for p, x in RR.leaves(tree)]
        rebuilt = {}
        for path, x in leaves:
            node = rebuilt
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = x
        lp, lr = fn_port(rebuilt), fn_ref(rebuilt)
        gp = torch.autograd.grad(lp, [x for _, x in leaves], retain_graph=True)
        gr = torch.autograd.grad(lr, [x for _, x in leaves])
        torch.testing.assert_close(lr, lp, rtol=1e-6, atol=1e-6)
        for x, y in zip(gr, gp):
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6)

    z2 = RM.tower(d, pod["theta2"], b["x2"]).detach()
    both(lambda t: model.loss(t["theta0"], model.h1(t["theta1"], b["x1"]), z2, b["y"]),
         lambda t: RM.loss(d, t["theta0"], RM.tower(d, t["theta1"], b["x1"]), z2, b["y"]),
         {"theta0": pod["theta0"], "theta1": pod["theta1"]})


@pytest.mark.parametrize("arch", ARCHS)
def test_round_is_the_ports(arch):
    """Two C-HSGD rounds, two pods, k 0.25 and b 128: the same losses and
    leaves (a quantization code may flip at a rounding boundary)."""
    cfg, d = smoke(arch)
    layout = RM.param_layout(d)
    tr, rounds = _batch(d, 16, 11)
    fn = LLMRoundRunner(llm_hybrid(cfg, n_tower=1, remat=False), n_pods=2).round_fn(
        4, 2, 0.25, 128, collect_stats=False)
    port = W.draw(layout, 11, 2, "cpu")
    ref = W.draw(layout, 11, 2, "cpu")
    pods = [RR.tree_map(lambda x, g=g: x[g], ref) for g in range(2)]
    eta = float(np.float32(0.01))
    for batch in rounds:
        port, lp = fn(port, batch, 0.01)
        lr = RR.run_round(RM, d, pods, batch, eta, 4, 2, 0.25, 128)
        torch.testing.assert_close(lr, lp, rtol=1e-5, atol=0)
    for (path, x), (_, y) in zip(RR.leaves(ref), RR.leaves(port)):
        scale = float(y.abs().max()) or 1.0
        assert float((x - y).abs().max()) <= 2e-3 * scale, path


def test_reference_imports_nothing_of_the_port():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax", "jaxlib"), \
                    (path.name, name)


def test_counts_cover_the_mixers():
    """A finite, positive count for each mixer at full width: the cell's Mamba-1
    configuration and the port's zamba2-2.7b."""
    import json
    root = Path(__file__).resolve().parents[1]
    tr = json.loads((root / "traffic" / "seq256.json").read_text())
    falcon = json.loads((root / "configs" / "falcon-mamba-7b-16L.json").read_text())["model"]
    for cfg in (falcon, dataclasses.asdict(get_config("zamba2-2.7b"))):
        flops = counts.round_flops(RM, cfg, tr)
        assert math.isfinite(flops) and flops > 0
