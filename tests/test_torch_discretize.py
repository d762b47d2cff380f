"""The Mamba-1 discretize kernels (``csrc/mamba1_discretize.cu``) against
the eager chain they replace, on the card (``gpu`` marker).

The forward kernel's a = exp(dt·A) and b = (dt·x)·B are bit-identical to
the chain's (each product rounded apart, the same ``expf``). The backward
kernel's ∂dt, ∂x, ∂B, ∂A round every product as autograd over the chain
does and differ only in the order of their sums (over N, over d_inner, over
(B, K)): each is held within 1e-5 of the sum of its terms' magnitudes, in
float64. At the training chunk the two orders part by 2.7e-7 of that
magnitude on the card, and a sum that dropped one of ∂B's 8 192 terms
would be off by about 1/8 192 = 1.2e-4 of it, so 1e-5 lies between what
the order moves and what a wrong sum moves. Two runs are
bit-identical (no atomics). Inputs are laid out as ``mamba1_forward``
hands them over: dt and x a chunk view of a longer [B, T, d] tensor, B the
first N columns of the [B, K, 2N + R] projection. Imports no JAX, so the
tests run on the card alone; the CPU tests of the route are in
``tests/test_torch_ssm.py``.
"""
import pytest
import torch

from repro_torch.common.config import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.mamba1_discretize import (Mamba1Discretize, mamba1_discretize_cuda,
                                                   mamba1_discretize_ref)
from repro_torch.models import ssm as S

SUM_TOL = 1e-5
# (B, K, d_inner, N): falcon-mamba-7b's training chunk and decode step, K and
# d off the kernels' steps and tiles, N odd, N with an idle lane a row, N 64
CASES = [(2, 256, 8192, 16), (2, 1, 8192, 16), (3, 37, 200, 16), (2, 45, 33, 7),
         (2, 20, 50, 12), (1, 64, 300, 64)]
DISCRETIZE_KEYS = ("mamba1_discretize", "mamba1_discretize_bwd", "mamba1_discretize_sum")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    """The bases of dt, x ([B, 2K, d]) and B ([B, K, 2N + 5]), A [d, N] and
    the scan's gradients ∂a, ∂b [B, K, d, N]."""
    B, K, d, N = shape
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    dt = torch.rand(B, 2 * K, d, generator=g, device=dev) * 0.5
    x = torch.randn(B, 2 * K, d, generator=g, device=dev)
    Bm = torch.randn(B, K, 2 * N + 5, generator=g, device=dev)
    A = -torch.exp(torch.randn(d, N, generator=g, device=dev) * 0.5)
    d_a = torch.randn(B, K, d, N, generator=g, device=dev)
    d_b = torch.randn(B, K, d, N, generator=g, device=dev)
    return (dt, x, Bm, A), d_a, d_b


def _views(dt, x, Bm, A):
    """dt and x as a chunk view of their base, B its first N columns."""
    K, N = Bm.shape[1], A.shape[1]
    return dt[:, K:], x[:, :K], Bm[..., :N], A


def _magnitudes(dt, x, Bm, A, d_a, d_b):
    """Each gradient's sum of |terms|, in float64."""
    dt, x, Bm, A, d_a, d_b = (t.double() for t in (dt, x, Bm, A, d_a, d_b))
    ga = (d_a * torch.exp(dt[..., None] * A)).abs()
    gb = (d_b * Bm[:, :, None, :]).abs().sum(-1)
    return [(ga * A.abs()).sum(-1) + gb * x.abs(), gb * dt.abs(),
            (d_b.abs() * (dt * x).abs()[..., None]).sum(2), (ga * dt.abs()[..., None]).sum((0, 1))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CASES)
def test_forward_kernel_matches_the_chain_bit_for_bit(dev, shape):
    dt, x, Bm, A = _views(*_inputs(shape, dev)[0])
    reset_launch_counts()
    a, b = mamba1_discretize_cuda(dt, x, Bm, A)
    torch.cuda.synchronize()
    assert dict(launch_counts) == {"mamba1_discretize": 1}
    want = mamba1_discretize_ref(dt, x, Bm, A)
    assert torch.equal(a, want[0]) and torch.equal(b, want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CASES)
def test_backward_kernel_within_sum_order_of_autograd(dev, shape):
    """Mamba1Discretize's gradients through torch.autograd.grad against
    autograd over the chain (within SUM_TOL of each sum's magnitude), one
    forward, one backward and one sum launch, and a second run bit-identical
    to the first."""
    bases, d_a, d_b = _inputs(shape, dev)
    leaves = [t.clone().requires_grad_() for t in bases]
    want = torch.autograd.grad(mamba1_discretize_ref(*_views(*leaves)), leaves, (d_a, d_b))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in bases]
        reset_launch_counts()
        runs.append(torch.autograd.grad(Mamba1Discretize.apply(*_views(*leaves)), leaves,
                                        (d_a, d_b)))
        torch.cuda.synchronize()
        assert dict(launch_counts) == dict.fromkeys(DISCRETIZE_KEYS, 1)
    mags = _magnitudes(*_views(*bases), d_a, d_b)
    for got, again, w, mag in zip(_views(*runs[0]), _views(*runs[1]), _views(*want), mags):
        assert torch.equal(got, again)
        assert bool(((got.double() - w.double()).abs() <= SUM_TOL * mag).all())
    K, N = shape[1], shape[3]
    d_dt, d_x, d_bm = runs[0][:3]  # nothing outside the chunk's views
    assert not (d_dt[:, :K].any() or d_x[:, K:].any() or d_bm[..., N:].any())


@pytest.mark.gpu
def test_mamba1_layer_launches_once_a_chunk(dev):
    """A Mamba-1 layer over 300 tokens (chunks of 256, the second padded)
    on the card: one forward, one backward and one sum launch of the
    discretize kernels a chunk, beside the chunk's scans; the output and
    the input's gradient close to the CPU's (the plain chain)."""
    cfg = get_config("falcon-mamba-7b", True)
    g = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s.shape, generator=g) * 0.1
              for k, s in S.mamba_specs(cfg).items()}
    x = torch.randn(2, 300, cfg.d_model, generator=g)
    outs = {}
    for where in ("cpu", dev):
        p = {k: v.to(where) for k, v in params.items()}
        xi = x.to(where).requires_grad_()
        reset_launch_counts()
        y, _ = S.mamba1_forward(p, xi, cfg)
        (gx,) = torch.autograd.grad(y.square().sum(), xi)
        outs[str(where)] = (y.detach().cpu(), gx.cpu(), dict(launch_counts))
    (y_cpu, g_cpu, n_cpu), (y_dev, g_dev, n_dev) = outs["cpu"], outs[str(dev)]
    assert n_cpu == {}
    assert n_dev == {"ssm_scan": 2, "ssm_scan_bwd": 2, **dict.fromkeys(DISCRETIZE_KEYS, 2)}
    torch.testing.assert_close(y_dev, y_cpu, rtol=1e-4, atol=1e-4 * float(y_cpu.abs().max()))
    torch.testing.assert_close(g_dev, g_cpu, rtol=1e-4, atol=1e-4 * float(g_cpu.abs().max()))
