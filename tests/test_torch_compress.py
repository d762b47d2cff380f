"""The port's fused compression against the JAX package's.

The same numpy inputs go through ``repro``'s Pallas kernel (interpret mode)
and its jitted oracle, and through ``repro_torch``'s plain version, which is
what a CPU tensor runs. Tolerances:

* the nonzero pattern (which entries survive top-k) is identical;
* with quantization off the values are identical;
* with quantization on they agree within 4·2⁻²³·max|x| of their row: XLA
  contracts the dequantize ``round(t)·scale + qlo`` into one fused
  multiply-add, while the port rounds the product and the sum separately
  (as its CUDA kernel does), and the difference lands on the scale of the
  row's range.

The CUDA kernel's bisection (its row layout, one warp-summed count a
step, the max |x| as an unsigned max of bit patterns) is emulated in numpy
float32 here and must land on the serial bisection's threshold bits
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core.compression import compress_rows_ref as jax_compress_rows_ref
from repro.kernels.compress import compress_pytree as jax_compress_pytree
from repro.kernels.compress import fused_compress_pallas
from repro_torch.core import compression as TC
from repro_torch.core.compression import compress_rows_ref, quantize
from repro_torch.kernels import build, launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels.compress import compress_pytree, compress_rows, fused_compress
from repro_torch.kernels.compress_cases import EDGE_WIDTHS, edge_case_rows, same_values
from repro_torch.kernels.topk_sparsify import topk_sparsify_cuda

_oracle = jax.jit(jax_compress_rows_ref, static_argnames=("levels",))
ULP = 2.0 ** -23



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and keeps parallel test
    workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# threads of the wide body's block (one block a row)
WIDE_BLOCK = 256
# the group body's limits (csrc/compress.cu): one warp a row up to 32 x 40
# floats; past it floats a CTA's slice, values a thread, CTAs a cluster
WARP_ROW_VALUES, SLICE_FLOATS, GROUP_VALUES, MAX_CLUSTER = 40, 32768, 64, 8


def _group_shape(n):
    """csrc/compress.cu::group_shape: (V values a thread, C CTAs a row (0:
    one warp a row), S columns a CTA's slice, T threads a row on a CTA) for
    a row of n > 1024 floats, or None past the cluster's reach (the wide
    body)."""
    if n <= 32 * WARP_ROW_VALUES:
        return WARP_ROW_VALUES, 0, -(-n // 32) * 32, 32
    C = 1
    while C <= MAX_CLUSTER:
        S = ((n - 1) // C + 32) // 32 * 32
        if S <= SLICE_FLOATS:
            return GROUP_VALUES, C, S, -(-S // (32 * GROUP_VALUES)) * 32
        C *= 2
    return None


def _bucket(n):
    """The kernel's body for a row width: V values a lane (the fewest of 1,
    2, 4, ..., 32 that hold n) in the register body; in the group body
    "warp-row" (one warp a row), "group" (one CTA a row) or "cluster-C"
    (a cluster of C CTAs); "wide" past 262144 floats."""
    if n <= 1024:
        return next(v for v in (1, 2, 4, 8, 16, 32) if n <= 32 * v)
    shape = _group_shape(n)
    if shape is None:
        return "wide"
    C = shape[1]
    return "warp-row" if C == 0 else "group" if C == 1 else f"cluster-{C}"


def _group_lanes(x, row_len):
    """The group body's layout of one row: [C, T, V] values, thread t of CTA
    c holding slice columns 4(t + T*i) + e (i < V/4, e < 4) of the slice
    from c*S, NaN at or past row_len and past the row."""
    n = x.shape[0]
    V, C, S, T = _group_shape(n)
    C = max(C, 1)
    quad = np.arange(T)[:, None] + T * np.arange(V // 4)[None, :]
    local = (4 * quad[:, :, None] + np.arange(4)).reshape(T, V)
    cols = np.arange(C)[:, None, None] * S + local[None]
    inside = (local[None] < S) & (cols < min(row_len, n))
    lanes = np.full(cols.shape, np.nan, np.float32)
    lanes[inside] = x[cols[inside]]
    return lanes, cols, inside


def _emulated_threshold(x, k, row_len):
    """The CUDA kernel's bisection of one row of width n = len(x) in numpy
    float32. In the register body lane l holds columns l + 32*i, V slots a
    lane, loaded whole (padding included) when the row is at most 512
    bytes, then NaN from row_len on and narrowed to the fewest W in
    {1, 2, 4, ..., V} slots that hold the valid prefix. In the group body
    (``_group_lanes``) each thread holds V values of its CTA's slice, and
    a step's count is summed by REDUX a warp, then over the C*G warp slots
    of the cluster (one warp a row: the REDUX alone). In the wide body
    thread t of a 256-thread block holds columns t + 256*i of the valid
    prefix, its count summed a warp, then over the block's 8 warps. hi is the unsigned max of the bit patterns
    bits & 0x7fffffff over the valid columns; each of the 16 steps counts
    |x| >= mid per lane (thread), sums the counts as uint32 warp by warp and
    moves lo or hi. Returns the threshold lo."""
    n, V = x.shape[0], _bucket(x.shape[0])
    if V == "wide":
        steps = np.arange(-(-row_len // WIDE_BLOCK))
        cols = np.arange(WIDE_BLOCK)[:, None] + WIDE_BLOCK * steps[None, :]
        valid = cols < row_len
        lanes = np.full(cols.shape, np.nan, np.float32)
        lanes[valid] = x[cols[valid]]
        warp_of = lambda cnt: cnt.reshape(-1, 32).sum(axis=1, dtype=np.uint32)
    elif isinstance(V, str):
        lanes, cols, valid = _group_lanes(x, row_len)
        C, T = lanes.shape[:2]
        warp_of = lambda cnt: cnt.reshape(C, T // 32, 32).sum(axis=2, dtype=np.uint32)
    else:
        W = next(w for w in (1, 2, 4, 8, 16, 32) if w >= V or row_len <= 32 * w)
        cols = np.arange(32)[:, None] + 32 * np.arange(V)[None, :]
        whole = V * 32 * 4 <= 512
        loaded = np.zeros((32, V), np.float32)
        inside = cols < (n if whole else row_len)
        loaded[inside] = x[cols[inside]]
        lanes = np.where(cols < row_len, loaded, np.float32(np.nan))[:, :W]
        cols = cols[:, :W]
        valid = cols < row_len
        warp_of = lambda cnt: cnt.sum(dtype=np.uint32)
    bits = np.where(valid, lanes.view(np.uint32) & np.uint32(0x7FFFFFFF), np.uint32(0))
    hi = np.array(bits.max(initial=0), np.uint32).view(np.float32)[()]
    lo, half = np.float32(0.0), np.float32(0.5)
    for _ in range(16):
        with np.errstate(invalid="ignore", over="ignore"):
            mid = half * (lo + hi)
            cnt = (np.abs(lanes) >= mid).sum(axis=-1).astype(np.uint32)
        total = warp_of(cnt).sum(dtype=np.uint32)
        lo, hi = (mid, hi) if int(total) >= k else (lo, mid)
    return lo


def _serial_threshold(x, k, row_len):
    """compress_rows_ref's 16-step bisection of one row, in numpy float32."""
    mag = np.abs(x[:row_len])
    hi, lo = (mag.max() if row_len else np.float32(0.0)), np.float32(0.0)
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(16):
            mid = np.float32(0.5) * (lo + hi)
            lo, hi = (mid, hi) if (mag >= mid).sum() >= k else (lo, mid)
    return lo


def _check_emulation(x, k, row_len):
    """The emulated threshold has the serial one's bits (NaN: both NaN), and
    keeping |x| >= it gives compress_rows_ref's output bit for bit."""
    want, got = _serial_threshold(x, k, row_len), _emulated_threshold(x, k, row_len)
    assert (np.isnan(got) and np.isnan(want)) or got.view(np.uint32) == want.view(np.uint32), \
        (got, want)
    with np.errstate(invalid="ignore"):
        kept = (np.arange(x.shape[0]) < row_len) & (np.abs(x) >= got)
    plain = compress_rows_ref(torch.from_numpy(x[None]), k, 0, torch.tensor([row_len]))[0]
    assert torch.equal(torch.from_numpy(np.where(kept, x, np.float32(0.0))), plain)


@pytest.mark.parametrize("V", [1, 2, 4, 8, 16, 32, "warp-row", "group", "cluster-2", "cluster-4",
                               "cluster-8", "wide"])
def test_lookahead_emulation_matches_serial_on_edge_rows(V):
    """The kernel's bisection (look-ahead depth 1: one mid and one REDUX
    count a step) and unsigned-pattern max, emulated in the layout of the
    body V (V values a lane in the register body; the group body on one warp,
    on one CTA or on a cluster of C CTAs; the wide body), against
    the serial bisection on every edge-case row of the widths that body
    takes."""
    widths = [n for n in EDGE_WIDTHS if _bucket(n) == V]
    assert widths
    for n in widths:
        x, k, row_len = (t.numpy() for t in edge_case_rows(n))
        for r in range(x.shape[0]):
            _check_emulation(x[r], int(k[r]), int(row_len[r]))


@pytest.mark.parametrize("n", [1025, 1281, 32769, 65537, 131073, 262144])
def test_group_norm_chain_matches_warp_order(n):
    """The DP norm in the group body: warp 0 of each CTA, in rank order,
    continues the 32 lane sums over its slice of the stage (columns below
    the row's valid length), then the last CTA's butterfly. Emulated in
    numpy float32, it has the bits of ``warp_order_sqnorm``, the plain
    version's order, because every slice starts at a multiple of 32."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    row_len = n - n // 7
    _, C, S, _ = _group_shape(n)
    s = np.zeros(32, np.float32)
    for c in range(max(C, 1)):
        lc = max(0, min(row_len - c * S, S, n - c * S))
        part = np.zeros(-(-lc // 32) * 32, np.float32)
        part[:lc] = x[c * S:c * S + lc]
        for m in range(part.shape[0] // 32):
            s = s + part[32 * m:32 * m + 32] * part[32 * m:32 * m + 32]
    while s.shape[0] > 1:
        s = s[:s.shape[0] // 2] + s[s.shape[0] // 2:]
    sq = torch.from_numpy(np.where(np.arange(n) < row_len, x * x, np.float32(0))[None])
    assert s.view(np.uint32)[0] == TC.warp_order_sqnorm(sq).numpy().view(np.uint32)[0, 0]


def test_lookahead_emulation_matches_serial_property():
    """The same on hypothesis rows: ties, zeros of both signs, ±inf, NaN,
    subnormals, k <= 0 and k > len, any valid length."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    value = st.one_of(
        st.sampled_from([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 0.5, np.inf, -np.inf, np.nan,
                         1e-40, 3e38, -3e38]),
        st.integers(-4, 4).map(float),
        st.floats(width=32))

    @hyp.settings(max_examples=300, deadline=None, derandomize=True)
    @hyp.given(st.lists(value, min_size=1, max_size=100), st.data())
    def check(vals, data):
        x = np.array(vals, np.float32)
        row_len = data.draw(st.integers(0, len(vals)))
        k = data.draw(st.integers(-3, len(vals) + 3))
        _check_emulation(x, k, row_len)

    check()


def _assert_compress_close(port, want, x, levels):
    port, want = np.asarray(port, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(port != 0, want != 0, err_msg="survivor pattern differs")
    if not (levels and levels > 1):
        np.testing.assert_array_equal(port, want)
        return
    tol = 4 * ULP * np.nanmax(np.abs(np.asarray(x, np.float32)), axis=-1, keepdims=True)
    assert (np.abs(port - want) <= tol).all(), np.abs(port - want).max()


@pytest.mark.parametrize("rows,n", [(4, 64), (16, 300), (3, 1000), (1, 128)])
@pytest.mark.parametrize("levels,k_div", [(0, 10), (128, 10), (16, 3), (128, 0)])
def test_compress_rows_ref_matches_jax(rows, n, levels, k_div):
    """top-k only (levels=0), fused, and quantize only (k_div=0 -> k=n)."""
    x = _normal(rows * n + levels, (rows, n))
    k = n if k_div == 0 else max(1, n // k_div)
    port = compress_rows_ref(torch.from_numpy(x), k, levels).numpy()
    for want in (fused_compress_pallas(jnp.asarray(x), k, levels=levels, interpret=True),
                 _oracle(jnp.asarray(x), k, levels=levels)):
        _assert_compress_close(port, want, x, levels)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_rows_ref_dtypes(dtype):
    x = _normal(0, (8, 256))
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    port = compress_rows_ref(xt, 25, levels=128)
    assert port.dtype == xt.dtype
    want = _oracle(xj, 25, levels=128)
    _assert_compress_close(port.float().numpy(), np.asarray(want, np.float32),
                           np.asarray(xj, np.float32), 128)


@pytest.mark.parametrize("levels", [0, 128])
def test_ragged_rows_match_jax(levels):
    """Rows padded to a common width + per-row valid length: same as the
    JAX kernel on the same padded matrix, padding columns zeroed."""
    widths, rows = [64, 300, 129], 5
    n_max = max(widths)
    padded = np.concatenate(
        [np.pad(_normal(i, (rows, w)), ((0, 0), (0, n_max - w))) for i, w in enumerate(widths)])
    k = np.repeat([max(1, w // 10) for w in widths], rows).astype(np.int32)
    row_len = np.repeat(widths, rows).astype(np.int32)
    port = compress_rows_ref(torch.from_numpy(padded), torch.from_numpy(k), levels,
                             torch.from_numpy(row_len)).numpy()
    want = fused_compress_pallas(jnp.asarray(padded), jnp.asarray(k), levels=levels,
                                 row_len=jnp.asarray(row_len), interpret=True)
    _assert_compress_close(port, want, padded, levels)
    for i, w in enumerate(widths):
        assert not port[i * rows:(i + 1) * rows, w:].any()


@pytest.mark.parametrize("levels", [0, 128])
def test_nan_rows_match_jax(levels):
    """A NaN in a row: the row max propagates it, the bisection ends at 0,
    and every non-NaN valid entry survives while the NaN is dropped, as in
    the JAX kernel and oracle."""
    x = _normal(21, (6, 96))
    x[1, 5] = np.nan
    x[4, [0, 50]] = np.nan
    row_len = np.array([96, 96, 40, 96, 96, 10], np.int32)
    x[5, 20] = np.nan  # in the padding: ignored
    args = (torch.from_numpy(x), 8, levels, torch.from_numpy(row_len))
    port = compress_rows_ref(*args).numpy()
    assert np.isfinite(port).all()
    assert ((port[[1, 4]] != 0).sum(axis=1) == [95, 94]).all()
    assert (port[5, 10:] == 0).all() and (port[5] != 0).sum() <= 8 + 2
    for want in (fused_compress_pallas(jnp.asarray(x), 8, levels=levels,
                                       row_len=jnp.asarray(row_len), interpret=True),
                 _oracle(jnp.asarray(x), 8, levels=levels, row_len=jnp.asarray(row_len))):
        _assert_compress_close(port, want, np.where(np.isnan(x), 0, x), levels)


def test_compress_pytree_matches_per_leaf_and_jax():
    tree = {
        "w": _normal(5, (3, 4, 96)),
        "b": _normal(6, (3, 17)),
        "c": _normal(7, (2, 5, 8, 130)),
    }
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    out = compress_pytree(ttree, 0.25, 128)
    want_jax = jax.jit(lambda t: jax_compress_pytree(t, 0.25, 128))(
        {k: jnp.asarray(v) for k, v in tree.items()})
    for name, leaf in tree.items():
        n = leaf.shape[-1]
        k = max(1, round(0.25 * n))
        per_leaf = compress_rows_ref(ttree[name].reshape(-1, n), k, 128).reshape(leaf.shape)
        assert torch.equal(out[name], per_leaf), name
        _assert_compress_close(out[name].reshape(-1, n).numpy(),
                               np.asarray(want_jax[name]).reshape(-1, n),
                               leaf.reshape(-1, n), 128)
    assert compress_pytree(ttree, 1.0, 0) is ttree  # no-op settings


@pytest.mark.parametrize("rows,n,k", [(8, 256, 16), (5, 300, 7), (1, 128, 1)])
def test_quantized_rows_stay_sparse(rows, n, k):
    """Zero-anchor regression: mixed-sign rows keep nnz <= k + ties after
    quantization, and the forced negative survivor stays negative."""
    x = _normal(rows + n + k, (rows, n))
    x[:, 0] = -10.0 - np.arange(rows, dtype=np.float32)
    out = compress_rows_ref(torch.from_numpy(x), k, 128).numpy()
    nnz = (out != 0).sum(axis=-1)
    assert nnz.max() <= k + 8, f"quantization re-densified: nnz={nnz}"
    assert nnz.min() >= 1
    assert (out[:, 0] < 0).all()


def test_k_at_least_n_is_noop():
    x = torch.from_numpy(_normal(3, (6, 200)))
    assert torch.equal(compress_rows_ref(x, 200, 0), x)
    assert torch.equal(compress_rows_ref(x, 1000, 0), x)
    assert ops.fused_compress(x, 1.0, 0) is x


def test_legacy_quantize_zero_anchored():
    x = torch.tensor([[-4.0, 0.0, 0.0, 1.0, 3.0], [0.5, 0.0, -0.5, 2.0, 0.0]])
    q = quantize(x, 128)
    assert (q[x == 0.0] == 0.0).all()
    step = (x.amax(-1) - x.amin(-1)) / 127
    assert (q - x).abs().max() <= step.max() / 2 + 1e-7


@pytest.mark.parametrize("n,k", [(128, 13), (256, 1), (64, 64)])
def test_topk_contains_exact_support(n, k):
    """The twin of the reference's property test on the plain version of the
    compress kernel with ``levels=0``: the threshold refinement keeps every
    entry of the exact top-k support (``ref.topk_exact_ref``, a sort), with
    at most k + 8 survivors a row (ties can add a few). The inputs are the
    reference test's draws."""
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (8, n))))
    kept = ref.topk_sparsify_ref(x, k) != 0
    exact_kept = ref.topk_exact_ref(x, k) != 0
    assert (kept & exact_kept).sum(dim=-1).min() >= min(k, n)  # exact support kept
    assert (~kept & exact_kept).sum() == 0
    assert kept.sum(dim=-1).max() <= k + 8
    if k >= n:
        assert kept.all() and exact_kept.all()


def test_ref_module_re_exports_the_plain_versions():
    """``kernels/ref.py`` is one import site for the plain versions that
    live beside their kernels: the same functions, not copies."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS

    assert ref.compress_rows_ref is compress_rows_ref
    assert ref.topk_exact_ref is TC.topk_exact_ref
    assert ref.flash_attention_ref is FA.flash_attention_ref
    assert ref.ssm_scan_ref is SS.ssm_scan_ref and ref.ssm_scan_bwd_ref is SS.ssm_scan_bwd_ref


def test_cpu_tensors_never_reach_the_kernel():
    """The router sends a CPU tensor to the plain version; the kernel wrapper
    refuses one outright."""
    reset_launch_counts()
    x = torch.from_numpy(_normal(9, (12, 40)))
    compress_rows(x, 4, 128)
    compress_pytree({"a": x, "b": x[:, :7]}, 0.25, 128)
    ops.fused_compress(x, 0.25, 16)
    ops.topk_sparsify(x, 0.1)
    assert launch_counts["fused_compress"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        fused_compress(x, 4, 128)
    assert launch_counts["fused_compress"] == 0


def test_nvcc_command_targets_hopper_without_fast_math():
    cmd = build.nvcc_command(build.CSRC / "compress.cu", "/dev/null")
    line = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in line
    assert "--fmad=false" in cmd
    assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert (build.CSRC / "compress.cu").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [0, 16, 128])
def test_kernel_matches_plain(levels):
    """The CUDA kernel against the plain version on the card: bit-identical,
    ragged rows and the edge-case matrix included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    widths, rows = [128, 11, 64], 300
    n_max = max(widths)
    x = torch.from_numpy(np.concatenate(
        [np.pad(_normal(i, (rows, w)), ((0, 0), (0, n_max - w))) for i, w in enumerate(widths)]))
    x[::37, 3] = float("nan")  # NaN rows: kept dense but for the NaN, as in plain
    k = torch.from_numpy(np.repeat([max(1, round(0.25 * w)) for w in widths], rows).astype(np.int32))
    row_len = torch.from_numpy(np.repeat(widths, rows).astype(np.int32))
    dev = torch.device("cuda")
    reset_launch_counts()
    got = fused_compress(x.to(dev), k.to(dev), levels, row_len.to(dev))
    want = compress_rows_ref(x.to(dev), k.to(dev), levels, row_len.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert launch_counts["fused_compress"] == 1
    dense = x[:rows].to(dev).contiguous()
    assert torch.equal(topk_sparsify_cuda(dense, 32), compress_rows_ref(dense, 32, 0))
    _assert_compress_close(got.cpu().numpy(), compress_rows_ref(x, k, levels, row_len).numpy(),
                           x.numpy(), levels)
    for n in EDGE_WIDTHS:  # every register bucket, the group body and the wide body
        xe, ke, le = (t.to(dev) for t in edge_case_rows(n))
        got = fused_compress(xe, ke, levels, le)
        want = compress_rows_ref(xe, ke, levels, le)
        torch.cuda.synchronize()
        assert same_values(got, want), n


def test_message_entry_points_and_byte_model_match_jax():
    x = _normal(11, (2, 3, 40))
    port = TC.compress_message(torch.from_numpy(x), 0.25, 128).numpy()
    want = JC.compress_message(jnp.asarray(x), 0.25, 128)
    _assert_compress_close(port.reshape(-1, 40), np.asarray(want).reshape(-1, 40),
                           x.reshape(-1, 40), 128)
    np.testing.assert_array_equal(TC.topk_sparsify(torch.from_numpy(x), 0.1).numpy(),
                                  np.asarray(jax.jit(lambda a: JC.topk_sparsify(a, 0.1))(x)))
    assert TC.COMPRESSION_LADDER == JC.COMPRESSION_LADDER
    for n, k, b in [(1000, 0.25, 128), (1000, 0.0, 0), (77, 0.05, 64), (10, 0.5, 1)]:
        assert TC.compressed_bytes(n, k, b) == JC.compressed_bytes(n, k, b)


def test_build_reuses_library_and_reports_failure(tmp_path, monkeypatch):
    """The build with a stand-in compiler: the library is keyed by a hash of
    the source, reused while the source is unchanged, and a failed build
    raises with nvcc's output and leaves no library behind."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "src=''; o=''\n"
                    "while [ $# -gt 0 ]; do case $1 in -o) o=$2; shift;; *.cu) src=$1;; esac; shift; done\n"
                    "grep -q FAIL $src && { echo broken $src; exit 3; }\n"
                    "echo built $src; cp $src $o\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))

    assert build.build("a") > 0
    assert build.library_path("a").read_text() == "// a\n"
    assert "built" in build.build_log("a")
    assert build.build("a") == 0.0  # unchanged source: reused
    (csrc / "a.cu").write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match="broken"):
        build.build("a")
    assert not build.library_path("a").exists()
    assert not list(out.glob("*.tmp.so"))
