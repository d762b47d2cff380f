// Fused top-k sparsify + b-level quantize over the rows of a matrix
// (C-HSGD's message compression, paper §VII-A1), for Hopper (sm_90a), with
// an optional DP stage in front (the privacy-hardened exchange).
//
// compress_rows_kernel<V> replaces the TPU kernel
// repro/kernels/compress.py::_fused_compress_call (body _compress_kernel);
// compress_rows_dp_kernel<V> replaces _fused_compress_dp_call (body
// _compress_dp_kernel); both run one row body. Per row, over the valid
// prefix [0, row_len):
//   0. (DP only) s = ||x||^2; coef = min(1, C / max(sqrt(s), 1e-12));
//      y = x * coef + (sigma * C) * noise, with C (clip) and sigma read from
//      one-element device buffers, so a new sigma never changes the launch.
//      The noise rows are an input (standard normals drawn by the caller),
//      so the kernel is deterministic;
//   1. hi = max |x|; 16-step bisection of the magnitude threshold in
//      [0, hi], moving lo up whenever count(|x| >= mid) >= k;
//   2. kept = |x| >= lo (>= k survivors: the exact top-k plus ties);
//   3. levels > 1: survivors snap to a levels-point grid over the
//      survivors' [min, max]; pruned and padding columns are written as 0.
//
// What bounds it. The work is ~20 compares per valid element against the
// bytes moved (the valid prefix of each row read once, as much again of
// noise with DP, the whole [rows, n] matrix written once, 8 bytes of k and
// row_len a row), far below the card's operations-per-byte balance: at
// large shapes ([16384, 1024] ragged) the bound is bytes. At the main
// path's message ([2900, 128]: 22 one-row warps a SM, one wave) every
// warp's chain of dependent steps sets the time: the load, 16 bisection
// decisions each waiting on a warp-wide count, the extrema, the write. The
// design shortens that chain and cuts the instructions a step:
//   - Rows in registers. For n <= 1024 a row lives in V = n/32 (rounded up
//     to 1, 2, 4, 8, 16 or 32) registers a lane; lane l holds columns
//     l + 32*i, so every load and store is coalesced and no pass goes
//     through shared memory. After the load, a warp-uniform choice narrows
//     the row to the fewest slots W that hold its valid prefix (an 11-wide
//     row of the main message runs 1 slot of its 4), and every loop then
//     runs W slots with no guard. Rows wider than 1024 keep one warp's n
//     floats of shared memory (compress_row_smem), up to the 58112 floats
//     of one block's shared memory. Rows wider still (an LLM's vocabulary
//     axis: 262144 floats) take the wide body (compress_row_wide): one
//     block a row, read from device memory at every pass (16 bisection
//     counts, the max, the extrema, the write), counts and extrema summed
//     per warp by REDUX and across the block's warps in shared memory.
//     It is the simple first version: bound by bytes at ~19 reads of the
//     row where one would do.
//   - Loads that do not wait on each other. k, row_len and (DP) C and sigma
//     are loaded together, and a lane issues all its row loads before the
//     first use. Rows of at most 512 bytes (V <= 4) load their whole padded
//     width, columns past row_len included, without waiting for row_len:
//     the matrix is [rows, n], so those reads are in bounds, and the values
//     are masked out once row_len arrives. With DP at V = 32 the noise goes
//     to shared memory by cp.async (see compress_row_regs).
//   - Hardware warp reductions. Counts are __reduce_add_sync (one REDUX
//     each) instead of a 5-shuffle butterfly. max |x| is __reduce_max_sync
//     on the bit pattern bits & 0x7fffffff: non-negative floats order as
//     unsigned integers, and every NaN pattern lies above +inf, so a NaN
//     still wins, as torch.amax propagates it. The bisection then ends
//     where it does in the plain version whatever the payload: mid is NaN,
//     no count reaches k >= 1, and lo stays 0 (k <= 0 moves lo onto the
//     NaN mid in both, and nothing is kept). The survivors' min and max use
//     the order-preserving integer map with __reduce_min/max_sync; only the
//     sign of a zero can differ from a float min/max, and -0 == +0.
//   - A serial bisection (bisect_step): 16 rounds of one mid, one compare
//     a slot, one REDUX and one decision. A look-ahead search that counts the
//     2^L - 1 mids of the next L levels in one round (two 16-bit counts
//     packed in a REDUX) would cut the chain to 16/L rounds on the same
//     fp32 mids, but on the H100 the extra compares cost more than the
//     shorter chain saves: L = 2 and L = 4 were slower at every row width
//     and at both shapes above, so the search stays serial.
//   - The DP norm stays a float butterfly in the order the plain version
//     (repro_torch/core/compression.py::warp_order_sqnorm) repeats: lane l
//     adds v*v over j = l, l+32, ... (j < row_len) in increasing j, then an
//     xor butterfly over offsets 16, 8, 4, 2, 1; every lane ends with the
//     same value because IEEE addition is commutative.
// Entries past row_len (and, in the register body, every slot a lane holds
// past it) are NaN once loaded: NaN never compares >= a threshold, so they
// are never counted, kept or written, with no valid-mask in the loops.
//
// NaN: a row holding a NaN ends its bisection at lo = 0 and keeps every
// non-NaN valid entry, as the plain version does. In the DP stage the min
// and max propagate NaN as torch.minimum / torch.clamp_min do (fminf/fmaxf
// would drop it): a NaN in a row makes its norm, and so every entry of y,
// NaN, and the row comes out as zeros.
//
// Exactness: the plain PyTorch version (repro_torch/core/compression.py::
// compress_rows_ref) runs one eager op at a time. To match it bit for bit
// this file is built with --fmad=false and without fast math, and spells
// out IEEE square root and division (__fsqrt_rn, __fdiv_rn),
// round-half-to-even (rintf), and separately rounded products and sums
// (__fmul_rn, __fadd_rn).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRefine = 16;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
// Rows this narrow are loaded whole, padding included (V <= 4).
constexpr int kWholeLoadBytes = 512;
// Shared memory a block may use on Hopper: 227 KB.
constexpr size_t kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;

// max that returns NaN when either operand is NaN (fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

// min that returns NaN when either operand is NaN (fminf drops it).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}

// Sum over the warp in the butterfly order the plain version repeats.
__device__ __forceinline__ float warp_sum_ordered(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Copy 4 bytes from device to shared memory without holding a register
// (cp.async); cp_async_wait_all() waits for this thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// |v| as a bit pattern: ordered as the magnitudes, every NaN above +inf.
__device__ __forceinline__ unsigned mag_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

// Order-preserving map of a non-NaN float onto the unsigned integers, and back.
__device__ __forceinline__ unsigned ord_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float ord_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A row as the bisection reads it: slot i of lane `lane` is column
// lane + 32*i. The slots [0, slots()) cover the valid prefix, the slots
// [0, out_slots()) the whole width n; at(i) is NaN for a column at or past
// len.
//
// RegRow holds the first W slots in registers (every column past len is
// NaN already) for a row of n <= 32*VN columns; its loops unroll fully, so
// v[] never leaves the register file, and slots past W are NaN at compile
// time.
template <int W, int VN>
struct RegRow {
  float v[W];
  int lane, n;
  __device__ __forceinline__ int slots() const { return W; }
  __device__ __forceinline__ int out_slots() const { return VN; }
  __device__ __forceinline__ float at(int i) const { return i < W ? v[i] : CUDART_NAN_F; }
};

// SmemRow reads the valid prefix from one warp's shared memory; a lane
// reads only columns it wrote itself, so no barrier is needed.
struct SmemRow {
  const float* buf;
  int len, lane, n;
  __device__ __forceinline__ int slots() const { return (len + kWarp - 1) / kWarp; }
  __device__ __forceinline__ int out_slots() const { return (n + kWarp - 1) / kWarp; }
  __device__ __forceinline__ float at(int i) const {
    const int j = lane + kWarp * i;
    return j < len ? buf[j] : CUDART_NAN_F;
  }
};

// One bisection step: lo moves up to mid when count(|x| >= mid) >= keep,
// else hi moves down to it.
template <class Row>
__device__ __forceinline__ void bisect_step(const Row& row, int keep, float& lo, float& hi) {
  const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
  unsigned cnt = 0;
#pragma unroll
  for (int i = 0; i < row.slots(); ++i) cnt += fabsf(row.at(i)) >= mid ? 1u : 0u;
  if (static_cast<int>(__reduce_add_sync(kFull, cnt)) >= keep) {
    lo = mid;
  } else {
    hi = mid;
  }
}

// A surviving value snapped to the grid; 0 for a pruned or missing one.
__device__ __forceinline__ float quantized(float v, float lo, float qlo, float scale, int levels) {
  if (!(fabsf(v) >= lo)) return 0.0f;
  if (levels <= 1) return v;
  const float t = rintf(__fdiv_rn(__fsub_rn(v, qlo), scale));
  return __fadd_rn(__fmul_rn(t, scale), qlo);
}

// Steps 1-3 on a loaded row whose lane-local max |x| bit pattern is
// `hbits`: bisect, quantize, write. Called by one whole warp.
template <class Row>
__device__ __forceinline__ void finish_row(const Row& row, unsigned hbits, int keep, int levels,
                                           float* __restrict__ orow) {
  float hi = __uint_as_float(__reduce_max_sync(kFull, hbits));
  float lo = 0.0f;
#pragma unroll 1
  for (int r = 0; r < kRefine; ++r) bisect_step(row, keep, lo, hi);

  float qlo = 0.0f, scale = 1.0f;
  if (levels > 1) {
    unsigned kmin = ord_key(CUDART_INF_F), kmax = ord_key(-CUDART_INF_F);
#pragma unroll
    for (int i = 0; i < row.slots(); ++i) {
      const float v = row.at(i);
      if (fabsf(v) >= lo) {
        kmin = min(kmin, ord_key(v));
        kmax = max(kmax, ord_key(v));
      }
    }
    qlo = ord_float(__reduce_min_sync(kFull, kmin));
    const float qhi = ord_float(__reduce_max_sync(kFull, kmax));
    scale = __fdiv_rn(nan_max(__fsub_rn(qhi, qlo), 1e-12f), static_cast<float>(levels - 1));
  }
#pragma unroll
  for (int i = 0; i < row.out_slots(); ++i) {
    const int j = row.lane + kWarp * i;
    if (j < row.n) orow[j] = quantized(row.at(i), lo, qlo, scale, levels);
  }
}

// Bisect, quantize and write a row held in V registers a lane, through
// the narrowest W in {1, 2, 4, ..., V} that holds its valid prefix: a
// warp-uniform choice, so every loop below runs W slots with no guard.
template <int W, int V>
__device__ __forceinline__ void finish_regs(const float (&v)[V], unsigned hbits, int len, int keep,
                                            int n, int levels, int lane,
                                            float* __restrict__ orow) {
  if constexpr (W < V) {
    if (len > kWarp * W) {
      finish_regs<2 * W, V>(v, hbits, len, keep, n, levels, lane, orow);
      return;
    }
  }
  RegRow<W, V> row;
#pragma unroll
  for (int i = 0; i < W; ++i) row.v[i] = v[i];
  row.lane = lane;
  row.n = n;
  finish_row(row, hbits, keep, levels, orow);
}

// The register body: rows of n <= 32*V floats, V slots a lane. Rows of at
// most 512 bytes (V <= 4) are loaded whole, padding included, without
// waiting for row_len. `stage` is the warp's 32*V floats of shared memory
// where the DP noise is staged (kStageNoise).
template <int V, bool kDP>
__device__ __forceinline__ void compress_row_regs(const float* __restrict__ xr,
                                                  float* __restrict__ orow,
                                                  const float* __restrict__ nr, float clip,
                                                  float sigma, int len, int keep, int n,
                                                  int levels, int lane, float* stage) {
  // At 32 slots the noise goes to shared memory by cp.async, issued with
  // the row's loads and read after the norm: the norm's division has a slow
  // path that is a call, and 64 values held in registers across it spill.
  constexpr bool kWhole = V * kWarp * sizeof(float) <= kWholeLoadBytes;
  constexpr bool kStageNoise = kDP && V == 32;
  float v[V];
  float noise[kDP && !kStageNoise ? V : 1];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = lane + kWarp * i;
    const bool load = kWhole ? j < n : j < len;
    v[i] = load ? xr[j] : 0.0f;
    if constexpr (kStageNoise) {
      if (load) cp_async4(stage + j, nr + j);
    } else if constexpr (kDP) {
      noise[i] = load ? nr[j] : 0.0f;
    }
  }
  unsigned hbits = 0;
  if constexpr (kDP) {
    // A slot past len adds +0 (loaded as 0, or masked when loaded whole),
    // which leaves s as it is.
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xi = !kWhole || lane + kWarp * i < len ? v[i] : 0.0f;
      s = __fadd_rn(s, __fmul_rn(xi, xi));
    }
    s = warp_sum_ordered(s);
    const float coef = nan_min(1.0f, __fdiv_rn(clip, nan_max(__fsqrt_rn(s), 1e-12f)));
    const float noise_scale = __fmul_rn(sigma, clip);
    if constexpr (kStageNoise) cp_async_wait_all();  // a lane reads only its own copies
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool valid = lane + kWarp * i < len;
      float ni;
      if constexpr (kStageNoise) {
        ni = stage[lane + kWarp * i];
      } else {
        ni = noise[i];
      }
      const float y = __fadd_rn(__fmul_rn(v[i], coef), __fmul_rn(noise_scale, ni));
      hbits = max(hbits, valid ? mag_bits(y) : 0u);
      v[i] = valid ? y : CUDART_NAN_F;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool valid = lane + kWarp * i < len;
      hbits = max(hbits, valid ? mag_bits(v[i]) : 0u);
      v[i] = valid ? v[i] : CUDART_NAN_F;
    }
  }
  finish_regs<1, V>(v, hbits, len, keep, n, levels, lane, orow);
}

// The shared-memory body: rows wider than 1024 floats. `buf` is the warp's
// n floats; only the valid prefix is read from device memory, once.
template <bool kDP>
__device__ __forceinline__ void compress_row_smem(const float* __restrict__ xr,
                                                  float* __restrict__ orow,
                                                  float* __restrict__ buf,
                                                  const float* __restrict__ nr, float clip,
                                                  float sigma, int len, int keep, int n,
                                                  int levels, int lane) {
  unsigned hbits = 0;
  if (kDP) {
    float s = 0.0f;
    for (int j = lane; j < len; j += kWarp) {
      const float v = xr[j];
      buf[j] = v;
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    s = warp_sum_ordered(s);
    const float coef = nan_min(1.0f, __fdiv_rn(clip, nan_max(__fsqrt_rn(s), 1e-12f)));
    const float noise_scale = __fmul_rn(sigma, clip);
    for (int j = lane; j < len; j += kWarp) {
      const float y = __fadd_rn(__fmul_rn(buf[j], coef), __fmul_rn(noise_scale, nr[j]));
      buf[j] = y;
      hbits = max(hbits, mag_bits(y));
    }
  } else {
    for (int j = lane; j < len; j += kWarp) {
      const float v = xr[j];
      buf[j] = v;
      hbits = max(hbits, mag_bits(v));
    }
  }
  finish_row(SmemRow{buf, len, lane, n}, hbits, keep, levels, orow);
}

// The wide body's block: the sum, max or min of one unsigned value a
// thread over the whole block (REDUX a warp, then the warps' results in
// shared memory, read by every thread). Called by every thread of the block.
enum class BlockOp { kAdd, kMax, kMin };

template <BlockOp kOp>
__device__ __forceinline__ unsigned block_reduce(unsigned v, unsigned* red) {
  if constexpr (kOp == BlockOp::kAdd) v = __reduce_add_sync(kFull, v);
  if constexpr (kOp == BlockOp::kMax) v = __reduce_max_sync(kFull, v);
  if constexpr (kOp == BlockOp::kMin) v = __reduce_min_sync(kFull, v);
  const int warps = blockDim.x / kWarp;
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  unsigned r = red[0];
  for (int w = 1; w < warps; ++w) {
    if constexpr (kOp == BlockOp::kAdd) r += red[w];
    if constexpr (kOp == BlockOp::kMax) r = max(r, red[w]);
    if constexpr (kOp == BlockOp::kMin) r = min(r, red[w]);
  }
  __syncthreads();  // red is reused by the next call
  return r;
}

// A wide row's valid prefix as the passes read it: x, or with DP
// x * coef + (sigma * C) * noise, recomputed at every read in the same
// rounded operations, so every pass sees the same bits.
template <bool kDP>
struct WideRow {
  const float* __restrict__ x;
  const float* __restrict__ noise;
  float coef, noise_scale;
  __device__ __forceinline__ float at(int j) const {
    if constexpr (kDP) return __fadd_rn(__fmul_rn(x[j], coef), __fmul_rn(noise_scale, noise[j]));
    return x[j];
  }
};

// The wide body: one block a row of any width, read from device memory at
// every pass. Thread t reads columns t, t + blockDim.x, ... of the valid
// prefix; the bisection, the quantize grid and NaN rules are those of
// finish_row. With DP, warp 0 sums the row's squares in the order of the
// one-warp bodies (lane l over j = l, l+32, ..., then the butterfly), so
// the norm has the plain version's bits.
template <bool kDP>
__device__ __forceinline__ void compress_row_wide(const float* __restrict__ xr,
                                                  float* __restrict__ orow,
                                                  const float* __restrict__ nr, float clip,
                                                  float sigma, int len, int keep, int n,
                                                  int levels) {
  __shared__ unsigned red[kWarpsPerBlock];
  __shared__ float norm2;
  const int tid = threadIdx.x, step = blockDim.x;
  WideRow<kDP> row{xr, nr, 1.0f, 0.0f};
  if constexpr (kDP) {
    if (tid < kWarp) {
      float s = 0.0f;
      for (int j = tid; j < len; j += kWarp) s = __fadd_rn(s, __fmul_rn(xr[j], xr[j]));
      s = warp_sum_ordered(s);
      if (tid == 0) norm2 = s;
    }
    __syncthreads();
    row.coef = nan_min(1.0f, __fdiv_rn(clip, nan_max(__fsqrt_rn(norm2), 1e-12f)));
    row.noise_scale = __fmul_rn(sigma, clip);
  }
  unsigned hbits = 0;
  for (int j = tid; j < len; j += step) hbits = max(hbits, mag_bits(row.at(j)));
  float hi = __uint_as_float(block_reduce<BlockOp::kMax>(hbits, red));
  float lo = 0.0f;
#pragma unroll 1
  for (int r = 0; r < kRefine; ++r) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned cnt = 0;
    for (int j = tid; j < len; j += step) cnt += fabsf(row.at(j)) >= mid ? 1u : 0u;
    if (static_cast<int>(block_reduce<BlockOp::kAdd>(cnt, red)) >= keep) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  float qlo = 0.0f, scale = 1.0f;
  if (levels > 1) {
    unsigned kmin = ord_key(CUDART_INF_F), kmax = ord_key(-CUDART_INF_F);
    for (int j = tid; j < len; j += step) {
      const float v = row.at(j);
      if (fabsf(v) >= lo) {
        kmin = min(kmin, ord_key(v));
        kmax = max(kmax, ord_key(v));
      }
    }
    qlo = ord_float(block_reduce<BlockOp::kMin>(kmin, red));
    const float qhi = ord_float(block_reduce<BlockOp::kMax>(kmax, red));
    scale = __fdiv_rn(nan_max(__fsub_rn(qhi, qlo), 1e-12f), static_cast<float>(levels - 1));
  }
  for (int j = tid; j < n; j += step)
    orow[j] = j < len ? quantized(row.at(j), lo, qlo, scale, levels) : 0.0f;
}

// One warp a row. V > 0: the register body for n <= 32*V; V = 0: the
// shared-memory body (dynamic shared memory, n floats a warp). V = kWide:
// one block a row, the wide body.
constexpr int kWide = -1;

template <int V, bool kDP>
__device__ __forceinline__ void compress_rows_body(const float* __restrict__ x,
                                                   const int* __restrict__ k,
                                                   const int* __restrict__ row_len,
                                                   const float* __restrict__ noise,
                                                   const float* __restrict__ clip,
                                                   const float* __restrict__ sigma,
                                                   float* __restrict__ out, int rows, int n,
                                                   int levels) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = V == kWide ? blockIdx.x : blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // warp-uniform: the reductions below see full warps
  // The row's scalars, loaded together: none waits on another.
  const int keep = k[row];
  const int len = min(max(row_len[row], 0), n);
  const float c = kDP ? *clip : 0.0f;
  const float s = kDP ? *sigma : 0.0f;
  const size_t off = static_cast<size_t>(row) * n;
  const float* nr = kDP ? noise + off : nullptr;
  if constexpr (V > 0) {
    compress_row_regs<V, kDP>(x + off, out + off, nr, c, s, len, keep, n, levels, lane,
                              smem + static_cast<size_t>(warp) * kWarp * V);
  } else if constexpr (V == 0) {
    compress_row_smem<kDP>(x + off, out + off, smem + static_cast<size_t>(warp) * n, nr, c, s,
                           len, keep, n, levels, lane);
  } else {
    compress_row_wide<kDP>(x + off, out + off, nr, c, s, len, keep, n, levels);
  }
}

template <int V>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    compress_rows_kernel(const float* __restrict__ x, const int* __restrict__ k,
                         const int* __restrict__ row_len, float* __restrict__ out, int rows,
                         int n, int levels) {
  compress_rows_body<V, false>(x, k, row_len, nullptr, nullptr, nullptr, out, rows, n, levels);
}

template <int V>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    compress_rows_dp_kernel(const float* __restrict__ x, const int* __restrict__ k,
                            const int* __restrict__ row_len, const float* __restrict__ noise,
                            const float* __restrict__ clip, const float* __restrict__ sigma,
                            float* __restrict__ out, int rows, int n, int levels) {
  compress_rows_body<V, true>(x, k, row_len, noise, clip, sigma, out, rows, n, levels);
}

struct Args {
  const float *x;
  const int *k, *row_len;
  const float *noise, *clip, *sigma;
  float* out;
  int rows, n, levels;
};

template <int V, bool kDP>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  size_t smem = 0;
  int warps = kWarpsPerBlock;
  if (kDP && V == 32) smem = warps * kWarp * V * sizeof(float);  // the staged noise rows
  if (V == 0) {  // one warp's row in shared memory; as many warps as fit
    const size_t row_bytes = static_cast<size_t>(a.n) * sizeof(float);
    if (row_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
    if (kMaxSmemBytes / row_bytes < static_cast<size_t>(warps))
      warps = static_cast<int>(kMaxSmemBytes / row_bytes);
    smem = warps * row_bytes;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          kDP ? cudaFuncSetAttribute(compress_rows_dp_kernel<V>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem))
              : cudaFuncSetAttribute(compress_rows_kernel<V>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
  }
  const int blocks = V == kWide ? a.rows : (a.rows + warps - 1) / warps;
  if (kDP) {
    compress_rows_dp_kernel<V><<<blocks, warps * kWarp, smem, stream>>>(
        a.x, a.k, a.row_len, a.noise, a.clip, a.sigma, a.out, a.rows, a.n, a.levels);
  } else {
    compress_rows_kernel<V><<<blocks, warps * kWarp, smem, stream>>>(
        a.x, a.k, a.row_len, a.out, a.rows, a.n, a.levels);
  }
  return cudaGetLastError();
}

// The body for a row width: the fewest values a lane that hold n, shared
// memory past 32 a lane, one block a row past one block's shared memory.
template <bool kDP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.rows <= 0 || a.n <= 0) return cudaErrorInvalidValue;
  if (a.n <= kWarp * 1) return launch_rows<1, kDP>(a, stream);
  if (a.n <= kWarp * 2) return launch_rows<2, kDP>(a, stream);
  if (a.n <= kWarp * 4) return launch_rows<4, kDP>(a, stream);
  if (a.n <= kWarp * 8) return launch_rows<8, kDP>(a, stream);
  if (a.n <= kWarp * 16) return launch_rows<16, kDP>(a, stream);
  if (a.n <= kWarp * 32) return launch_rows<32, kDP>(a, stream);
  if (static_cast<size_t>(a.n) * sizeof(float) <= kMaxSmemBytes)
    return launch_rows<0, kDP>(a, stream);
  return launch_rows<kWide, kDP>(a, stream);
}

}  // namespace

// x, out: [rows, n] fp32 row-major on the device; k, row_len: [rows] int32.
// Launches on `stream` and does not synchronise. Returns a cudaError_t code:
// cudaErrorInvalidValue for rows <= 0 or n <= 0, otherwise
// cudaGetLastError() after the launch.
extern "C" int compress_rows_f32(const float* x, const int* k, const int* row_len, float* out,
                                 int rows, int n, int levels, cudaStream_t stream) {
  const Args a{x, k, row_len, nullptr, nullptr, nullptr, out, rows, n, levels};
  return static_cast<int>(launch<false>(a, stream));
}

// As compress_rows_f32, with the DP stage: noise [rows, n] fp32 standard
// normals, clip and sigma one-element fp32 buffers, all on the device.
extern "C" int compress_rows_dp_f32(const float* x, const int* k, const int* row_len,
                                    const float* noise, const float* clip, const float* sigma,
                                    float* out, int rows, int n, int levels, cudaStream_t stream) {
  const Args a{x, k, row_len, noise, clip, sigma, out, rows, n, levels};
  return static_cast<int>(launch<true>(a, stream));
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
