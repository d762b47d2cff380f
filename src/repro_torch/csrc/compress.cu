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
//     runs W slots with no guard.
//   - Rows wider than 1024, up to 262144 floats: the group body
//     (compress_group_kernel), one row on a warp, on a CTA of G warps or on
//     a thread-block cluster of C CTAs, read from device memory once. CTA
//     `rank` of a cluster holds the slice of S columns from rank * S (S a
//     multiple of 32); thread t holds V values, the quads of slice columns
//     4(t + T*i) + 0..3, so a read from shared memory and a write to device
//     memory is one 16-byte access where the row is 16-byte aligned. The
//     CTAs are persistent: while a row runs its passes, the next row's
//     slice comes into the CTA's stage in shared memory by cp.async; at the
//     row's start it moves to registers, and max |x|, the 16 counts, the
//     extrema, the quantize and the one write run there. A row's k and
//     row_len come a row ahead the same way, so no per-row scalar is held
//     in a register across a row.
//     A count is a compare and a predicated add an element (summed as one
//     tree, the 0/1 of all V elements were held at once and spilled). A
//     step's values are summed a warp by REDUX, sent to a slot in every
//     CTA of the cluster and combined after one barrier: __syncthreads, or
//     for C > 1 the CTA's mbarrier, which completes when every warp of the
//     cluster has sent its 16 bytes by st.async. A cluster.sync, or an
//     mbarrier arrival with release semantics, also waits for the CTA's
//     earlier stores to device memory (the previous row's output), and was
//     slower. The slots are double-buffered, so no second barrier.
//     With DP, the row's first warp (with C > 1, warp 0 of each CTA in rank
//     order, handing its 32 lane sums on by st.async) walks the stage for
//     the norm, a batch of squares ahead of its adds; then y = x*coef +
//     (sigma*C)*noise goes to the registers, the noise read once from
//     device memory beside x from the stage (staged through shared memory
//     instead, the x values waiting for it spilled), the next row's noise
//     prefetched into L2. Buckets, from the card's times
//     (launch/profile_compress.py):
//       n in (1024, 1280]:      one warp a row, V = 40, 8 rows a block, no
//                               barrier (1152-wide rows on five warps with a
//                               barrier a step ran 1.36x the old one-warp
//                               body)
//       n in (1280, 32768]:     C = 1, V = 64, T = 32 * ceil(n / 2048)
//       n in (32768, 65536]:    C = 2, V = 64, T up to 512 a CTA
//       n in (65536, 131072]:   C = 4, V = 64
//       n in (131072, 262144]:  C = 8, V = 64 (8 CTAs: the portable limit)
//     64 values a thread on at most 512 threads leave 128 registers a
//     thread; 32 on 1024 and 48 on 704 threads spilled, and 48 was slower
//     on clusters. Rows wider still take the wide body (compress_row_wide):
//     one block a row, read from device memory at every pass.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRefine = 16;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
// Rows this narrow are loaded whole, padding included (V <= 4).
constexpr int kWholeLoadBytes = 512;
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

// Reductions over a row held by many threads: the sum, max or min of one
// unsigned value a thread. kNone marks an absent second value.
enum class BlockOp { kAdd, kMax, kMin, kNone };

template <BlockOp kOp>
__device__ __forceinline__ unsigned warp_reduce(unsigned v) {
  if constexpr (kOp == BlockOp::kAdd) return __reduce_add_sync(kFull, v);
  if constexpr (kOp == BlockOp::kMax) return __reduce_max_sync(kFull, v);
  if constexpr (kOp == BlockOp::kMin) return __reduce_min_sync(kFull, v);
  return v;
}

template <BlockOp kOp>
__device__ __forceinline__ unsigned combine(unsigned a, unsigned b) {
  if constexpr (kOp == BlockOp::kAdd) return a + b;
  if constexpr (kOp == BlockOp::kMax) return max(a, b);
  if constexpr (kOp == BlockOp::kMin) return min(a, b);
  return a;
}

template <BlockOp kOp>
__device__ __forceinline__ unsigned identity() {
  return kOp == BlockOp::kMin ? ~0u : 0u;
}

// The group body: rows wider than 1024 floats, up to kClusterRowFloats.
// One warp a row up to kWarpRowFloats (values a lane, rows a block); past
// it, most threads of a CTA, values a thread, floats a CTA's slice, CTAs a
// cluster (the portable limit) and floats a row.
constexpr int kWarpRowValues = 40;
constexpr int kWarpRowsPerBlock = 8;
constexpr int kWarpRowFloats = kWarp * kWarpRowValues;
constexpr int kSliceFloats = 32768;
constexpr int kGroupValues = 64;
constexpr int kGroupThreads =
    (kSliceFloats + kWarp * kGroupValues - 1) / (kWarp * kGroupValues) * kWarp;
constexpr int kMaxCluster = 8;
constexpr int kClusterRowFloats = kMaxCluster * kSliceFloats;
static_assert(kClusterRowFloats == 262144, "kernels/compress.py::CLUSTER_ROW_FLOATS mirrors it");

// A row's layout in the group body. C = 0: one warp a row (T = 32 threads,
// V = kWarpRowValues), kWarpRowsPerBlock rows a block at once. C >= 1: one
// CTA a row (C = 1) or a cluster of C CTAs, CTA `rank` holding the slice of
// S columns from rank * S (S a multiple of 32, so a lane's columns keep
// their residue mod 32 in every slice), on T threads of V = kGroupValues
// values, the fewest warps that hold the slice; C is the fewest of 1, 2,
// 4, 8 whose slices hold at most kSliceFloats. Thread t of a row holds the
// quads of slice columns 4(t + T*i) .. 4(t + T*i) + 3, i < V/4. `threads`
// is the CTA's (kWarpRowsPerBlock warps at C = 0).
struct GroupShape {
  int V, C, S, threads;
};

__host__ __device__ inline bool group_shape(int n, GroupShape& g) {
  if (n <= kWarpRowFloats) {
    g = {kWarpRowValues, 0, (n + kWarp - 1) / kWarp * kWarp, kWarp * kWarpRowsPerBlock};
    return true;
  }
  for (int C = 1; C <= kMaxCluster; C *= 2) {
    const int S = ((n - 1) / C + kWarp) / kWarp * kWarp;
    if (S > kSliceFloats) continue;
    constexpr int kPerWarp = kWarp * kGroupValues;
    g = {kGroupValues, C, S, (S + kPerWarp - 1) / kPerWarp * kWarp};
    return true;
  }
  return false;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

// src's offset in floats past a 16-byte boundary.
__device__ __forceinline__ int float_shift(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
}

// Copy src[0, cnt) to stage[shift, shift + cnt) by cp.async: 16-byte copies
// where src - shift lies on a 16-byte boundary (stage does), 4-byte ones at
// the two ends and where it does not. Called by the row's T threads (t is
// the caller's index among them); done at cp_async_wait_all().
__device__ __forceinline__ void copy_slice(float* stage, const float* src, int cnt, int shift,
                                           int t, int T) {
  const float* base = src - shift;
  if ((reinterpret_cast<uintptr_t>(base) & 15u) == 0) {
    const int end = shift + cnt;
    for (int p = 4 * t; p < end; p += 4 * T) {
      if (p >= shift && p + 4 <= end) {
        cp_async16(stage + p, base + p);
      } else {
        for (int q = max(p, shift); q < min(p + 4, end); ++q) cp_async4(stage + q, base + q);
      }
    }
  } else {
    for (int j = t; j < cnt; j += T) cp_async4(stage + shift + j, src + j);
  }
}

// Bring src[0, cnt) into L2, a 128-byte line a thread at a time (T threads,
// t the caller's index); holds no register past the instruction.
__device__ __forceinline__ void prefetch_l2(const float* src, int cnt, int t, int T) {
  for (int j = 32 * t; j < cnt; j += 32 * T)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + j));
}

// stage[p + shift, p + shift + 4) for p a multiple of 4: one 16-byte read,
// or two and a select when the row is not 16-byte aligned.
__device__ __forceinline__ float4 stage_quad(const float* stage, int p, int shift) {
  const float4 a = *reinterpret_cast<const float4*>(stage + p);
  if (shift == 0) return a;
  const float4 b = *reinterpret_cast<const float4*>(stage + p + 4);
  if (shift == 1) return make_float4(a.y, a.z, a.w, b.x);
  if (shift == 2) return make_float4(a.z, a.w, b.x, b.y);
  return make_float4(a.w, b.x, b.y, b.z);
}

// The running sum of squares of one lane over columns lane, lane + 32, ...
// below cnt, in increasing order, from s. Batches of kBatch squares are read
// and formed a batch ahead of their adds, so only the adds wait on each
// other: the chain runs at the add's latency.
template <int kBatch>
__device__ __forceinline__ float chain_sqsum(const float* row, int cnt, int lane, float s) {
  constexpr int kSpan = kWarp * kBatch;
  const int full = cnt > lane ? (cnt - lane + kWarp - 1) / kSpan : 0;  // this lane's batches
  const float* p = row + lane;
  float sq[kBatch];
  if (full > 0) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) sq[b] = __fmul_rn(p[kWarp * b], p[kWarp * b]);
  }
#pragma unroll 1
  for (int batch = 1; batch < full; ++batch) {
    p += kSpan;
    float nxt[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) nxt[b] = __fmul_rn(p[kWarp * b], p[kWarp * b]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) s = __fadd_rn(s, sq[b]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) sq[b] = nxt[b];
  }
  if (full > 0) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) s = __fadd_rn(s, sq[b]);
    p += kSpan;
  }
  for (int j = static_cast<int>(p - row); j < cnt; j += kWarp)
    s = __fadd_rn(s, __fmul_rn(row[j], row[j]));
  return s;
}

// cnt += (|v| >= mid) as a compare and a predicated add (NaN compares
// false). Summed as one tree, the 0/1 of every element were held at once,
// and |v| taken outside the asm was hoisted out of the bisection loop for
// all V values; both spilled.
__device__ __forceinline__ void add_ge(unsigned& cnt, float v, float mid) {
  asm("{\n"
      ".reg .f32 a;\n"
      ".reg .pred p;\n"
      "abs.f32 a, %1;\n"
      "setp.ge.f32 p, a, %2;\n"
      "@p add.u32 %0, %0, 1;\n"
      "}\n"
      : "+r"(cnt)
      : "f"(v), "f"(mid));
}

// count(|v[i]| >= mid) over a thread's V values, in four running sums.
template <int V>
__device__ __forceinline__ unsigned count_ge(const float (&v)[V], float mid) {
  unsigned c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < V; ++i) add_ge(c[i % 4], v[i], mid);
  return (c[0] + c[1]) + (c[2] + c[3]);
}

// The shared::cluster address of `local`'s twin in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(local))), "r"(rank));
  return r;
}

// Store v (one or four 32-bit words) into shared memory of the cluster at
// `addr`, completing its bytes of transaction on the mbarrier at `bar`
// (both shared::cluster addresses). Unlike a release, it does not wait for
// this thread's earlier stores to device memory.
__device__ __forceinline__ void store_async(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void store_async4(unsigned addr, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// This thread's arrival on its CTA's mbarrier `bar` for the current phase,
// which then also waits for `bytes` of transaction.
__device__ __forceinline__ void arrive_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(bar))),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `phase` of this CTA's mbarrier `bar` has
// completed; what the arrivals ordered before it is then visible here.
__device__ __forceinline__ void wait_phase(const unsigned long long* bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))),
      "r"(phase)
      : "memory");
}

// The exchange of a row's step values (one to three unsigned values a
// step, of ops kA, kB, kC; kNone marks an absent one) among the row's
// threads. C = 0: the row's warp alone (REDUX). C = 1: REDUX a warp, the
// warps' results into shared-memory slots, one __syncthreads, every warp
// combines the G slots. C > 1: REDUX a warp; lane j sends the warp's
// results (16 bytes) to its slot in CTA j of the cluster by st.async,
// completing that many bytes on CTA j's mbarrier, where thread 0 has
// arrived expecting C*G*16; every warp waits on its own CTA's mbarrier and
// combines the C*G slots. Two buffers of slots (each with its mbarrier)
// alternate by step: a buffer is written again two steps later, with values
// computed from the step between, which every warp sends only after reading
// the buffer.
template <int C>
struct RowExchange {
  static constexpr int kSlots = C > 0 ? C * kWarp : 1;
  uint4* slots;              // [2 buffers][kSlots]
  unsigned long long* bars;  // [2 buffers], C > 1
  int rank;
  int parity = 0;
  unsigned phases = 0;  // bit p: the parity of the phase of bars[p] to wait for

  template <BlockOp kA, BlockOp kB = BlockOp::kNone, BlockOp kC = BlockOp::kNone>
  __device__ __forceinline__ void reduce(unsigned& a, unsigned& b, unsigned& c) {
    constexpr bool kHasB = kB != BlockOp::kNone, kHasC = kC != BlockOp::kNone;
    a = warp_reduce<kA>(a);
    if constexpr (kHasB) b = warp_reduce<kB>(b);
    if constexpr (kHasC) c = warp_reduce<kC>(c);
    if constexpr (C > 0) {
      const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
      const int G = blockDim.x / kWarp;
      uint4* s = slots + parity * kSlots;
      const int idx = rank * G + warp;
      if constexpr (C == 1) {
        if (lane == 0) s[idx] = make_uint4(a, b, c, 0u);
        __syncthreads();
      } else {
        if (threadIdx.x == 0) arrive_expect(bars + parity, C * G * sizeof(uint4));
        if (lane < C)
          store_async4(cluster_addr(s + idx, lane), make_uint4(a, b, c, 0u),
                       cluster_addr(bars + parity, lane));
        wait_phase(bars + parity, (phases >> parity) & 1u);
        phases ^= 1u << parity;
      }
      unsigned ra = identity<kA>(), rb = identity<kB>(), rc = identity<kC>();
      for (int i = lane; i < C * G; i += kWarp) {
        const uint4 q = s[i];
        ra = combine<kA>(ra, q.x);
        if constexpr (kHasB) rb = combine<kB>(rb, q.y);
        if constexpr (kHasC) rc = combine<kC>(rc, q.z);
      }
      a = warp_reduce<kA>(ra);
      if constexpr (kHasB) b = warp_reduce<kB>(rb);
      if constexpr (kHasC) c = warp_reduce<kC>(rc);
      parity ^= 1;
    }
  }
};

// Noise columns [col, col + 4) of a row, those at or past lc as 0: one
// 16-byte read where the row is 16-byte aligned (vec) and the quad whole.
__device__ __forceinline__ float4 noise_quad(const float* nrow, int col, int lc, bool vec) {
  if (vec && col + 4 <= lc) return __ldg(reinterpret_cast<const float4*>(nrow + col));
  return make_float4(__ldg(nrow + col), col + 1 < lc ? __ldg(nrow + col + 1) : 0.0f,
                     col + 2 < lc ? __ldg(nrow + col + 2) : 0.0f,
                     col + 3 < lc ? __ldg(nrow + col + 3) : 0.0f);
}

// *p, read where it is used: not hoisted out of the row loop.
__device__ __forceinline__ float load_volatile(const float* p) {
  float r;
  asm volatile("ld.global.f32 %0, [%1];\n" : "=f"(r) : "l"(p));
  return r;
}

// The CTA's thread count, read anew at each use: held as one value, every
// quad's column offset was hoisted out of the row loop and spilled.
__device__ __forceinline__ int thread_count() {
  int r;
  asm volatile("mov.u32 %0, %%ntid.x;\n" : "=r"(r));
  return r;
}

// Write slice columns [col, col + 4) of a slice `width` columns wide: one
// 16-byte store where the row is 16-byte aligned (vec) and the quad whole,
// else a store a column inside the slice.
__device__ __forceinline__ void store_quad(float* orow, int col, int width, bool vec, float4 q) {
  if (vec && col + 4 <= width) {
    *reinterpret_cast<float4*>(orow + col) = q;
    return;
  }
  if (col < width) orow[col] = q.x;
  if (col + 1 < width) orow[col + 1] = q.y;
  if (col + 2 < width) orow[col + 2] = q.z;
  if (col + 3 < width) orow[col + 3] = q.w;
}

// The group body's kernel: persistent rows of a warp (C = 0), a block
// (C = 1) or a cluster, each taking rows first, first + stride, ... . A
// row's slice is read from device memory once, by cp.async into the row's
// stage in shared memory while the row before runs its passes; it then
// moves to registers and every pass runs there: max |x|, the 16 bisection
// counts, the survivors' extrema, the quantize and the one write. With DP,
// the row's first warp sums the squares over the stage in the plain
// version's order first (with C > 1, the CTAs in rank order, each handing
// its 32 lane sums to the next through distributed shared memory); then
// y = x*coef + (sigma*C)*noise goes to the registers, the noise read from
// device memory once, beside x from the stage.
template <int V, int C, bool kDP>
__global__ void __launch_bounds__(C == 0 ? kWarp * kWarpRowsPerBlock : kGroupThreads, 1)
    compress_group_kernel(const float* __restrict__ x, const int* __restrict__ k,
                          const int* __restrict__ row_len, const float* __restrict__ noise,
                          const float* __restrict__ clip, const float* __restrict__ sigma,
                          float* __restrict__ out, int rows, int n, int levels, int S) {
  static_assert(V % 4 == 0, "a thread holds whole quads");
  constexpr int kQuads = V / 4;
  constexpr bool kWarpRow = C == 0;
  constexpr int kCtas = kWarpRow ? 1 : C;
  extern __shared__ __align__(16) float stages[];  // S + 4 floats a row of the block
  __shared__ uint4 slots[2 * RowExchange<C>::kSlots];
  // with C > 1 the step exchange's two buffers, the DP norm's carry and
  // result: one arrival each and the bytes sent
  __shared__ unsigned long long bars[4];
  __shared__ float carry[kWarp];
  __shared__ float norm2;
  // k and row_len of the row a row group takes next, by cp.async a row
  // ahead, in two slots by row parity: not held in registers across a row
  __shared__ int2 next_row[kWarpRow ? kWarpRowsPerBlock : 1][2];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int t = kWarpRow ? lane : threadIdx.x;  // the thread's index among its row's T
  const int per_block = kWarpRow ? blockDim.x / kWarp : 1;
  float* stage = stages + (kWarpRow ? warp : 0) * (S + 4);
  int rank = 0;
  if constexpr (C > 1) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    if (threadIdx.x == 0) {
      for (int p = 0; p < 4; ++p) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
            static_cast<unsigned>(__cvta_generic_to_shared(bars + p))));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cg::this_cluster().sync();  // every CTA's mbarriers are set before any arrival
  }
  RowExchange<C> xchg{slots, bars, rank};
  const unsigned c0 = static_cast<unsigned>(rank * S);  // 32 bits: no sign-extended copy
  const int width = max(0, min(S, n - static_cast<int>(c0)));
  const int first = blockIdx.x / kCtas * per_block + (kWarpRow ? warp : 0);
  const int stride = gridDim.x / kCtas * per_block;
  // a row's valid columns in this CTA's slice, from its row_len
  auto clamp_len = [&](int len) {
    return max(0, min(min(max(len, 0), n) - static_cast<int>(c0), width));
  };
  auto slice_len = [&](int r) { return clamp_len(row_len[r]); };
  auto slice = [&](const float* m, int r) { return m + static_cast<size_t>(r) * n + c0; };
  auto sync_row = [&]() {
    if constexpr (kWarpRow) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  };
  // the row's slice from the stage into v[] (NaN at or past lc), with DP
  // (nrow: the row's noise slice) as y = x*coef + noise_scale*noise, the
  // noise read from device memory here, a quad at a time (16 bytes where
  // nvec); returns the max |value| bit pattern over the valid columns
  float v[V];
  auto from_stage = [&](int lc, int shift, const float* nrow, bool nvec, float coef,
                        float noise_scale) {
    const int T = kWarpRow ? kWarp : thread_count();
    unsigned hbits = 0;
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int col = 4 * (t + T * i);
      const float4 q = col < lc ? stage_quad(stage, col, shift) : make_float4(0, 0, 0, 0);
      float4 z = make_float4(0, 0, 0, 0);
      if (kDP && col < lc) z = noise_quad(nrow, col, lc, nvec);
      const float xs[4] = {q.x, q.y, q.z, q.w}, zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = col + e < lc;
        const float y =
            kDP ? __fadd_rn(__fmul_rn(xs[e], coef), __fmul_rn(noise_scale, zs[e])) : xs[e];
        hbits = max(hbits, valid ? mag_bits(y) : 0u);
        v[4 * i + e] = valid ? y : CUDART_NAN_F;
      }
    }
    return hbits;
  };
  unsigned chain_rows = 0;  // rows whose DP norm this CTA has taken (C > 1)
  int2* scalars = next_row[kWarpRow ? warp : 0];
  // row r's k and row_len into scalars[slot], by thread 0 of the row group
  auto fetch_scalars = [&](int r, int slot) {
    cp_async4(reinterpret_cast<float*>(&scalars[slot].x), reinterpret_cast<const float*>(k + r));
    cp_async4(reinterpret_cast<float*>(&scalars[slot].y),
              reinterpret_cast<const float*>(row_len + r));
  };
  if (first < rows) {
    if (t == 0) fetch_scalars(first, 0);
    copy_slice(stage, slice(x, first), slice_len(first), float_shift(slice(x, first)), t,
               kWarpRow ? kWarp : thread_count());
  }
  int turn = 0;
#pragma unroll 1
  for (int row = first; row < rows; row += stride, turn ^= 1) {
    const int next = row + stride;
    const int shift = float_shift(slice(x, row));
    cp_async_wait_all();
    sync_row();
    const int lc = clamp_len(scalars[turn].y);
    if (t == 0 && next < rows) fetch_scalars(next, turn ^ 1);
    unsigned hbits;
    if constexpr (kDP) {
      // ||x||^2 in the plain version's order, lane l over columns j = l
      // (mod 32) of the row in increasing j, then the butterfly; before x
      // moves to registers, so that the chain's registers are free.
      float nrm;
      if constexpr (C <= 1) {
        if (kWarpRow || warp == 0) {
          nrm = warp_sum_ordered(chain_sqsum<8>(stage + shift, lc, lane, 0.0f));
          if (!kWarpRow && lane == 0) norm2 = nrm;
        }
        if constexpr (!kWarpRow) {
          __syncthreads();
          nrm = norm2;
        }
      } else {
        // warp 0 of each CTA in rank order: wait for the 32 lane sums of the
        // CTA before (rank > 0), add its slice, send the sums on to the next
        // CTA, or, in the last CTA, butterfly and send the norm to every CTA
        // (st.async, completing the bytes on the receiver's mbarrier)
        const unsigned phase = chain_rows & 1u;
        if (threadIdx.x == 0) {
          if (rank > 0) arrive_expect(bars + 2, kWarp * sizeof(float));
          arrive_expect(bars + 3, sizeof(float));
        }
        if (warp == 0) {
          float s = 0.0f;
          if (rank > 0) {
            wait_phase(bars + 2, phase);
            s = carry[lane];
          }
          s = chain_sqsum<16>(stage + shift, lc, lane, s);
          if (rank + 1 < C) {
            store_async(cluster_addr(carry + lane, rank + 1), __float_as_uint(s),
                        cluster_addr(bars + 2, rank + 1));
          } else {
            s = warp_sum_ordered(s);
            if (lane < C)
              store_async(cluster_addr(&norm2, lane), __float_as_uint(s),
                          cluster_addr(bars + 3, lane));
          }
        }
        wait_phase(bars + 3, phase);
        ++chain_rows;
        nrm = norm2;
      }
      // C and sigma read at each row, not held in registers across it
      const float c = load_volatile(clip), sg = load_volatile(sigma);
      const float coef = nan_min(1.0f, __fdiv_rn(c, nan_max(__fsqrt_rn(nrm), 1e-12f)));
      const float noise_scale = __fmul_rn(sg, c);
      const float* nrow = slice(noise, row);
      hbits = from_stage(lc, shift, nrow, (reinterpret_cast<uintptr_t>(nrow) & 15u) == 0, coef,
                         noise_scale);
    } else {
      hbits = from_stage(lc, shift, nullptr, false, 0.0f, 0.0f);
    }
    if (t == 0) cp_async_wait_all();  // the next row's k and row_len
    sync_row();  // every thread has read the stage: the next row may land there
    if (next < rows) {
      const int lc_next = clamp_len(scalars[turn ^ 1].y);
      copy_slice(stage, slice(x, next), lc_next, float_shift(slice(x, next)), t,
                 kWarpRow ? kWarp : thread_count());
      // the next row's noise into L2, so that its y pass waits on L2
      if constexpr (kDP)
        prefetch_l2(slice(noise, next), lc_next, t, kWarpRow ? kWarp : thread_count());
    }

    const int keep = scalars[turn].x;
    unsigned u0 = 0, u1 = 0;
    xchg.template reduce<BlockOp::kMax>(hbits, u0, u1);
    float hi = __uint_as_float(hbits);
    float lo = 0.0f;
#pragma unroll 1
    for (int r = 0; r < kRefine; ++r) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      unsigned cnt = count_ge(v, mid);
      xchg.template reduce<BlockOp::kAdd>(cnt, u0, u1);
      if (static_cast<int>(cnt) >= keep) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    float qlo = 0.0f, scale = 1.0f;
    if (levels > 1) {
      unsigned kmin = ord_key(CUDART_INF_F), kmax = ord_key(-CUDART_INF_F);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (fabsf(v[i]) >= lo) {
          kmin = min(kmin, ord_key(v[i]));
          kmax = max(kmax, ord_key(v[i]));
        }
      }
      xchg.template reduce<BlockOp::kMin, BlockOp::kMax>(kmin, kmax, u0);
      qlo = ord_float(kmin);
      const float qhi = ord_float(kmax);
      scale = __fdiv_rn(nan_max(__fsub_rn(qhi, qlo), 1e-12f), static_cast<float>(levels - 1));
    }
    // C >= 1: quantize in place, then store, so that no address is live
    // across the division's slow-path calls (one warp a row has the
    // registers to spare, and stores as it goes)
    if constexpr (!kWarpRow) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = quantized(v[i], lo, qlo, scale, levels);
    }
    float* orow = out + static_cast<size_t>(row) * n + c0;
    const bool vec = (reinterpret_cast<uintptr_t>(orow) & 15u) == 0;
    const int Tw = kWarpRow ? kWarp : thread_count();
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int col = 4 * (t + Tw * i);
      if (col < width) {
        float4 q = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
        if constexpr (kWarpRow) {
          q = make_float4(quantized(q.x, lo, qlo, scale, levels),
                          quantized(q.y, lo, qlo, scale, levels),
                          quantized(q.z, lo, qlo, scale, levels),
                          quantized(q.w, lo, qlo, scale, levels));
        }
        store_quad(orow, col, width, vec, q);
      }
    }
  }
  if constexpr (C > 1) cg::this_cluster().sync();  // no CTA leaves while others may write it
}

// The wide body's block: the sum, max or min of one unsigned value a
// thread over the whole block (REDUX a warp, then the warps' results in
// shared memory, read by every thread). Called by every thread of the block.
template <BlockOp kOp>
__device__ __forceinline__ unsigned block_reduce(unsigned v, unsigned* red) {
  v = warp_reduce<kOp>(v);
  const int warps = blockDim.x / kWarp;
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  unsigned r = red[0];
  for (int w = 1; w < warps; ++w) r = combine<kOp>(r, red[w]);
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

// The wide body: rows past kClusterRowFloats (wider than any in the
// repository's configs), one block a row, read from device memory at every
// pass. Thread t reads columns t, t + blockDim.x, ... of the valid
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

// One warp a row. V > 0: the register body for n <= 32*V. V = kWide: one
// block a row, the wide body.
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

// The group body at its shape: persistent, as many CTAs (clusters) as the
// card holds at once, at most as many as the rows need; a stage of S + 4
// floats of dynamic shared memory for each row a CTA runs at once.
template <int C, bool kDP>
cudaError_t launch_group(const Args& a, const GroupShape& g, cudaStream_t stream) {
  constexpr int V = C == 0 ? kWarpRowValues : kGroupValues;
  const auto kernel = compress_group_kernel<V, C, kDP>;
  const int per_cta = C == 0 ? g.threads / kWarp : 1;  // rows a CTA runs at once
  const size_t smem = per_cta * (static_cast<size_t>(g.S) + 4) * sizeof(float);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C > 1 ? C : 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C > 1 ? C : 1);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = C > 1 ? 1 : 0;
  int resident = 0;
  if (C <= 1) {
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, g.threads, smem);
    resident = per_sm * sms;
  } else {
    e = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  }
  if (e != cudaSuccess) return e;
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const int needed = (a.rows + per_cta - 1) / per_cta;
  cfg.gridDim = dim3(static_cast<unsigned>((needed < resident ? needed : resident) *
                                           (C > 1 ? C : 1)));
  e = cudaLaunchKernelEx(&cfg, kernel, a.x, a.k, a.row_len, a.noise, a.clip, a.sigma, a.out,
                         a.rows, a.n, a.levels, g.S);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The body for a row width: the fewest values a lane that hold n up to
// 1024, the group body (one CTA or a cluster a row) up to
// kClusterRowFloats, one block a row past it.
template <bool kDP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.rows <= 0 || a.n <= 0) return cudaErrorInvalidValue;
  if (a.n <= kWarp * 1) return launch_rows<1, kDP>(a, stream);
  if (a.n <= kWarp * 2) return launch_rows<2, kDP>(a, stream);
  if (a.n <= kWarp * 4) return launch_rows<4, kDP>(a, stream);
  if (a.n <= kWarp * 8) return launch_rows<8, kDP>(a, stream);
  if (a.n <= kWarp * 16) return launch_rows<16, kDP>(a, stream);
  if (a.n <= kWarp * 32) return launch_rows<32, kDP>(a, stream);
  GroupShape g;
  if (!group_shape(a.n, g)) return launch_rows<kWide, kDP>(a, stream);
  if (g.C == 0) return launch_group<0, kDP>(a, g, stream);
  if (g.C == 1) return launch_group<1, kDP>(a, g, stream);
  if (g.C == 2) return launch_group<2, kDP>(a, g, stream);
  if (g.C == 4) return launch_group<4, kDP>(a, g, stream);
  return launch_group<kMaxCluster, kDP>(a, g, stream);
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

// The body that compress_rows_f32 and compress_rows_dp_f32 run for rows of
// n floats, into info[0..3]: body (1 registers, 2 group, 3 wide), values a
// thread (a lane), CTAs a row and threads that hold the row on each CTA (32:
// one warp a row). Returns 0, or
// cudaErrorInvalidValue for n <= 0.
extern "C" int compress_body_info(int n, int* info) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  GroupShape g;
  if (n <= kWarp * 32) {
    int v = 1;
    while (kWarp * v < n) v *= 2;
    info[0] = 1, info[1] = v, info[2] = 1, info[3] = kWarp * kWarpsPerBlock;
  } else if (group_shape(n, g)) {
    info[0] = 2, info[1] = g.V, info[2] = g.C > 1 ? g.C : 1, info[3] = g.C == 0 ? kWarp : g.threads;
  } else {
    info[0] = 3, info[1] = 0, info[2] = 1, info[3] = kWarp * kWarpsPerBlock;
  }
  return 0;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
