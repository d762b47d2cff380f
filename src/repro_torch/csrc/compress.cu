// Fused top-k sparsify + b-level quantize over the rows of a matrix
// (C-HSGD's message compression, paper §VII-A1), for Hopper (sm_90a), with
// an optional DP stage in front (the privacy-hardened exchange).
//
// compress_rows_kernel replaces the TPU kernel
// repro/kernels/compress.py::_fused_compress_call (body _compress_kernel).
// Per row, over the valid prefix [0, row_len):
//   1. hi = max |x|; 16-step bisection of the magnitude threshold in
//      [0, hi], moving lo up whenever count(|x| >= mid) >= k;
//   2. kept = |x| >= lo (>= k survivors: the exact top-k plus ties);
//   3. levels > 1: survivors snap to a levels-point grid over the
//      survivors' [min, max]; pruned and padding columns are written as 0.
//
// compress_rows_dp_kernel replaces repro/kernels/compress.py::
// _fused_compress_dp_call (body _compress_dp_kernel): the same row body,
// preceded by the DP stage
//   s = ||x||^2; coef = min(1, C / max(sqrt(s), 1e-12));
//   y = x * coef + (sigma * C) * noise
// with C (clip) and sigma read from one-element device buffers, so a new
// sigma never changes the launch. The noise rows are an input (standard
// normals drawn by the caller), so the kernel is deterministic. The sum s
// is taken in one fixed order, which the plain version
// (repro_torch/core/compression.py::warp_order_sqnorm) repeats: lane l adds
// v*v over j = l, l+32, ... (j < row_len) in increasing j, then an xor
// butterfly over offsets 16, 8, 4, 2, 1; every lane ends with the same
// value because IEEE addition is commutative.
//
// Bound: bytes. The work is ~20 compares per valid element (a few more for
// the DP stage) against the bytes moved: the valid prefix of each row read
// once (4*sum(row_len), and as much again of noise with DP), the whole
// [rows, n] matrix written once (rows*n*4, padding as 0), and 8 bytes of k
// and row_len a row; that is far below the card's operations-per-byte
// balance. The design reads only the valid prefix of each row from device
// memory, once, into shared memory (n*4 bytes reserved per warp), runs the
// 16 count passes and the extrema out of shared memory, and writes the row
// once, coalesced. With DP the noise is read once, in the pass that turns
// x into y in shared memory. One warp owns one row, so every reduction is
// a __shfl_xor_sync butterfly and no block-level barrier is needed; several
// rows (warps) share a block.
//
// NaN: the row max propagates NaN as torch.amax does, so a row holding a NaN
// ends its bisection at lo = 0 and keeps every non-NaN valid entry, as the
// plain version does. In the DP stage the min and max propagate NaN as
// torch.minimum / torch.clamp_min do (fminf/fmaxf would drop it): a NaN in
// a row makes its norm, and so every entry of y, NaN, and the row comes out
// as zeros.
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
constexpr int kMaxWarpsPerBlock = 8;
// Shared memory a block may use on Hopper: 227 KB.
constexpr size_t kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;

// max that returns NaN when either operand is NaN (fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ float warp_nan_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One row: load the valid prefix into shared memory (with DP, turned into
// y = x*coef + (sigma*C)*noise on the way), bisect the threshold, quantize,
// write the row. Called by one whole warp; `buf` is its n floats of smem.
template <bool kDP>
__device__ __forceinline__ void compress_row(const float* __restrict__ xr, float* __restrict__ orow,
                                             float* __restrict__ buf, const float* __restrict__ nr,
                                             float clip, float sigma, int len, int keep, int n,
                                             int levels, int lane) {
  // One read of the valid prefix; lane j holds columns j, j+32, ... and is
  // the only lane that touches them again, so no barrier is needed between
  // passes. Padding columns are never read.
  float hi = 0.0f;
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
      hi = nan_max(hi, fabsf(y));
    }
  } else {
    for (int j = lane; j < len; j += kWarp) {
      const float v = xr[j];
      buf[j] = v;
      hi = nan_max(hi, fabsf(v));
    }
  }
  hi = warp_nan_max(hi);

  float lo = 0.0f;
  for (int it = 0; it < kRefine; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int j = lane; j < len; j += kWarp) c += fabsf(buf[j]) >= mid ? 1 : 0;
    if (warp_sum(c) >= keep) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  float qlo = 0.0f, scale = 1.0f;
  if (levels > 1) {
    float smin = CUDART_INF_F, smax = -CUDART_INF_F;
    for (int j = lane; j < len; j += kWarp) {
      const float v = buf[j];
      if (fabsf(v) >= lo) {
        smin = fminf(smin, v);
        smax = fmaxf(smax, v);
      }
    }
    qlo = warp_min(smin);
    const float qhi = warp_max(smax);
    scale = __fdiv_rn(fmaxf(__fsub_rn(qhi, qlo), 1e-12f), static_cast<float>(levels - 1));
  }

  for (int j = lane; j < n; j += kWarp) {
    float o = 0.0f;
    if (j < len) {
      const float v = buf[j];
      if (fabsf(v) >= lo) {
        o = v;
        if (levels > 1) {
          const float t = rintf(__fdiv_rn(__fsub_rn(v, qlo), scale));
          o = __fadd_rn(__fmul_rn(t, scale), qlo);
        }
      }
    }
    orow[j] = o;
  }
}

__global__ void compress_rows_kernel(const float* __restrict__ x, const int* __restrict__ k,
                                     const int* __restrict__ row_len, float* __restrict__ out,
                                     int rows, int n, int levels) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // warp-uniform: the shuffles below see full warps
  const size_t off = static_cast<size_t>(row) * n;
  compress_row<false>(x + off, out + off, smem + static_cast<size_t>(warp) * n, nullptr, 0.0f,
                      0.0f, min(max(row_len[row], 0), n), k[row], n, levels, lane);
}

__global__ void compress_rows_dp_kernel(const float* __restrict__ x, const int* __restrict__ k,
                                        const int* __restrict__ row_len,
                                        const float* __restrict__ noise,
                                        const float* __restrict__ clip,
                                        const float* __restrict__ sigma, float* __restrict__ out,
                                        int rows, int n, int levels) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // warp-uniform: the shuffles below see full warps
  const size_t off = static_cast<size_t>(row) * n;
  compress_row<true>(x + off, out + off, smem + static_cast<size_t>(warp) * n, noise + off, *clip,
                     *sigma, min(max(row_len[row], 0), n), k[row], n, levels, lane);
}

// Rows per block and dynamic shared memory for rows of n floats; sets the
// kernel's shared-memory limit when it is above the 48 KB default.
template <typename Kernel>
cudaError_t launch_shape(Kernel kernel, int rows, int n, int* blocks, int* threads, size_t* smem) {
  if (rows <= 0 || n <= 0) return cudaErrorInvalidValue;
  const size_t row_bytes = static_cast<size_t>(n) * sizeof(float);
  if (row_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  size_t warps = kMaxSmemBytes / row_bytes;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  *smem = warps * row_bytes;
  if (*smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(*smem));
    if (e != cudaSuccess) return e;
  }
  *blocks = static_cast<int>((static_cast<size_t>(rows) + warps - 1) / warps);
  *threads = static_cast<int>(warps) * kWarp;
  return cudaSuccess;
}

}  // namespace

// x, out: [rows, n] fp32 row-major on the device; k, row_len: [rows] int32.
// Launches on `stream` and does not synchronise. Returns a cudaError_t code:
// cudaErrorInvalidValue when one row does not fit in a block's shared memory,
// otherwise cudaGetLastError() after the launch.
extern "C" int compress_rows_f32(const float* x, const int* k, const int* row_len, float* out,
                                 int rows, int n, int levels, cudaStream_t stream) {
  int blocks = 0, threads = 0;
  size_t smem = 0;
  const cudaError_t e = launch_shape(compress_rows_kernel, rows, n, &blocks, &threads, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  compress_rows_kernel<<<blocks, threads, smem, stream>>>(x, k, row_len, out, rows, n, levels);
  return static_cast<int>(cudaGetLastError());
}

// As compress_rows_f32, with the DP stage: noise [rows, n] fp32 standard
// normals, clip and sigma one-element fp32 buffers, all on the device.
extern "C" int compress_rows_dp_f32(const float* x, const int* k, const int* row_len,
                                    const float* noise, const float* clip, const float* sigma,
                                    float* out, int rows, int n, int levels, cudaStream_t stream) {
  int blocks = 0, threads = 0;
  size_t smem = 0;
  const cudaError_t e = launch_shape(compress_rows_dp_kernel, rows, n, &blocks, &threads, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  compress_rows_dp_kernel<<<blocks, threads, smem, stream>>>(x, k, row_len, noise, clip, sigma,
                                                             out, rows, n, levels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
