// Fused top-k sparsify + b-level quantize over the rows of a matrix
// (C-HSGD's message compression, paper §VII-A1), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/compress.py::_fused_compress_call
// (body _compress_kernel). Per row, over the valid prefix [0, row_len):
//   1. hi = max |x|; 16-step bisection of the magnitude threshold in
//      [0, hi], moving lo up whenever count(|x| >= mid) >= k;
//   2. kept = |x| >= lo (>= k survivors: the exact top-k plus ties);
//   3. levels > 1: survivors snap to a levels-point grid over the
//      survivors' [min, max]; pruned and padding columns are written as 0.
//
// Bound: bytes. The work is ~20 compares per valid element against the
// bytes moved: the valid prefix of each row read once (4*sum(row_len)), the
// whole [rows, n] matrix written once (rows*n*4, padding as 0), and 8 bytes
// of k and row_len a row; that is far below the card's operations-per-byte
// balance. The design reads only the valid prefix of each row from device
// memory, once, into shared memory (n*4 bytes reserved per warp), runs the
// 16 count passes and the extrema out of shared memory, and writes the row
// once, coalesced. One warp owns one row, so every reduction is a
// __shfl_xor_sync butterfly and no block-level barrier is needed; several
// rows (warps) share a block.
//
// NaN: the row max propagates NaN as torch.amax does, so a row holding a NaN
// ends its bisection at lo = 0 and keeps every non-NaN valid entry, as the
// plain version does.
//
// Exactness: the plain PyTorch version (repro_torch/core/compression.py::
// compress_rows_ref) runs one eager op at a time. To match it bit for bit
// this file is built with --fmad=false and without fast math, and the
// dequantize spells out IEEE division, round-half-to-even (rintf), and a
// separately rounded multiply and add (__fmul_rn, __fadd_rn).
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

__global__ void compress_rows_kernel(const float* __restrict__ x, const int* __restrict__ k,
                                     const int* __restrict__ row_len, float* __restrict__ out,
                                     int rows, int n, int levels) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // warp-uniform: the shuffles below see full warps

  float* buf = smem + static_cast<size_t>(warp) * n;
  const float* xr = x + static_cast<size_t>(row) * n;
  float* orow = out + static_cast<size_t>(row) * n;
  const int len = min(max(row_len[row], 0), n);
  const int keep = k[row];

  // One read of the valid prefix; lane j holds columns j, j+32, ... and is
  // the only lane that touches them again, so no barrier is needed between
  // passes. Padding columns are never read.
  float hi = 0.0f;
  for (int j = lane; j < len; j += kWarp) {
    const float v = xr[j];
    buf[j] = v;
    hi = nan_max(hi, fabsf(v));
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

}  // namespace

// x, out: [rows, n] fp32 row-major on the device; k, row_len: [rows] int32.
// Launches on `stream` and does not synchronise. Returns a cudaError_t code:
// cudaErrorInvalidValue when one row does not fit in a block's shared memory,
// otherwise cudaGetLastError() after the launch.
extern "C" int compress_rows_f32(const float* x, const int* k, const int* row_len, float* out,
                                 int rows, int n, int levels, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t row_bytes = static_cast<size_t>(n) * sizeof(float);
  if (row_bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  size_t warps = kMaxSmemBytes / row_bytes;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  const size_t smem = warps * row_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        compress_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = static_cast<int>((static_cast<size_t>(rows) + warps - 1) / warps);
  compress_rows_kernel<<<blocks, static_cast<int>(warps) * kWarp, smem, stream>>>(
      x, k, row_len, out, rows, n, levels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
