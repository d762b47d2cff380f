// Causal flash attention with a runtime sliding window, forward only, for
// Hopper (sm_90a): the long-prompt prefill attention of the serving path.
//
// flash_fwd_kernel replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel). On q, k, v [BH, S, D] (KV heads already repeated to the
// query heads), for every row i < S:
//   s_ij = (scale * q_i) . k_j over the unmasked j: j <= i, j < S, and
//          (window <= 0 or j > i - window);
//   out_i = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i),
// with an online softmax over 64-key tiles: per row a running max m and sum
// l in fp32, the accumulator rescaled by exp(m_old - m_new) at each tile.
// fp32 or bf16 in (bf16 is read into fp32), fp32 accumulation, the output
// in the input's type. The window is a runtime argument, so gemma3's 5:1
// local:global schedule runs one build and one instantiation per (D, type).
//
// Masking keeps the reference's finite NEG_INF = -2e38. KV tiles that are
// wholly masked for the block's rows (above the diagonal, or before the
// window of its first row) are skipped, which is exact: a tile that is
// masked only for some rows gives those rows p = exp(-2e38 + 2e38) = 1
// while their running max is still -2e38, and the first tile holding one of
// their keys wipes that with corr = exp(-2e38 - m) = 0; every valid row
// reaches its diagonal key, so the wipe always happens. Keys and values
// past S are staged as zeros, so a wiped entry is never 0 * NaN.
//
// Bound: operations. At the serving path's shape (gemma3-1b, [8, 4096,
// 256]) the kernel does 4*D flops for each unmasked (i, j) pair, 8.6e10 at
// window 0, against 4*BH*S*D*4 = 134 MB that it must move: about 640 flops
// a byte, far above the card's fp32 balance (67 TFLOP/s over 3.35 TB/s, 20
// flops a byte). This first design keeps to fp32 FFMA outside the tensor
// cores, so the fp32 rate is its ceiling: one block of 256 threads per
// (bh, 64-row query tile) holds the scaled Q tile in shared memory for the
// whole KV loop and stages each 64-key K and V tile beside it (rows padded
// by 4 floats, so the 16-byte reads of 8 neighbouring threads hit 32
// distinct banks). Each thread computes a 4x4 block of the score tile
// (16 FFMA per 2 float4 reads), a warp per 8 rows does the softmax update,
// and each thread accumulates 4 rows x D/16 columns of the output in
// registers (16 FFMA per float4 read of V). At D = 256 the tiles take
// 212 KB of dynamic shared memory, so one block runs per SM.
//
// Tensor cores (wgmma on TF32 or bf16), TMA and a pipelined KV ring are for
// a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;       // floats of padding per shared-memory row
constexpr int kLdS = kBK + 1;  // row stride of the score tile
constexpr float kNegInf = -2.0e38f;
// Shared memory a block may use on Hopper: 227 KB.
constexpr size_t kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Shape {
  static_assert(D % 32 == 0 && D <= 256, "head_dim must be 32, 64, 128 or 256");
  static constexpr int kLd = D + kPad;  // row stride of Q, K and V in shared memory
  static constexpr size_t kSmemFloats =
      static_cast<size_t>(kBQ + 2 * kBK) * kLd + kBQ * kLdS + 3 * kBQ;
  // P.V layout: kNCG column groups, each reading float4 chunks of V at a
  // stride of 4*kNCG columns; kNRG row groups of kRPT rows each.
  static constexpr int kNCG = (D / 4 < 16) ? D / 4 : 16;
  static constexpr int kNRG = kThreads / kNCG;
  static constexpr int kRPT = kBQ / kNRG;
  static constexpr int kChunks = D / (4 * kNCG);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [row0, row0 + kRows) of a [S, D] matrix into shared memory (row
// stride D + kPad), times `mul`; rows at or past S are written as zeros.
template <int D, int kRows, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S, float mul) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) {
      v = load4(src + static_cast<size_t>(row0 + r) * D + c);
      v.x *= mul;
      v.y *= mul;
      v.z *= mul;
      v.w *= mul;
    }
    store4(dst + r * Shape<D>::kLd + c, v);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int S, float scale, int window) {
  using Sh = Shape<D>;
  constexpr int kLd = Sh::kLd;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * kLd;
  float* sV = sK + kBK * kLd;
  float* sS = sV + kBK * kLd;
  float* sM = sS + kBQ * kLdS;
  float* sL = sM + kBQ;
  float* sC = sL + kBQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;

  load_tile<D, kBQ>(sQ, q + base, q0, S, scale);
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // Score tile: thread (tr, tc) owns rows tr + 16 i and columns tc + 16 j.
  const int tr = tid / 16, tc = tid % 16;
  // Output: thread (rg, cg) owns rows rg + kNRG i and the float4 chunks at
  // columns cg*4 + 4*kNCG t.
  const int rg = tid / Sh::kNCG, cg = tid % Sh::kNCG;
  const int warp = tid / 32, lane = tid % 32;
  float acc[Sh::kRPT][Sh::kChunks][4];
#pragma unroll
  for (int i = 0; i < Sh::kRPT; ++i)
#pragma unroll
    for (int t = 0; t < Sh::kChunks; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int first_key = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_end = q_last / kBK;
  for (int kt = first_key / kBK; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, kBK>(sK, k + base, k0, S, 1.f);
    load_tile<D, kBK>(sV, v + base, k0, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(sQ + (tr + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(sK + (tc + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j, kj = k0 + c;
        const bool ok = kj <= qi && kj < S && (window <= 0 || kj > qi - window);
        sS[r * kLdS + c] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: a warp per 8 rows, two columns a lane.
    for (int rr = 0; rr < kBQ / kWarps; ++rr) {
      const int r = warp * (kBQ / kWarps) + rr;
      float a = sS[r * kLdS + lane], b = sS[r * kLdS + lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
      a = expf(a - m_new);
      b = expf(b - m_new);
      sS[r * kLdS + lane] = a;
      sS[r * kLdS + lane + 32] = b;
      const float sum = warp_sum(a + b);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < Sh::kRPT; ++i) {
      const float corr = sC[rg + Sh::kNRG * i];
#pragma unroll
      for (int t = 0; t < Sh::kChunks; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[Sh::kRPT];
#pragma unroll
      for (int i = 0; i < Sh::kRPT; ++i) p[i] = sS[(rg + Sh::kNRG * i) * kLdS + j];
#pragma unroll
      for (int t = 0; t < Sh::kChunks; ++t) {
        const float4 vv = load4(sV + j * kLd + cg * 4 + 4 * Sh::kNCG * t);
#pragma unroll
        for (int i = 0; i < Sh::kRPT; ++i) {
          acc[i][t][0] = fmaf(p[i], vv.x, acc[i][t][0]);
          acc[i][t][1] = fmaf(p[i], vv.y, acc[i][t][1]);
          acc[i][t][2] = fmaf(p[i], vv.z, acc[i][t][2]);
          acc[i][t][3] = fmaf(p[i], vv.w, acc[i][t][3]);
        }
      }
    }
  }
  // sL was last written before the barrier that precedes the P.V loop.
#pragma unroll
  for (int i = 0; i < Sh::kRPT; ++i) {
    const int r = rg + Sh::kNRG * i, qi = q0 + r;
    if (qi >= S) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < Sh::kChunks; ++t) {
      const float4 o = make_float4(acc[i][t][0] / l, acc[i][t][1] / l, acc[i][t][2] / l,
                                   acc[i][t][3] / l);
      store4(out + base + static_cast<size_t>(qi) * D + cg * 4 + 4 * Sh::kNCG * t, o);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
                   float scale, int window, cudaStream_t stream) {
  const size_t smem = Shape<D>::kSmemFloats * sizeof(float);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<D, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), s,
                                           scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int bh, int s, int d,
                     float scale, int window, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32, T>(q, k, v, out, bh, s, scale, window, stream);
    case 64: return launch<64, T>(q, k, v, out, bh, s, scale, window, stream);
    case 128: return launch<128, T>(q, k, v, out, bh, s, scale, window, stream);
    case 256: return launch<256, T>(q, k, v, out, bh, s, scale, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [bh, s, d] row-major on the device, fp32 (bf16 == 0) or
// bf16 (bf16 == 1); d in {32, 64, 128, 256}; window <= 0 is full causal.
// Launches on `stream` and does not synchronise. Returns a cudaError_t code:
// cudaErrorInvalidValue for a shape the kernel does not take, otherwise
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int bh,
                                   int s, int d, float scale, int window, int bf16,
                                   cudaStream_t stream) {
  if (bh <= 0 || bh > 65535 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, bh, s, d, scale, window, stream)
           : dispatch<float>(q, k, v, out, bh, s, d, scale, window, stream);
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
