// Linear recurrence h_t = a_t * h_{t-1} + b_t over time, for Hopper
// (sm_90a): the selective-scan step of the Mamba layers, which the serving
// path runs once per 256-token chunk of every layer's prefill and once per
// layer at each decode token.
//
// ssm_scan_kernel replaces the TPU kernel
// repro/kernels/ssm_scan.py::ssm_scan_pallas (body _scan_kernel). On a, b
// [B, T, C] and h0 [B, C] it writes every state hs [B, T, C] and the last
// one h_last [B, C]. The arithmetic is in fp32 whatever the types: a and b
// are fp32 or bf16 (read into fp32), h0 fp32 or bf16; hs is written in a's
// type and h_last in h0's type, each rounded to nearest even. The step is a
// multiply, rounded, then an add, rounded (__fmul_rn, __fadd_rn: never
// contracted into an FMA), so the kernel is bit-identical to its plain
// version, whose two eager tensor ops round the same way.
//
// Bound: bytes. Each step does 2 flops and moves a, b and hs once: at the
// serving shape ([2, 256, 131072] fp32, C = d_inner * ssm_state of
// falcon-mamba-7b) 805 MB a call, 0.24 ms at 3.35 TB/s, against 67 MFLOP.
// The TPU kernel kept a 128-channel tile's state in VMEM and walked time in
// 128-step slabs over a sequential grid; on Hopper the channels are
// independent, so each thread owns one (b, c) channel, keeps its h in a
// register and walks t from 0 to T-1 itself. The 32 threads of a warp hold
// 32 neighbouring channels, so every load of a[b, t, c:c+32] and b[...] and
// every store of hs[b, t, ...] is one coalesced 128-byte line (64 bytes in
// bf16). h is the only dependency between steps: the loop over t is
// unrolled by kUnroll, with the group's loads issued before its chain of
// multiply-adds, so each thread keeps 2 * kUnroll loads in flight. The
// grid is ceil(C / 256) x B blocks of 256 threads; bounds checks replace
// the TPU kernel's padding to whole tiles (a = 1, b = 0). At decode (T = 1)
// the call is a few MB and bound by its launch latency instead.
//
// Fusing the construction of a = exp(dt * A) and b = dt * x * B, and the
// C-projection of hs, into the kernel is for a later change.
//
// ssm_scan_bwd_kernel is the recurrence's gradient, for the training path
// (fp32 only). The TPU side has no backward kernel: the reference takes
// jax.grad through its lax.scan twin of the kernel
// (repro/models/ssm.py::_chunk_recurrence). With g_t the gradient of the loss
// with respect to h_t, it walks t from T-1 down to 0:
//   g_t = d_hs_t + c,  d_a_t = g_t * h_{t-1} (h_{-1} = h0),  d_b_t = g_t,
//   c = a_t * g_t,
// starting from c = d_h_last and ending with d_h0 = c. Each product and sum
// is rounded apart (never an FMA), so it is bit-identical to its plain
// version. Bound: bytes. It reads a, d_hs and hs once and writes d_a and d_b
// once: 5 * B * T * C * 4 bytes, 0.250 ms at zamba2-2.7b's training chunk
// [2, 64, 327680]. The layout is the forward's: one thread a (b, c)
// channel, g's carry in a register, the walk over t unrolled by kUnroll with
// the group's 3 * kUnroll loads issued before its chain of multiply-adds, 32
// neighbouring channels a warp, so every load and store is one coalesced
// line; a grid of ceil(C / 256) x B blocks. A kernel of its own, rather
// than the forward kernel on time-reversed inputs: that would add flips, a
// shift and an elementwise pass for d_a, each a full [B, T, C] pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TA, typename TH>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const TA* __restrict__ a, const TA* __restrict__ b,
                    const TH* __restrict__ h0, TA* __restrict__ hs, TH* __restrict__ h_last,
                    int t_len, int64_t c_len) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= c_len) return;
  const int64_t row = blockIdx.y;
  const int64_t base = row * t_len * c_len + c;
  const TA* pa = a + base;
  const TA* pb = b + base;
  TA* ph = hs + base;
  float h = to_f32(h0[row * c_len + c]);
  int t = 0;
  for (; t + kUnroll <= t_len; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_f32(pa[u * c_len]);
      bv[u] = to_f32(pb[u * c_len]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      ph[u * c_len] = from_f32<TA>(h);
    }
    pa += kUnroll * c_len;
    pb += kUnroll * c_len;
    ph += kUnroll * c_len;
  }
  for (; t < t_len; ++t) {
    h = __fadd_rn(__fmul_rn(to_f32(*pa), h), to_f32(*pb));
    *ph = from_f32<TA>(h);
    pa += c_len;
    pb += c_len;
    ph += c_len;
  }
  h_last[row * c_len + c] = from_f32<TH>(h);
}

__global__ void __launch_bounds__(kThreads)
    ssm_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h0,
                        const float* __restrict__ hs, const float* __restrict__ d_hs,
                        const float* __restrict__ d_last, float* __restrict__ d_a,
                        float* __restrict__ d_b, float* __restrict__ d_h0, int t_len,
                        int64_t c_len) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= c_len) return;
  const int64_t row = blockIdx.y;
  const int64_t base = row * t_len * c_len + c;
  float carry = d_last[row * c_len + c];
  int t = t_len - 1;
  // groups of kUnroll steps t, t-1, ..., t-kUnroll+1, all with t-kUnroll+1 >= 1,
  // so each step's h_{t-1} is a row of hs
  for (; t - kUnroll + 1 >= 1; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + static_cast<int64_t>(t - u) * c_len;
      av[u] = a[off];
      gv[u] = d_hs[off];
      hv[u] = hs[off - c_len];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + static_cast<int64_t>(t - u) * c_len;
      const float g = __fadd_rn(gv[u], carry);
      d_a[off] = __fmul_rn(g, hv[u]);
      d_b[off] = g;
      carry = __fmul_rn(av[u], g);
    }
  }
  for (; t >= 0; --t) {
    const int64_t off = base + static_cast<int64_t>(t) * c_len;
    const float h_prev = t ? hs[off - c_len] : h0[row * c_len + c];
    const float g = __fadd_rn(d_hs[off], carry);
    d_a[off] = __fmul_rn(g, h_prev);
    d_b[off] = g;
    carry = __fmul_rn(a[off], g);
  }
  d_h0[row * c_len + c] = carry;
}

template <typename TA, typename TH>
cudaError_t launch(const void* a, const void* b, const void* h0, void* hs, void* h_last,
                   int batch, int t_len, int c_len, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(c_len) + kThreads - 1) / kThreads),
                  batch);
  ssm_scan_kernel<TA, TH><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TA*>(b), static_cast<const TH*>(h0),
      static_cast<TA*>(hs), static_cast<TH*>(h_last), t_len, c_len);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t dispatch_h(const void* a, const void* b, const void* h0, void* hs, void* h_last,
                       int batch, int t_len, int c_len, int dtype_h, cudaStream_t stream) {
  switch (dtype_h) {
    case 0: return launch<TA, float>(a, b, h0, hs, h_last, batch, t_len, c_len, stream);
    case 1: return launch<TA, __nv_bfloat16>(a, b, h0, hs, h_last, batch, t_len, c_len, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// a, b, hs: [batch, t_len, c_len] and h0, h_last: [batch, c_len], row-major on
// the device. dtype_a is the type of a, b and hs, dtype_h that of h0 and
// h_last: 0 for fp32, 1 for bf16. Launches on `stream` and does not
// synchronise. Returns a cudaError_t code: cudaErrorInvalidValue for a shape
// or type the kernel does not take, otherwise cudaGetLastError() after the
// launch.
extern "C" int ssm_scan_fwd(const void* a, const void* b, const void* h0, void* hs,
                            void* h_last, int batch, int t_len, int c_len, int dtype_a,
                            int dtype_h, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || t_len < 0 || c_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e;
  switch (dtype_a) {
    case 0:
      e = dispatch_h<float>(a, b, h0, hs, h_last, batch, t_len, c_len, dtype_h, stream);
      break;
    case 1:
      e = dispatch_h<__nv_bfloat16>(a, b, h0, hs, h_last, batch, t_len, c_len, dtype_h, stream);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// a, hs, d_hs, d_a, d_b: [batch, t_len, c_len] and h0, d_last, d_h0:
// [batch, c_len], fp32, row-major on the device. Launches on `stream` and does
// not synchronise. Returns a cudaError_t code as ssm_scan_fwd does.
extern "C" int ssm_scan_bwd(const void* a, const void* h0, const void* hs, const void* d_hs,
                            const void* d_last, void* d_a, void* d_b, void* d_h0, int batch,
                            int t_len, int c_len, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || t_len < 0 || c_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(c_len) + kThreads - 1) / kThreads),
                  batch);
  ssm_scan_bwd_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(h0), static_cast<const float*>(hs),
      static_cast<const float*>(d_hs), static_cast<const float*>(d_last),
      static_cast<float*>(d_a), static_cast<float*>(d_b), static_cast<float*>(d_h0), t_len,
      c_len);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
