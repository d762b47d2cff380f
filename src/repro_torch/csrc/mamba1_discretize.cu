// Mamba-1's discretization for one chunk, and its gradient, for Hopper
// (sm_90a): the body of models/ssm.py::mamba1_forward's chunk loop around
// the scan.
//
// No TPU kernel is replaced: the reference builds a = exp(dt * A) and
// b = (dt * x) * B in jax.numpy and differentiates them with jax.grad. On
// the card the eager chain took three passes to build a and b as
// [B, K, d_inner, N] tensors and about ten more in the backward (exp's
// backward, broadcast products each followed by a sum over N, d_inner or
// (B, K)), some 19 such tensors of traffic a chunk.
//
// mamba1_discretize_fwd_kernel takes dt, x [B, K, d] and B [B, K, N] (any
// strides, fp32) and A [d, N] (contiguous) and writes a and b
// [B, K, d, N] (contiguous) once. It rounds as the eager ops do: dt * A
// rounded, then expf; dt * x rounded, then times B rounded (__fmul_rn,
// never contracted into an FMA), so a and b are bit-identical to the chain.
// Bound: bytes. It writes 2 * B * K * d * N * 4 bytes and reads only the
// small inputs: 0.160 ms at falcon-mamba-7b's training chunk
// [2, 256, 8192, 16] at 3.35 TB/s.
//
// mamba1_discretize_bwd_kernel takes the scan's gradients d_a, d_b
// [B, K, d, N] (contiguous) and the forward's small inputs, and writes
//   d_dt = sum_n (d_a * a) * A + (sum_n d_b * B) * x,
//   d_x  = (sum_n d_b * B) * dt,
// and per-block partial sums of
//   d_B  = sum_d d_b * (dt * x)   and   d_A = sum_{b,k} (d_a * a) * dt,
// each product rounded as the chain rounds it; a is recomputed from dt and
// A (the forward's expression, bit for bit), so only d_a and d_b are read
// from device memory. mamba1_discretize_sum_kernel then adds the partials
// in a fixed order. No atomics: two runs are bit-identical. Against the
// chain only the order of the sums differs. Bound: bytes, 2 * B * K * d *
// N * 4 read: 0.160 ms at the training chunk.
//
// Layout, both kernels: a thread owns V neighbouring n (V = 4, 2 or 1, the
// widest that divides N) of one (b, d) row, the G = N / V threads of a row
// are neighbouring lanes (G a power of two up to 32, rows padded with idle
// lanes), so every load and store of the large tensors is one coalesced
// line a warp (V = 4: 16 bytes a lane, 512 a warp). A block of 256 threads
// holds 256 / G rows of d and walks a stretch of time steps k, keeping its
// row of A (and, backward, its share of d_A) in registers across them.
// Backward, the sums over n are a butterfly over a row's G lanes, the sum
// over d a butterfly over the warp's rows and then over the block's 8 warps
// through shared memory ([8][steps][N] floats), written once a block.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdSteps = 16;  // time steps a forward block walks
constexpr int kMaxShared = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// strides of the small inputs, in floats
struct Strides {
  int64_t dt_b, dt_k, dt_d, x_b, x_k, x_d, bm_b, bm_k, bm_n;
};

template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else if constexpr (V == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    mamba1_discretize_fwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                                 const float* __restrict__ bm, const float* __restrict__ A,
                                 float* __restrict__ a_out, float* __restrict__ b_out, Strides s,
                                 int k_len, int d_len, int n_len, int g_log2) {
  const int q = threadIdx.x & ((1 << g_log2) - 1);
  const int d = blockIdx.x * (kThreads >> g_log2) + (threadIdx.x >> g_log2);
  const int n0 = q * V;
  if (d >= d_len || n0 >= n_len) return;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kFwdSteps;
  const int k1 = min(k0 + kFwdSteps, k_len);
  float av[V];
#pragma unroll
  for (int j = 0; j < V; ++j) av[j] = A[static_cast<int64_t>(d) * n_len + n0 + j];
  const float* pdt = dt + b * s.dt_b + d * s.dt_d;
  const float* px = x + b * s.x_b + d * s.x_d;
  const float* pbm = bm + b * s.bm_b + n0 * s.bm_n;
  for (int k = k0; k < k1; ++k) {
    const float dtv = pdt[k * s.dt_k];
    const float dx = __fmul_rn(dtv, px[k * s.x_k]);
    float ao[V], bo[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ao[j] = expf(__fmul_rn(dtv, av[j]));
      bo[j] = __fmul_rn(dx, pbm[k * s.bm_k + j * s.bm_n]);
    }
    const int64_t off = ((static_cast<int64_t>(b) * k_len + k) * d_len + d) * n_len + n0;
    store_v<V>(a_out + off, ao);
    store_v<V>(b_out + off, bo);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    mamba1_discretize_bwd_kernel(const float* __restrict__ d_a, const float* __restrict__ d_b,
                                 const float* __restrict__ dt, const float* __restrict__ x,
                                 const float* __restrict__ bm, const float* __restrict__ A,
                                 float* __restrict__ d_dt, float* __restrict__ d_x,
                                 float* __restrict__ part_a, float* __restrict__ part_b,
                                 Strides s, int k_len, int d_len, int n_len, int g_log2,
                                 int steps) {
  extern __shared__ float red[];  // [kWarps][steps][n_len]: each warp's sums over its rows
  const int G = 1 << g_log2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = threadIdx.x & (G - 1);
  const int d = blockIdx.x * (kThreads >> g_log2) + (threadIdx.x >> g_log2);
  const int n0 = q * V;
  const bool on = d < d_len && n0 < n_len;  // idle lanes still join every shuffle
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * steps;
  const int k1 = min(k0 + steps, k_len);
  float av[V], acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    av[j] = on ? A[static_cast<int64_t>(d) * n_len + n0 + j] : 0.0f;
    acc[j] = 0.0f;
  }
  const float* pdt = dt + b * s.dt_b + d * s.dt_d;
  const float* px = x + b * s.x_b + d * s.x_d;
  const float* pbm = bm + b * s.bm_b + n0 * s.bm_n;
  for (int k = k0; k < k1; ++k) {
    float dtv = 0.0f, xv = 0.0f, ga[V], gb[V], bv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) ga[j] = gb[j] = bv[j] = 0.0f;
    const int64_t row = (static_cast<int64_t>(b) * k_len + k) * d_len + d;
    if (on) {
      dtv = pdt[k * s.dt_k];
      xv = px[k * s.x_k];
      load_v<V>(d_a + row * n_len + n0, ga);
      load_v<V>(d_b + row * n_len + n0, gb);
#pragma unroll
      for (int j = 0; j < V; ++j) bv[j] = pbm[k * s.bm_k + j * s.bm_n];
    }
    const float dx = __fmul_rn(dtv, xv);
    float s1 = 0.0f, s2 = 0.0f, r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float g = __fmul_rn(ga[j], expf(__fmul_rn(dtv, av[j])));  // d(dt * A) = d_a * a
      const float p1 = __fmul_rn(g, av[j]);
      const float p2 = __fmul_rn(gb[j], bv[j]);
      s1 = j ? __fadd_rn(s1, p1) : p1;
      s2 = j ? __fadd_rn(s2, p2) : p2;
      acc[j] = __fadd_rn(acc[j], __fmul_rn(g, dtv));
      r[j] = __fmul_rn(gb[j], dx);
    }
    for (int o = 1; o < G; o <<= 1) {  // sums over n: the row's G lanes
      s1 = __fadd_rn(s1, __shfl_xor_sync(kFull, s1, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(kFull, s2, o));
    }
    if (on && q == 0) {
      d_dt[row] = __fadd_rn(s1, __fmul_rn(s2, xv));
      d_x[row] = __fmul_rn(s2, dtv);
    }
    for (int o = G; o < 32; o <<= 1) {  // sums over d: the warp's rows
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = __fadd_rn(r[j], __shfl_xor_sync(kFull, r[j], o));
    }
    if (lane < G && n0 < n_len) {
#pragma unroll
      for (int j = 0; j < V; ++j) red[(warp * steps + (k - k0)) * n_len + n0 + j] = r[j];
    }
  }
  if (on) {
    const int64_t slice = static_cast<int64_t>(b) * gridDim.z + blockIdx.z;
#pragma unroll
    for (int j = 0; j < V; ++j) part_a[(slice * d_len + d) * n_len + n0 + j] = acc[j];
  }
  __syncthreads();
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * gridDim.y + b;
  for (int i = threadIdx.x; i < (k1 - k0) * n_len; i += kThreads) {
    const int kk = i / n_len;
    const int n = i - kk * n_len;
    float t = red[kk * n_len + n];
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, red[(w * steps + kk) * n_len + n]);
    part_b[(tile * k_len + k0 + kk) * n_len + n] = t;
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order; blockIdx.y picks the
// job: 0 the partials of d_A, 1 those of d_B
__global__ void __launch_bounds__(kThreads)
    mamba1_discretize_sum_kernel(const float* __restrict__ part_a, int slices_a, int64_t len_a,
                                 float* __restrict__ d_A, const float* __restrict__ part_b,
                                 int slices_b, int64_t len_b, float* __restrict__ d_B) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const float* part = blockIdx.y ? part_b : part_a;
  const int slices = blockIdx.y ? slices_b : slices_a;
  const int64_t len = blockIdx.y ? len_b : len_a;
  float* out = blockIdx.y ? d_B : d_A;
  if (i >= len) return;
  float t = part[i];
  for (int j = 1; j < slices; ++j) t = __fadd_rn(t, part[j * len + i]);
  out[i] = t;
}

// ---------------------------------------------------------------------------
// launches

bool shape_ok(int batch, int k_len, int d_len, int n_len, int vec, int g_log2) {
  return batch > 0 && batch <= 65535 && k_len > 0 && d_len > 0 && n_len > 0 &&
         (vec == 1 || vec == 2 || vec == 4) && n_len % vec == 0 && g_log2 >= 0 &&
         g_log2 <= 5 && (vec << g_log2) >= n_len;
}

Strides strides_of(const long long* st) {
  return Strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
}

template <int V>
cudaError_t launch_fwd(const float* dt, const float* x, const float* bm, const float* A,
                       float* a, float* b, Strides s, int batch, int k_len, int d_len,
                       int n_len, int g_log2, cudaStream_t stream) {
  const dim3 grid((d_len + (kThreads >> g_log2) - 1) / (kThreads >> g_log2), batch,
                  (k_len + kFwdSteps - 1) / kFwdSteps);
  mamba1_discretize_fwd_kernel<V><<<grid, kThreads, 0, stream>>>(dt, x, bm, A, a, b, s, k_len,
                                                                   d_len, n_len, g_log2);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_bwd(const float* d_a, const float* d_b, const float* dt, const float* x,
                       const float* bm, const float* A, float* d_dt, float* d_x,
                       float* part_a, float* part_b, Strides s, int batch, int k_len,
                       int d_len, int n_len, int g_log2, int steps, cudaStream_t stream) {
  const dim3 grid((d_len + (kThreads >> g_log2) - 1) / (kThreads >> g_log2), batch,
                  (k_len + steps - 1) / steps);
  const size_t shared = sizeof(float) * kWarps * steps * n_len;
  mamba1_discretize_bwd_kernel<V><<<grid, kThreads, shared, stream>>>(
      d_a, d_b, dt, x, bm, A, d_dt, d_x, part_a, part_b, s, k_len, d_len, n_len, g_log2, steps);
  return cudaGetLastError();
}

}  // namespace

// dt, x: [batch, k_len, d_len] and bm: [batch, k_len, n_len], fp32 on the
// device with the strides `st` gives (in floats: dt's b, k, d, x's b, k, d,
// bm's b, k, n); A: [d_len, n_len] and a, b: [batch, k_len, d_len, n_len],
// contiguous fp32. vec (1, 2 or 4) divides n_len and the lanes of a row are
// 2^g_log2 <= 32 with vec * 2^g_log2 >= n_len; with vec > 1, a and b are
// aligned to vec floats. Launches on `stream` and does not synchronise.
// Returns a cudaError_t code: cudaErrorInvalidValue for a shape the kernel
// does not take, otherwise cudaGetLastError() after the launch.
extern "C" int mamba1_discretize_fwd(const void* dt, const void* x, const void* bm,
                                     const void* A, void* a, void* b, int batch, int k_len,
                                     int d_len, int n_len, int vec, int g_log2,
                                     const long long* st, cudaStream_t stream) {
  if (!shape_ok(batch, k_len, d_len, n_len, vec, g_log2) ||
      (k_len + kFwdSteps - 1) / kFwdSteps > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t e;
  switch (vec) {
    case 4:
      e = launch_fwd<4>(f(dt), f(x), f(bm), f(A), static_cast<float*>(a), static_cast<float*>(b),
                        strides_of(st), batch, k_len, d_len, n_len, g_log2, stream);
      break;
    case 2:
      e = launch_fwd<2>(f(dt), f(x), f(bm), f(A), static_cast<float*>(a), static_cast<float*>(b),
                        strides_of(st), batch, k_len, d_len, n_len, g_log2, stream);
      break;
    default:
      e = launch_fwd<1>(f(dt), f(x), f(bm), f(A), static_cast<float*>(a), static_cast<float*>(b),
                        strides_of(st), batch, k_len, d_len, n_len, g_log2, stream);
  }
  return static_cast<int>(e);
}

// d_a, d_b: [batch, k_len, d_len, n_len] contiguous fp32 (aligned to vec
// floats), the forward's inputs as mamba1_discretize_fwd takes them; writes
// d_dt, d_x [batch, k_len, d_len], d_A [d_len, n_len] and d_B
// [batch, k_len, n_len], contiguous. A backward block walks `steps` time
// steps (8 * steps * n_len floats of shared memory, at most 48 KB); the
// scratch part_a holds batch * ceil(k_len / steps) slices of d_len * n_len
// floats and part_b ceil(d_len / (256 >> g_log2)) slices of batch * k_len *
// n_len. Two launches on `stream`, the backward kernel and the sums; does
// not synchronise. Returns a cudaError_t code as mamba1_discretize_fwd does.
extern "C" int mamba1_discretize_bwd(const void* d_a, const void* d_b, const void* dt,
                                     const void* x, const void* bm, const void* A, void* d_dt,
                                     void* d_x, void* d_A, void* d_B, void* part_a,
                                     void* part_b, int batch, int k_len, int d_len, int n_len,
                                     int vec, int g_log2, int steps, const long long* st,
                                     cudaStream_t stream) {
  if (!shape_ok(batch, k_len, d_len, n_len, vec, g_log2) || steps <= 0 ||
      (k_len + steps - 1) / steps > 65535 ||
      sizeof(float) * kWarps * steps * n_len > static_cast<size_t>(kMaxShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const Strides s = strides_of(st);
  cudaError_t e;
  switch (vec) {
    case 4:
      e = launch_bwd<4>(f(d_a), f(d_b), f(dt), f(x), f(bm), f(A), w(d_dt), w(d_x), w(part_a),
                        w(part_b), s, batch, k_len, d_len, n_len, g_log2, steps, stream);
      break;
    case 2:
      e = launch_bwd<2>(f(d_a), f(d_b), f(dt), f(x), f(bm), f(A), w(d_dt), w(d_x), w(part_a),
                        w(part_b), s, batch, k_len, d_len, n_len, g_log2, steps, stream);
      break;
    default:
      e = launch_bwd<1>(f(d_a), f(d_b), f(dt), f(x), f(bm), f(A), w(d_dt), w(d_x), w(part_a),
                        w(part_b), s, batch, k_len, d_len, n_len, g_log2, steps, stream);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t len_a = static_cast<int64_t>(d_len) * n_len;
  const int64_t len_b = static_cast<int64_t>(batch) * k_len * n_len;
  const int slices_a = batch * ((k_len + steps - 1) / steps);
  const int slices_b = (d_len + (kThreads >> g_log2) - 1) / (kThreads >> g_log2);
  const int64_t most = len_a > len_b ? len_a : len_b;
  const dim3 grid(static_cast<unsigned>((most + kThreads - 1) / kThreads), 2);
  mamba1_discretize_sum_kernel<<<grid, kThreads, 0, stream>>>(
      f(part_a), slices_a, len_a, w(d_A), f(part_b), slices_b, len_b, w(d_B));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
