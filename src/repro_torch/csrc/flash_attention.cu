// Causal flash attention with a runtime sliding window, forward only, for
// Hopper (sm_90a): the long-prompt prefill attention of the serving path.
//
// flash_fwd_kernel replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel). On q, k, v [BH, S, D] (KV heads already repeated to the
// query heads), for every row i < S:
//   s_ij = scale * (q_i . k_j) over the unmasked j: j <= i, j < S, and
//          (window <= 0 or j > i - window);
//   out_i = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i),
// with an online softmax over KV tiles: per row a running max m and sum l
// in fp32, the accumulator rescaled by exp(m_old - m_new) at each tile.
// fp32 or bf16 in, fp32 accumulation, the output in the input's type. The
// window is a runtime argument, so gemma3's 5:1 local:global schedule runs
// one build and one instantiation per (D, type).
//
// Masking keeps the reference's finite NEG_INF = -2e38. KV tiles that are
// wholly masked for a consumer's rows (above the diagonal, or before the
// window of its first row) are skipped, which is exact: a tile that is
// masked only for some rows gives those rows p = exp(-2e38 + 2e38) = 1
// while their running max is still -2e38, and the first tile holding one of
// their keys wipes that with corr = exp(-2e38 - m) = 0; every valid row
// reaches its diagonal key, so the wipe always happens. Keys and values
// past S arrive as zeros (the tensor maps' out-of-bounds fill), so a wiped
// entry is never 0 * NaN.
//
// Bound: operations. The kernel does 4*D flops for each unmasked (i, j)
// pair: at the serving path's shape (gemma3-1b, [8, 4096, 256]) 8 * 4096 *
// 4097 / 2 = 6.71e7 pairs, 6.87e10 flops at window 0 (3.0e10 at window
// 1024), against 4*BH*S*D*4 = 134 MB that it must move: about 510 flops a
// byte, far above the card's balance in either type. So the products go to
// the tensor cores, by one of two routes on one skeleton:
//
// - bf16: wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32. S = Q.K^T is SS
//   (Q and K both K-major in shared memory, N = 64 keys); O += P.V is RS:
//   P in registers (the S accumulator's layout is the A-fragment layout,
//   so P needs no shuffle), rounded to bf16 (RNE), and V from shared memory
//   as an MN-major B operand (transpose-B), one 64-column slab (32 at
//   D = 32) per instruction. The bound is the bf16 dense rate.
// - fp32: 3xTF32 on mma.sync.m16n8k8 (tf32 x tf32 -> fp32). Each operand
//   is split as hi = rna_tf32(x), lo = rna_tf32(x - hi), and the product
//   accumulates lo.hi + hi.lo + hi.hi (lo.lo dropped), which keeps fp32's
//   accuracy (one TF32 pass misses the fp32 tolerance about 50-fold).
//   rna_tf32 is cvt.rna.tf32.f32 written as integer ops on the bits
//   ((x + 0x1000) & ~0x1fff); for lo the mask is left to the tensor core,
//   which ignores a tf32 operand's low 13 bits. wgmma's TF32 form wants
//   both operands K-major, so V would have to be transposed, and hi and lo
//   copies of every tile do not fit at D = 256; mma.sync reads fragments
//   from one fp32 copy of each tile and splits them in registers. The
//   bound is three TF32 passes at the card's dense TF32 rate (half the
//   bf16 rate), which mma.sync does not reach: it is the legacy path.
//
// The skeleton: a block is one producer warp and 64 query rows of consumer
// warps, 16 rows a warp. The producer's elected lane loads the block's Q
// tile once and keeps K/V tiles in flight through a ring of kStages stages
// with TMA (cp.async.bulk.tensor, 3-D maps over [BH, S, D], so rows past S
// are zero-filled and never the next head's), one "full" mbarrier per
// stage (TMA's complete_tx) and one "empty" mbarrier per stage (each
// consumer warp arrives when it is done with the tile); there is no
// block-wide barrier in the KV loop. Tiles land in shared memory as
// 128-byte rows with the 128-byte swizzle (64-byte rows and swizzle for
// bf16 at D = 32), the layout wgmma's descriptors read; the fp32 route
// reads its fragments through the same XOR, with the d and key orders
// inside each fragment permuted (a contraction may take its terms in any
// order) so that every fragment load is a conflict-free 16-byte load and
// P's accumulator registers are already P.V's A fragment. The online
// softmax stays in registers: each thread holds rows g and g + 8 of its
// warp's 16, the row max goes through two quad shuffles, the row sum is
// kept per thread and reduced once at the end. The grid is (BH, query
// tiles) with the query tile reversed, so the longest causal tiles start
// first and the last wave is the short ones.
//
// Warps and memory. bf16: one consumer warpgroup (4 warps), 64-key tiles;
// at D = 256 Q takes 32 KB and 2 stages of K and V 128 KB, one block an
// SM (two at D <= 128). fp32: 32-key tiles; at D >= 128 warps w and w + 4
// share rows and split D (consume_f32), 8 consumer warps, so that two
// warps on each scheduler hide the mma.sync and split latencies that one
// warp a scheduler left exposed; at D = 256
// Q takes 64 KB, the ring 128 KB and the pairs' partial scores 32 KB. The
// O accumulator is D/2 fp32 registers a thread (D/4 with the split);
// ptxas reports no spills for any instantiation, and with one block of at
// most 9 warps an SM there is no need for setmaxnreg.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;     // query rows per block, 16 a consumer warp
constexpr int kStages = 2;  // K/V ring depth
constexpr float kNegInf = -2.0e38f;
// Shared memory a block may use on Hopper: 227 KB; an SM holds 228 KB,
// with 1 KB reserved per block.
constexpr size_t kMaxSmemBytes = 232448;
constexpr size_t kSmSmemBytes = 233472;
constexpr unsigned kFull = 0xffffffffu;

template <int D, typename T>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "head_dim must be 32, 64, 128 or 256");
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kElem = sizeof(T);
  // Columns per shared-memory row: 128 bytes (the 128-byte swizzle), or
  // the whole row where it is shorter (bf16 at D = 32: 64-byte swizzle).
  static constexpr int kSlabCols = (D * kElem < 128) ? D : 128 / kElem;
  static constexpr int kRowBytes = kSlabCols * kElem;
  static constexpr int kSlabs = D / kSlabCols;
  static constexpr int kBK = kF32 ? 32 : 64;  // keys per KV tile
  static constexpr int kQSlabBytes = kBQ * kRowBytes;
  static constexpr int kKSlabBytes = kBK * kRowBytes;
  static constexpr int kQBytes = kSlabs * kQSlabBytes;
  static constexpr int kKVBytes = kSlabs * kKSlabBytes;  // one K (or V) tile
  // fp32 at D >= 128 pairs two warps on each 16 rows, each taking half of
  // D (consume_f32): 8 consumer warps, else 4 (one warpgroup).
  static constexpr int kSplit = (kF32 && D >= 128) ? 2 : 1;
  static constexpr int kConsumerWarps = 4 * kSplit;
  static constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
  // The pairs' partial scores: 2 buffers x warps x (16 x kBK) floats.
  static constexpr int kScratchOff = kQBytes + kStages * 2 * kKVBytes;
  static constexpr int kScratchBytes = kSplit == 2 ? 2 * kConsumerWarps * 16 * kBK * 4 : 0;
  static constexpr int kBarOff = kScratchOff + kScratchBytes;
  static constexpr size_t kSmemBytes = kBarOff + 64 + 1024;  // + barriers, + alignment slack
  // Two blocks an SM where shared memory allows it and the O accumulator
  // is at most 32 registers a thread (5 warps a block, so 10 an SM leave
  // 168 registers a thread); one otherwise (168 registers for 9 warps, 255
  // for 5).
  static constexpr int kMinBlocks =
      2 * (kSmemBytes + 1024) <= kSmSmemBytes && D * kElem / kSplit <= 256 ? 2 : 1;
  static_assert(kSmemBytes <= kMaxSmemBytes, "tiles exceed shared memory");
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Barrier `id` (1..15) over `threads` threads of the block.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// fp32 -> tf32, rounded to nearest with ties away from zero (what
// cvt.rna.tf32.f32 does), kept in an fp32 container.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|). The tensor core reads a tf32 operand's top 19
// bits and ignores the low 13, so lo goes in as its bits plus half a tf32
// ulp: what the product sees is rna_tf32(lo), one integer add cheaper.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += a.b[j] in 3xTF32 for N column tiles: the small terms first, then
// hi.hi, each pass over all N tiles so that N independent products are in
// flight between two that share an accumulator.
template <int N>
__device__ __forceinline__ void mma_3xtf32_tiles(float (&d)[N][4], const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4],
                                                 const uint32_t (&bh)[N][2],
                                                 const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ah, bh[j][0], bh[j][1]);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading accumulator registers across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}

// S (64 x 64, fp32) = or += A . B^T, A and B K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 64 slab) += P . V: P bf16 in registers, V MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same for a 32-column slab (D = 32).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the shared pieces of both routes -------------------------------------

// Which rows and keys a consumer sees. Accumulator fragments of both routes
// share one layout: per 8-column tile j, a thread (g = lane / 4, t = lane %
// 4) holds [0], [1] at row g, columns 8j + 2t and 8j + 2t + 1, and [2], [3]
// at row g + 8.
struct Rows {
  int row0;  // absolute query row of the warp's first row
  int g, t;
  int S, window;
  float scale;

  // Is KV tile [k0, k0 + bk) wholly masked for rows [lo, hi]?
  static __device__ __forceinline__ bool skip(int k0, int bk, int lo, int hi, int window) {
    return k0 > hi || (window > 0 && k0 + bk - 1 <= lo - window);
  }
  // Is it wholly unmasked for rows [lo, hi]?
  static __device__ __forceinline__ bool full(int k0, int bk, int lo, int hi, int S, int window) {
    return k0 + bk - 1 <= lo && k0 + bk - 1 < S && (window <= 0 || k0 > hi - window);
  }
};

// One KV tile's online-softmax step on the scores s (raw dot products in,
// probabilities out), rescaling the output accumulator o.
template <int NT, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&o)[NO][4], float (&m)[2],
                                             float (&l)[2], const Rows& r, int k0,
                                             bool need_mask) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * r.scale;
      if (need_mask) {
        const int qi = r.row0 + r.g + (e >> 1) * 8;
        const int kj = k0 + 8 * j + 2 * r.t + (e & 1);
        const bool ok = kj <= qi && kj < r.S && (r.window <= 0 || kj > qi - r.window);
        x = ok ? x : kNegInf;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = expf(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - m[e >> 1]);
      s[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    o[i][0] *= corr[0];
    o[i][1] *= corr[0];
    o[i][2] *= corr[1];
    o[i][3] *= corr[1];
  }
}

// The row sums l, reduced over the quad that shares each row.
__device__ __forceinline__ void finish_rows(float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
}

// ---- fp32: 3xTF32 on mma.sync ---------------------------------------------

// Chunk c (16 bytes) of row `row` of a 128-byte-swizzled fp32 slab.
__device__ __forceinline__ float4 lds_chunk(const float* slab, int row, int c) {
  return *reinterpret_cast<const float4*>(slab + row * 32 + ((c ^ (row & 7)) << 2));
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// S = Q . K^T for the warp's 16 rows and the tile's kBK keys. In half h of
// slab sl, thread t reads the 16-byte chunk 2t + h of its rows; its k-step
// e (0, 1) pairs logical k = t with d = 32 sl + 8 t + 4 h + 2 e and k = t + 4
// with d + 1, the same order for Q (A) and K (B).
template <int D>
__device__ __forceinline__ void qk_f32(float (&s)[Cfg<D, float>::kBK / 8][4], const float* sQ,
                                       const float* sK, int sl0, int qrow, int g, int t) {
  using C = Cfg<D, float>;
  constexpr int NT = C::kBK / 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int sl = sl0; sl < sl0 + C::kSlabs / C::kSplit; ++sl) {
    const float* q = sQ + sl * kBQ * 32;
    const float* k = sK + sl * C::kBK * 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 q0 = lds_chunk(q, qrow, 2 * t + h);
      const float4 q1 = lds_chunk(q, qrow + 8, 2 * t + h);
      float4 kv[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) kv[j] = lds_chunk(k, 8 * j + g, 2 * t + h);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t ah[4], al[4];
        split_tf32(at(q0, 2 * e), ah[0], al[0]);
        split_tf32(at(q1, 2 * e), ah[1], al[1]);
        split_tf32(at(q0, 2 * e + 1), ah[2], al[2]);
        split_tf32(at(q1, 2 * e + 1), ah[3], al[3]);
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_tf32(at(kv[j], 2 * e), bh[j][0], bl[j][0]);
          split_tf32(at(kv[j], 2 * e + 1), bh[j][1], bl[j][1]);
        }
        mma_3xtf32_tiles(s, ah, al, bh, bl);
      }
    }
  }
}

// O += P . V over the warp's slabs sl0, sl0 + 1, ... Key step kk takes the
// scores' column tile kk as the A fragment directly (logical k = t is key
// 2t, k = t + 4 is key 2t + 1), and output column tile 4 i + u (i-th slab of
// the warp) holds d = 32 (sl0 + i) + 4 n + u for B's column n, so thread
// (g, t) reads V rows 8 kk + 2t and 8 kk + 2t + 1 at chunk g of each slab.
template <int D>
__device__ __forceinline__ void pv_f32(float (&o)[D / 8 / Cfg<D, float>::kSplit][4],
                                       const float (&p)[Cfg<D, float>::kBK / 8][4],
                                       const float* sV, int sl0, int g, int t) {
  using C = Cfg<D, float>;
  constexpr int NT = C::kBK / 8;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(p[kk][0], ah[0], al[0]);
    split_tf32(p[kk][2], ah[1], al[1]);
    split_tf32(p[kk][1], ah[2], al[2]);
    split_tf32(p[kk][3], ah[3], al[3]);
    const int ra = 8 * kk + 2 * t;
#pragma unroll
    for (int sl = 0; sl < C::kSlabs / C::kSplit; ++sl) {
      const float* v = sV + (sl0 + sl) * C::kBK * 32;
      const float4 va = lds_chunk(v, ra, g);
      const float4 vb = lds_chunk(v, ra + 1, g);
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        split_tf32(at(va, u), bh[u][0], bl[u][0]);
        split_tf32(at(vb, u), bh[u][1], bl[u][1]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) mma_tf32(o[4 * sl + u], al, bh[u][0], bh[u][1]);
#pragma unroll
      for (int u = 0; u < 4; ++u) mma_tf32(o[4 * sl + u], ah, bl[u][0], bl[u][1]);
#pragma unroll
      for (int u = 0; u < 4; ++u) mma_tf32(o[4 * sl + u], ah, bh[u][0], bh[u][1]);
    }
  }
}

// The fp32 consumer. At D >= 128 warps w and w + 4 share rows 16 (w % 4)
// .. + 15 and split D: each takes half the slabs of Q.K^T, the pair adds its
// two partial score tiles through shared memory (double-buffered, one
// 64-thread named barrier a tile; both add mine + theirs, so both hold the
// same scores bit for bit and take the same softmax), and each computes
// P.V for its half of the output. That halves O's registers, so 8
// consumer warps fit where 4 held all of D.
template <int D>
__device__ __forceinline__ void consume_f32(uint8_t* smem, uint32_t full_bar, uint32_t empty_bar,
                                            uint32_t q_bar, float* __restrict__ out, int kt0,
                                            int kt1, Rows r, int warp, int lane) {
  using C = Cfg<D, float>;
  constexpr int NT = C::kBK / 8;
  constexpr int NS = C::kSlabs / C::kSplit;  // slabs of this warp
  constexpr int NO = 4 * NS;
  const int rg = warp % 4;
  const int sl0 = (warp / 4) * NS;
  const float* sQ = reinterpret_cast<const float*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + C::kScratchOff);
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int lo = r.row0, hi = r.row0 + 15;
  mbar_wait(q_bar, 0);
  for (int kt = kt0, i = 0; kt <= kt1; ++kt, ++i) {
    const int stage = i % kStages;
    mbar_wait(full_bar + 8 * stage, (i / kStages) & 1);
    const int k0 = kt * C::kBK;
    if (!Rows::skip(k0, C::kBK, lo, hi, r.window)) {  // the same for both warps of a pair
      const float* sK = reinterpret_cast<const float*>(smem + C::kQBytes + stage * 2 * C::kKVBytes);
      const float* sV = sK + C::kKVBytes / 4;
      float s[NT][4];
      qk_f32<D>(s, sQ, sK, sl0, 16 * rg + r.g, r.g, r.t);
      if constexpr (C::kSplit == 2) {
        float* mine = scratch + ((i & 1) * C::kConsumerWarps + warp) * NT * 128;
        const float* theirs = scratch + ((i & 1) * C::kConsumerWarps + (warp ^ 4)) * NT * 128;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<float4*>(mine + (j * 32 + lane) * 4) =
              make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
        named_bar_sync(1 + rg, 64);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 p = *reinterpret_cast<const float4*>(theirs + (j * 32 + lane) * 4);
          s[j][0] += p.x;
          s[j][1] += p.y;
          s[j][2] += p.z;
          s[j][3] += p.w;
        }
      }
      softmax_step(s, o, m, l, r, k0, !Rows::full(k0, C::kBK, lo, hi, r.S, r.window));
      pv_f32<D>(o, s, sV, sl0, r.g, r.t);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
  }
  finish_rows(l);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r.row0 + r.g + 8 * h;
    if (qi >= r.S) continue;
    const float inv = 1.f / l[h];
    float* dst = out + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const int d0 = 32 * (sl0 + sl) + 8 * r.t;
      *reinterpret_cast<float4*>(dst + d0) =
          make_float4(o[4 * sl][2 * h] * inv, o[4 * sl + 1][2 * h] * inv,
                      o[4 * sl + 2][2 * h] * inv, o[4 * sl + 3][2 * h] * inv);
      *reinterpret_cast<float4*>(dst + d0 + 4) =
          make_float4(o[4 * sl][2 * h + 1] * inv, o[4 * sl + 1][2 * h + 1] * inv,
                      o[4 * sl + 2][2 * h + 1] * inv, o[4 * sl + 3][2 * h + 1] * inv);
    }
  }
}

// ---- bf16: wgmma ----------------------------------------------------------

template <int D>
__device__ __forceinline__ void consume_bf16(uint8_t* smem, uint32_t full_bar,
                                             uint32_t empty_bar, uint32_t q_bar,
                                             __nv_bfloat16* __restrict__ out, int kt0, int kt1,
                                             Rows r, int lane) {
  using C = Cfg<D, __nv_bfloat16>;
  constexpr int NT = C::kBK / 8;  // 8: S is m64n64
  constexpr int NO = D / 8;
  constexpr uint32_t kSwizzle = C::kRowBytes == 128 ? 1 : 2;
  constexpr uint32_t kSBO = 8 * C::kRowBytes;  // one 8-row swizzle atom
  const uint32_t q_base = smem_u32(smem);
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);
  for (int kt = kt0, i = 0; kt <= kt1; ++kt, ++i) {
    const int stage = i % kStages;
    mbar_wait(full_bar + 8 * stage, (i / kStages) & 1);
    const int k0 = kt * C::kBK;
    const uint32_t k_base = q_base + C::kQBytes + stage * 2 * C::kKVBytes;
    const uint32_t v_base = k_base + C::kKVBytes;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int sl = kk * 16 / C::kSlabCols;
      const uint32_t off = (kk * 16 % C::kSlabCols) * 2;
      wgmma_ss_n64(s, gmma_desc(q_base + sl * C::kQSlabBytes + off, 16, kSBO, kSwizzle),
                   gmma_desc(k_base + sl * C::kKSlabBytes + off, 16, kSBO, kSwizzle), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    softmax_step(s, o, m, l, r, k0, !Rows::full(k0, C::kBK, r.row0, r.row0 + 15, r.S, r.window));
    uint32_t pa[C::kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk)
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl) {
        const uint64_t db = gmma_desc(v_base + sl * C::kKSlabBytes + kk * 16 * C::kRowBytes,
                                      C::kKSlabBytes, kSBO, kSwizzle);
        if constexpr (C::kSlabCols == 64)
          wgmma_rs_n64(&o[8 * sl][0], pa[kk], db);
        else
          wgmma_rs_n32(&o[4 * sl][0], pa[kk], db);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
  }
  finish_rows(l);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r.row0 + r.g + 8 * h;
    if (qi >= r.S) continue;
    const float inv = 1.f / l[h];
    __nv_bfloat16* dst = out + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<uint32_t*>(dst + 8 * i + 2 * r.t) =
          pack_bf16(o[i][2 * h] * inv, o[i][2 * h + 1] * inv);
  }
}

// ---- the kernel -------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(Cfg<D, T>::kThreads, Cfg<D, T>::kMinBlocks)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, T* __restrict__ out, int S,
                     float scale, int window) {
  using C = Cfg<D, T>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned (the 128-byte swizzle's period), as an offset from
  // smem_raw so the compiler keeps the shared address space.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // Barriers: full[kStages], then empty[kStages], then Q's; stage st's
  // full barrier is at full_bar + 8 st (likewise empty).
  const uint32_t full_bar = smem_u32(smem + C::kBarOff);
  const uint32_t empty_bar = full_bar + 8 * kStages;
  const uint32_t q_bar = empty_bar + 8 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal tiles first
  const int q_last = min(q0 + kBQ, S) - 1;
  const int first_key = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = first_key / C::kBK, kt1 = q_last / C::kBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, C::kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::kConsumerWarps) {  // the producer
    if (lane == 0) {
      const uint32_t base = smem_u32(smem);
      mbar_expect_tx(q_bar, C::kQBytes);
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl)
        tma_load(base + sl * C::kQSlabBytes, &tq, sl * C::kSlabCols, q0, bh, q_bar);
      for (int kt = kt0, i = 0; kt <= kt1; ++kt, ++i) {
        const int stage = i % kStages;
        mbar_wait(empty_bar + 8 * stage, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * stage, 2 * C::kKVBytes);
        const uint32_t kdst = base + C::kQBytes + stage * 2 * C::kKVBytes;
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl) {
          tma_load(kdst + sl * C::kKSlabBytes, &tk, sl * C::kSlabCols, kt * C::kBK, bh,
                   full_bar + 8 * stage);
          tma_load(kdst + C::kKVBytes + sl * C::kKSlabBytes, &tv, sl * C::kSlabCols,
                   kt * C::kBK, bh, full_bar + 8 * stage);
        }
      }
    }
    return;
  }

  Rows r;
  r.row0 = q0 + 16 * (warp % 4);
  r.g = lane / 4;
  r.t = lane % 4;
  r.S = S;
  r.window = window;
  r.scale = scale;
  T* o = out + static_cast<size_t>(bh) * S * D;
  if constexpr (C::kF32)
    consume_f32<D>(smem, full_bar, empty_bar, q_bar, o, kt0, kt1, r, warp, lane);
  else
    consume_bf16<D>(smem, full_bar, empty_bar, q_bar, o, kt0, kt1, r, lane);
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// address, so this library does not link libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over [bh, s, d] (innermost first: d, s, bh) with boxes of
// `cols` x `rows` x 1, swizzled to match the kernel's shared-memory layout;
// boxes past s are zero-filled.
template <int D, typename T>
bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int rows) {
  using C = Cfg<D, T>;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * C::kElem,
                                 static_cast<cuuint64_t>(s) * D * C::kElem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::kSlabCols), static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, C::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS;
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
                   float scale, int window, cudaStream_t stream) {
  using C = Cfg<D, T>;
  CUtensorMap tq, tk, tv;
  if (!make_map<D, T>(&tq, q, bh, s, kBQ) || !make_map<D, T>(&tk, k, bh, s, C::kBK) ||
      !make_map<D, T>(&tv, v, bh, s, C::kBK))
    return cudaErrorInvalidValue;
  const size_t smem = C::kSmemBytes;
  auto kernel = flash_fwd_kernel<D, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  kernel<<<grid, C::kThreads, smem, stream>>>(tq, tk, tv, static_cast<T*>(out), s, scale, window);
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
// bf16 (bf16 == 1), 16-byte aligned; d in {32, 64, 128, 256}; window <= 0
// is full causal. Launches on `stream` and does not synchronise. Returns a
// cudaError_t code: cudaErrorInvalidValue for a shape the kernel does not
// take or a tensor map cuTensorMapEncodeTiled refuses, otherwise
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int bh,
                                   int s, int d, float scale, int window, int bf16,
                                   cudaStream_t stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || (s + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, bh, s, d, scale, window, stream)
           : dispatch<float>(q, k, v, out, bh, s, d, scale, window, stream);
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
