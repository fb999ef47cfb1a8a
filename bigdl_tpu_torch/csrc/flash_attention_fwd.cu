// Flash-attention forward for Hopper (sm_90a), with a plain C entry point
// that bigdl_tpu_torch/kernels/flash_attention.py loads through ctypes.
//
// Replaces the TPU kernel `_flash_attention_impl` (flash_attention.py:589,
// its pallas_call at :758) of jax/experimental/pallas/ops/tpu/, which the
// JAX package reaches from bigdl_tpu/nn/attention.py MultiHeadAttention.apply
// with flash=True.  Same function: o = softmax(q k^T * sm_scale [causal]) v,
// with an online softmax so the (T, T) score matrix never reaches device
// memory, and (when the caller passes an lse pointer: training, where the
// backward recomputes P from it) each row's log-sum-exp of the scaled scores
// in natural log, (B, H, T) fp32; a null pointer writes nothing (serving).
//
// Layout.  q, k, v and o are (B, T, H, Dh) with the head dimension contiguous
// and any strides for B, T and H, so the module needs no transposes; T is a
// multiple of 64.  One block per (query tile, head, batch); a loop over key
// tiles inside the block takes the place of the TPU grid's sequential key
// axis.  For causal attention (top-left mask) the key loop stops at the
// diagonal tile, so tiles wholly above the diagonal are skipped, and the
// query tiles are scheduled heaviest first within groups of 8 heads
// (block_tile).
//
// Bounds on an H100 SXM at B8/H8/T2048/Dh128, causal: 4*B*H*Dh*T(T+1)/2 =
// 68.7 GFLOP; q, k, v read once and o written once.
//
// bf16: flash_fwd_wgmma_bf16_kernel.  68.7 GFLOP at 989 TFLOP/s (bf16 tensor
//   cores) = 69 us against 134 MB at 3.35 TB/s = 40 us: bound by operations,
//   and only wgmma reaches that rate.  So the design is Hopper's own:
//   * 128 query rows per block, three warpgroups.  A producer warp issues TMA
//     loads (cp.async.bulk.tensor, 4-D maps over (Dh, T, H, B) encoded on the
//     host): Q once, then K and V tiles of 128 keys into a ring of three
//     stages with full/empty mbarrier pairs, so loads overlap the products
//     (Q 32 KB + 3 x 64 KB of K and V: 224 KB of shared memory, one block
//     per SM).  Two consumer warpgroups each own 64 query rows.  setmaxnreg
//     moves the producer's registers to the consumers (24 / 240).
//   * S = Q K^T by wgmma m64n128k16 with both operands in shared memory,
//     K-major, 128B swizzle: a 128-column bf16 row arrives as two boxes of
//     64 columns (a swizzled box is at most 128 bytes wide).
//   * Online softmax in exp2 on the accumulator fragments in registers.
//   * O += P V by wgmma with P converted to bf16 in registers as the A
//     operand, and V in shared memory as B in MN-major layout (wgmma's
//     transpose of B, which 16-bit types allow), so V needs no transpose.
//   * The tensor cores are kept busy two ways.  Within a warpgroup, tile i's
//     S is issued before tile i - 1's P V, and tile i's softmax runs while
//     that product is in flight (so a stage is held one tile longer: three
//     stages, where two left the loads exposed).  Across the two warpgroups,
//     named barriers make them take turns to issue, so one's softmax runs
//     while the other's products hold the tensor cores.
//   Traps, each handled below:
//   * TMA zero-fills rows beyond T.  A zero key scores 0, not -inf, so keys
//     >= T are masked explicitly in the ragged last tile (T need only be a
//     multiple of 64, the tiles are 128).  Query rows >= T are not stored.
//   * The descriptors' byte offsets differ by major-ness: K-major (Q, K)
//     has its 8-row groups SBO = 1024 bytes apart and no use for LBO;
//     MN-major (V) has the 8-key groups SBO = 1024 bytes apart and the two
//     64-column halves LBO = 16 KB apart.
//   * wgmma.fence before the first wgmma that reads registers written by
//     ordinary instructions (P, and O after its rescale), and
//     wgmma.wait_group before the accumulators are read.
//   * A consumer releases a stage (arrives on "empty") only after the wgmma
//     that reads it has completed.
//
// fp32: flash_fwd_tf32x3_kernel.  FMA outside the tensor cores would be
//   bound at 68.7 GFLOP / 67 TFLOP/s = 1.03 ms, and single-pass TF32 (an
//   11-bit significand) misses the fp32 tolerance.  So each product runs as
//   split TF32 on the tensor cores: with x_hi = tf32_rna(x) and
//   x_lo = tf32_rna(x - x_hi), a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, each
//   term one mma.sync m16n8k8 tf32, about 2^-21 relative per product.  Bound:
//   3 x 68.7 GFLOP at 494.7 TFLOP/s (dense TF32) = 0.417 ms.
//   * 128 query rows per block, 8 warps of 16 rows; key tiles of 64 keys,
//     staged by cp.async into a ring of two stages so loads overlap the
//     products.  Q waits in shared memory too (202 KB in all, one block of
//     8 warps per SM), which leaves the registers to the 16x128 output
//     accumulator and the products in flight: no spills.
//   * Every fragment is split into hi and lo as it is loaded; the three
//     products of a tile run as three passes over independent output
//     tiles, so no product waits on the one before it.
//   * The order of k inside one k-step is free: k = t4 reads key (or Dh
//     index) 2*t4 and k = t4 + 4 reads 2*t4 + 1.  Then the C fragment of one
//     8-key tile of S is the A fragment of one k-step of P V, with no
//     shuffle and no round trip of P through shared memory, and Q's and K's
//     fragment pairs are one 8-byte load each.
// Both accumulate in fp32 and write o in the input's type.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run
                   // time through cudaGetDriverEntryPoint, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockM = 128;  // query rows per block, both kernels
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, t, h;  // in elements; the head dimension has stride 1
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, T) or null
  Strides sq, sk, sv, so;
  int batch, seq_len, heads;
  float scale_log2;  // sm_scale * log2(e): the softmax runs on exp2
  int causal;
};

// the lse entries of (b, h)
__device__ __forceinline__ float* lse_row(const Args& a, int b, int h) {
  return a.lse + ((long long)b * a.heads + h) * a.seq_len;
}

// One block per work tile: 128 query rows of one (head, batch).  Blocks
// start in the order of blockIdx.x.  They take the (head, batch) pairs in
// groups of kHeadGroup and, within a group, the query tiles heaviest first:
// for causal attention the last query tile sees the most keys.  So few long
// tiles are left to the end of the grid, where heaviest first within each
// head alone started the last heads' longest tiles last, and the blocks in
// flight read the K and V of about one group (8 MB in bf16 at T 2048),
// which L2 holds.
constexpr int kHeadGroup = 8;

struct Tile {
  int m0, h, b;
};

__device__ __forceinline__ Tile block_tile(const Args& a) {
  const int m_tiles = (a.seq_len + kBlockM - 1) / kBlockM;
  const int pairs = a.heads * a.batch;
  const int group = blockIdx.x / (kHeadGroup * m_tiles);
  const int size = min(kHeadGroup, pairs - group * kHeadGroup);
  const int p = blockIdx.x - group * kHeadGroup * m_tiles;
  const int hb = group * kHeadGroup + p % size;
  Tile t;
  t.m0 = (m_tiles - 1 - p / size) * kBlockM;
  t.h = hb % a.heads;
  t.b = hb / a.heads;
  return t;
}

// keys [0, kv_end) that a query tile starting at m0 attends to
__device__ __forceinline__ int kv_end(const Args& a, int m0) {
  return a.causal ? min(m0 + kBlockM, a.seq_len) : a.seq_len;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------- fp32 (3xTF32, mma.sync)

constexpr int kTfBlockN = 64;  // keys per tile
constexpr int kTfThreads = 256;
// row strides in floats: Q's and K's 8-byte fragment loads and V's 4-byte
// ones hit 32 distinct banks per warp; all keep 16-byte aligned rows
constexpr int kTfQKStride = kHeadDim + 8;
constexpr int kTfVStride = kHeadDim + 4;
constexpr int kTfQFloats = kBlockM * kTfQKStride;
constexpr int kTfStageFloats = kTfBlockN * (kTfQKStride + kTfVStride);
constexpr size_t kTfSmemBytes =
    sizeof(float) * (kTfQFloats + 2 * kTfStageFloats);

// x rounded to tf32 (10 explicit significand bits), to nearest with ties
// away from zero, as cvt.rna.tf32.f32 does but in two integer operations:
// adding half a tf32 ulp to the magnitude's bits carries into the kept ones
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 2^-22 relative, both exact in tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b for one 16x8x8 tf32 tile: a row-major 16x8, b column-major 8x8.
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_1688(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a b[n] in 3xTF32 for N independent tiles, the small terms first;
// each pass runs over all N so no product waits on the one before it
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const float (&b)[N][2]) {
  uint32_t b_hi[N][2], b_lo[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) split_tf32(b[n][e], b_hi[n][e], b_lo[n][e]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688(c[n], a_lo, b_hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688(c[n], a_hi, b_lo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688(c[n], a_hi, b_hi[n]);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
}

// rows [r_begin, r_end) of a (T, Dh) operand into shared memory rows of
// `stride` floats, in kBytes pieces (16 when every row start is 16-byte
// aligned, else 4)
template <int kBytes>
__device__ __forceinline__ void copy_rows(float* dst, int stride,
                                          const float* src, long long st,
                                          int r_begin, int r_end) {
  constexpr int kPer = kBytes / 4;
  constexpr int kRowPieces = kHeadDim / kPer;
  const int pieces = (r_end - r_begin) * kRowPieces;
  for (int e = threadIdx.x; e < pieces; e += kTfThreads) {
    const int r = e / kRowPieces, c = (e % kRowPieces) * kPer;
    cp_async<kBytes>(&dst[r * stride + c], src + (r_begin + r) * st + c);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kBytes>
__global__ void __launch_bounds__(kTfThreads, 1)
    flash_fwd_tf32x3_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* stage0 = smem + kTfQFloats;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row, and column of B
  const int t4 = lane & 3;
  const Tile tile = block_tile(a);
  const int m0 = tile.m0, h = tile.h, b = tile.b;
  const int T = a.seq_len;

  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  float* o = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h;

  // Q's rows below T (T is a multiple of 64, so a warp's 16 rows lie all
  // below T or all beyond it; the latter only wait), then K and V of the
  // first tile: one cp.async group
  copy_rows<kBytes>(qs, kTfQKStride, q, a.sq.t, m0, min(m0 + kBlockM, T));
  const int n_tiles = kv_end(a, m0) / kTfBlockN;
  auto load_tile = [&](int i) {
    float* ks = stage0 + (i & 1) * kTfStageFloats;
    const int n0 = i * kTfBlockN;
    copy_rows<kBytes>(ks, kTfQKStride, k, a.sk.t, n0, n0 + kTfBlockN);
    copy_rows<kBytes>(ks + kTfBlockN * kTfQKStride, kTfVStride, v, a.sv.t, n0,
                      n0 + kTfBlockN);
    cp_async_commit();
  };
  load_tile(0);

  const int wrow = m0 + warp * 16;  // the warp's first row
  const int r0 = wrow + g;          // the lane's rows are r0 and r0 + 8
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int n0 = i * kTfBlockN;
    if (i + 1 < n_tiles) {
      load_tile(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* ks = stage0 + (i & 1) * kTfStageFloats;
    const float* vs = ks + kTfBlockN * kTfQKStride;

    // a warp whose rows all lie above this tile's keys (causal), or beyond
    // T (the ragged last query tile), has nothing to add
    const bool active = wrow < T && (!a.causal || n0 <= wrow + 15);
    if (active) {
      // S = Q K^T: 8 tiles of 16 rows x 8 keys, over Dh in 16 k-steps of 8;
      // k = t4 reads Dh index 2*t4 and k = t4 + 4 reads 2*t4 + 1, so each
      // fragment pair is one 8-byte load
      float s[kTfBlockN / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTfBlockN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kHeadDim / 8; ++kk) {
        const int c = kk * 8 + 2 * t4;
        const float2 q0 = *reinterpret_cast<const float2*>(
            &qs[(warp * 16 + g) * kTfQKStride + c]);
        const float2 q1 = *reinterpret_cast<const float2*>(
            &qs[(warp * 16 + g + 8) * kTfQKStride + c]);
        const float qa[4] = {q0.x, q1.x, q0.y, q1.y};
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(qa[e], a_hi[e], a_lo[e]);
        float kb[kTfBlockN / 8][2];
#pragma unroll
        for (int nt = 0; nt < kTfBlockN / 8; ++nt) {
          const float2 x = *reinterpret_cast<const float2*>(
              &ks[(nt * 8 + g) * kTfQKStride + c]);
          kb[nt][0] = x.x;
          kb[nt][1] = x.y;
        }
        mma_3xtf32(s, a_hi, a_lo, kb);
      }

      // online softmax; s[nt][0..1] lie on row r0, s[nt][2..3] on r0 + 8
      const bool diag = a.causal && n0 + kTfBlockN - 1 > wrow;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kTfBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (diag && n0 + nt * 8 + t4 * 2 + (e & 1) > r0 + (e >> 1) * 8)
            s[nt][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 lanes that share a row are adjacent: t4 = lane & 3
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // every row sees key 0 in its first tile, so m_new is finite
        m_new[r] = fmaxf(m_run[r], mx[r] * a.scale_log2);
        alpha[r] = exp2f(m_run[r] - m_new[r]);
        m_run[r] = m_new[r];
      }
#pragma unroll
      for (int nt = 0; nt < kTfBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[nt][e], a.scale_log2, -m_new[e >> 1]));
          s[nt][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }

      // O += P V: S tile j's C fragment, read with k = t4 as key 2*t4 and
      // k = t4 + 4 as key 2*t4 + 1, is the A fragment of k-step j; the 16
      // output tiles go in groups of 4
#pragma unroll
      for (int j = 0; j < kTfBlockN / 8; ++j) {
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t p_hi[4], p_lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(pa[e], p_hi[e], p_lo[e]);
        const float* v0 = &vs[(j * 8 + 2 * t4) * kTfVStride + g];
#pragma unroll
        for (int dg = 0; dg < kHeadDim / 32; ++dg) {
          float vb[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            vb[n][0] = v0[(dg * 4 + n) * 8];
            vb[n][1] = v0[kTfVStride + (dg * 4 + n) * 8];
          }
          mma_3xtf32(*reinterpret_cast<float(*)[4][4]>(&acc[dg * 4]), p_hi,
                     p_lo, vb);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if (wrow >= T) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    // m_run is in the exp2 domain: lse = ln(2^m * l) = (m + log2 l) ln 2
    if (a.lse != nullptr && t4 == 0)
      lse_row(a, b, h)[r0 + r * 8] = (m_run[r] + log2f(l)) * kLn2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* orow = o + (long long)(r0 + r * 8) * a.so.t;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      orow[dt * 8 + t4 * 2] = acc[dt][2 * r] * inv[r];
      orow[dt * 8 + t4 * 2 + 1] = acc[dt][2 * r + 1] * inv[r];
    }
  }
}

// ------------------------------------- bf16 (wgmma + TMA, warp-specialised)

constexpr int kWgBlockN = 128;  // keys per tile
constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kWgStages = 3;
constexpr uint32_t kHalfBytes = 128 * 64 * 2;  // one 128-row, 64-column box
constexpr uint32_t kTileBytes = 2 * kHalfBytes;  // 128 rows x 128 columns
// shared memory from a 1024-byte aligned base: Q, then per stage K and V,
// then the mbarriers
constexpr uint32_t kSmemQ = 0;
constexpr uint32_t kSmemKV = kTileBytes;
constexpr uint32_t kSmemBar = kSmemKV + kWgStages * 2 * kTileBytes;
constexpr size_t kWgSmemBytes =
    kSmemBar + 8 * (1 + 2 * kWgStages) + 1024;  // + alignment slack
constexpr int kConsumerWarps = 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of the given parity has completed.  (A
// bounded wait that traps costs the consumers registers: with a clock64
// check here the wgmma kernel spilled and ptxas serialised its wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
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

// one box of the 4-D map (Dh, T, H, B) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

// a wgmma shared-memory descriptor with the 128B swizzle (layout type 1);
// offsets in bytes
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of wgmma are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x by the special-function unit alone (2^-inf = 0); P is rounded to bf16
// next, far coarser than its 2 ulp
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d (+)= a b for one m64n128k16 step: a and b from shared memory, both
// K-major with the 128B swizzle; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += a b for one m64n128k16 step: a from registers (bf16 pairs, the
// mma.m16n8k16 A fragment of each warp's 16 rows), b from shared memory
// MN-major (transposed: its N index contiguous) with the 128B swizzle
__device__ __forceinline__ void wgmma_rs_tn(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// keeps the compiler from moving accumulator registers while a wgmma that
// writes them is in flight
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                Args a) {
  extern __shared__ unsigned char smem_raw[];
  // the 128B swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + kSmemQ;
  const uint32_t q_full = base + kSmemBar;
  // stage s: K at kv(s), V at kv(s) + kTileBytes; full(s), empty(s) barriers
  auto kv = [&](int s) { return base + kSmemKV + s * 2 * kTileBytes; };
  auto full = [&](int s) { return q_full + 8 + 8 * s; };
  auto empty = [&](int s) { return q_full + 8 + 8 * kWgStages + 8 * s; };

  const int wg = threadIdx.x / 128;
  const Tile tile = block_tile(a);
  const int m0 = tile.m0, h = tile.h, b = tile.b;
  const int T = a.seq_len;
  const int n_tiles = (kv_end(a, m0) + kWgBlockN - 1) / kWgBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_load(sq, &map_q, q_full, 0, m0, h, b);
      tma_load(sq + kHalfBytes, &map_q, q_full, 64, m0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kWgStages;
        // the first pass over the ring finds every stage free
        mbar_wait(empty(s), ((i / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTileBytes);
        const int n0 = i * kWgBlockN;
        tma_load(kv(s), &map_k, full(s), 0, n0, h, b);
        tma_load(kv(s) + kHalfBytes, &map_k, full(s), 64, n0, h, b);
        tma_load(kv(s) + kTileBytes, &map_v, full(s), 0, n0, h, b);
        tma_load(kv(s) + kTileBytes + kHalfBytes, &map_v, full(s), 64, n0, h,
                 b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows m0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);  // and r0 + 8
    const int c2 = (lane & 3) * 2;  // the lane's column pair in each 8

    float o[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.f;
    float sc[64];                      // S of the current tile, then its P
    uint32_t pa[kWgBlockN / 16][4];    // P in bf16: the A operand of P V
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];                    // the factor that rescales O

    // S = Q K^T over Dh in 8 steps of 16; steps 4-7 read the second
    // 64-column half of Q and K.  K-major: 8-row groups 1024 bytes apart.
    auto gemm_s = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
        wgmma_ss(sc, wgmma_desc(sq + wg * 64 * 128 + off, 16, 1024),
                 wgmma_desc(kv(s) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V over the keys in 8 steps of 16.  V MN-major: 8-key groups
    // 1024 bytes apart (SBO), the two 64-column halves kHalfBytes apart (LBO).
    auto gemm_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < kWgBlockN / 16; ++kk)
        wgmma_rs_tn(o, pa[kk],
                    wgmma_desc(kv(s) + kTileBytes + kk * 16 * 128,
                               kHalfBytes, 1024));
      wgmma_commit();
    };
    // online softmax of tile i over the accumulator: sc[4n + e] is row
    // r0 + 8 (e >> 1), key n0 + 8n + c2 + (e & 1).  The last tile holds the
    // causal diagonal and, for T not a multiple of 128, the keys >= T that
    // TMA filled with zeros.  Leaves P in sc and the factor that rescales O
    // in alpha.
    auto softmax = [&](int i) {
      if (i == n_tiles - 1) {
        const int n0 = i * kWgBlockN;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int key = n0 + 8 * (e / 4) + c2 + (e & 1);
          const int row = r0 + 8 * ((e >> 1) & 1);
          if (key >= T || (a.causal && key > row)) sc[e] = -INFINITY;
        }
      }
      // a row's 32 entries go to 4 partial maxima and sums, so the
      // softmax, which stands between two batches of wgmma, is not one
      // long chain of dependent instructions
      float mx[2][4], sum[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mx[r][j] = -INFINITY;
          sum[r][j] = 0.f;
        }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        float& m = mx[(e >> 1) & 1][(e & 1) + 2 * ((e >> 2) & 1)];
        m = fmaxf(m, sc[e]);
      }
      float m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        // the 4 lanes that share a row are adjacent: lane & 3
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        // every row sees a key below T and not above it in every tile, so
        // m_new is finite
        m_new[r] = fmaxf(m_run[r], m * a.scale_log2);
        alpha[r] = exp2_approx(m_run[r] - m_new[r]);
        m_run[r] = m_new[r];
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e >> 1) & 1;
        sc[e] = exp2_approx(fmaf(sc[e], a.scale_log2, -m_new[r]));
        sum[r][(e & 1) + 2 * ((e >> 2) & 1)] += sc[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l_run[r] = l_run[r] * alpha[r] +
                   ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
    };
    // P's bf16 A fragments: keys 16kk..16kk+15 are the accumulator's key
    // groups 2kk and 2kk + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kWgBlockN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_f32(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] *= alpha[(e >> 1) & 1];
    };
    // called once every wgmma of this warp that read stage s has completed
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    // The two warpgroups take turns to issue their products, so one's
    // softmax runs while the other's products hold the tensor cores: named
    // barrier 1 + w is warpgroup w's turn; it syncs there before issuing and
    // passes the turn with an arrive on the other's after.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    auto pass_turn = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };
    if (wg == 1) pass_turn();  // warpgroup 0 goes first

    // Tile i's S = Q K^T is issued first; O's rescale by tile i - 1's
    // factor runs while it computes; then tile i - 1's O += P V is issued,
    // and tile i's softmax runs while that product is in flight.  The
    // fences: before each batch of wgmma, since the threads wrote P, O
    // (rescaled) and S (read by the softmax); around the accumulators, so
    // the compiler moves none of them while a wgmma is in flight.  Tile 0's
    // softmax leaves alpha 0, which keeps O at zero.
    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    fence_acc(sc);
    wgmma_fence();
    my_turn();
    gemm_s(0);
    pass_turn();
    wgmma_wait<0>();
    fence_acc(sc);
    softmax(0);
    pack_p();
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kWgStages, prev = (i - 1) % kWgStages;
      mbar_wait(full(s), (i / kWgStages) & 1);
      fence_acc(sc);
      wgmma_fence();
      my_turn();
      gemm_s(s);
      rescale_o();
      fence_acc(o);
      wgmma_fence();
      gemm_pv(prev);
      pass_turn();
      wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 may still run
      fence_acc(sc);
      softmax(i);
      wgmma_wait<0>();
      fence_acc(o);
      release(prev);
      pack_p();
    }
    rescale_o();
    fence_acc(o);
    wgmma_fence();
    my_turn();
    gemm_pv((n_tiles - 1) % kWgStages);
    pass_turn();
    wgmma_wait<0>();
    fence_acc(o);
    release((n_tiles - 1) % kWgStages);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / l;
      // m_run is in the exp2 domain: lse = ln(2^m * l) = (m + log2 l) ln 2
      if (a.lse != nullptr && (lane & 3) == 0 && r0 + 8 * r < T)
        lse_row(a, b, h)[r0 + 8 * r] = (m_run[r] + log2f(l)) * kLn2;
    }
    __nv_bfloat16* o_bh =
        static_cast<__nv_bfloat16*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r0 + 8 * r >= T) continue;
      __nv_bfloat16* orow = o_bh + (long long)(r0 + 8 * r) * a.so.t;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + c2) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] * inv[r],
                                  o[4 * n + 2 * r + 1] * inv[r]);
    }
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over one bf16 (B, T, H, Dh) operand, innermost first:
// (Dh, T, H, B) with its byte strides; boxes of 64 columns x 128 rows with
// the 128B swizzle; rows beyond T read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, const Strides& st,
                int batch, int seq_len, int heads) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kHeadDim, (cuuint64_t)seq_len,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.t * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 &&
         st.t % 4 == 0 && st.h % 4 == 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 host values, (b, t, h) in
// elements for q, k, v and o in that order.  lse: (B, H, T) fp32, contiguous,
// or null for none.  Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 on success), or the error that
// stopped it before (cudaErrorInvalidValue for arguments the kernels do not
// take, including a bf16 operand whose tensor map cannot be encoded).
int bigdl_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, const long long* strides,
                              int batch,
                              int seq_len, int heads, int head_dim, int dtype,
                              float sm_scale, int causal, void* stream) {
  if (head_dim != kHeadDim || seq_len <= 0 || seq_len % 64 != 0 ||
      batch <= 0 || heads <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  Strides* dst[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) {
    dst[i]->b = strides[3 * i];
    dst[i]->t = strides[3 * i + 1];
    dst[i]->h = strides[3 * i + 2];
  }
  a.batch = batch;
  a.seq_len = seq_len;
  a.heads = heads;
  a.scale_log2 = sm_scale * 1.4426950408889634f;
  a.causal = causal;
  const int grid = (seq_len + kBlockM - 1) / kBlockM * heads * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    if (aligned16(q, a.sq) && aligned16(k, a.sk) && aligned16(v, a.sv)) {
      err = set_smem(flash_fwd_tf32x3_kernel<16>, kTfSmemBytes);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_tf32x3_kernel<16><<<grid, kTfThreads, kTfSmemBytes, s>>>(a);
    } else {
      err = set_smem(flash_fwd_tf32x3_kernel<4>, kTfSmemBytes);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_tf32x3_kernel<4><<<grid, kTfThreads, kTfSmemBytes, s>>>(a);
    }
  } else {
    CUtensorMap mq, mk, mv;
    if (!encode_map(&mq, q, a.sq, batch, seq_len, heads) ||
        !encode_map(&mk, k, a.sk, batch, seq_len, heads) ||
        !encode_map(&mv, v, a.sv, batch, seq_len, heads))
      return (int)cudaErrorInvalidValue;
    err = set_smem(flash_fwd_wgmma_bf16_kernel, kWgSmemBytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_wgmma_bf16_kernel<<<grid, kWgThreads, kWgSmemBytes, s>>>(
        mq, mk, mv, a);
  }
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
