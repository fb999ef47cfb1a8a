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

#include <math.h>

#include "hopper.cuh"  // cp.async, 3xTF32, mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace hopper;

constexpr int kHeadDim = 128;
constexpr int kBlockM = 128;  // query rows per block, both kernels
constexpr float kLn2 = 0.6931471805599453f;

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

// One block per work tile: 128 query rows of one (head, batch), the last
// query tile (under causal attention the one that sees the most keys) first
// (block_work).
struct Tile {
  int m0, h, b;
};

__device__ __forceinline__ Tile block_tile(const Args& a) {
  const int m_tiles = (a.seq_len + kBlockM - 1) / kBlockM;
  const Work w = block_work(m_tiles, a.heads, a.batch);
  Tile t;
  t.m0 = (m_tiles - 1 - w.tile) * kBlockM;
  t.h = w.h;
  t.b = w.b;
  return t;
}

// keys [0, kv_end) that a query tile starting at m0 attends to
__device__ __forceinline__ int kv_end(const Args& a, int m0) {
  return a.causal ? min(m0 + kBlockM, a.seq_len) : a.seq_len;
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
  copy_rows<kBytes, kTfThreads, kHeadDim>(qs, kTfQKStride, q, a.sq.t, m0,
                                          min(m0 + kBlockM, T));
  const int n_tiles = kv_end(a, m0) / kTfBlockN;
  auto load_tile = [&](int i) {
    float* ks = stage0 + (i & 1) * kTfStageFloats;
    const int n0 = i * kTfBlockN;
    copy_rows<kBytes, kTfThreads, kHeadDim>(ks, kTfQKStride, k, a.sk.t, n0,
                                            n0 + kTfBlockN);
    copy_rows<kBytes, kTfThreads, kHeadDim>(ks + kTfBlockN * kTfQKStride,
                                            kTfVStride, v, a.sv.t, n0,
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
    if (!encode_map(&mq, q, a.sq, batch, seq_len, heads, 128) ||
        !encode_map(&mk, k, a.sk, batch, seq_len, heads, 128) ||
        !encode_map(&mv, v, a.sv, batch, seq_len, heads, 128))
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
