// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel and the dQ
// kernel, each in fp32 and bf16, with plain C entry points that
// bigdl_tpu_torch/kernels/flash_attention.py loads through ctypes.
//
// Replaces the TPU kernels `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq`, the backward pallas_calls of
// jax/experimental/pallas/ops/tpu/flash_attention.py that the JAX package
// reaches when it differentiates MultiHeadAttention with flash=True.  Same
// function: with P = softmax(q k^T * s [causal]) recomputed from the
// forward's log-sum-exp and di = rowsum(o * do),
//   dV = P^T dO,   dS = P * (dO V^T - di),   dK = s dS^T Q,   dQ = s dS K.
//
// Design.  The TPU kernels walk a sequential grid and carry partial sums in
// scratch; here blocks run in parallel in no order, so each output tile is
// owned by one block and nothing crosses blocks (no atomics, so the result is
// the same bits from run to run):
//   * dK/dV: one block per (key tile, head, batch) keeps its K and V tile and
//     loops over query tiles (under causal, from the diagonal tile on),
//     recomputing P and dS, accumulating dV and dK in fp32 registers, and
//     writes them once.  Key tiles with the most query tiles launch first.
//   * dQ: one block per (query tile, head, batch) loops over key tiles (under
//     causal, up to the diagonal tile) and accumulates dQ.  The heaviest
//     query tiles launch first.
// P is recomputed as exp2(S * s * log2(e) - lse * log2(e)), lse being the
// forward's natural-log log-sum-exp, so both use one convention.
//
// Layout.  q, k, v, do, dq, dk and dv are (B, T, H, Dh) with the head
// dimension contiguous and any strides for B, T and H; lse and di are
// (B, H, T) fp32, contiguous.
//
// Bound on an H100 SXM at B8/H8/T2048/Dh128, causal (pairs = T(T+1)/2 per
// head; a multiply-add counts as two operations):
//   dK/dV: four products (S, dP, dV, dK) = 8*Dh*pairs*B*H = 137 GFLOP;
//          q, k, v, do read and dk, dv written once, plus lse and di, in
//          bf16 = 202 MB.  bf16: 0.139 ms (operations); fp32: 2.05 ms by
//          FMA, 0.834 ms as 3xTF32 on the tensor cores (3 x 137 GFLOP at
//          494.7 TFLOP/s).
//   dQ:    three products (S, dP, dQ) = 103 GFLOP; 168 MB in bf16.
//          bf16: 0.104 ms (operations); fp32: 1.54 ms by FMA, 0.625 ms as
//          3xTF32 on the tensor cores (3 x 103 GFLOP at 494.7 TFLOP/s).
//
// Kernels (each wgmma kernel runs a producer warpgroup, whose one thread
// issues every TMA copy, beside two consumer warpgroups that setmaxnreg
// gives 240 registers each; each 3xTF32 kernel runs every product as three
// TF32 mma.sync m16n8k8, the split of flash_attention_fwd.cu: round to
// nearest, ties away, by integer operations, about 2^-21 relative per
// product):
//   * bf16 dK/dV, flash_bwd_dkv_wgmma_bf16_kernel: the bf16 forward's design
//     (flash_attention_fwd.cu).  128 keys per block, 64 per consumer
//     warpgroup.  The producer TMA-loads the block's K and V tiles once
//     (32 KB each, 128B swizzle, two 64-column boxes per row), then streams
//     query tiles of 64 rows into a 3-stage mbarrier ring: per stage the Q
//     and dO tiles (16 KB each) and, by a bulk copy on the same barrier, the
//     tile's 64 lse and 64 di values.  Per query tile, each consumer:
//       - S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 from shared
//         memory, both operands K-major; dP^T is issued before P^T is
//         computed, so the exponentials run while it is in flight;
//       - P^T = exp2(S^T s log2e - lse log2e) with lse per column (the
//         query), the causal mask on the one 64-query tile that crosses the
//         warpgroup's 64-key diagonal; dS^T = P^T * (dP^T - di);
//       - both to bf16 register A fragments (the C layout of m64n64 is the A
//         layout of four k16 steps), then dV += P^T dO and dK += dS^T Q as
//         wgmma m64n128k16 with B MN-major: the forward's transpose of V.
//         The Q tile is read K-major for S^T and MN-major for dK: one tile,
//         two descriptors.
//     A warpgroup whose keys all lie beyond T (the ragged last key tile)
//     or above a query tile (causal) only releases the stage.  dK (times s)
//     and dV go out once in bf16; rows at or beyond T are not stored (TMA
//     zero-filled them, and a zero key's P is not 0, but it reaches only
//     that key's own row).
//   * bf16 dQ, flash_bwd_dq_wgmma_bf16_kernel: the mirror image, Q and K
//     swapped.  128 query rows per block, 64 per consumer warpgroup.  The
//     producer TMA-loads the block's Q and dO once (32 KB each), then
//     streams K and V tiles of 64 keys (16 KB each) through a 3-stage ring.
//     Each consumer reads its own rows' lse and di once from global memory
//     and, per key tile: S = Q K^T and dP = dO V^T as wgmma m64n64k16 (dP
//     in flight while P is computed); dS = P * (dP - di), packed to bf16 A
//     fragments; dQ += dS K as m64n128k16 with K read MN-major from the same
//     stage (K-major for S).  A warpgroup whose rows lie beyond T (T is a
//     multiple of 64, not of 128: TMA zero-filled them) or below a key tile
//     (causal) only releases the stage; it reads no lse or di past T and
//     stores nothing there.  160 KB of shared memory.
//   * fp32 dK/dV, flash_bwd_dkv_tf32x3_kernel: the fp32 dQ's machinery with
//     the roles of queries and keys swapped.  64 keys per block in 8 warps:
//     warps 2p and 2p + 1 share keys 16p..16p+15, each holding dK and dV for
//     64 of the 128 columns (64 accumulators a thread; a warp holding all
//     128 would need 128 before any score).  K and V stay in shared memory;
//     32-query Q and dO tiles, with their lse and di, stream through a
//     2-stage cp.async ring (157 KB in all, one block per SM).  Per tile one
//     warp of the pair computes S^T = K Q^T and from it P^T, the other
//     dP^T = V dO^T and from it dP^T - di, for the pair's keys and all 32
//     queries (one split A fragment serves 4 products); both go through
//     shared memory, and both warps read them as the A fragments of
//     dV += P^T dO and dK += dS^T Q, forming dS^T = P^T * (dP^T - di) as
//     they read it: no product is done twice.  Each tile's dV and dK are
//     summed apart and added to the running sums by fp32 adds: summed in
//     one accumulator over the 768 mma of a 2048-query sum, the tensor
//     cores' fp32 accumulation loses low bits that an fp32 add keeps, and
//     the error against the plain backward grew several times on an
//     H100.  Q and dO are read at rows g (S^T's B) and at rows
//     2 t4 and 2 t4 + 1 (dV's and dK's B), so their rows are stored
//     swizzled as K is in the dQ kernel.  Under causal attention the loop
//     starts at the diagonal tile; dK is scaled by s once, at the store.
//   * fp32 dQ, flash_bwd_dq_tf32x3_kernel: the fp32 forward's design.  128
//     query rows per block, 8 warps of 16 rows, Q and dO in shared memory,
//     K and V tiles of 32 keys through a 2-stage cp.async ring (204 KB in
//     all, one block per SM).  S = Q K^T and dP = dO V^T per warp; dS in the
//     C fragments; dQ += dS K with dS's C fragment as the A fragment (k = t4
//     reads key 2 t4, k = t4 + 4 key 2 t4 + 1).  K's rows are then read at
//     rows 2 t4 and at rows g, which no padding serves both without bank
//     conflicts: K's row r is stored with its columns XOR-ed by 8 when
//     r & 4 is set.

#include <math.h>

#include "hopper.cuh"  // cp.async, 3xTF32, mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace hopper;

constexpr int kHeadDim = 128;
constexpr int kTBlock = 64;  // T must be a multiple of it
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, H, T): the forward's log-sum-exp, natural log
  const float* di;   // (B, H, T): rowsum(o * do)
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int batch, heads;
  int seq_len;
  float sm_scale;
  float scale_log2;  // sm_scale * log2(e)
  int causal;
};

// ------------------------------------------------- fp32 dK/dV (3xTF32)

// rows of kTfStride floats: 16-byte aligned, and the 8-byte fragment loads
// of rows g hit 32 distinct banks per half warp
constexpr int kTfStride = kHeadDim + 8;
constexpr int kTkKeys = 64;      // keys per block: 4 pairs of warps x 16
constexpr int kTkQueries = 32;   // queries per tile of the loop
constexpr int kTkThreads = 256;
// P^T and dS^T rows: the 8-byte fragment reads and writes of rows g hit 32
// distinct banks per half warp
constexpr int kTkPStride = kTkQueries + 8;
constexpr int kTkKvFloats = kTkKeys * kTfStride;
// per stage: Q, dO, then the tile's lse and di
constexpr int kTkStageFloats = 2 * kTkQueries * kTfStride + 2 * kTkQueries;
constexpr size_t kTkDkvSmemBytes =
    sizeof(float) * (2 * kTkKvFloats + 2 * kTkKeys * kTkPStride +
                     2 * kTkStageFloats);

// one m16n8k8 A fragment of 16 rows x 8 columns from shared memory, k = t4
// read as column 2 t4 and k = t4 + 4 as 2 t4 + 1 (one 8-byte load per row),
// split into tf32 hi and lo
__device__ __forceinline__ void a_frag_3xtf32(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4],
                                              const float* p, int stride) {
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * stride);
  const float xa[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(xa[e], hi[e], lo[e]);
}

// as a_frag_3xtf32, of the elementwise product p * d of two tiles laid out
// alike
__device__ __forceinline__ void ds_frag_3xtf32(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float* p, const float* d,
                                               int stride) {
  const float2 p0 = *reinterpret_cast<const float2*>(p);
  const float2 p1 = *reinterpret_cast<const float2*>(p + 8 * stride);
  const float2 d0 = *reinterpret_cast<const float2*>(d);
  const float2 d1 = *reinterpret_cast<const float2*>(d + 8 * stride);
  const float xa[4] = {p0.x * d0.x, p1.x * d1.x, p0.y * d0.y, p1.y * d1.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(xa[e], hi[e], lo[e]);
}

template <int kBytes>
__global__ void __launch_bounds__(kTkThreads, 1)
    flash_bwd_dkv_tf32x3_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTkKvFloats;
  float* ps = vs + kTkKvFloats;
  float* dss = ps + kTkKeys * kTkPStride;
  float* stage0 = dss + kTkKeys * kTkPStride;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row, and column of B
  const int t4 = lane & 3;
  // warps 2p and 2p + 1 own keys 16p..16p+15 of the block; `half` picks the
  // warp's product of the pair (S^T or dP^T) and its 64 columns of dK and dV
  const int kr = (warp >> 1) * 16, half = warp & 1;
  const int T = a.seq_len;
  const Work w = block_work(T / kTkKeys, a.heads, a.batch);
  const int n0 = w.tile * kTkKeys, h = w.h, b = w.b;

  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const long long row_bh = ((long long)b * a.heads + h) * T;

  // K and V of the block's keys (T is a multiple of 64: all below T), then
  // the first query tile: one cp.async group
  copy_rows<kBytes, kTkThreads, kHeadDim>(ks, kTfStride, k, a.sk.t, n0,
                                          n0 + kTkKeys);
  copy_rows<kBytes, kTkThreads, kHeadDim>(vs, kTfStride, v, a.sv.t, n0,
                                          n0 + kTkKeys);
  // under causal attention no query before n0 sees the block's keys
  const int m_begin = a.causal ? n0 : 0;
  const int n_q = (T - m_begin) / kTkQueries;
  auto load_tile = [&](int i) {
    float* qs = stage0 + (i & 1) * kTkStageFloats;
    const int m0 = m_begin + i * kTkQueries;
    copy_rows<kBytes, kTkThreads, kHeadDim, true>(qs, kTfStride, q, a.sq.t,
                                                  m0, m0 + kTkQueries);
    copy_rows<kBytes, kTkThreads, kHeadDim, true>(
        qs + kTkQueries * kTfStride, kTfStride, dout, a.sdo.t, m0,
        m0 + kTkQueries);
    if (tid < 2 * kTkQueries)
      cp_async<4>(qs + 2 * kTkQueries * kTfStride + tid,
                  (tid < kTkQueries ? a.lse + tid : a.di + tid - kTkQueries) +
                      row_bh + m0);
    cp_async_commit();
  };
  load_tile(0);

  float dk[kHeadDim / 16][4], dv[kHeadDim / 16][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // Q's and dO's swizzle (columns XOR 8 on rows with bit 2 set) as each
  // lane meets it: on rows g in S^T and dP^T, on rows 2 t4 and 2 t4 + 1 in
  // dV and dK
  const int x_s = (g & 4) << 1;
  const int x_acc = (t4 & 2) << 2;
  const int key0 = n0 + kr;     // the warp's first key

  for (int i = 0; i < n_q; ++i) {
    const int m0 = m_begin + i * kTkQueries;
    if (i + 1 < n_q) {
      load_tile(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* qs = stage0 + (i & 1) * kTkStageFloats;
    const float* dos = qs + kTkQueries * kTfStride;
    const float* lse_s = dos + kTkQueries * kTfStride;
    const float* di_s = lse_s + kTkQueries;

    // The pair splits S^T and dP^T by product: warp half 0 computes
    // S^T = K Q^T and from it P^T, half 1 dP^T = V dO^T and from it
    // dP^T - di, each for the pair's 16 keys and the tile's 32 queries (4
    // tiles of 8, over Dh in 16 k-steps of 8), so that each split A
    // fragment serves 4 products.  Under causal attention a pair whose keys
    // all lie above the tile's queries has nothing to add.
    const bool active = !a.causal || key0 <= m0 + kTkQueries - 1;
    if (active) {
      const float* xa = half ? vs : ks;
      const float* xq = half ? dos : qs;
      float sx[kTkQueries / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTkQueries / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sx[nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kHeadDim / 8; ++kk) {
        const int c = kk * 8 + 2 * t4;
        uint32_t a_hi[4], a_lo[4];
        float xb[kTkQueries / 8][2];
        a_frag_3xtf32(a_hi, a_lo, &xa[(kr + g) * kTfStride + c], kTfStride);
#pragma unroll
        for (int nt = 0; nt < kTkQueries / 8; ++nt) {
          const float2 y = *reinterpret_cast<const float2*>(
              &xq[(nt * 8 + g) * kTfStride + (c ^ x_s)]);
          xb[nt][0] = y.x;
          xb[nt][1] = y.y;
        }
        mma_3xtf32(sx, a_hi, a_lo, xb);
      }
      // sx[nt][e] lies on key key0 + g + 8 (e >> 1) and query
      // m0 + 8 nt + 2 t4 + (e & 1); lse and di are per query, so per column
      const bool diag = a.causal && key0 + 15 > m0;
      float* out = half ? dss : ps;
#pragma unroll
      for (int nt = 0; nt < kTkQueries / 8; ++nt) {
        const int qc = nt * 8 + 2 * t4;
        if (half == 0) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + qc);
          const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(sx[nt][e], a.scale_log2, -l2[e & 1]));
            if (diag && key0 + g + 8 * (e >> 1) > m0 + qc + (e & 1)) p = 0.f;
            sx[nt][e] = p;
          }
        } else {
          const float2 d = *reinterpret_cast<const float2*>(di_s + qc);
#pragma unroll
          for (int e = 0; e < 4; ++e) sx[nt][e] -= (e & 1) ? d.y : d.x;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              &out[(kr + g + 8 * r) * kTkPStride + qc]) =
              make_float2(sx[nt][2 * r], sx[nt][2 * r + 1]);
      }
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (warp >> 1)) : "memory");

    // dV += P^T dO, then dK += dS^T Q with dS^T = P^T * (dP^T - di) formed
    // as its fragments are read, over the tile's 32 queries in 4 k-steps of
    // 8, for the warp's 64 columns in 8 tiles of 8.  B is dO's or Q's rows
    // 2 t4 and 2 t4 + 1 (k = t4 and t4 + 4 as the A fragment reads them).
    // The tile's sum goes to the running one by fp32 adds (see the top).
    if (active) {
      float part[kHeadDim / 16][4];
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
        for (int n = 0; n < kHeadDim / 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kTkQueries / 8; ++kk) {
          const int pc = (kr + g) * kTkPStride + kk * 8 + 2 * t4;
          uint32_t a_hi[4], a_lo[4];
          if (pass == 0)
            a_frag_3xtf32(a_hi, a_lo, &ps[pc], kTkPStride);
          else
            ds_frag_3xtf32(a_hi, a_lo, &ps[pc], &dss[pc], kTkPStride);
          const float* x0 =
              (pass == 0 ? dos : qs) + (kk * 8 + 2 * t4) * kTfStride;
#pragma unroll
          for (int dg = 0; dg < 2; ++dg) {
            float xb[4][2];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int col = (64 * half + (dg * 4 + n) * 8 + g) ^ x_acc;
              xb[n][0] = x0[col];
              xb[n][1] = x0[kTfStride + col];
            }
            mma_3xtf32(*reinterpret_cast<float(*)[4][4]>(&part[dg * 4]), a_hi,
                       a_lo, xb);
          }
        }
        float(&acc)[kHeadDim / 16][4] = pass == 0 ? dv : dk;
#pragma unroll
        for (int n = 0; n < kHeadDim / 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }
    }
    __syncthreads();  // this stage, P^T and dS^T are consumed
  }

  // dK (times s) and dV: dk[n][e] lies on key key0 + g + 8 (e >> 1) and
  // column 64 half + 8 n + 2 t4 + (e & 1)
  float* dk_bh = static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  float* dv_bh = static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* dk_row = dk_bh + (long long)(key0 + g + 8 * r) * a.sdk.t;
    float* dv_row = dv_bh + (long long)(key0 + g + 8 * r) * a.sdv.t;
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) {
      const int col = 64 * half + n * 8 + 2 * t4;
      dk_row[col] = dk[n][2 * r] * a.sm_scale;
      dk_row[col + 1] = dk[n][2 * r + 1] * a.sm_scale;
      dv_row[col] = dv[n][2 * r];
      dv_row[col + 1] = dv[n][2 * r + 1];
    }
  }
}

// ------------------------------------------- fp32 dQ (3xTF32, mma.sync)

constexpr int kTfRows = 128;   // query rows per block, 16 per warp
constexpr int kTfKeys = 32;    // keys per tile of the loop
constexpr int kTfThreads = 256;
constexpr int kTfTileFloats = kTfRows * kTfStride;
constexpr int kTfStageFloats = 2 * kTfKeys * kTfStride;  // K, then V
constexpr size_t kTfDqSmemBytes =
    sizeof(float) * (2 * kTfTileFloats + 2 * kTfStageFloats);

template <int kBytes>
__global__ void __launch_bounds__(kTfThreads, 1)
    flash_bwd_dq_tf32x3_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTfTileFloats;
  float* stage0 = dos + kTfTileFloats;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row, and column of B
  const int t4 = lane & 3;
  const int T = a.seq_len;
  const int m_tiles = (T + kTfRows - 1) / kTfRows;
  const Work w = block_work(m_tiles, a.heads, a.batch);
  const int m0 = (m_tiles - 1 - w.tile) * kTfRows, h = w.h, b = w.b;

  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const long long row_bh = ((long long)b * a.heads + h) * T;

  // Q's and dO's rows below T (T is a multiple of 64, so a warp's 16 rows
  // lie all below T or all beyond it; the latter only wait), then K and V
  // of the first tile: one cp.async group
  const int m_end = min(m0 + kTfRows, T);
  copy_rows<kBytes, kTfThreads, kHeadDim>(qs, kTfStride, q, a.sq.t, m0, m_end);
  copy_rows<kBytes, kTfThreads, kHeadDim>(dos, kTfStride, dout, a.sdo.t, m0,
                                          m_end);
  const int n_tiles = (a.causal ? m_end : T) / kTfKeys;
  auto load_tile = [&](int i) {
    float* ks = stage0 + (i & 1) * kTfStageFloats;
    const int n0 = i * kTfKeys;
    copy_rows<kBytes, kTfThreads, kHeadDim, true>(ks, kTfStride, k, a.sk.t,
                                                  n0, n0 + kTfKeys);
    copy_rows<kBytes, kTfThreads, kHeadDim>(ks + kTfKeys * kTfStride,
                                            kTfStride, v, a.sv.t, n0,
                                            n0 + kTfKeys);
    cp_async_commit();
  };
  load_tile(0);

  const int wrow = m0 + warp * 16;  // the warp's first row
  const int r0 = wrow + g;          // the lane's rows are r0 and r0 + 8
  float lse2[2] = {0.f, 0.f}, dir[2] = {0.f, 0.f};
  if (wrow < T) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = a.lse[row_bh + r0 + 8 * r] * kLog2e;
      dir[r] = a.di[row_bh + r0 + 8 * r];
    }
  }
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  // K's swizzle (columns XOR 8 on rows with bit 2 set) as each lane meets
  // it: on rows g in S = Q K^T, on rows 2 t4 and 2 t4 + 1 in dQ += dS K
  const int kx_s = (g & 4) << 1;
  const int kx_dq = (t4 & 2) << 2;

  for (int i = 0; i < n_tiles; ++i) {
    const int n0 = i * kTfKeys;
    if (i + 1 < n_tiles) {
      load_tile(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* ks = stage0 + (i & 1) * kTfStageFloats;
    const float* vs = ks + kTfKeys * kTfStride;

    // a warp whose rows all lie above this tile's keys (causal), or beyond
    // T (the ragged last query tile), has nothing to add
    const bool active = wrow < T && (!a.causal || n0 <= wrow + 15);
    if (active) {
      // S = Q K^T and dP = dO V^T: 4 tiles of 16 rows x 8 keys each, over
      // Dh in 16 k-steps of 8; k = t4 reads Dh index 2 t4 and k = t4 + 4
      // reads 2 t4 + 1, so each fragment pair is one 8-byte load
      float s[kTfKeys / 8][4], dp[kTfKeys / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTfKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kHeadDim / 8; ++kk) {
        const int c = kk * 8 + 2 * t4;
        uint32_t a_hi[4], a_lo[4];
        float kb[kTfKeys / 8][2];
        {
          const float2 x0 = *reinterpret_cast<const float2*>(
              &qs[(warp * 16 + g) * kTfStride + c]);
          const float2 x1 = *reinterpret_cast<const float2*>(
              &qs[(warp * 16 + g + 8) * kTfStride + c]);
          const float xa[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(xa[e], a_hi[e], a_lo[e]);
#pragma unroll
          for (int nt = 0; nt < kTfKeys / 8; ++nt) {
            const float2 y = *reinterpret_cast<const float2*>(
                &ks[(nt * 8 + g) * kTfStride + (c ^ kx_s)]);
            kb[nt][0] = y.x;
            kb[nt][1] = y.y;
          }
          mma_3xtf32(s, a_hi, a_lo, kb);
        }
        {
          const float2 x0 = *reinterpret_cast<const float2*>(
              &dos[(warp * 16 + g) * kTfStride + c]);
          const float2 x1 = *reinterpret_cast<const float2*>(
              &dos[(warp * 16 + g + 8) * kTfStride + c]);
          const float xa[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(xa[e], a_hi[e], a_lo[e]);
#pragma unroll
          for (int nt = 0; nt < kTfKeys / 8; ++nt) {
            const float2 y = *reinterpret_cast<const float2*>(
                &vs[(nt * 8 + g) * kTfStride + c]);
            kb[nt][0] = y.x;
            kb[nt][1] = y.y;
          }
          mma_3xtf32(dp, a_hi, a_lo, kb);
        }
      }

      // dS = P * (dP - di) in the C fragments: s[nt][e] lies on row
      // r0 + 8 (e >> 1) and key n0 + 8 nt + 2 t4 + (e & 1)
      const bool diag = a.causal && n0 + kTfKeys - 1 > wrow;
#pragma unroll
      for (int nt = 0; nt < kTfKeys / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[nt][e], a.scale_log2, -lse2[e >> 1]));
          if (diag && n0 + nt * 8 + 2 * t4 + (e & 1) > r0 + (e >> 1) * 8)
            p = 0.f;
          dp[nt][e] = p * (dp[nt][e] - dir[e >> 1]);
        }
      }

      // dQ += dS K: dS tile j's C fragment, read with k = t4 as key 2 t4
      // and k = t4 + 4 as key 2 t4 + 1, is the A fragment of k-step j; B
      // is K's rows 2 t4 and 2 t4 + 1 of the step; the 16 output tiles go
      // in groups of 4
#pragma unroll
      for (int j = 0; j < kTfKeys / 8; ++j) {
        const float da[4] = {dp[j][0], dp[j][2], dp[j][1], dp[j][3]};
        uint32_t d_hi[4], d_lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(da[e], d_hi[e], d_lo[e]);
        const float* k0 = &ks[(j * 8 + 2 * t4) * kTfStride + g];
#pragma unroll
        for (int dg = 0; dg < kHeadDim / 32; ++dg) {
          float kb[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = ((dg * 4 + n) * 8) ^ kx_dq;
            kb[n][0] = k0[col];
            kb[n][1] = k0[kTfStride + col];
          }
          mma_3xtf32(*reinterpret_cast<float(*)[4][4]>(&acc[dg * 4]), d_hi,
                     d_lo, kb);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if (wrow >= T) return;
  float* dq = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = dq + (long long)(r0 + 8 * r) * a.sdq.t;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      row[dt * 8 + 2 * t4] = acc[dt][2 * r] * a.sm_scale;
      row[dt * 8 + 2 * t4 + 1] = acc[dt][2 * r + 1] * a.sm_scale;
    }
  }
}

// ------------------------------- bf16 dK/dV (wgmma + TMA, warp-specialised)

constexpr int kWgKeys = 128;     // keys per block, 64 per consumer warpgroup
constexpr int kWgQueries = 64;   // queries per tile of the loop
constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kWgStages = 3;
constexpr int kWgConsumerWarps = 8;
constexpr uint32_t kKvHalf = kWgKeys * 64 * 2;        // 128 rows x 64 columns
constexpr uint32_t kKvBytes = 2 * kKvHalf;            // one 128 x 128 tile
constexpr uint32_t kQHalf = kWgQueries * 64 * 2;      // 64 rows x 64 columns
constexpr uint32_t kQBytes = 2 * kQHalf;              // one 64 x 128 tile
constexpr uint32_t kRowBytes = kWgQueries * 4;        // a tile's lse or di
// shared memory from a 1024-byte aligned base: K, V, then per stage Q and
// dO, then per stage lse and di, then the mbarriers
constexpr uint32_t kSmK = 0;
constexpr uint32_t kSmV = kKvBytes;
constexpr uint32_t kSmStages = 2 * kKvBytes;
constexpr uint32_t kSmRows = kSmStages + kWgStages * 2 * kQBytes;
constexpr uint32_t kSmBar = kSmRows + kWgStages * 2 * kRowBytes;
constexpr size_t kWgSmemBytes =
    kSmBar + 8 * (1 + 2 * kWgStages) + 1024;  // + alignment slack

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                                    const __grid_constant__ CUtensorMap map_k,
                                    const __grid_constant__ CUtensorMap map_v,
                                    const __grid_constant__ CUtensorMap map_do,
                                    Args a) {
  extern __shared__ unsigned char smem_raw[];
  // the 128B swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t kv_full = base + kSmBar;
  // stage s: Q at q_at(s), dO kQBytes after it; lse and di; full(s) and
  // empty(s) barriers
  auto q_at = [&](int s) { return base + kSmStages + s * 2 * kQBytes; };
  auto rows_at = [&](int s) {
    return reinterpret_cast<const float*>(smem_raw + (base - raw) + kSmRows +
                                          s * 2 * kRowBytes);
  };
  auto full = [&](int s) { return kv_full + 8 + 8 * s; };
  auto empty = [&](int s) { return kv_full + 8 + 8 * kWgStages + 8 * s; };

  const int wg = threadIdx.x / 128;
  const int T = a.seq_len;
  const Work w = block_work((T + kWgKeys - 1) / kWgKeys, a.heads, a.batch);
  const int n0 = w.tile * kWgKeys, h = w.h, b = w.b;
  // under causal attention no query before n0 sees the block's keys; n0 is
  // a multiple of 128, so the first query tile starts there
  const int m_begin = a.causal ? n0 : 0;
  const int n_q = (T - m_begin) / kWgQueries;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread loads K and V, then keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * kKvBytes);
      tma_load(base + kSmK, &map_k, kv_full, 0, n0, h, b);
      tma_load(base + kSmK + kKvHalf, &map_k, kv_full, 64, n0, h, b);
      tma_load(base + kSmV, &map_v, kv_full, 0, n0, h, b);
      tma_load(base + kSmV + kKvHalf, &map_v, kv_full, 64, n0, h, b);
      const long long row_bh = ((long long)b * a.heads + h) * T;
      for (int i = 0; i < n_q; ++i) {
        const int s = i % kWgStages;
        const int m0 = m_begin + i * kWgQueries;
        // the first pass over the ring finds every stage free
        mbar_wait(empty(s), ((i / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kQBytes + 2 * kRowBytes);
        tma_load(q_at(s), &map_q, full(s), 0, m0, h, b);
        tma_load(q_at(s) + kQHalf, &map_q, full(s), 64, m0, h, b);
        tma_load(q_at(s) + kQBytes, &map_do, full(s), 0, m0, h, b);
        tma_load(q_at(s) + kQBytes + kQHalf, &map_do, full(s), 64, m0, h, b);
        const uint32_t rows = smem_u32(rows_at(s));
        bulk_load(rows, a.lse + row_bh + m0, kRowBytes, full(s));
        bulk_load(rows + kRowBytes, a.di + row_bh + m0, kRowBytes, full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys n0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int key0 = n0 + wg * 64;
    const int kr = warp * 16 + (lane >> 2);  // the lane's keys: key0 + kr, + 8
    const int c2 = (lane & 3) * 2;  // the lane's query pair in each 8
    // this warpgroup's 64 rows of K and V in each 64-column half
    const uint32_t k_rows = base + kSmK + wg * 64 * 128;
    const uint32_t v_rows = base + kSmV + wg * 64 * 128;

    float dv[64], dk[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) dv[e] = dk[e] = 0.f;
    float st[32];    // S^T of the current tile, then P^T
    float dpt[32];   // dP^T, then dS^T
    uint32_t pa[kWgQueries / 16][4], da[kWgQueries / 16][4];  // bf16 A

    // S^T = K Q^T (or dP^T = V dO^T) over Dh in 8 steps of 16; steps 4-7
    // read the second 64-column halves.  Both K-major: 8-row groups 1024
    // bytes apart.
    auto gemm_t = [&](float(&d)[32], uint32_t a_rows, uint32_t b_tile) {
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk)
        wgmma_ss_n64(d,
                     wgmma_desc(a_rows + (kk / 4) * kKvHalf + (kk % 4) * 32,
                                16, 1024),
                     wgmma_desc(b_tile + (kk / 4) * kQHalf + (kk % 4) * 32,
                                16, 1024),
                     kk > 0);
      wgmma_commit();
    };
    // d += A X over the tile's queries in 4 steps of 16, X (dO or Q) read
    // MN-major: 8-query groups 1024 bytes apart (SBO), the two 64-column
    // halves kQHalf apart (LBO)
    auto gemm_acc = [&](float(&d)[64], const uint32_t(&f)[kWgQueries / 16][4],
                        uint32_t x_tile) {
#pragma unroll
      for (int kk = 0; kk < kWgQueries / 16; ++kk)
        wgmma_rs_tn(d, f[kk], wgmma_desc(x_tile + kk * 16 * 128, kQHalf, 1024));
    };
    // called once every wgmma of this warp that read stage s has completed
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_q; ++i) {
      const int s = i % kWgStages;
      const int m0 = m_begin + i * kWgQueries;
      const uint32_t qt = q_at(s), dot = qt + kQBytes;
      mbar_wait(full(s), (i / kWgStages) & 1);
      // keys beyond T (the ragged last key tile) have no gradient to store;
      // under causal attention a query tile below the keys adds nothing
      if (key0 < T && (!a.causal || m0 + kWgQueries > key0)) {
        // the fences: before each batch of wgmma, since the threads wrote
        // its register operands; around the accumulators, so the compiler
        // moves none of them while a wgmma is in flight
        fence_acc(st);
        fence_acc(dpt);
        wgmma_fence();
        gemm_t(st, k_rows, qt);
        gemm_t(dpt, v_rows, dot);
        wgmma_wait<1>();  // S^T is in; dP^T may still run
        fence_acc(st);
        // P^T: st[4n + e] lies on key key0 + kr + 8 (e >> 1) and query
        // m0 + 8n + c2 + (e & 1); only the tile on the warpgroup's diagonal
        // (m0 == key0) has keys above queries
        const float* lse_s = rows_at(s);
        const float* di_s = lse_s + kWgQueries;
        const bool diag = a.causal && m0 == key0;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * n + c2);
          const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(fmaf(st[4 * n + e], a.scale_log2,
                                       -l2[e & 1]));
            if (diag && kr + 8 * (e >> 1) > 8 * n + c2 + (e & 1)) p = 0.f;
            st[4 * n + e] = p;
          }
        }
        wgmma_wait<0>();
        fence_acc(dpt);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 d = *reinterpret_cast<const float2*>(di_s + 8 * n + c2);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] -
                                              ((e & 1) ? d.y : d.x));
        }
        // queries 16kk..16kk+15 are the accumulator's groups 2kk, 2kk + 1
#pragma unroll
        for (int kk = 0; kk < kWgQueries / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pa[kk][e] = pack_f32(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
            da[kk][e] = pack_f32(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
          }
        fence_acc(dv);
        fence_acc(dk);
        wgmma_fence();
        gemm_acc(dv, pa, dot);
        gemm_acc(dk, da, qt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
      }
      release(s);
    }

    __nv_bfloat16* dk_bh =
        static_cast<__nv_bfloat16*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
    __nv_bfloat16* dv_bh =
        static_cast<__nv_bfloat16*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + kr + 8 * r;
      if (key >= T) continue;
      __nv_bfloat16* dk_row = dk_bh + (long long)key * a.sdk.t;
      __nv_bfloat16* dv_row = dv_bh + (long long)key * a.sdv.t;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * n + c2) =
            __floats2bfloat162_rn(dk[4 * n + 2 * r] * a.sm_scale,
                                  dk[4 * n + 2 * r + 1] * a.sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * n + c2) =
            __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

// --------------------------------- bf16 dQ (wgmma + TMA, warp-specialised)

constexpr int kDqRows = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int kDqKeys = 64;    // keys per tile of the loop
constexpr uint32_t kDqQHalf = kDqRows * 64 * 2;   // 128 rows x 64 columns
constexpr uint32_t kDqQBytes = 2 * kDqQHalf;      // one 128 x 128 tile
constexpr uint32_t kDqKHalf = kDqKeys * 64 * 2;   // 64 rows x 64 columns
constexpr uint32_t kDqKBytes = 2 * kDqKHalf;      // one 64 x 128 tile
// shared memory from a 1024-byte aligned base: Q, dO, then per stage K and
// V, then the mbarriers
constexpr uint32_t kDqSmQ = 0;
constexpr uint32_t kDqSmDo = kDqQBytes;
constexpr uint32_t kDqSmStages = 2 * kDqQBytes;
constexpr uint32_t kDqSmBar = kDqSmStages + kWgStages * 2 * kDqKBytes;
constexpr size_t kDqSmemBytes =
    kDqSmBar + 8 * (1 + 2 * kWgStages) + 1024;  // + alignment slack

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v,
                                   const __grid_constant__ CUtensorMap map_do,
                                   Args a) {
  extern __shared__ unsigned char smem_raw[];
  // the 128B swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + kDqSmBar;
  // stage s: K at k_at(s), V kDqKBytes after it; full(s) and empty(s)
  auto k_at = [&](int s) { return base + kDqSmStages + s * 2 * kDqKBytes; };
  auto full = [&](int s) { return q_full + 8 + 8 * s; };
  auto empty = [&](int s) { return q_full + 8 + 8 * kWgStages + 8 * s; };

  const int wg = threadIdx.x / 128;
  const int T = a.seq_len;
  const int m_tiles = (T + kDqRows - 1) / kDqRows;
  const Work w = block_work(m_tiles, a.heads, a.batch);
  const int m0 = (m_tiles - 1 - w.tile) * kDqRows, h = w.h, b = w.b;
  // under causal attention no key beyond the block's last query is seen
  const int n_k = (a.causal ? min(m0 + kDqRows, T) : T) / kDqKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread loads Q and dO, then keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * kDqQBytes);
      tma_load(base + kDqSmQ, &map_q, q_full, 0, m0, h, b);
      tma_load(base + kDqSmQ + kDqQHalf, &map_q, q_full, 64, m0, h, b);
      tma_load(base + kDqSmDo, &map_do, q_full, 0, m0, h, b);
      tma_load(base + kDqSmDo + kDqQHalf, &map_do, q_full, 64, m0, h, b);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kWgStages;
        const int n0 = i * kDqKeys;
        // the first pass over the ring finds every stage free
        mbar_wait(empty(s), ((i / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kDqKBytes);
        tma_load(k_at(s), &map_k, full(s), 0, n0, h, b);
        tma_load(k_at(s) + kDqKHalf, &map_k, full(s), 64, n0, h, b);
        tma_load(k_at(s) + kDqKBytes, &map_v, full(s), 0, n0, h, b);
        tma_load(k_at(s) + kDqKBytes + kDqKHalf, &map_v, full(s), 64, n0, h,
                 b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns queries m0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int row0 = m0 + wg * 64;
    const int qr = warp * 16 + (lane >> 2);  // the lane's rows: row0 + qr, + 8
    const int c2 = (lane & 3) * 2;  // the lane's key pair in each 8
    // rows at or beyond T (the ragged last query tile: T is a multiple of
    // 64, so a warpgroup's rows lie all below T or all beyond it) have
    // nothing to compute or store, and no lse or di to read: those
    // addresses hold the next head's rows or lie past the array
    const bool rows_in = row0 < T;
    // this warpgroup's 64 rows of Q and dO in each 64-column half
    const uint32_t q_rows = base + kDqSmQ + wg * 64 * 128;
    const uint32_t do_rows = base + kDqSmDo + wg * 64 * 128;
    float lse2[2] = {0.f, 0.f}, dir[2] = {0.f, 0.f};
    if (rows_in) {
      const long long row_bh = ((long long)b * a.heads + h) * T;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = a.lse[row_bh + row0 + qr + 8 * r] * kLog2e;
        dir[r] = a.di[row_bh + row0 + qr + 8 * r];
      }
    }

    float dq[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) dq[e] = 0.f;
    float s[32];     // S of the current tile, then P
    float dp[32];    // dP, then dS
    uint32_t da[kDqKeys / 16][4];  // dS as bf16 A fragments

    // S = Q K^T (or dP = dO V^T) over Dh in 8 steps of 16; steps 4-7 read
    // the second 64-column halves.  Both K-major: 8-row groups 1024 bytes
    // apart.
    auto gemm_t = [&](float(&d)[32], uint32_t a_rows, uint32_t b_tile) {
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk)
        wgmma_ss_n64(d,
                     wgmma_desc(a_rows + (kk / 4) * kDqQHalf + (kk % 4) * 32,
                                16, 1024),
                     wgmma_desc(b_tile + (kk / 4) * kDqKHalf + (kk % 4) * 32,
                                16, 1024),
                     kk > 0);
      wgmma_commit();
    };
    // called once every wgmma of this warp that read the stage has completed
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
    };

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_k; ++i) {
      const int st = i % kWgStages;
      const int n0 = i * kDqKeys;
      const uint32_t kt = k_at(st), vt = kt + kDqKBytes;
      mbar_wait(full(st), (i / kWgStages) & 1);
      // under causal attention a key tile above the warpgroup's rows adds
      // nothing (n0 and row0 are multiples of 64)
      if (rows_in && (!a.causal || n0 <= row0)) {
        // the fences: before each batch of wgmma, since the threads wrote
        // its register operands; around the accumulators, so the compiler
        // moves none of them while a wgmma is in flight
        fence_acc(s);
        fence_acc(dp);
        wgmma_fence();
        gemm_t(s, q_rows, kt);
        gemm_t(dp, do_rows, vt);
        wgmma_wait<1>();  // S is in; dP may still run
        fence_acc(s);
        // P: s[4n + e] lies on query row0 + qr + 8 (e >> 1) and key
        // n0 + 8n + c2 + (e & 1); only the tile on the warpgroup's diagonal
        // (n0 == row0) has keys above queries
        const bool diag = a.causal && n0 == row0;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(fmaf(s[4 * n + e], a.scale_log2,
                                       -lse2[e >> 1]));
            if (diag && 8 * n + c2 + (e & 1) > qr + 8 * (e >> 1)) p = 0.f;
            s[4 * n + e] = p;
          }
        wgmma_wait<0>();
        fence_acc(dp);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          dp[e] = s[e] * (dp[e] - dir[(e >> 1) & 1]);
        // keys 16kk..16kk+15 are the accumulator's groups 2kk, 2kk + 1
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            da[kk][e] = pack_f32(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        // dQ += dS K over the tile's keys in 4 steps of 16, K read MN-major
        // from the same stage: 8-key groups 1024 bytes apart (SBO), the two
        // 64-column halves kDqKHalf apart (LBO)
        fence_acc(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
          wgmma_rs_tn(dq, da[kk],
                      wgmma_desc(kt + kk * 16 * 128, kDqKHalf, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dq);
      }
      release(st);
    }

    if (!rows_in) return;
    __nv_bfloat16* dq_bh =
        static_cast<__nv_bfloat16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat16* row = dq_bh + (long long)(row0 + qr + 8 * r) * a.sdq.t;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + c2) =
            __floats2bfloat162_rn(dq[4 * n + 2 * r] * a.sm_scale,
                                  dq[4 * n + 2 * r + 1] * a.sm_scale);
    }
  }
}

// Shared checks and argument packing of the two entry points.  strides holds
// (b, t, h) in elements for each operand in `order`.
int pack_args(Args* a, const long long* strides, Strides* const* order,
              int n_operands, int batch, int seq_len, int heads, int head_dim,
              int dtype, float sm_scale, int causal) {
  if (head_dim != kHeadDim || seq_len <= 0 || seq_len % kTBlock != 0 ||
      batch <= 0 || heads <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_operands; ++i) {
    order[i]->b = strides[3 * i];
    order[i]->t = strides[3 * i + 1];
    order[i]->h = strides[3 * i + 2];
  }
  a->batch = batch;
  a->heads = heads;
  a->seq_len = seq_len;
  a->sm_scale = sm_scale;
  a->scale_log2 = sm_scale * kLog2e;
  a->causal = causal;
  return 0;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 18 host values, (b, t, h) in
// elements for q, k, v, do, dk and dv in that order.  lse and di are (B, H, T)
// fp32, contiguous (in bf16 also 16-byte aligned: the kernel bulk-copies
// their rows).  Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 on success), or the error that
// stopped it before (cudaErrorInvalidValue for arguments the kernels do not
// take, including a bf16 operand whose tensor map cannot be encoded).
int bigdl_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* di, void* dk, void* dv,
                                  const long long* strides, int batch,
                                  int seq_len, int heads, int head_dim,
                                  int dtype, float sm_scale, int causal,
                                  void* stream) {
  Args a = {};
  Strides* order[6] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdk, &a.sdv};
  int err = pack_args(&a, strides, order, 6, batch, seq_len, heads, head_dim,
                      dtype, sm_scale, causal);
  if (err != 0) return err;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.di = di;
  a.dk = dk;
  a.dv = dv;
  if (dtype == 0) {
    const dim3 grid(seq_len / kTkKeys * heads * batch);
    if (aligned16(q, a.sq) && aligned16(k, a.sk) && aligned16(v, a.sv) &&
        aligned16(dout, a.sdo))
      return launch(flash_bwd_dkv_tf32x3_kernel<16>, grid, kTkThreads,
                    kTkDkvSmemBytes, a, stream);
    return launch(flash_bwd_dkv_tf32x3_kernel<4>, grid, kTkThreads,
                  kTkDkvSmemBytes, a, stream);
  }
  CUtensorMap mq, mk, mv, mdo;
  if (reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(di) % 16 != 0 ||
      !encode_map(&mq, q, a.sq, batch, seq_len, heads, kWgQueries) ||
      !encode_map(&mk, k, a.sk, batch, seq_len, heads, kWgKeys) ||
      !encode_map(&mv, v, a.sv, batch, seq_len, heads, kWgKeys) ||
      !encode_map(&mdo, dout, a.sdo, batch, seq_len, heads, kWgQueries))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (seq_len + kWgKeys - 1) / kWgKeys * heads * batch;
  flash_bwd_dkv_wgmma_bf16_kernel<<<grid, kWgThreads, kWgSmemBytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, a);
  return (int)cudaGetLastError();
}

// As above; strides: 15 host values, for q, k, v, do and dq in that order.
int bigdl_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* di, void* dq,
                                 const long long* strides, int batch,
                                 int seq_len, int heads, int head_dim,
                                 int dtype, float sm_scale, int causal,
                                 void* stream) {
  Args a = {};
  Strides* order[5] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq};
  int err = pack_args(&a, strides, order, 5, batch, seq_len, heads, head_dim,
                      dtype, sm_scale, causal);
  if (err != 0) return err;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.di = di;
  a.dq = dq;
  if (dtype == 0) {
    const dim3 grid((seq_len + kTfRows - 1) / kTfRows * heads * batch);
    if (aligned16(q, a.sq) && aligned16(k, a.sk) && aligned16(v, a.sv) &&
        aligned16(dout, a.sdo))
      return launch(flash_bwd_dq_tf32x3_kernel<16>, grid, kTfThreads,
                    kTfDqSmemBytes, a, stream);
    return launch(flash_bwd_dq_tf32x3_kernel<4>, grid, kTfThreads,
                  kTfDqSmemBytes, a, stream);
  }
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_map(&mq, q, a.sq, batch, seq_len, heads, kDqRows) ||
      !encode_map(&mk, k, a.sk, batch, seq_len, heads, kDqKeys) ||
      !encode_map(&mv, v, a.sv, batch, seq_len, heads, kDqKeys) ||
      !encode_map(&mdo, dout, a.sdo, batch, seq_len, heads, kDqRows))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (seq_len + kDqRows - 1) / kDqRows * heads * batch;
  flash_bwd_dq_wgmma_bf16_kernel<<<grid, kWgThreads, kDqSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, a);
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
