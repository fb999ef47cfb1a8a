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
//          bf16 = 202 MB.  bf16: 0.139 ms (operations); fp32: 2.05 ms (FMA).
//   dQ:    three products (S, dP, dQ) = 103 GFLOP; 168 MB in bf16.
//          bf16: 0.104 ms (operations); fp32: 1.54 ms by FMA, 0.625 ms as
//          3xTF32 on the tensor cores (3 x 103 GFLOP at 494.7 TFLOP/s).
//
// Kernels:
//   * bf16 dK/dV, flash_bwd_dkv_wgmma_bf16_kernel: the bf16 forward's design
//     (flash_attention_fwd.cu).  128 keys per block, three warpgroups.  A
//     producer thread TMA-loads the block's K and V tiles once (32 KB each,
//     128B swizzle, two 64-column boxes per row), then streams query tiles
//     of 64 rows into a 3-stage mbarrier ring: per stage the Q and dO tiles
//     (16 KB each) and, by a bulk copy on the same barrier, the tile's 64
//     lse and 64 di values.  Two consumer warpgroups (240 registers by
//     setmaxnreg) own 64 keys each and, per query tile:
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
//   * bf16 dQ, flash_bwd_dq_mma_bf16_kernel: mma.sync m16n8k16 with fp32
//     accumulation; each of 4 warps owns 16 queries of a 64-query tile.  P
//     and dS are cast to bf16 for their products, as flash attention does
//     on GPUs.
//   * fp32 dQ, flash_bwd_dq_tf32x3_kernel: the fp32 forward's design.  Every
//     product runs as 3xTF32 mma.sync m16n8k8 (the split of
//     flash_attention_fwd.cu: round to nearest, ties away, by integer
//     operations; about 2^-21 relative per product).  128 query rows per
//     block, 8 warps of 16 rows, Q and dO in shared memory, K and V tiles of
//     32 keys through a 2-stage cp.async ring (204 KB in all, one block per
//     SM).  S = Q K^T and dP = dO V^T per warp; dS in the C fragments; dQ +=
//     dS K with dS's C fragment as the A fragment (k = t4 reads key 2 t4,
//     k = t4 + 4 key 2 t4 + 1).  K's rows are then read at rows 2 t4 and at
//     rows g, which no padding serves both without bank conflicts: K's row r
//     is stored with its columns XOR-ed by 8 when r & 4 is set.
//   * fp32 dK/dV, flash_bwd_dkv_fma_kernel: plain FMA in full fp32, 256
//     threads; each thread owns 2 rows x 8 columns of a 64x64 score tile and
//     2 rows x 16 columns of each accumulator; P and dS go through shared
//     memory.

#include <math.h>

#include "hopper.cuh"  // cp.async, 3xTF32, mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace hopper;

constexpr int kHeadDim = 128;
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

// offset of row (b, h, 0) in a (B, H, T) array, in the kernels whose grid's
// y is the head (the 1-D grids take a.heads)
__device__ __forceinline__ long long bht_row(int b, int h, int seq_len) {
  return ((long long)b * gridDim.y + h) * seq_len;
}

// ------------------------------------------------------ fp32 dK/dV (FMA)

constexpr int kFmaThreads = 256;
constexpr int kFmaBlock = 64;               // rows of every tile
constexpr int kFmaStride = kHeadDim + 1;    // conflict-free column reads
constexpr int kFmaPStride = kFmaBlock + 1;
constexpr size_t kFmaDkvSmemBytes =
    sizeof(float) * (4 * kFmaBlock * kFmaStride + 2 * kFmaBlock * kFmaPStride +
                     2 * kFmaBlock);

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0) {
  for (int e = threadIdx.x; e < kFmaBlock * kHeadDim; e += kFmaThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    dst[r * kFmaStride + c] = src[(long long)(row0 + r) * row_stride + c];
  }
}

__global__ void __launch_bounds__(kFmaThreads)
    flash_bwd_dkv_fma_kernel(Args a) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kFmaBlock * kFmaStride;
  float* qs = vs + kFmaBlock * kFmaStride;
  float* dos = qs + kFmaBlock * kFmaStride;
  float* ps = dos + kFmaBlock * kFmaStride;
  float* dss = ps + kFmaBlock * kFmaPStride;
  float* lse_s = dss + kFmaBlock * kFmaPStride;
  float* di_s = lse_s + kFmaBlock;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // key rows ty*2, ty*2+1 of the tile
  const int tx = tid & 7;   // query columns tx + 8j; head-dim columns tx + 8j
  const int n0 = blockIdx.x * kFmaBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* lse = a.lse + bht_row(b, h, a.seq_len);
  const float* di = a.di + bht_row(b, h, a.seq_len);

  load_tile_f32(ks, k, a.sk.t, n0);
  load_tile_f32(vs, v, a.sv.t, n0);

  float dk_acc[2][kHeadDim / 8], dv_acc[2][kHeadDim / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int m0 = a.causal ? n0 : 0; m0 < a.seq_len; m0 += kFmaBlock) {
    __syncthreads();  // the previous query tile is consumed
    load_tile_f32(qs, q, a.sq.t, m0);
    load_tile_f32(dos, dout, a.sdo.t, m0);
    if (tid < kFmaBlock) {
      lse_s[tid] = lse[m0 + tid] * kLog2e;
      di_s[tid] = di[m0 + tid];
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's 2 keys x 8 queries
    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float kv[2], vv[2], qv[8], dov[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kv[i] = ks[(ty * 2 + i) * kFmaStride + d];
        vv[i] = vs[(ty * 2 + i) * kFmaStride + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = qs[(tx + 8 * j) * kFmaStride + d];
        dov[j] = dos[(tx + 8 * j) * kFmaStride + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

    // P^T and dS^T = P^T * (dP^T - di), masked where key > query
    const bool diag = a.causal && m0 < n0 + kFmaBlock;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = tx + 8 * j;
        float p = exp2f(s[i][j] * a.scale_log2 - lse_s[qc]);
        if (diag && n0 + kr > m0 + qc) p = 0.f;
        ps[kr * kFmaPStride + qc] = p;
        dss[kr * kFmaPStride + qc] = p * (dp[i][j] - di_s[qc]);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's 64 queries
#pragma unroll 4
    for (int m = 0; m < kFmaBlock; ++m) {
      float pv[2], dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pv[i] = ps[(ty * 2 + i) * kFmaPStride + m];
        dsv[i] = dss[(ty * 2 + i) * kFmaPStride + m];
      }
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        const float dov = dos[m * kFmaStride + tx + 8 * j];
        const float qv = qs[m * kFmaStride + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dv_acc[i][j] = fmaf(pv[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

  float* dk = static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  float* dv = static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = n0 + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      dk[row * a.sdk.t + tx + 8 * j] = dk_acc[i][j] * a.sm_scale;
      dv[row * a.sdv.t + tx + 8 * j] = dv_acc[i][j];
    }
  }
}

// ------------------------------------------- fp32 dQ (3xTF32, mma.sync)

constexpr int kTfRows = 128;   // query rows per block, 16 per warp
constexpr int kTfKeys = 32;    // keys per tile of the loop
constexpr int kTfThreads = 256;
// rows of kTfStride floats: 16-byte aligned, and the 8-byte fragment loads
// of rows g hit 32 distinct banks per half warp
constexpr int kTfStride = kHeadDim + 8;
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

// ------------------------------------------------ bf16 dQ (mma.sync)

constexpr int kMmaThreads = 128;
constexpr int kMmaStride = kHeadDim + 8;  // 272-byte rows: 16-B aligned and
                                          // conflict-free fragment reads
constexpr int kDqQueries = 64;   // queries per dQ block, 16 per warp
constexpr int kDqKeys = 64;      // keys per tile of its loop
constexpr size_t kMmaDqSmemBytes =
    sizeof(__nv_bfloat16) * (2 * kDqQueries + 2 * kDqKeys) * kMmaStride;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += a b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + rows) of a (T, Dh) slice into shared memory, 16 bytes a
// thread
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride, int row0,
                                               int rows) {
  constexpr int kChunks = kHeadDim / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    *reinterpret_cast<uint4*>(&dst[r * kMmaStride + c]) =
        *reinterpret_cast<const uint4*>(&src[(long long)(row0 + r) * row_stride +
                                             c]);
  }
}

// the A fragment of rows row0..row0+15, columns col0..col0+15 of a tile
__device__ __forceinline__ void load_a_frag(uint32_t (&f)[4],
                                            const __nv_bfloat16* tile, int row0,
                                            int col0, int g, int t4) {
  const __nv_bfloat16* p = &tile[(row0 + g) * kMmaStride + col0 + t4 * 2];
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * kMmaStride);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * kMmaStride + 8);
}

// B fragment (k x n = 16 x 8) read from a tile whose rows are the k index:
// rows row0..row0+15, columns col0..col0+7
__device__ __forceinline__ void load_b_frag_rows(uint32_t& b0, uint32_t& b1,
                                                 const __nv_bfloat16* tile,
                                                 int row0, int col0, int g,
                                                 int t4) {
  const __nv_bfloat16* p = &tile[(row0 + t4 * 2) * kMmaStride + col0 + g];
  b0 = pack_bf16(p[0], p[kMmaStride]);
  b1 = pack_bf16(p[8 * kMmaStride], p[9 * kMmaStride]);
}

__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kDqQueries * kMmaStride;
  __nv_bfloat16* ks = dos + kDqQueries * kMmaStride;
  __nv_bfloat16* vs = ks + kDqKeys * kMmaStride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kDqQueries;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* lse = a.lse + bht_row(b, h, a.seq_len);
  const float* di = a.di + bht_row(b, h, a.seq_len);

  load_tile_bf16(qs, q, a.sq.t, m0, kDqQueries);
  load_tile_bf16(dos, dout, a.sdo.t, m0, kDqQueries);

  const int r0 = warp * 16;  // this warp's queries; the lane's are r0 + g, +8
  float lse2[2], dir[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse[m0 + r0 + g + r * 8] * kLog2e;
    dir[r] = di[m0 + r0 + g + r * 8];
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int kv_end = a.causal ? m0 + kDqQueries : a.seq_len;
  for (int n0 = 0; n0 < kv_end; n0 += kDqKeys) {
    __syncthreads();  // the previous key tile is consumed
    load_tile_bf16(ks, k, a.sk.t, n0, kDqKeys);
    load_tile_bf16(vs, v, a.sv.t, n0, kDqKeys);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 8 tiles of 16 queries x 8 keys each
    float s[kDqKeys / 8][4], dp[kDqKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kDqKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a_frag(qa, qs, r0, kk * 16, g, t4);
      load_a_frag(da, dos, r0, kk * 16, g, t4);
#pragma unroll
      for (int nt = 0; nt < kDqKeys / 8; ++nt) {
        const __nv_bfloat16* pk = &ks[(nt * 8 + g) * kMmaStride + kk * 16 + t4 * 2];
        mma_16816(s[nt], qa, ld32(pk), ld32(pk + 8));
        const __nv_bfloat16* pv = &vs[(nt * 8 + g) * kMmaStride + kk * 16 + t4 * 2];
        mma_16816(dp[nt], da, ld32(pv), ld32(pv + 8));
      }
    }

    // dS = P * (dP - di); s[nt][e] lies on query r0 + g + (e >> 1) * 8 and
    // key nt * 8 + t4 * 2 + (e & 1) of the tiles
    const bool diag = a.causal && n0 + kDqKeys > m0;
#pragma unroll
    for (int nt = 0; nt < kDqKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e >> 1) * 8;
        const int col = nt * 8 + t4 * 2 + (e & 1);
        float p = exp2f(s[nt][e] * a.scale_log2 - lse2[e >> 1]);
        if (diag && n0 + col > m0 + row) p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - dir[e >> 1]);
      }
    }

    // dQ += dS K
#pragma unroll
    for (int j = 0; j < kDqKeys / 16; ++j) {
      const uint32_t da[4] = {pack_f32(dp[2 * j][0], dp[2 * j][1]),
                              pack_f32(dp[2 * j][2], dp[2 * j][3]),
                              pack_f32(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_f32(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        uint32_t b0, b1;
        load_b_frag_rows(b0, b1, ks, j * 16, dt * 8, g, t4);
        mma_16816(acc[dt], da, b0, b1);
      }
    }
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  const long long row = m0 + r0 + g;
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(dq + row * a.sdq.t + c) =
        __floats2bfloat162_rn(acc[dt][0] * a.sm_scale, acc[dt][1] * a.sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(dq + (row + 8) * a.sdq.t + c) =
        __floats2bfloat162_rn(acc[dt][2] * a.sm_scale, acc[dt][3] * a.sm_scale);
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

// Shared checks and argument packing of the two entry points.  strides holds
// (b, t, h) in elements for each operand in `order`.
int pack_args(Args* a, const long long* strides, Strides* const* order,
              int n_operands, int batch, int seq_len, int heads, int head_dim,
              int dtype, float sm_scale, int causal) {
  if (head_dim != kHeadDim || seq_len <= 0 || seq_len % kDqQueries != 0 ||
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
  if (dtype == 0)
    return launch(flash_bwd_dkv_fma_kernel, dim3(seq_len / kFmaBlock, heads, batch),
                  kFmaThreads, kFmaDkvSmemBytes, a, stream);
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
  return launch(flash_bwd_dq_mma_bf16_kernel,
                dim3(seq_len / kDqQueries, heads, batch), kMmaThreads,
                kMmaDqSmemBytes, a, stream);
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
