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
//          bf16 = 202 MB.  bf16: 0.139 ms (operations); fp32: 2.05 ms.
//   dQ:    three products (S, dP, dQ) = 103 GFLOP; 168 MB in bf16.
//          bf16: 0.104 ms (operations); fp32: 1.54 ms.
//
// Kernels, simple first (no TMA, no wgmma, no warp specialisation):
//   * bf16: mma.sync m16n8k16 with fp32 accumulation, in the forward's
//     fragment layouts.  dK/dV: each of 4 warps owns 16 keys of a 64-key tile
//     and works on S^T = K Q^T (keys as rows), so P^T and dS^T come out as A
//     fragments of dV += P^T dO and dK += dS^T Q; 32-query tiles keep the two
//     16x128 fp32 accumulators and the score tiles in registers.  dQ: each of
//     4 warps owns 16 queries of a 64-query tile.  P and dS are cast to bf16
//     for their products, as flash attention does on GPUs.
//   * fp32: plain FMA in full fp32 (TF32 would not hold the fp32 tolerance),
//     256 threads; each thread owns 2 rows x 8 columns of a 64x64 score tile
//     and 2 rows x 16 columns of each accumulator; P and dS go through shared
//     memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, h;  // in elements; the head dimension has stride 1
};

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
  int seq_len;
  float sm_scale;
  float scale_log2;  // sm_scale * log2(e)
  int causal;
};

// offset of row (b, h, 0) in a (B, H, T) array; the grid's y is the head
__device__ __forceinline__ long long bht_row(int b, int h, int seq_len) {
  return ((long long)b * gridDim.y + h) * seq_len;
}

// ---------------------------------------------------------------- fp32 (FMA)

constexpr int kFmaThreads = 256;
constexpr int kFmaBlock = 64;               // rows of every tile
constexpr int kFmaStride = kHeadDim + 1;    // conflict-free column reads
constexpr int kFmaPStride = kFmaBlock + 1;
constexpr size_t kFmaDkvSmemBytes =
    sizeof(float) * (4 * kFmaBlock * kFmaStride + 2 * kFmaBlock * kFmaPStride +
                     2 * kFmaBlock);
constexpr size_t kFmaDqSmemBytes =
    sizeof(float) * (4 * kFmaBlock * kFmaStride + kFmaBlock * kFmaPStride);

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

__global__ void __launch_bounds__(kFmaThreads)
    flash_bwd_dq_fma_kernel(Args a) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kFmaBlock * kFmaStride;
  float* ks = dos + kFmaBlock * kFmaStride;
  float* vs = ks + kFmaBlock * kFmaStride;
  float* dss = vs + kFmaBlock * kFmaStride;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // query rows ty*2, ty*2+1 of the tile
  const int tx = tid & 7;   // key columns tx + 8j; head-dim columns tx + 8j
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kFmaBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* lse = a.lse + bht_row(b, h, a.seq_len);
  const float* di = a.di + bht_row(b, h, a.seq_len);

  load_tile_f32(qs, q, a.sq.t, m0);
  load_tile_f32(dos, dout, a.sdo.t, m0);
  float lse2[2], dir[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse[m0 + ty * 2 + i] * kLog2e;
    dir[i] = di[m0 + ty * 2 + i];
  }

  float acc[2][kHeadDim / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) acc[i][j] = 0.f;

  const int kv_end = a.causal ? m0 + kFmaBlock : a.seq_len;
  for (int n0 = 0; n0 < kv_end; n0 += kFmaBlock) {
    __syncthreads();  // the previous key tile is consumed
    load_tile_f32(ks, k, a.sk.t, n0);
    load_tile_f32(vs, v, a.sv.t, n0);
    __syncthreads();

    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float qv[2], dov[2], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qv[i] = qs[(ty * 2 + i) * kFmaStride + d];
        dov[i] = dos[(ty * 2 + i) * kFmaStride + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = ks[(tx + 8 * j) * kFmaStride + d];
        vv[j] = vs[(tx + 8 * j) * kFmaStride + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

    const bool diag = a.causal && n0 + kFmaBlock > m0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = tx + 8 * j;
        float p = exp2f(s[i][j] * a.scale_log2 - lse2[i]);
        if (diag && n0 + kc > m0 + qr) p = 0.f;
        dss[qr * kFmaPStride + kc] = p * (dp[i][j] - dir[i]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's 64 keys
#pragma unroll 4
    for (int n = 0; n < kFmaBlock; ++n) {
      float dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsv[i] = dss[(ty * 2 + i) * kFmaPStride + n];
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        const float kv = ks[n * kFmaStride + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

  float* dq = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = m0 + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j)
      dq[row * a.sdq.t + tx + 8 * j] = acc[i][j] * a.sm_scale;
  }
}

// ---------------------------------------------------------- bf16 (mma.sync)

constexpr int kMmaThreads = 128;
constexpr int kMmaStride = kHeadDim + 8;  // 272-byte rows: 16-B aligned and
                                          // conflict-free fragment reads
constexpr int kDkvKeys = 64;     // keys per dK/dV block, 16 per warp
constexpr int kDkvQueries = 32;  // queries per tile of its loop
constexpr int kDqQueries = 64;   // queries per dQ block, 16 per warp
constexpr int kDqKeys = 64;      // keys per tile of its loop
constexpr size_t kMmaDkvSmemBytes =
    sizeof(__nv_bfloat16) * (2 * kDkvKeys + 2 * kDkvQueries) * kMmaStride +
    sizeof(float) * 2 * kDkvQueries;
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

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
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
    flash_bwd_dkv_mma_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kDkvKeys * kMmaStride;
  __nv_bfloat16* qs = vs + kDkvKeys * kMmaStride;
  __nv_bfloat16* dos = qs + kDkvQueries * kMmaStride;
  float* lse_s = reinterpret_cast<float*>(dos + kDkvQueries * kMmaStride);
  float* di_s = lse_s + kDkvQueries;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and column of B) within a tile
  const int t4 = lane & 3;  // fragment column pair
  const int n0 = blockIdx.x * kDkvKeys;
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

  load_tile_bf16(ks, k, a.sk.t, n0, kDkvKeys);
  load_tile_bf16(vs, v, a.sv.t, n0, kDkvKeys);

  const int kr0 = warp * 16;  // this warp's keys; the lane's are kr0 + g, +8
  float dk_acc[kHeadDim / 8][4], dv_acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  for (int m0 = a.causal ? n0 : 0; m0 < a.seq_len; m0 += kDkvQueries) {
    __syncthreads();  // the previous query tile is consumed
    load_tile_bf16(qs, q, a.sq.t, m0, kDkvQueries);
    load_tile_bf16(dos, dout, a.sdo.t, m0, kDkvQueries);
    if (tid < kDkvQueries) {
      lse_s[tid] = lse[m0 + tid] * kLog2e;
      di_s[tid] = di[m0 + tid];
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 4 tiles of 16 keys x 8 queries each
    float st[kDkvQueries / 8][4], dpt[kDkvQueries / 8][4];
#pragma unroll
    for (int nt = 0; nt < kDkvQueries / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, ks, kr0, kk * 16, g, t4);
      load_a_frag(va, vs, kr0, kk * 16, g, t4);
#pragma unroll
      for (int nt = 0; nt < kDkvQueries / 8; ++nt) {
        const __nv_bfloat16* pq = &qs[(nt * 8 + g) * kMmaStride + kk * 16 + t4 * 2];
        mma_16816(st[nt], ka, ld32(pq), ld32(pq + 8));
        const __nv_bfloat16* pd = &dos[(nt * 8 + g) * kMmaStride + kk * 16 + t4 * 2];
        mma_16816(dpt[nt], va, ld32(pd), ld32(pd + 8));
      }
    }

    // P^T, and dS^T = P^T * (dP^T - di); st[nt][e] lies on key kr0 + g +
    // (e >> 1) * 8 and query nt * 8 + t4 * 2 + (e & 1) of the tiles
    const bool diag = a.causal && m0 < n0 + kDkvKeys;
#pragma unroll
    for (int nt = 0; nt < kDkvQueries / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kr0 + g + (e >> 1) * 8;
        const int col = nt * 8 + t4 * 2 + (e & 1);
        float p = exp2f(st[nt][e] * a.scale_log2 - lse_s[col]);
        if (diag && n0 + key > m0 + col) p = 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - di_s[col]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: the C fragments of two adjacent score
    // tiles are the A fragment of one 16-query step
#pragma unroll
    for (int j = 0; j < kDkvQueries / 16; ++j) {
      const uint32_t pa[4] = {pack_f32(st[2 * j][0], st[2 * j][1]),
                              pack_f32(st[2 * j][2], st[2 * j][3]),
                              pack_f32(st[2 * j + 1][0], st[2 * j + 1][1]),
                              pack_f32(st[2 * j + 1][2], st[2 * j + 1][3])};
      const uint32_t da[4] = {pack_f32(dpt[2 * j][0], dpt[2 * j][1]),
                              pack_f32(dpt[2 * j][2], dpt[2 * j][3]),
                              pack_f32(dpt[2 * j + 1][0], dpt[2 * j + 1][1]),
                              pack_f32(dpt[2 * j + 1][2], dpt[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        uint32_t b0, b1;
        load_b_frag_rows(b0, b1, dos, j * 16, dt * 8, g, t4);
        mma_16816(dv_acc[dt], pa, b0, b1);
        load_b_frag_rows(b0, b1, qs, j * 16, dt * 8, g, t4);
        mma_16816(dk_acc[dt], da, b0, b1);
      }
    }
  }

  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
  const long long row = n0 + kr0 + g;
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(dk + row * a.sdk.t + c) =
        __floats2bfloat162_rn(dk_acc[dt][0] * a.sm_scale,
                              dk_acc[dt][1] * a.sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(dk + (row + 8) * a.sdk.t + c) =
        __floats2bfloat162_rn(dk_acc[dt][2] * a.sm_scale,
                              dk_acc[dt][3] * a.sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(dv + row * a.sdv.t + c) =
        __floats2bfloat162_rn(dv_acc[dt][0], dv_acc[dt][1]);
    *reinterpret_cast<__nv_bfloat162*>(dv + (row + 8) * a.sdv.t + c) =
        __floats2bfloat162_rn(dv_acc[dt][2], dv_acc[dt][3]);
  }
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
// fp32, contiguous.  Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 on success).
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
  return launch(flash_bwd_dkv_mma_bf16_kernel,
                dim3(seq_len / kDkvKeys, heads, batch), kMmaThreads,
                kMmaDkvSmemBytes, a, stream);
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
  if (dtype == 0)
    return launch(flash_bwd_dq_fma_kernel, dim3(seq_len / kFmaBlock, heads, batch),
                  kFmaThreads, kFmaDqSmemBytes, a, stream);
  return launch(flash_bwd_dq_mma_bf16_kernel,
                dim3(seq_len / kDqQueries, heads, batch), kMmaThreads,
                kMmaDqSmemBytes, a, stream);
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
