// Flash-attention forward for Hopper (sm_90a), with a plain C entry point
// that bigdl_tpu_torch/kernels/flash_attention.py loads through ctypes.
//
// Replaces the TPU kernel `_flash_attention_impl`, the forward pallas_call of
// jax/experimental/pallas/ops/tpu/flash_attention.py that the JAX package
// reaches from bigdl_tpu/nn/attention.py MultiHeadAttention.apply with
// flash=True.  Same function: o = softmax(q k^T * sm_scale [causal]) v, with
// an online softmax so the (T, T) score matrix never reaches device memory.
//
// Layout.  q, k, v and o are (B, T, H, Dh) with the head dimension contiguous
// and any strides for B, T and H, so the module needs no transposes.  One block
// per (query tile, head, batch); a loop over key tiles inside the block takes
// the place of the TPU grid's sequential key axis.  K and V tiles stage through
// shared memory.  For causal attention the key loop stops at the diagonal
// tile, so tiles wholly above the diagonal are skipped, and the query tiles
// are scheduled heaviest first.
//
// Bound on an H100 SXM at B8/H8/T2048/Dh128, causal:
//   bf16: 4*B*H*T^2*Dh/2 = 68.7 GFLOP at 989 TFLOP/s (tensor cores) = 69 us;
//         q, k, v read once and o written once = 134 MB at 3.35 TB/s = 40 us.
//         Bound by operations.
//   fp32: the same 68.7 GFLOP at 67 TFLOP/s (fp32 outside the tensor cores)
//         = 1.03 ms; 268 MB at 3.35 TB/s = 80 us.  Bound by operations.
//
// Two kernels, both simple first (no TMA, no wgmma, no warp specialisation):
//   * bf16: mma.sync m16n8k16 with fp32 accumulation.  Each of the 4 warps
//     owns 16 query rows; S = Q K^T stays in registers, and the probabilities
//     are re-packed in registers as the A operand of P V.
//   * fp32: plain FMA in full fp32 (TF32 would not hold the fp32 tolerance).
//     Each thread owns 4 query rows x 8 key columns of S and 4 rows x 16
//     columns of O; P goes through shared memory.
// Both accumulate in fp32 and write o in the input's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 128;

struct Strides {
  long long b, t, h;  // in elements; the head dimension has stride 1
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int seq_len;
  float scale_log2;  // sm_scale * log2(e): the softmax runs on exp2
  int causal;
};

// ---------------------------------------------------------------- fp32 (FMA)

constexpr int kFmaQKStride = kHeadDim + 1;  // conflict-free column reads
constexpr int kFmaPStride = kBlockN + 1;
constexpr size_t kFmaSmemBytes =
    sizeof(float) * (kBlockM * kFmaQKStride + kBlockN * kFmaQKStride +
                     kBlockN * kHeadDim + kBlockM * kFmaPStride);

__global__ void __launch_bounds__(kThreads) flash_fwd_fma_kernel(Args a) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * kFmaQKStride;
  float* vs = ks + kBlockN * kFmaQKStride;
  float* ps = vs + kBlockN * kHeadDim;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 7;   // S columns tx + 8j, O columns tx + 8j
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  float* o = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h;

  for (int e = tid; e < kBlockM * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    qs[r * kFmaQKStride + c] = q[(long long)(m0 + r) * a.sq.t + c];
  }

  float acc[4][kHeadDim / 8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = a.causal ? m0 + kBlockM : a.seq_len;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed before it is overwritten
    for (int e = tid; e < kBlockN * kHeadDim; e += kThreads) {
      const int r = e / kHeadDim, c = e % kHeadDim;
      ks[r * kFmaQKStride + c] = k[(long long)(n0 + r) * a.sk.t + c];
      vs[r * kHeadDim + c] = v[(long long)(n0 + r) * a.sv.t + c];
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * kFmaQKStride + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[(tx + 8 * j) * kFmaQKStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    const bool diag = a.causal && n0 + kBlockN > m0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[i][j] * a.scale_log2;
        if (diag && n0 + tx + 8 * j > row) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 lanes that share a row are adjacent: tx = lane & 7
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // every row sees key 0 in its first tile, so m_new is finite
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = exp2f(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        ps[(ty * 4 + i) * kFmaPStride + tx + 8 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + sum;  // this lane's share of the row sum
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float pv[4], vv[kHeadDim / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kFmaPStride + n];
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) vv[j] = vs[n * kHeadDim + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kHeadDim / 8; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const float inv = 1.f / l;
    float* orow = o + (long long)(m0 + ty * 4 + i) * a.so.t;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) orow[tx + 8 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------- bf16 (mma.sync)

constexpr int kMmaStride = kHeadDim + 8;  // 272-byte rows: 16-B aligned and
                                          // conflict-free fragment reads
constexpr size_t kMmaSmemBytes =
    sizeof(__nv_bfloat16) * (kBlockM + 2 * kBlockN) * kMmaStride;

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

__global__ void __launch_bounds__(kThreads) flash_fwd_mma_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * kMmaStride;
  __nv_bfloat16* vs = ks + kBlockN * kMmaStride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;   // fragment row (and column of B) within a tile
  const int t4 = lane & 3;   // fragment column pair
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.sv.b + h * a.sv.h;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.so.b + h * a.so.h;

  constexpr int kChunks = kHeadDim / 8;  // 16-byte chunks per row
  for (int e = tid; e < kBlockM * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    *reinterpret_cast<uint4*>(&qs[r * kMmaStride + c]) =
        *reinterpret_cast<const uint4*>(&q[(long long)(m0 + r) * a.sq.t + c]);
  }
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide slice of Dh
  const int r0 = warp * 16 + g;  // the lane's rows are r0 and r0 + 8
  uint32_t qf[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const __nv_bfloat16* p = &qs[r0 * kMmaStride + kk * 16 + t4 * 2];
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * kMmaStride);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * kMmaStride + 8);
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int kv_end = a.causal ? m0 + kBlockM : a.seq_len;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();
    for (int e = tid; e < kBlockN * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      *reinterpret_cast<uint4*>(&ks[r * kMmaStride + c]) =
          *reinterpret_cast<const uint4*>(&k[(long long)(n0 + r) * a.sk.t + c]);
      *reinterpret_cast<uint4*>(&vs[r * kMmaStride + c]) =
          *reinterpret_cast<const uint4*>(&v[(long long)(n0 + r) * a.sv.t + c]);
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 16 rows x 8 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const __nv_bfloat16* p = &ks[(nt * 8 + g) * kMmaStride + kk * 16 + t4 * 2];
        mma_16816(s[nt], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    // online softmax; s[nt][0..1] lie on row r0, s[nt][2..3] on row r0 + 8
    const bool diag = a.causal && n0 + kBlockN > m0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale_log2;
        if (diag && n0 + nt * 8 + t4 * 2 + (e & 1) > m0 + r0 + (e >> 1) * 8)
          x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes that share a row are adjacent: t4 = lane & 3
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_new[e >> 1]);
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

    // O += P V: the C fragments of two adjacent S tiles are the A fragment
    // of one 16-key step
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      const uint32_t pa[4] = {pack_f32(s[2 * j][0], s[2 * j][1]),
                              pack_f32(s[2 * j][2], s[2 * j][3]),
                              pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        const __nv_bfloat16* p = &vs[(j * 16 + t4 * 2) * kMmaStride + dt * 8 + g];
        const uint32_t b0 = pack_bf16(p[0], p[kMmaStride]);
        const uint32_t b1 = pack_bf16(p[8 * kMmaStride], p[9 * kMmaStride]);
        mma_16816(acc[dt], pa, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
  __nv_bfloat16* o0 = o + (long long)(m0 + r0) * a.so.t;
  __nv_bfloat16* o1 = o0 + 8 * a.so.t;
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
        __floats2bfloat162_rn(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
        __floats2bfloat162_rn(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 host values, (b, t, h) in
// elements for q, k, v and o in that order.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() after the launch (0 on success).
int bigdl_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, const long long* strides, int batch,
                              int seq_len, int heads, int head_dim, int dtype,
                              float sm_scale, int causal, void* stream) {
  if (head_dim != kHeadDim || seq_len <= 0 || seq_len % kBlockM != 0 ||
      batch <= 0 || heads <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  Strides* dst[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) {
    dst[i]->b = strides[3 * i];
    dst[i]->t = strides[3 * i + 1];
    dst[i]->h = strides[3 * i + 2];
  }
  a.seq_len = seq_len;
  a.scale_log2 = sm_scale * 1.4426950408889634f;
  a.causal = causal;
  const dim3 grid(seq_len / kBlockM, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(flash_fwd_fma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kFmaSmemBytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_fma_kernel<<<grid, kThreads, kFmaSmemBytes, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_mma_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMmaSmemBytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma_bf16_kernel<<<grid, kThreads, kMmaSmemBytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
