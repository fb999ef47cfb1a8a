// Device helpers for Hopper (sm_90a) shared by the flash-attention sources:
// the 3xTF32 split and mma.sync, cp.async, mbarriers, TMA, wgmma, and the
// host-side encoding of TMA tensor maps.  Included by flash_attention_fwd.cu
// and flash_attention_bwd.cu; kernels/build.py hashes every *.cuh here into
// each library's name, so an edit to this file rebuilds both.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time (encode_tiled), no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

struct Strides {
  long long b, t, h;  // in elements; the head dimension has stride 1
};

// The work of one block of a 1-D grid over n_tiles tiles of each (head,
// batch): its tile counted from the heaviest under causal attention, its
// head and batch.  Blocks take the (head, batch) pairs in groups of
// kHeadGroup and, within a group, the tiles heaviest first: so few long
// tiles are left to the end of the grid (heaviest first within each head
// alone started the last heads' longest tiles last), and the blocks in
// flight read the operands of about one group (8 MB in bf16 at T 2048),
// which L2 holds.
constexpr int kHeadGroup = 8;

struct Work {
  int tile, h, b;
};

__device__ __forceinline__ Work block_work(int n_tiles, int heads,
                                           int batch) {
  const int pairs = heads * batch;
  const int group = blockIdx.x / (kHeadGroup * n_tiles);
  const int size = min(kHeadGroup, pairs - group * kHeadGroup);
  const int p = blockIdx.x - group * kHeadGroup * n_tiles;
  const int hb = group * kHeadGroup + p % size;
  Work w;
  w.tile = p / size;
  w.h = hb % heads;
  w.b = hb / heads;
  return w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------- 3xTF32 on mma.sync

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

// ------------------------------------------------------------- cp.async

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
}

// rows [r_begin, r_end) of a (T, kCols) fp32 operand into shared memory rows
// of `stride` floats, in kBytes pieces (16 when every row start is 16-byte
// aligned, else 4), by kThreads threads.  With kSwizzle, local row r's
// columns land XOR-ed with 8 when r & 4 is set (see the dQ kernel).
template <int kBytes, int kThreads, int kCols, bool kSwizzle = false>
__device__ __forceinline__ void copy_rows(float* dst, int stride,
                                          const float* src, long long st,
                                          int r_begin, int r_end) {
  constexpr int kPer = kBytes / 4;
  constexpr int kRowPieces = kCols / kPer;
  const int pieces = (r_end - r_begin) * kRowPieces;
  for (int e = threadIdx.x; e < pieces; e += kThreads) {
    const int r = e / kRowPieces, c = (e % kRowPieces) * kPer;
    const int cs = kSwizzle ? c ^ ((r & 4) << 1) : c;
    cp_async<kBytes>(&dst[r * stride + cs], src + (r_begin + r) * st + c);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ------------------------------------------------- mbarriers and TMA

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

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ wgmma

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

// d (+)= a b for one m64n64k16 step, as wgmma_ss with 64 columns
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
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
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// ------------------------------------------------------------------ host

// whether every row start of an fp32 (B, T, H, Dh) operand is 16-byte
// aligned, so cp.async may move it in 16-byte pieces
inline bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 &&
         st.t % 4 == 0 && st.h % 4 == 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// A 4-D map over one bf16 (B, T, H, Dh=128) operand, innermost first:
// (Dh, T, H, B) with its byte strides; boxes of 64 columns x box_rows rows
// with the 128B swizzle; rows beyond T read as zeros.
inline bool encode_map(CUtensorMap* map, const void* ptr, const Strides& st,
                       int batch, int seq_len, int heads, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)128, (cuuint64_t)seq_len,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.t * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
