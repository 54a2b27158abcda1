// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// TMA tensor maps and loads, mbarriers, and warpgroup matrix multiplies
// (wgmma) on bf16 tiles in the 128-byte swizzled layout TMA writes.
//
// Tiles. A 64-row tile of a [B, S, N, H] bf16 tensor comes into shared
// memory as H/64 boxes of [64 rows][64 columns], 8 KB each, one after the
// other. With CU_TENSOR_MAP_SWIZZLE_128B a row is 128 bytes and every
// eight rows form a 1024-byte swizzle atom, so each box starts on a
// 1024-byte boundary. The same tile serves wgmma two ways:
// - K-major (the contraction runs along H, as in Q K^T): a k-step of 16
//   columns moves the descriptor 32 bytes inside a box, and after four
//   steps on to the next box; SBO is the 1024-byte atom.
// - MN-major (the contraction runs along the tile's rows, as in dS K):
//   a k-step of 16 rows moves it 2048 bytes; SBO is again the 1024-byte
//   step between groups of eight rows, and LBO the 8 KB step from one box
//   of 64 columns to the next. wgmma reads this transposed layout only
//   for 16-bit types, with the trans-b bit.
//
// Everything here is header-only; a kernel source includes it, and the
// loader hashes every csrc/*.cuh into each library's key.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBoxCols = 64;                    // bf16 columns per 128-byte row
constexpr int kBoxRows = 64;                    // rows per box
constexpr int kBoxBytes = kBoxRows * 128;       // 8 KB
constexpr int kAtomBytes = 8 * 128;             // swizzle atom: 8 rows of 128 bytes

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled is a driver-API function. It is reached through
// the runtime's entry-point query, so the library links no -lcuda; the
// signature is CUDA 12.0's, which later releases keep.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map over a [B, S, N, H] bf16 tensor with element strides (sb,
// ss, sn) and a contiguous head axis, read in boxes of 64 rows by 64
// columns of one (b, n) head, 128-byte swizzled. Rows past S and columns
// past H (the true head dim, which may be less than the kernel's tile
// width) read as zeros. TMA needs a 16-byte aligned base and strides that
// are multiples of 16 bytes; the caller checks both. Returns false if the
// map is refused.
inline bool bshd_tensor_map(CUtensorMap* map, const void* base, int b, int s, int n, int h,
                            long long sb, long long ss, long long sn) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBoxRows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map over `len` contiguous fp32 values, read 64 at a time from any
// start; values past `len` read as zeros.
inline bool row_tensor_map(CUtensorMap* map, const float* base, long long len) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(len)};
  const cuuint64_t strides[1] = {0};  // unused at rank 1
  const cuuint32_t box[1] = {64};
  const cuuint32_t elem_strides[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (c0, c1, c2, c3) of a 4-D tensor map into shared memory; completion
// is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// The 64-row tile [64][D] at shared address `tile` (D/64 boxes), rows
// [row0, row0 + 64) of head (b, n), onto `bar`.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* tile, const CUtensorMap* map,
                                              uint64_t* bar, int b, int n, int row0) {
#pragma unroll
  for (int box = 0; box < D / kBoxCols; ++box)
    tma_load_4d(tile + box * kBoxBytes, map, bar, box * kBoxCols, n, row0, b);
}

// Two 64-row tiles [64][D] (K and V, or Q and dO) of the same rows, the
// second `tile_bytes` after the first, onto one barrier that expects both.
template <int D>
__device__ __forceinline__ void tma_load_tile_pair(uint8_t* tiles, const CUtensorMap* map_a,
                                                   const CUtensorMap* map_b, uint64_t* bar, int b,
                                                   int n, int row0) {
  constexpr int tile_bytes = kBoxRows * D * 2;
  mbar_arrive_expect_tx(bar, 2 * tile_bytes);
  tma_load_tile<D>(tiles, map_a, bar, b, n, row0);
  tma_load_tile<D>(tiles + tile_bytes, map_b, bar, b, n, row0);
}

// The first 1024-byte boundary at or after p (swizzled TMA boxes start on
// one).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// k-step `kk` (16 columns) of a tile read K-major.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, kAtomBytes);
}

// k-step `kk` (16 rows) of a tile read MN-major.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, kBoxBytes, kAtomBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so that the
// compiler moves no use of them across a wgmma_fence, commit or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two fp32 values as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x D] += A B for k-step kk of a 64-deep product: A the bf16
// fragments of a 64 x 64 accumulator (four per k-step), B a [64][D] tile
// read MN-major.
template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2], const uint32_t (&a)[16], int kk,
                                            uint64_t desc_b);

// Accumulator layout of wgmma m64nN (fp32): thread t of the warpgroup
// holds d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and
// column 8j + 2 (t % 4) + e % 2. Columns [16 kk, 16 kk + 16) of such an
// accumulator are, rounded to bf16, exactly the register A fragment of
// k-step kk for the next product: no shuffle, no shared memory.
template <int R>
__device__ __forceinline__ void to_a_fragments(const float (&d)[R], uint32_t (&a)[R / 2]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) a[i] = pack_bf16x2(d[2 * i], d[2 * i + 1]);
}

// Row (within the 64-row tile) and column (within a 64-column score tile)
// of accumulator element i of this thread, by the layout above.
__device__ __forceinline__ int acc_row(int i, int warp, int lane) {
  return warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

// Rows [row0, row0 + 64) of one head from an m64nD accumulator, as bf16:
// rows at or past `len` and columns at or past `h` (the true head dim, a
// multiple of 8) are not written.
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, long long row_stride, int row0,
                                           int len, int h, int warp, int lane,
                                           const float (&acc)[D / 2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * half;
    if (row >= len) continue;
    __nv_bfloat16* out = dst + row * row_stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < h)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory,
// both K-major (trans-a = trans-b = 0).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the m64k16
// fragment), B from shared memory MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], uint32_t a0, uint32_t a1,
                                                     uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (the m64k16
// fragment), B from shared memory MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], uint32_t a0, uint32_t a1,
                                                      uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[16], int kk,
                                                uint64_t desc_b) {
  wgmma_m64n64k16_rs_tb(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc_b, 1);
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64], const uint32_t (&a)[16], int kk,
                                                 uint64_t desc_b) {
  wgmma_m64n128k16_rs_tb(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc_b, 1);
}

// D[64 x 256]: two m64n128 products, one per half of the accumulator and
// of the B tile (boxes 0-1 and 2-3). The halves side by side are the
// m64n256 accumulator layout above, so store_tile<256> reads them as one.
template <>
__device__ __forceinline__ void wgmma_rs_tb<256>(float (&d)[128], const uint32_t (&a)[16], int kk,
                                                 uint64_t desc_b) {
  float(&lo)[64] = *reinterpret_cast<float(*)[64]>(&d[0]);
  float(&hi)[64] = *reinterpret_cast<float(*)[64]>(&d[64]);
  wgmma_m64n128k16_rs_tb(lo, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc_b, 1);
  wgmma_m64n128k16_rs_tb(hi, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                         desc_b + ((2 * kBoxBytes) >> 4), 1);
}

}  // namespace hopper
