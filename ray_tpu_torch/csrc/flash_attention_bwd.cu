// Flash attention backward for Hopper (sm_90a), written by hand: two
// kernels, dQ and dK/dV, each in two variants by input dtype.
//
// Replaces ray_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (dQ) and
// ::_flash_bwd_dkv_kernel (dK/dV), the Pallas TPU kernels behind
// _flash_bwd. Both variants of each compute the same functions from the
// forward's residuals (q, k, v, O and LSE, the natural log of the sum of
// exp of the scaled logits) and D = rowsum(dO * O), which the caller
// takes outside the kernels, as the TPU code does:
//   P  = exp(q k^T * scale - LSE)            (masked entries are 0)
//   dP = dO V^T,  dS = P * (dP - D) * scale
//   dQ = dS K,    dK = dS^T Q,   dV = P^T dO
// The mask is k_pos < sk and q_pos < sq and, when causal, q_pos >= k_pos
// with both positions counted from 0 (top left).
//
// - fp32 inputs: CUDA-core FMA kernels (flash_bwd_dq_kernel,
//   flash_bwd_dkv_kernel). Every product in fp32, as on the TPU; the only
//   way to meet the JAX package's 2e-4 gradient bound. Their design note
//   is beside their code.
// - bf16 inputs: wgmma kernels fed by TMA (flash_bwd_dq_wgmma,
//   flash_bwd_dkv_wgmma). Precision contract:
//   * S = Q K^T and dP = dO V^T: bf16 operands, fp32 accumulation. The
//     inputs are exact bf16 values, so this equals the fp32 product up to
//     summation order.
//   * P and dS: fp32, in registers: P = exp(S * scale - LSE), masked;
//     dS = P * (dP - D) * scale.
//   * dV += P^T dO, dK += dS^T Q, dQ += dS K: P and dS are rounded to
//     bf16 as the A operand, with fp32 accumulation. This is the one place
//     where the bf16 variant departs from the TPU kernel's fp32
//     arithmetic; PyTorch's own flash backward rounds there too, and the
//     dense bf16 attention path of models/transformer.py rounds P at the
//     same point. ops/flash_attention.py::flash_attention_bwd_plain rounds
//     the same way for bf16 inputs.
//   * dQ, dK and dV are written as bf16.
//
// The split is the TPU's: dQ runs one CTA per (64-row query tile, b*n)
// and loops over the KV tiles up to the diagonal; dK/dV runs one CTA per
// (64-key tile, b*n) and loops over the query tiles from the diagonal on.
// Each CTA owns the rows it writes, so no atomics are needed and the
// gradients are the same from run to run. The price is that S and dP are
// taken in both kernels: 7 products where a fused kernel with atomic dQ
// takes 5.
//
// What bounds them on this card. At the flagship shape (B4, S2048, N16,
// H128, bf16, causal) dQ takes three products over the causal pairs,
// 103.1 GFLOP, and dK/dV four, 137.4 GFLOP: 104 us and 139 us at the bf16
// tensor-core rate (989 TFLOP/s), above the 50 us and 60 us that moving
// their bytes once takes at 3.35 TB/s. Both are bound by operations, and
// only wgmma reaches the tensor cores' rate; the CUDA cores' 67 TFLOP/s
// would hold them above 1.54 ms and 2.05 ms.
//
// What the bf16 design does about that:
// - All four kinds of product are wgmma.mma_async m64nNk16 with fp32
//   accumulators. S and dP (and S^T, dP^T) read both operands from
//   shared memory, K-major over H. dQ += dS K, dK += dS^T Q and
//   dV += P^T dO take P or dS from registers: the m64n64 accumulator,
//   rounded to bf16 pairs, is the register A fragment of the next
//   product, so P and dS never touch shared memory. Their B operand is
//   the same bf16 tile read MN-major (the trans-b bit), so no transposed
//   second copy of any tile exists.
// - Operand tiles arrive by TMA, in the 128-byte swizzled layout wgmma
//   reads, from a 4-D tensor map over [H, N, S, B] with the tensor's own
//   strides; one thread issues a tile, the rest spend nothing on it.
//   Rows past S arrive as zeros and are masked by position (exp(0 - LSE)
//   is not 0). At H=128 a 256-byte row is two 128-byte boxes, and the
//   K-major walk steps from the first to the second after four k-steps.
// - Streamed tiles (K and V for dQ; Q, dO, LSE and D for dK/dV) go
//   through a ring of two stages, each guarded by an mbarrier that counts
//   the TMA bytes; the next tile but one is requested as soon as a stage
//   is read, so its load overlaps a whole step of products.
// - A CTA is one warpgroup of 128 threads that loads, multiplies and
//   computes P and dS. With 96 KB (dQ) or 97 KB (dK/dV) of shared memory
//   at H=128, two CTAs fit on an SM and each thread may hold 255
//   registers: dK/dV keeps dK and dV (64 + 64 fp32), S^T and dP^T
//   (32 + 32) and their bf16 fragments in registers. While one CTA
//   computes P and dS, the other's products run.
// - Within a step, dP's products are issued before P is computed from S,
//   so the exponentials overlap them. Tiles wholly inside the mask take
//   no mask arithmetic; tiles past the diagonal are never loaded; the
//   CTAs with the most causal work are launched first.
//
// Layout: q, o, dO, dQ [B, Sq, N, H] and k, v, dK, dV [B, Sk, N, H], read
// and written by element strides (the last axis contiguous), so the
// caller makes no transposed or padded copy; for bf16 the base must be
// 16-byte aligned and the strides multiples of 8 elements (TMA). LSE and
// D are unpadded fp32 [B*N, Sq]. Each entry point launches on the given
// stream, allocates nothing and returns a CUDA error code: 0, the
// launch's error, or cudaErrorInvalidValue for what it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

struct Strides {
  long long b, s, n;
};

// ---------------------------------------------------------------------------
// fp32 inputs: CUDA-core FMA (flash_bwd_dq_kernel, flash_bwd_dkv_kernel).
//
// Every operand tile sits in shared memory as fp32 in its natural [row][H]
// layout (one copy serves both the products that contract over H and
// those that contract over the tile's rows); each thread keeps a 4x4 tile
// of scores and 4x(H/16) tiles of its outputs in registers, so that eight
// 16-byte shared-memory reads feed 64 FMAs in the products over H, and
// 1 + H/64 of them feed 16 H/64 FMAs in the products over the tile's rows;
// score columns are interleaved across threads (column tx + 16j) and rows
// are padded by 4 floats, so the 16-byte reads of one quarter-warp fall on
// 32 distinct banks; tiles past the diagonal are never loaded; and the
// CTAs with the most causal work are launched first. The kernels are
// templates on the element type, instantiated for float only.

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads, 4 x 4 scores each
constexpr int LDT = 64 + 4;    // row stride of the score tiles in shared memory

static_assert(BQ == 64 && BK == 64, "the 4x4 thread tile over 16x16 threads assumes 64x64 tiles");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }

// Row stride of an operand tile [64][D]: D + 4 floats keeps float4
// alignment and puts rows r and r+1 four banks apart.
template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }

// rows x D tile of rows [row0, row0 + rows) of one head into shared memory
// as fp32, zero past `len`.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long row_stride,
                                           int row0, int len) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[r * ld<D>() + d] = row < len ? load_f32(src + row * row_stride + d) : 0.f;
  }
}

// acc[i][j] += sum_d A[i][d] * B[j][d], where A's rows are a + i * LD
// (this thread's four rows) and B's are b + 16 * j * LD (its four
// interleaved columns).
template <int D>
__device__ __forceinline__ void dot_rows(const float* a, const float* b, float acc[4][4]) {
  constexpr int LD = ld<D>();
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][g*4 + e] += sum_r W[r][i] * X[r][g*64 + e] over the 64 rows r of
// a tile: W is a score tile [64][LDT] read at this thread's four rows, X
// an operand tile [64][D] read at this thread's output columns.
template <int D>
__device__ __forceinline__ void accumulate(const float* w, const float* x, float acc[4][D / 16]) {
  constexpr int LD = ld<D>();
  constexpr int G = D / 64;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 wv = *reinterpret_cast<const float4*>(w + r * LDT);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 xv = *reinterpret_cast<const float4*>(x + r * LD + g * 64);
      const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g * 4 + e] = fmaf(wr[i], xc[e], acc[i][g * 4 + e]);
    }
  }
}

// Rows ty*4 + i of a [64][D] output tile from a thread's registers.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long row_stride, int row0, int len,
                                           int ty, int tx, float acc[4][D / 16]) {
  constexpr int G = D / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= len) continue;
    T* out = dst + row * row_stride;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) store_from_f32(out + g * 64 + tx * 4 + e, acc[i][g * 4 + e]);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sDO, sK, sV [64][D+4]; sDS [BK][LDT], dS transposed (key, query row)
  return sizeof(float) * (4 * 64 * ld<D>() + BK * LDT);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV, sQ, sDO [64][D+4]; sP, sDS [BQ][LDT] (query row, key);
  // LSE and D of the query tile
  return sizeof(float) * (4 * 64 * ld<D>() + 2 * BQ * LDT + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int n_heads, int sq, int sk, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dqs,
                    float sm_scale, int causal) {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  constexpr int LD = ld<D>();

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* sDO = sQ + BQ * LD;                    // [BQ][LD]
  float* sK = sDO + BQ * LD;                    // [BK][LD]
  float* sV = sK + BK * LD;                     // [BK][LD]
  float* sDS = sV + BK * LD;                    // [BK][LDT]

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // query rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // keys tx + 16j; output columns g*64 + tx*4 ..
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int q0 = qt * BQ;

  const T* kb = k + b * ks.b + n * ks.n;
  const T* vb = v + b * vs.b + n * vs.n;
  stage_rows<T, D>(sQ, q + b * qs.b + n * qs.n, qs.s, q0, sq);
  stage_rows<T, D>(sDO, dout + b * dos.b + n * dos.n, dos.s, q0, sq);

  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + ty * 4 + i;
    const long long at = static_cast<long long>(bn) * sq + q_pos;
    row_lse[i] = q_pos < sq ? lse[at] : 0.f;
    row_delta[i] = q_pos < sq ? delta[at] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int n_kv = (sk + BK - 1) / BK;
  const int n_iter = causal ? min(n_kv, (q0 + BQ + BK - 1) / BK) : n_kv;

  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's sK, sV and sDS are no longer read
    stage_rows<T, D>(sK, kb, ks.s, k0, sk);
    stage_rows<T, D>(sV, vb, vs.s, k0, sk);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    dot_rows<D>(sQ + ty * 4 * LD, sK + tx * LD, s);
    dot_rows<D>(sDO + ty * 4 * LD, sV + tx * LD, dp);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k_pos = k0 + tx + 16 * jj;
        const bool ok = q_pos < sq && k_pos < sk && (!causal || q_pos >= k_pos);
        const float p = ok ? expf(s[i][jj] * sm_scale - row_lse[i]) : 0.f;
        dp[i][jj] = p * (dp[i][jj] - row_delta[i]) * sm_scale;  // dS
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(sDS + (tx + 16 * jj) * LDT + ty * 4) =
          make_float4(dp[0][jj], dp[1][jj], dp[2][jj], dp[3][jj]);
    __syncthreads();

    accumulate<D>(sDS + ty * 4, sK + tx * 4, acc);  // dQ += dS K
  }

  store_rows<T, D>(dq + b * dqs.b + n * dqs.n, dqs.s, q0, sq, ty, tx, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int n_heads, int sq,
                     int sk, Strides qs, Strides ks, Strides vs, Strides dos,
                     Strides dks, Strides dvs, float sm_scale, int causal) {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  constexpr int LD = ld<D>();

  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* sV = sK + BK * LD;                     // [BK][LD]
  float* sQ = sV + BK * LD;                     // [BQ][LD]
  float* sDO = sQ + BQ * LD;                    // [BQ][LD]
  float* sP = sDO + BQ * LD;                    // [BQ][LDT]
  float* sDS = sP + BQ * LDT;                   // [BQ][LDT]
  float* sLSE = sDS + BQ * LDT;                 // [BQ]
  float* sDelta = sLSE + BQ;                    // [BQ]

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // keys ty*4 .. ty*4+3
  const int tx = tid % 16;  // query rows tx + 16j; output columns g*64 + tx*4 ..
  const int kt = blockIdx.x;  // tile 0 has the most causal work: launched first
  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int k0 = kt * BK;

  const T* qb = q + b * qs.b + n * qs.n;
  const T* dob = dout + b * dos.b + n * dos.n;
  stage_rows<T, D>(sK, k + b * ks.b + n * ks.n, ks.s, k0, sk);
  stage_rows<T, D>(sV, v + b * vs.b + n * vs.n, vs.s, k0, sk);

  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_q = (sq + BQ - 1) / BQ;
  // the first query tile whose rows can attend to this key tile
  const int i0 = causal ? k0 / BQ : 0;

  for (int it = i0; it < n_q; ++it) {
    const int r0 = it * BQ;
    __syncthreads();  // the previous tile's sQ, sDO, sP and sDS are no longer read
    stage_rows<T, D>(sQ, qb, qs.s, r0, sq);
    stage_rows<T, D>(sDO, dob, dos.s, r0, sq);
    if (tid < BQ) {
      const int row = r0 + tid;
      const long long at = static_cast<long long>(bn) * sq + row;
      sLSE[tid] = row < sq ? lse[at] : 0.f;
      sDelta[tid] = row < sq ? delta[at] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are keys, columns query rows
    float st[4][4] = {}, dpt[4][4] = {};
    dot_rows<D>(sK + ty * 4 * LD, sQ + tx * LD, st);
    dot_rows<D>(sV + ty * 4 * LD, sDO + tx * LD, dpt);

#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int r = tx + 16 * jj;
      const int q_pos = r0 + r;
      const float row_lse = sLSE[r];
      const float row_delta = sDelta[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k_pos = k0 + ty * 4 + i;
        const bool ok = q_pos < sq && k_pos < sk && (!causal || q_pos >= k_pos);
        const float p = ok ? expf(st[i][jj] * sm_scale - row_lse) : 0.f;
        st[i][jj] = p;
        dpt[i][jj] = p * (dpt[i][jj] - row_delta) * sm_scale;  // dS^T
      }
      *reinterpret_cast<float4*>(sP + r * LDT + ty * 4) =
          make_float4(st[0][jj], st[1][jj], st[2][jj], st[3][jj]);
      *reinterpret_cast<float4*>(sDS + r * LDT + ty * 4) =
          make_float4(dpt[0][jj], dpt[1][jj], dpt[2][jj], dpt[3][jj]);
    }
    __syncthreads();

    accumulate<D>(sP + ty * 4, sDO + tx * 4, acc_v);   // dV += P^T dO
    accumulate<D>(sDS + ty * 4, sQ + tx * 4, acc_k);   // dK += dS^T Q
  }

  store_rows<T, D>(dk + b * dks.b + n * dks.n, dks.s, k0, sk, ty, tx, acc_k);
  store_rows<T, D>(dv + b * dvs.b + n * dvs.n, dvs.s, k0, sk, ty, tx, acc_v);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int batch,
              int n_heads, int sq, int sk, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, float sm_scale, int causal,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, batch * n_heads);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), n_heads, sq, sk, qs, ks, vs, dos, dqs, sm_scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int batch, int n_heads, int sq, int sk, Strides qs, Strides ks,
               Strides vs, Strides dos, Strides dks, Strides dvs,
               float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + BK - 1) / BK, batch * n_heads);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), n_heads, sq, sk, qs, ks, vs,
      dos, dks, dvs, sm_scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: wgmma fed by TMA (flash_bwd_dq_wgmma, flash_bwd_dkv_wgmma).

namespace wg {

using namespace hopper;

constexpr int THREADS = 128;  // one warpgroup: loads, products, P and dS
constexpr int TILE_ROWS = 64;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-byte aligned base. A tile is 64
// rows of D bf16 in D/64 swizzled boxes.
template <int D>
struct DqLayout {
  static constexpr int TILE = TILE_ROWS * D * 2;
  static constexpr int Q = 0, DO = TILE;
  static constexpr int KV = 2 * TILE;       // stage s: K at KV + 2 s TILE, V after it
  static constexpr int BARS = 6 * TILE;     // Q and dO, then one per stage
  static constexpr int BYTES = BARS + 3 * 8;
};

template <int D>
struct DkvLayout {
  static constexpr int TILE = TILE_ROWS * D * 2;
  static constexpr int K = 0, V = TILE;
  static constexpr int QDO = 2 * TILE;      // stage s: Q at QDO + 2 s TILE, dO after it
  static constexpr int STATS = 6 * TILE;    // stage s: LSE[64], D[64] at STATS + 512 s
  static constexpr int BARS = STATS + 2 * 512;  // K and V, then one per stage
  static constexpr int BYTES = BARS + 3 * 8;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Accumulator element i of this thread: row (within the 64-row tile) and
// column (within a 64-column score tile).
__device__ __forceinline__ int acc_row(int i, int warp, int lane) {
  return warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

// Rows [row0, row0 + 64) of one head from an m64nD accumulator, as bf16.
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, long long row_stride, int row0,
                                           int len, int warp, int lane, const float (&acc)[D / 2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * half;
    if (row >= len) continue;
    __nv_bfloat16* out = dst + row * row_stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

template <int D>
__device__ __forceinline__ void load_kv_stage(uint8_t* smem, uint64_t* bar, const CUtensorMap* tk,
                                              const CUtensorMap* tv, int b, int n, int row0) {
  using L = DqLayout<D>;
  mbar_arrive_expect_tx(bar, 2 * L::TILE);
  tma_load_tile<D>(smem, tk, bar, b, n, row0);
  tma_load_tile<D>(smem + L::TILE, tv, bar, b, n, row0);
}

template <int D>
__device__ __forceinline__ void load_q_stage(uint8_t* smem, uint8_t* stats, uint64_t* bar,
                                             const CUtensorMap* tq, const CUtensorMap* tdo,
                                             const CUtensorMap* tlse, const CUtensorMap* tdelta,
                                             int b, int n, int row0, int stat0) {
  using L = DkvLayout<D>;
  mbar_arrive_expect_tx(bar, 2 * L::TILE + 2 * TILE_ROWS * 4);
  tma_load_tile<D>(smem, tq, bar, b, n, row0);
  tma_load_tile<D>(smem + L::TILE, tdo, bar, b, n, row0);
  tma_load_1d(stats, tlse, bar, stat0);
  tma_load_1d(stats + TILE_ROWS * 4, tdelta, bar, stat0);
}

// dQ for one 64-row query tile of one head: S = Q K^T and dP = dO V^T
// (SS wgmma), dS in registers, dQ += dS K (RS wgmma, K read MN-major),
// over the KV tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int n_heads, int sq, int sk, Strides dqs,
                   float sm_scale, int causal) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* bar_qdo = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* bar_kv = bar_qdo + 1;  // one per stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bn = blockIdx.y;
  const int b = bn / n_heads, n = bn % n_heads;
  const int q0 = qt * TILE_ROWS;
  const int n_kv = (sk + TILE_ROWS - 1) / TILE_ROWS;
  const int n_iter = causal ? min(n_kv, qt + 1) : n_kv;

  if (tid == 0) {
    mbar_init(bar_qdo, 1);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 1, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar_qdo, 2 * L::TILE);
    tma_load_tile<D>(smem + L::Q, &tq, bar_qdo, b, n, q0);
    tma_load_tile<D>(smem + L::DO, &tdo, bar_qdo, b, n, q0);
    for (int j = 0; j < 2 && j < n_iter; ++j)
      load_kv_stage<D>(smem + L::KV + 2 * j * L::TILE, bar_kv + j, &tk, &tv, b, n, j * TILE_ROWS);
  }

  // LSE (in log2 units) and D of this thread's two rows.
  const float scale_log2 = sm_scale * LOG2E;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q_pos = q0 + acc_row(2 * h, warp, lane);
    const long long at = static_cast<long long>(bn) * sq + q_pos;
    row_lse[h] = q_pos < sq ? lse[at] * LOG2E : 0.f;
    row_delta[h] = q_pos < sq ? delta[at] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t s_q = smem_addr(smem + L::Q), s_do = smem_addr(smem + L::DO);
  mbar_wait(bar_qdo, 0);

  for (int j = 0; j < n_iter; ++j) {
    const int stage = j & 1;
    const int k0 = j * TILE_ROWS;
    const uint32_t s_k = smem_addr(smem + L::KV + 2 * stage * L::TILE);
    const uint32_t s_v = s_k + L::TILE;
    mbar_wait(bar_kv + stage, (j >> 1) & 1);

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc(s_q, kk), kmajor_desc(s_k, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(dp, kmajor_desc(s_do, kk), kmajor_desc(s_v, kk), kk);
    wgmma_commit();

    wgmma_wait<1>();  // S is in; dP's products still run
    fence_regs(s);
    const bool edge = (causal && k0 + TILE_ROWS - 1 > q0) || k0 + TILE_ROWS > sk ||
                      q0 + TILE_ROWS > sq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(fmaf(s[i], scale_log2, -row_lse[(i / 2) % 2]));
      if (edge) {
        const int q_pos = q0 + acc_row(i, warp, lane), k_pos = k0 + acc_col(i, lane);
        if (!(q_pos < sq && k_pos < sk && (!causal || q_pos >= k_pos))) p = 0.f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - row_delta[(i / 2) % 2]) * sm_scale;

    uint32_t ds[16];
    to_a_fragments(dp, ds);
    fence_regs(ds);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<D>(acc, ds, kk, mnmajor_desc(s_k, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // every warp has read this stage
    if (tid == 0 && j + 2 < n_iter)
      load_kv_stage<D>(smem + L::KV + 2 * stage * L::TILE, bar_kv + stage, &tk, &tv, b, n,
                       (j + 2) * TILE_ROWS);
  }

  store_tile<D>(dq + b * dqs.b + n * dqs.n, dqs.s, q0, sq, warp, lane, acc);
}

// dK and dV for one 64-key tile of one head, on transposed scores:
// S^T = K Q^T and dP^T = V dO^T (SS wgmma), P^T and dS^T in registers,
// dV += P^T dO and dK += dS^T Q (RS wgmma, dO and Q read MN-major), over
// the query tiles from the diagonal on.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tlse,
                    const __grid_constant__ CUtensorMap tdelta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int n_heads, int sq, int sk, Strides dks,
                    Strides dvs, float sm_scale, int causal) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  using L = DkvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* bar_q = bar_kv + 1;  // one per stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kt = blockIdx.x;  // tile 0 has the most causal work: launched first
  const int bn = blockIdx.y;
  const int b = bn / n_heads, n = bn % n_heads;
  const int k0 = kt * TILE_ROWS;
  const int n_q = (sq + TILE_ROWS - 1) / TILE_ROWS;
  // the first query tile whose rows can attend to this key tile
  const int i0 = causal ? min(kt, n_q) : 0;
  const int n_iter = n_q - i0;
  const int stat_base = bn * sq;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 1, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar_kv, 2 * L::TILE);
    tma_load_tile<D>(smem + L::K, &tk, bar_kv, b, n, k0);
    tma_load_tile<D>(smem + L::V, &tv, bar_kv, b, n, k0);
    for (int t = 0; t < 2 && t < n_iter; ++t)
      load_q_stage<D>(smem + L::QDO + 2 * t * L::TILE, smem + L::STATS + 512 * t, bar_q + t, &tq,
                      &tdo, &tlse, &tdelta, b, n, (i0 + t) * TILE_ROWS,
                      stat_base + (i0 + t) * TILE_ROWS);
  }

  const float scale_log2 = sm_scale * LOG2E;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  const uint32_t s_k = smem_addr(smem + L::K), s_v = smem_addr(smem + L::V);
  mbar_wait(bar_kv, 0);

  for (int t = 0; t < n_iter; ++t) {
    const int stage = t & 1;
    const int r0 = (i0 + t) * TILE_ROWS;
    const uint32_t s_qt = smem_addr(smem + L::QDO + 2 * stage * L::TILE);
    const uint32_t s_dot = s_qt + L::TILE;
    const float* st_lse = reinterpret_cast<const float*>(smem + L::STATS + 512 * stage);
    const float* st_delta = st_lse + TILE_ROWS;
    mbar_wait(bar_q + stage, (t >> 1) & 1);

    float s[32], dp[32];  // rows: keys; columns: query rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc(s_k, kk), kmajor_desc(s_qt, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(dp, kmajor_desc(s_v, kk), kmajor_desc(s_dot, kk), kk);
    wgmma_commit();

    wgmma_wait<1>();  // S^T is in; dP^T's products still run
    fence_regs(s);
    const bool edge = (causal && r0 < k0 + TILE_ROWS - 1) || r0 + TILE_ROWS > sq ||
                      k0 + TILE_ROWS > sk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = acc_col(i, lane);
      float p = exp2f(fmaf(s[i], scale_log2, -st_lse[col] * LOG2E));
      if (edge) {
        const int q_pos = r0 + col, k_pos = k0 + acc_row(i, warp, lane);
        if (!(q_pos < sq && k_pos < sk && (!causal || q_pos >= k_pos))) p = 0.f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - st_delta[acc_col(i, lane)]) * sm_scale;

    uint32_t pt[16], dst[16];
    to_a_fragments(s, pt);
    to_a_fragments(dp, dst);
    fence_regs(pt);
    fence_regs(dst);
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<D>(acc_v, pt, kk, mnmajor_desc(s_dot, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<D>(acc_k, dst, kk, mnmajor_desc(s_qt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);

    __syncthreads();  // every warp has read this stage
    if (tid == 0 && t + 2 < n_iter)
      load_q_stage<D>(smem + L::QDO + 2 * stage * L::TILE, smem + L::STATS + 512 * stage,
                      bar_q + stage, &tq, &tdo, &tlse, &tdelta, b, n, r0 + 2 * TILE_ROWS,
                      stat_base + r0 + 2 * TILE_ROWS);
  }

  store_tile<D>(dk + b * dks.b + n * dks.n, dks.s, k0, sk, warp, lane, acc_k);
  store_tile<D>(dv + b * dvs.b + n * dvs.n, dvs.s, k0, sk, warp, lane, acc_v);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int batch, int n_heads, int sq, int sk, Strides qs,
              Strides ks, Strides vs, Strides dos, Strides dqs, float sm_scale, int causal,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!bshd_tensor_map(&tq, q, batch, sq, n_heads, D, qs.b, qs.s, qs.n) ||
      !bshd_tensor_map(&tk, k, batch, sk, n_heads, D, ks.b, ks.s, ks.n) ||
      !bshd_tensor_map(&tv, v, batch, sk, n_heads, D, vs.b, vs.s, vs.n) ||
      !bshd_tensor_map(&tdo, dout, batch, sq, n_heads, D, dos.b, dos.s, dos.n))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DqLayout<D>::BYTES + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + TILE_ROWS - 1) / TILE_ROWS, batch * n_heads);
  flash_bwd_dq_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), n_heads, sq, sk, dqs, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int batch, int n_heads, int sq, int sk,
               Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
               float sm_scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const long long n_stats = static_cast<long long>(batch) * n_heads * sq;
  if (!bshd_tensor_map(&tq, q, batch, sq, n_heads, D, qs.b, qs.s, qs.n) ||
      !bshd_tensor_map(&tk, k, batch, sk, n_heads, D, ks.b, ks.s, ks.n) ||
      !bshd_tensor_map(&tv, v, batch, sk, n_heads, D, vs.b, vs.s, vs.n) ||
      !bshd_tensor_map(&tdo, dout, batch, sq, n_heads, D, dos.b, dos.s, dos.n) ||
      !row_tensor_map(&tlse, static_cast<const float*>(lse), n_stats) ||
      !row_tensor_map(&tdelta, static_cast<const float*>(delta), n_stats))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DkvLayout<D>::BYTES + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + TILE_ROWS - 1) / TILE_ROWS, batch * n_heads);
  flash_bwd_dkv_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n_heads, sq, sk, dks, dvs, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 float32 (the CUDA-core kernels), 1 bfloat16 (the wgmma
// kernels). head_dim: 64 or 128. Strides in elements, (batch, sequence,
// head) for each [B, S, N, H] tensor.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int batch,
    int n_heads, int sq, int sk, int head_dim,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long do_sb, long long do_ss, long long do_sn,
    long long dq_sb, long long dq_ss, long long dq_sn,
    float sm_scale, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn}, vs{v_sb, v_ss, v_sn};
  const Strides dos{do_sb, do_ss, do_sn}, dqs{dq_sb, dq_ss, dq_sn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launch) {
    return launch(q, k, v, dout, lse, delta, dq, batch, n_heads, sq, sk, qs, ks, vs, dos, dqs,
                  sm_scale, causal, st);
  };
  if (dtype == 0 && head_dim == 64) return run(launch_dq<float, 64>);
  if (dtype == 0 && head_dim == 128) return run(launch_dq<float, 128>);
  if (dtype == 1 && head_dim == 64) return run(wg::launch_dq<64>);
  if (dtype == 1 && head_dim == 128) return run(wg::launch_dq<128>);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype,
    int batch, int n_heads, int sq, int sk, int head_dim,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long do_sb, long long do_ss, long long do_sn,
    long long dk_sb, long long dk_ss, long long dk_sn,
    long long dv_sb, long long dv_ss, long long dv_sn,
    float sm_scale, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn}, vs{v_sb, v_ss, v_sn};
  const Strides dos{do_sb, do_ss, do_sn}, dks{dk_sb, dk_ss, dk_sn};
  const Strides dvs{dv_sb, dv_ss, dv_sn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launch) {
    return launch(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, sq, sk, qs, ks, vs, dos,
                  dks, dvs, sm_scale, causal, st);
  };
  if (dtype == 0 && head_dim == 64) return run(launch_dkv<float, 64>);
  if (dtype == 0 && head_dim == 128) return run(launch_dkv<float, 128>);
  if (dtype == 1 && head_dim == 64) return run(wg::launch_dkv<64>);
  if (dtype == 1 && head_dim == 128) return run(wg::launch_dkv<128>);
  return static_cast<int>(cudaErrorInvalidValue);
}
