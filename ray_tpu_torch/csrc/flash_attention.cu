// Flash attention forward for Hopper (sm_90a), written by hand, in two
// variants by input dtype.
//
// Replaces ray_tpu/ops/flash_attention.py::_flash_fwd_kernel, the Pallas
// TPU kernel. Both variants compute the same function: blockwise attention
// with an online softmax (running max m, normaliser l), mask k_pos < sk
// and, when causal, q_pos >= k_pos with both positions counted from 0 (top
// left), masked p set to 0 so that a tile in which a row sees no key adds
// nothing, KV tiles past the diagonal skipped. They write O in the input
// dtype, divided by l_safe = max(l, 1e-30), and LSE = m + log(l_safe) in
// fp32, the natural log of the sum of exp of the *scaled* logits, which
// the backward kernels read.
//
// - fp32 inputs: a CUDA-core FMA kernel (flash_fwd_kernel). As on the
//   TPU, q is scaled by sm_scale first and every product is taken in
//   fp32; the only way to meet the JAX package's 2e-5 forward bound.
// - bf16 inputs: a wgmma kernel fed by TMA (flash_fwd_wgmma). Precision
//   contract:
//   * S = Q K^T: bf16 operands, fp32 accumulation. The inputs are exact
//     bf16 values, so this equals the fp32 product up to summation order;
//     the scale is applied to S in fp32.
//   * m, l, P and the rescaling of O: fp32, in registers, with exp2 of
//     logits in log2 units (the same numbers up to rounding).
//   * O += P V: P rounded to bf16 as the A operand, fp32 accumulation.
//     This is the one place where the bf16 variant departs from the TPU
//     kernel's fp32 arithmetic (PyTorch's own flash forward rounds there
//     too); l sums the unrounded P. O is written as bf16.
//   ops/flash_attention.py::flash_attention_plain does not round P; the
//   kernel is held against it under bf16 bounds (relative norm 1e-2, and
//   2e-2 for the worst 64-row tile of any head).
//
// What bounds it on this card. At the flagship shape (B4, S2048, N16,
// H128, causal) the two products need 68.7 GFLOP. At the bf16 tensor-core
// rate (989 TFLOP/s) that is 69.5 us, more than the 40 us that moving q,
// k, v, o and LSE once takes at 3.35 TB/s, so the work is bound by
// operations, and only wgmma reaches that rate: the CUDA cores' 67 TFLOP/s
// hold the fp32 kernel above 1.03 ms.
//
// What the bf16 design does about that (the backward's design, in
// flash_attention_bwd.cu, applied to the forward):
// - A CTA is one warpgroup of 128 threads for one 64-row query tile of one
//   head. Its Q tile comes in once by TMA; K and V tiles of 64 keys come
//   through a ring of two stages, each guarded by an mbarrier that counts
//   the TMA bytes, issued by one thread; the next tile but one is
//   requested as soon as a stage is read, so its load overlaps a whole
//   step. 80 KB of shared memory at H=128, so two CTAs share an SM, and
//   while one computes its softmax the other's products run.
// - S = Q K^T is an SS wgmma m64n64k16 (both operands K-major over H from
//   the 128-byte swizzled tiles TMA writes). The online softmax runs on the
//   accumulator fragment in registers: a thread holds 16 values of each of
//   two rows, and the four threads that share a row reduce its max and
//   sum with two shuffles (the sum only once, at the end).
// - P never leaves registers: the m64n64 accumulator, rounded to bf16
//   pairs, is the register A fragment of O += P V, an RS wgmma m64nDk16
//   whose B operand is the V tile read MN-major (the trans-b bit), so no
//   transposed copy of V exists. O is rescaled by alpha in registers.
// - Only the diagonal tile and the ragged last tile take mask arithmetic;
//   tiles past the diagonal are never loaded; the query tiles with the
//   most causal work are launched first.
//
// Head dims. Each variant has three instances, for tiles D = 64, 128 and
// 256 columns wide; a head dim H <= 256 runs on the smallest D >= H, with
// the true H passed at run time. Columns at or past H load as zeros (the
// TMA map's extent is H; the fp32 staging masks them), so they add nothing
// to q k^T or p v, and stores skip them: no padded copy is made, as the TPU
// code pads by _pad_head. The bf16 kernel takes H a multiple of 8 (the
// wrapper pads any other H to one). At D = 256 a CTA holds 200 KB of
// shared memory (fp32) or 160 KB (bf16: Q, two stages of K and V) and the
// bf16 O accumulator takes 128 registers a thread, so one CTA runs on an
// SM; the O += P V product is two m64n128 wgmmas over the two halves.
// Heads wider than 256 take more launches' worth of work, not new tiles:
// a grid axis of output windows (fp32: 128 columns, bf16: 256), each CTA
// summing S over the head's pieces loaded in turn (flash_fwd_kernel's
// CHUNKED instances, flash_fwd_wgmma_wide).
//
// Layout: q/o [B, Sq, N, H] and k/v [B, Sk, N, H], read and written by
// element strides (the last axis contiguous), so the caller makes no
// transposed or padded copy; for bf16 the base must be 16-byte aligned and
// the strides multiples of 8 elements (TMA). Ragged edges are masked by
// the true lengths. LSE is [B*N, Sq]. The entry point launches on the
// given stream, allocates nothing and returns a CUDA error code: 0, the
// launch's error, or cudaErrorInvalidValue for what it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;  // the masked logit, as in the TPU kernel

struct Strides {
  long long b, s, n;
};

// ---------------------------------------------------------------------------
// fp32 inputs: CUDA-core FMA (flash_fwd_kernel).
//
// Each thread holds a 4x4 tile of scores and a 4x(D/16) tile of the
// output in registers, so every pair of 16-byte shared memory reads feeds
// 16 FMAs; q is staged once per CTA and K/V tiles once per 64 query rows;
// two CTAs fit on an SM so that one's loads overlap the other's
// arithmetic.

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads, 4 x 4 scores each
constexpr int LDT = BQ + 4;    // row stride of the transposed tiles: keeps
                               // float4 alignment, spreads stores over banks

static_assert(BQ == BK, "sP reuses sK's rows; the 4x4 thread tile assumes BQ == BK == 64");

template <int D>
constexpr size_t smem_bytes() {
  // sQ and sK transposed ([D][LDT]), sV natural ([BK][D]); sP ([BK][LDT])
  // reuses sK once the scores of a tile are taken.
  return sizeof(float) * (2 * D * LDT + BK * D);
}

// CHUNKED (heads wider than one tile): gridDim.z chunks of D columns
// cover the head; q k^T is summed over them, staging Q and K chunk by
// chunk, and blockIdx.z is the output window, the chunk of O the CTA
// writes. Every window takes the same S and LSE.
template <int D, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, D > 128 ? 1 : 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int n_heads, int sq, int sk, int h,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 float sm_scale, int causal) {
  static_assert(D % 64 == 0 && BK <= D, "tiles are a multiple of 64 columns wide");
  constexpr int G = D / 64;  // float4 column groups per thread in the output
  const int n_chunks = CHUNKED ? gridDim.z : 1;
  const int w = CHUNKED ? blockIdx.z : 0;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [D][LDT], q * sm_scale
  float* sK = sQ + D * LDT;                     // [D][LDT]
  float* sV = sK + D * LDT;                     // [BK][D]
  float* sP = sK;                               // [BK][LDT]

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // keys tx*4 .. tx*4+3; output columns g*64 + tx*4 ..
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int q0 = qt * BQ;

  const float* qb = q + b * qs.b + n * qs.n;
  const float* kb = k + b * ks.b + n * ks.n;
  const float* vb = v + b * vs.b + n * vs.n;

  // Q chunk at column c0 into sQ, transposed and scaled.
  const auto stage_q = [&](int c0) {
    for (int idx = tid; idx < BQ * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int qi = q0 + r;
      sQ[d * LDT + r] = qi < sq && c0 + d < h ? qb[qi * qs.s + c0 + d] * sm_scale : 0.f;
    }
  };
  if (!CHUNKED) stage_q(0);

  float acc[4][4 * G];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;  // this thread's share of the row sum, reduced at the end
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (sk + BK - 1) / BK;
  const int n_iter = causal ? min(n_kv, (q0 + BQ + BK - 1) / BK) : n_kv;

  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * BK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = c * D, v0 = w * D;
      __syncthreads();  // the previous chunk's or tile's sQ, sK, sP and sV are no longer read
      if (CHUNKED) stage_q(c0);
      for (int idx = tid; idx < BK * D; idx += THREADS) {
        const int r = idx / D, d = idx % D;
        const int kj = k0 + r;
        sK[d * LDT + r] = kj < sk && c0 + d < h ? kb[kj * ks.s + c0 + d] : 0.f;
        if (c == n_chunks - 1)  // V's window, staged with the last chunk
          sV[r * D + d] = kj < sk && v0 + d < h ? vb[kj * vs.s + v0 + d] : 0.f;
      }
      __syncthreads();

#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(sQ + d * LDT + ty * 4);
        const float4 bk = *reinterpret_cast<const float4*>(sK + d * LDT + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(av[i], bv[jj], s[i][jj]);
      }
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i;
      bool ok[4];
      float row_max = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k_pos = k0 + tx * 4 + jj;
        ok[jj] = k_pos < sk && (!causal || q_pos >= k_pos);
        s[i][jj] = ok[jj] ? s[i][jj] : NEG;
        row_max = fmaxf(row_max, s[i][jj]);
      }
      // the 16 threads that share a row are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        p[i][jj] = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        row_sum += p[i][jj];
      }
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread has read sK; sP overwrites it
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(sP + (tx * 4 + jj) * LDT + ty * 4) =
          make_float4(p[0][jj], p[1][jj], p[2][jj], p[3][jj]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(sP + kk * LDT + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + kk * D + g * 64 + tx * 4);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pr[i], vc[e], acc[i][g * 4 + e]);
      }
    }
  }

  float* ob = o + b * os.b + n * os.n + w * D;
  const int h_out = h - w * D;  // the window's columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float row_l = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      row_l += __shfl_xor_sync(0xffffffffu, row_l, off);
    const float l_safe = fmaxf(row_l, 1e-30f);
    const int q_pos = q0 + ty * 4 + i;
    if (q_pos < sq) {
      float* orow = ob + q_pos * os.s;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = g * 64 + tx * 4 + e;
          if (col < h_out) orow[col] = acc[i][g * 4 + e] / l_safe;
        }
      if (tx == 0 && w == 0) lse[static_cast<long long>(bn) * sq + q_pos] = m[i] + logf(l_safe);
    }
  }
}

template <int D, bool CHUNKED = false>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int n_heads, int sq, int sk, int h, Strides qs, Strides ks,
           Strides vs, Strides os, float sm_scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, batch * n_heads, CHUNKED ? (h + D - 1) / D : 1);
  flash_fwd_kernel<D, CHUNKED><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      n_heads, sq, sk, h, qs, ks, vs, os, sm_scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: wgmma fed by TMA (flash_fwd_wgmma).

namespace wg {

using namespace hopper;

constexpr int THREADS = 128;  // one warpgroup: loads, products, softmax
constexpr int TILE_ROWS = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory, in bytes from a 1024-byte aligned base. A tile is 64
// rows of D bf16 in D/64 swizzled boxes.
template <int D>
struct FwdLayout {
  static constexpr int TILE = TILE_ROWS * D * 2;
  static constexpr int Q = 0;
  static constexpr int KV = TILE;       // stage s: K at KV + 2 s TILE, V after it
  static constexpr int BARS = 5 * TILE;  // Q, then one per stage
  static constexpr int BYTES = BARS + 3 * 8;
};

// O and LSE for one 64-row query tile of one head: S = Q K^T (SS wgmma),
// the online softmax in registers, O += P V (RS wgmma, V read MN-major),
// over the KV tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(THREADS, D > 128 ? 1 : 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int n_heads, int sq, int sk, int h, Strides os,
                float sm_scale, int causal) {
  static_assert(D == 64 || D == 128 || D == 256, "tiles 64, 128 or 256 columns wide");
  using L = FwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* bar_kv = bar_q + 1;  // one per stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bn = blockIdx.y;
  const int b = bn / n_heads, n = bn % n_heads;
  const int q0 = qt * TILE_ROWS;
  const int n_kv = (sk + TILE_ROWS - 1) / TILE_ROWS;
  const int n_iter = causal ? min(n_kv, qt + 1) : n_kv;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 1, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar_q, L::TILE);
    tma_load_tile<D>(smem + L::Q, &tq, bar_q, b, n, q0);
    for (int j = 0; j < 2 && j < n_iter; ++j)
      tma_load_tile_pair<D>(smem + L::KV + 2 * j * L::TILE, &tk, &tv, bar_kv + j, b, n,
                            j * TILE_ROWS);
  }

  // Logits in log2 units: x = S * scale * log2(e), so exp(S * scale - m)
  // is exp2(x - m2). m2 and l are per row; a thread holds two rows (r = 0
  // for its accumulator elements with (i / 2) % 2 == 0, r = 1 for the
  // rest) and its own share of each row's l.
  const float scale_log2 = sm_scale * LOG2E;
  float m2[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t s_q = smem_addr(smem + L::Q);
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_iter; ++j) {
    const int stage = j & 1;
    const int k0 = j * TILE_ROWS;
    const uint32_t s_k = smem_addr(smem + L::KV + 2 * stage * L::TILE);
    const uint32_t s_v = s_k + L::TILE;
    mbar_wait(bar_kv + stage, (j >> 1) & 1);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc(s_q, kk), kmajor_desc(s_k, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Masks by position, on the diagonal tile and the ragged last tile only.
    const bool edge = (causal && k0 + TILE_ROWS - 1 > q0) || k0 + TILE_ROWS > sk;
    const auto keep = [&](int i) {
      if (!edge) return true;
      const int q_pos = q0 + acc_row(i, warp, lane), k_pos = k0 + acc_col(i, lane);
      return k_pos < sk && (!causal || q_pos >= k_pos);
    };
    float tile_max[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = keep(i) ? s[i] * scale_log2 : NEG;
      tile_max[(i / 2) % 2] = fmaxf(tile_max[(i / 2) % 2], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads that share a row are lanes 4t .. 4t+3 of one warp
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m2[r], tile_max[r]);
      alpha[r] = exp2f(m2[r] - m_new);
      m2[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float p = keep(i) ? exp2f(s[i] - m2[r]) : 0.f;
      l[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    uint32_t pa[16];
    to_a_fragments(s, pa);
    fence_regs(pa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<D>(acc, pa, kk, mnmajor_desc(s_v, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // every warp has read this stage
    if (tid == 0 && j + 2 < n_iter)
      tma_load_tile_pair<D>(smem + L::KV + 2 * stage * L::TILE, &tk, &tv, bar_kv + stage, b, n,
                            (j + 2) * TILE_ROWS);
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float row_l = l[r];
    row_l += __shfl_xor_sync(0xffffffffu, row_l, 1);
    row_l += __shfl_xor_sync(0xffffffffu, row_l, 2);
    l_safe[r] = fmaxf(row_l, 1e-30f);
    const int q_pos = q0 + warp * 16 + lane / 4 + 8 * r;
    if (lane % 4 == 0 && q_pos < sq)
      lse[static_cast<long long>(bn) * sq + q_pos] = m2[r] * LN2 + logf(l_safe[r]);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] /= l_safe[(i / 2) % 2];
  store_tile<D>(o + b * os.b + n * os.n, os.s, q0, sq, h, warp, lane, acc);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
           int n_heads, int sq, int sk, int h, Strides qs, Strides ks, Strides vs, Strides os,
           float sm_scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!bshd_tensor_map(&tq, q, batch, sq, n_heads, h, qs.b, qs.s, qs.n) ||
      !bshd_tensor_map(&tk, k, batch, sk, n_heads, h, ks.b, ks.s, ks.n) ||
      !bshd_tensor_map(&tv, v, batch, sk, n_heads, h, vs.b, vs.s, vs.n))
    return cudaErrorInvalidValue;
  constexpr size_t smem = FwdLayout<D>::BYTES + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + TILE_ROWS - 1) / TILE_ROWS, batch * n_heads);
  flash_fwd_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), n_heads, sq, sk, h,
      os, sm_scale, causal);
  return cudaGetLastError();
}

// Heads wider than 256 columns (flash_fwd_wgmma_wide). A CTA is one
// 64-row query tile of one head and one output window of 256 columns
// (blockIdx.z). S = Q K^T is summed over 256-column pieces of Q and K,
// loaded in turn by TMA into one stage (the k-steps past the head dim are
// skipped); the online softmax and O += P V then run as in
// flash_fwd_wgmma<256>, on the window's 256 columns of V. Every window
// takes the same S, so LSE is written by window 0. The price of keeping
// it simple: Q is loaded again for every KV tile, no load overlaps a
// product, and S is taken once per window.
struct WideFwdLayout {
  static constexpr int TILE = TILE_ROWS * 256 * 2;
  static constexpr int Q = 0, K = TILE, V = 2 * TILE;
  static constexpr int BARS = 3 * TILE;  // Q and K, then V
  static constexpr int BYTES = BARS + 2 * 8;
};

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_wide(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int n_heads, int sq, int sk, int h, Strides os,
                     float sm_scale, int causal) {
  constexpr int D = 256;
  using L = WideFwdLayout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* bar_qk = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* bar_v = bar_qk + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bn = blockIdx.y;
  const int w = blockIdx.z;
  const int b = bn / n_heads, n = bn % n_heads;
  const int q0 = qt * TILE_ROWS;
  const int n_kv = (sk + TILE_ROWS - 1) / TILE_ROWS;
  const int n_iter = causal ? min(n_kv, qt + 1) : n_kv;
  const int n_pieces = (h + D - 1) / D;

  if (tid == 0) {
    mbar_init(bar_qk, 1);
    mbar_init(bar_v, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const float scale_log2 = sm_scale * LOG2E;
  float m2[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t s_q = smem_addr(smem + L::Q), s_k = smem_addr(smem + L::K);
  const uint32_t s_v = smem_addr(smem + L::V);
  uint32_t phase_qk = 0, phase_v = 0;

  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * TILE_ROWS;
    if (tid == 0) {  // the window of V, read after the softmax
      mbar_arrive_expect_tx(bar_v, L::TILE);
      tma_load_tile<D>(smem + L::V, &tv, bar_v, b, n, k0, w * D);
    }

    float s[32];
    for (int p = 0; p < n_pieces; ++p) {
      if (tid == 0) {
        mbar_arrive_expect_tx(bar_qk, 2 * L::TILE);
        tma_load_tile<D>(smem + L::Q, &tq, bar_qk, b, n, q0, p * D);
        tma_load_tile<D>(smem + L::K, &tk, bar_qk, b, n, k0, p * D);
      }
      mbar_wait(bar_qk, phase_qk);
      phase_qk ^= 1;
      const int steps = (min(D, h - p * D) + 15) / 16;  // k-steps inside the head
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        if (kk < steps)
          wgmma_m64n64k16_ss(s, kmajor_desc(s_q, kk), kmajor_desc(s_k, kk), p > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      __syncthreads();  // every warp has read this piece of Q and K
    }

    const bool edge = (causal && k0 + TILE_ROWS - 1 > q0) || k0 + TILE_ROWS > sk;
    const auto keep = [&](int i) {
      if (!edge) return true;
      const int q_pos = q0 + acc_row(i, warp, lane), k_pos = k0 + acc_col(i, lane);
      return k_pos < sk && (!causal || q_pos >= k_pos);
    };
    float tile_max[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = keep(i) ? s[i] * scale_log2 : NEG;
      tile_max[(i / 2) % 2] = fmaxf(tile_max[(i / 2) % 2], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m2[r], tile_max[r]);
      alpha[r] = exp2f(m2[r] - m_new);
      m2[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float p = keep(i) ? exp2f(s[i] - m2[r]) : 0.f;
      l[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    uint32_t pa[16];
    to_a_fragments(s, pa);
    fence_regs(pa);
    fence_regs(acc);
    mbar_wait(bar_v, phase_v);
    phase_v ^= 1;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<D>(acc, pa, kk, mnmajor_desc(s_v, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp has read V
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float row_l = l[r];
    row_l += __shfl_xor_sync(0xffffffffu, row_l, 1);
    row_l += __shfl_xor_sync(0xffffffffu, row_l, 2);
    l_safe[r] = fmaxf(row_l, 1e-30f);
    const int q_pos = q0 + warp * 16 + lane / 4 + 8 * r;
    if (w == 0 && lane % 4 == 0 && q_pos < sq)
      lse[static_cast<long long>(bn) * sq + q_pos] = m2[r] * LN2 + logf(l_safe[r]);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] /= l_safe[(i / 2) % 2];
  store_tile<D>(o + b * os.b + n * os.n + w * D, os.s, q0, sq, h - w * D, warp, lane, acc);
}

int launch_wide(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                int n_heads, int sq, int sk, int h, Strides qs, Strides ks, Strides vs,
                Strides os, float sm_scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!bshd_tensor_map(&tq, q, batch, sq, n_heads, h, qs.b, qs.s, qs.n) ||
      !bshd_tensor_map(&tk, k, batch, sk, n_heads, h, ks.b, ks.s, ks.n) ||
      !bshd_tensor_map(&tv, v, batch, sk, n_heads, h, vs.b, vs.s, vs.n))
    return cudaErrorInvalidValue;
  constexpr size_t smem = WideFwdLayout::BYTES + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + TILE_ROWS - 1) / TILE_ROWS, batch * n_heads, (h + 255) / 256);
  flash_fwd_wgmma_wide<<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), n_heads, sq, sk, h,
      os, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 float32 (the CUDA-core kernel), 1 bfloat16 (the wgmma kernel).
// head_dim: any H >= 1 (a multiple of 8 for bfloat16). Up to 256 it runs
// on the instance 64, 128 or 256 columns wide; above, fp32 on 128-column
// chunks and bf16 on flash_fwd_wgmma_wide. Strides in elements, (batch, sequence, head) for
// each [B, S, N, H] tensor.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int batch, int n_heads, int sq, int sk, int head_dim,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn,
    float sm_scale, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn};
  const Strides vs{v_sb, v_ss, v_sn}, os{o_sb, o_ss, o_sn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launch_fn) {
    return launch_fn(q, k, v, o, lse, batch, n_heads, sq, sk, head_dim, qs, ks, vs, os,
                     sm_scale, causal, st);
  };
  if (head_dim < 1 || (dtype == 1 && head_dim % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return head_dim > 256   ? run(launch<128, true>)
           : head_dim > 128 ? run(launch<256>)
           : head_dim > 64  ? run(launch<128>)
                            : run(launch<64>);
  if (dtype == 1)
    return head_dim > 256   ? run(wg::launch_wide)
           : head_dim > 128 ? run(wg::launch<256>)
           : head_dim > 64 ? run(wg::launch<128>)
                           : run(wg::launch<64>);
  return static_cast<int>(cudaErrorInvalidValue);
}
