// Flash attention backward for Hopper (sm_90a), written by hand: two
// kernels, dQ and dK/dV.
//
// Replaces ray_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel, the Pallas TPU kernels. They compute the same
// functions from the forward's residuals (q, k, v, O and LSE, the natural
// log of the sum of exp of the scaled logits) and D = rowsum(dO * O),
// which the caller takes outside the kernels, as the TPU code does:
//   P  = exp(q k^T * scale - LSE)            (masked entries are 0)
//   dP = dO V^T,  dS = P * (dP - D) * scale
//   dQ = dS K,    dK = dS^T Q,   dV = P^T dO
// The mask is k_pos < sk and q_pos < sq and, when causal, q_pos >= k_pos
// with both positions counted from 0 (top left). As on the TPU, every
// product is taken in fp32 from fp32 or bf16 inputs; the gradients are
// written in the input dtype.
//
// The split is the TPU's: the dQ kernel runs one CTA per (64-row query
// tile, b*n) and loops over the KV tiles up to the diagonal; the dK/dV
// kernel runs one CTA per (64-key tile, b*n) and loops over the query
// tiles from the diagonal on. Each CTA owns the rows it writes, so no
// atomics are needed and the gradients are the same from run to run.
//
// What bounds it on this card. At the flagship shape (B4, S2048, N16,
// H128, bf16, causal) dQ takes three products over the causal pairs,
// 103.1 GFLOP, and dK/dV four, 137.4 GFLOP: 104 us and 139 us at the bf16
// tensor-core rate (989 TFLOP/s), above the 50 us and 60 us that moving
// their bytes once takes at 3.35 TB/s, so both are compute-bound. These
// kernels do their arithmetic in fp32 on the CUDA cores, whose peak is
// 67 TFLOP/s, so they cannot beat 1.54 ms and 2.05 ms there. What the
// design does about that: every operand tile sits in shared memory in
// its natural [row][H] layout (one copy serves both the products that
// contract over H and those that contract over the tile's rows); each
// thread keeps a 4x4 tile of scores and 4x(H/16) tiles of its outputs in
// registers, so that eight 16-byte shared-memory reads feed 64 FMAs in
// the products over H, and 1 + H/64 of them feed 16 H/64 FMAs in the
// products over the tile's rows; score columns are interleaved across threads
// (column tx + 16j) and rows are padded by 4 floats, so the 16-byte
// reads of one quarter-warp fall on 32 distinct banks; tiles past the
// diagonal are never loaded; and the CTAs with the most causal work are
// launched first. wgmma and TMA are the way past the fp32 ceiling.
//
// Layout: q, o, dO, dQ [B, Sq, N, H] and k, v, dK, dV [B, Sk, N, H], read
// and written by element strides (the last axis contiguous), so the
// caller makes no transposed or padded copy. LSE and D are unpadded fp32
// [B*N, Sq]. Each entry point launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads, 4 x 4 scores each
constexpr int LDT = 64 + 4;    // row stride of the score tiles in shared memory

static_assert(BQ == 64 && BK == 64, "the 4x4 thread tile over 16x16 threads assumes 64x64 tiles");

struct Strides {
  long long b, s, n;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

}  // namespace

// dtype: 0 float32, 1 bfloat16. head_dim: 64 or 128. Strides in elements,
// (batch, sequence, head) for each [B, S, N, H] tensor.
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
#define RTT_LAUNCH(T, D)                                                               \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq, batch, n_heads, sq, sk, qs, ks, vs, \
                  dos, dqs, sm_scale, causal, st)
  if (dtype == 0 && head_dim == 64) return RTT_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) return RTT_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) return RTT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) return RTT_LAUNCH(__nv_bfloat16, 128);
#undef RTT_LAUNCH
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
#define RTT_LAUNCH(T, D)                                                          \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, sq, sk, qs, \
                   ks, vs, dos, dks, dvs, sm_scale, causal, st)
  if (dtype == 0 && head_dim == 64) return RTT_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) return RTT_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) return RTT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) return RTT_LAUNCH(__nv_bfloat16, 128);
#undef RTT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
