// The scheduler's device programs for Hopper (sm_90a), written by hand.
//
// Replaces the jitted jnp programs of ray_tpu/_private/scheduler/:
// - schedule_classes: tpu_policy.py::_schedule_classes_kernel (:76-311),
//   K scheduling classes against the dense [N nodes x R resources] matrix;
// - pg_pack: pg_kernel.py::_pack_kernel (:49-84), one placement group's
//   bundles packed in sequence;
// - pg_pack_rank + pg_pack_batch: pg_kernel.py::_pack_batch_kernel
//   (:87-162), many groups, each over its top-k candidate nodes.
// Each computes its reference op for op in fp32, so the integer
// placements agree exactly with the plain PyTorch versions in
// ray_tpu_torch/_private/scheduler/ (schedule_classes_plain, pack_plain,
// pack_batch_plain). For that:
// - Every product followed by a sum or difference is written with
//   __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into an
//   fma (PyTorch's elementwise kernels and XLA round each op apart).
//   Division is IEEE (/, compiled without fast math).
// - Sorts are stable: (key, index) pairs in a bitonic network, with the
//   index breaking ties, which is jnp.argsort's order (and torch's with
//   stable=True); jnp.lexsort's (rarity, -pressure) order likewise.
// - Sums of integer-valued floats below 2^24 (capacities, placements) are
//   exact in any order. Two sums are not: the live supply of each
//   resource (it orders classes by pressure, and moves that order only
//   when two classes' pressures tie within an ulp) and sums past 2^24.
//
// What bounds them on this card. Each program moves little: at the
// scheduling benchmark's shape (10,000 nodes x 4 resources, 8 classes) the
// inputs are 0.3 MB and the output 1.3 MB, under a microsecond at 3.35
// TB/s. The time goes to a chain of dependent steps instead: per class, a
// totals pass, a capacity pass, 40 bisection steps each ending in a
// block-wide sum, a sort of N keys and a scan, and the classes run one
// after another. The reference's device program is the same chain under
// one XLA launch; its plain PyTorch version is thousands of launches and
// a host sync. The design here: one CTA of 1024 threads runs the whole
// chain in one launch (node state in L2, block reductions by warp
// shuffles, the sort in shared memory up to 16,384 keys and in global
// memory past that), so a step costs a few barriers, not a launch.
// Several CTAs, or a thread-block cluster sharing the node state, would
// cut the time further; that is later work.
//
// Each entry point launches on the given stream, allocates nothing and
// returns a CUDA error code: 0, the launch's error, or
// cudaErrorInvalidValue for what it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = 64;            // resources a kernel takes
constexpr int SMEM_SORT_MAX = 16384;  // keys sorted in shared memory (128 KB)
constexpr int BISECT_STEPS = 40;
constexpr float EPS = 1e-6f;
constexpr float UPPER_CLAMP = 1073741824.f;  // 2^30
constexpr float SPREAD_PENALTY = 1e3f;
constexpr float INF = __builtin_huge_valf();

__host__ __device__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ------------------------------------------------------------ block helpers

// Sum of v over the block, returned to every thread. `red` holds WARPS + 1
// floats of shared memory.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x + 31) / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  const float total = red[WARPS];
  __syncthreads();
  return total;
}

// (a, ia) before (b, ib): ascending key, ties by index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// The first index of the least key over the block: (key, index) reduced
// by `before`, returned to every thread. `rk` and `ri` hold WARPS + 1
// values of shared memory each.
__device__ int block_argmin(float key, int idx, float* rk, int* ri) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float k2 = __shfl_xor_sync(0xffffffffu, key, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
    if (before(k2, i2, key, idx)) key = k2, idx = i2;
  }
  if (lane == 0) rk[warp] = key, ri[warp] = idx;
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < (blockDim.x + 31) / 32;
    key = live ? rk[lane] : INF;
    idx = live ? ri[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float k2 = __shfl_xor_sync(0xffffffffu, key, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
      if (before(k2, i2, key, idx)) key = k2, idx = i2;
    }
    if (lane == 0) ri[WARPS] = idx;
  }
  __syncthreads();
  const int best = ri[WARPS];
  __syncthreads();
  return best;
}

// Sorts p (a power of two) (key, index) pairs ascending by `before`: a
// bitonic network, one barrier a stage. With unique indices the order is
// total, so it is the stable argsort of the keys.
__device__ void block_sort_pairs(float* key, int* idx, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const float ki = key[i], kl = key[l];
          const int ii = idx[i], il = idx[l];
          const bool ascending = (i & k) == 0;
          if (ascending == before(kl, il, ki, ii)) {
            key[i] = kl, key[l] = ki;
            idx[i] = il, idx[l] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Inclusive prefix sums of x[0..n) into out[0..n), in place allowed: each
// thread scans a contiguous chunk, the chunk totals are scanned across the
// block. `red` holds WARPS + 1 floats.
__device__ void block_inclusive_scan(const float* x, float* out, int n, float* red) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  float local = 0.f;
  for (int j = lo; j < hi; ++j) local += x[j];
  // exclusive scan of the chunk totals
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < (blockDim.x + 31) / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    red[lane] = w;  // inclusive scan of warp totals
  }
  __syncthreads();
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);  // this lane's chunks before it
  if (lane == 0) excl = 0.f;
  float run = (warp > 0 ? red[warp - 1] : 0.f) + excl;
  __syncthreads();
  for (int j = lo; j < hi; ++j) {
    run += x[j];
    out[j] = run;
  }
  __syncthreads();
}

// ------------------------------------------------- S1: schedule_classes

struct Scratch {
  float* cap;      // [n] per-node capacity of the class
  float* x_lo;     // [n] the fill at the bisection's low level
  float* delta;    // [n] extra tasks a node takes at the high level
  float* key;      // [p] sort keys past SMEM_SORT_MAX
  int* idx;        // [p]
  int* perm;       // [k] commit order: perm[c] is the class committed c-th
  float* rarity;   // [k]
  float* npress;   // [k] -pressure
  float* local;    // [k] local_take of the class committed c-th
  float* admitted; // [k]
  float* take_sum; // [k]
  float* residual; // [k]
};

long long scratch_floats(int n, int k) {
  return 3LL * n + 2LL * next_pow2(n) + 8LL * k;
}

__device__ Scratch carve(float* base, int n, int k) {
  const int p = next_pow2(n);
  Scratch s;
  s.cap = base;
  s.x_lo = s.cap + n;
  s.delta = s.x_lo + n;
  s.key = s.delta + n;
  s.idx = reinterpret_cast<int*>(s.key + p);
  s.perm = s.idx + p;
  s.rarity = reinterpret_cast<float*>(s.perm + k);
  s.npress = s.rarity + k;
  s.local = s.npress + k;
  s.admitted = s.local + k;
  s.take_sum = s.admitted + k;
  s.residual = s.take_sum + k;
  return s;
}

// x_n(lam): the tasks node n absorbs before exceeding utilization lam,
// clipped to [0, cap[n]] (tpu_policy.py:225-232).
__device__ __forceinline__ float x_of(float lam, const float* a, const float* t, const float* d,
                                      int r, float cap) {
  float m = INF;
  for (int j = 0; j < r; ++j) {
    if (d[j] > 0.f) {
      const float used = __fsub_rn(t[j], a[j]);
      const float head = __fsub_rn(__fmul_rn(lam, t[j]), used);
      m = fminf(m, floorf(head / fmaxf(d[j], EPS)));
    }
  }
  return fminf(fmaxf(m, 0.f), cap);
}

// One class's fill (tpu_policy.py:156-261) against the carried `avail`,
// by the whole block. Writes avail in place, and the class's order and
// take into `row_order` and `row_take`; returns its scalars through `out`
// (thread 0's values; every thread computes the same).
struct ClassOut {
  float local_take, any_feasible, fenced, admitted, upper, take_sum;
};

__device__ ClassOut fill_class(float* avail, const float* total, const uint8_t* alive,
                               const float* sd, int n, int r, int p, float countf, int pref,
                               float threshold, const Scratch& s, float* skey, int* sidx,
                               int* row_order, int* row_take, float* red, float* bcast) {
  const int tid = threadIdx.x;
  ClassOut out;

  // Capacity bound from node totals, the fence (:168-181).
  float sum_tot = 0.f;
  int any = 0;
  for (int i = tid; i < n; i += blockDim.x) {
    float m = INF;
    for (int j = 0; j < r; ++j)
      if (sd[j] > 0.f) m = fminf(m, __fadd_rn(total[i * r + j], EPS) / fmaxf(sd[j], EPS));
    const float cap_tot = alive[i] ? floorf(m) : 0.f;
    sum_tot += cap_tot;
    any |= cap_tot >= 1.f;
  }
  out.any_feasible = __syncthreads_or(any) ? 1.f : 0.f;
  out.upper = fminf(block_sum(sum_tot, red), UPPER_CLAMP);
  float fenced = fmaxf(__fsub_rn(countf, out.upper), 0.f);
  fenced = countf > 0.f ? fenced : 0.f;
  out.fenced = fenced;
  const float target = __fsub_rn(countf, fenced);

  // Per-node capacity now (:183-191).
  float sum_cap = 0.f;
  for (int i = tid; i < n; i += blockDim.x) {
    float m_tot = INF, m = INF;
    for (int j = 0; j < r; ++j) {
      if (sd[j] > 0.f) {
        const float dj = fmaxf(sd[j], EPS);
        m_tot = fminf(m_tot, __fadd_rn(total[i * r + j], EPS) / dj);
        m = fminf(m, __fadd_rn(avail[i * r + j], EPS) / dj);
      }
    }
    const bool feas = (alive[i] ? floorf(m_tot) : 0.f) >= 1.f;
    const float cap = feas ? fminf(floorf(m), target) : 0.f;
    s.cap[i] = cap;
    sum_cap += cap;
  }
  out.admitted = fminf(target, block_sum(sum_cap, red));

  // Phase 1: pack the preferred node while util < threshold (:198-215).
  if (tid == 0) {
    const int q = max(pref, 0);
    const float* aq = avail + q * r;
    const float* tq = total + q * r;
    float util = -INF, c_min = INF;
    for (int j = 0; j < r; ++j) {
      const float used = __fsub_rn(tq[j], aq[j]);
      util = fmaxf(util, tq[j] > 0.f ? used / fmaxf(tq[j], EPS) : 0.f);
      if (sd[j] > 0.f)
        c_min = fminf(c_min, ceilf(__fsub_rn(__fmul_rn(threshold, tq[j]), used) /
                                   fmaxf(sd[j], EPS)));
    }
    const float c_thresh = fmaxf(c_min, 0.f);
    float lt = pref >= 0 && util < threshold ? fminf(fminf(c_thresh, s.cap[q]), target) : 0.f;
    lt = countf > 0.f ? lt : 0.f;
    for (int j = 0; j < r; ++j) avail[q * r + j] = __fsub_rn(aq[j], __fmul_rn(lt, sd[j]));
    s.cap[q] = __fsub_rn(s.cap[q], lt);
    bcast[0] = lt;
  }
  __syncthreads();
  out.local_take = bcast[0];
  const float remaining = __fsub_rn(target, out.local_take);
  __syncthreads();

  // Phase 2: bisection for the common utilization level (:225-242).
  float lo = 0.f, hi = 1.f;
  for (int step = 0; step < BISECT_STEPS; ++step) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    float part = 0.f;
    for (int i = tid; i < n; i += blockDim.x)
      part += x_of(mid, avail + i * r, total + i * r, sd, r, s.cap[i]);
    const bool ge = block_sum(part, red) >= remaining;
    lo = ge ? lo : mid;
    hi = ge ? mid : hi;
  }

  // x_lo, the deficit, delta and the post-fill utilization (:243-250).
  float part = 0.f;
  for (int i = tid; i < n; i += blockDim.x) {
    const float* a = avail + i * r;
    const float* t = total + i * r;
    const float xl = x_of(lo, a, t, sd, r, s.cap[i]);
    s.x_lo[i] = xl;
    s.delta[i] = fmaxf(__fsub_rn(x_of(hi, a, t, sd, r, s.cap[i]), xl), 0.f);
    float u = -INF;
    for (int j = 0; j < r; ++j) {
      const float used = __fsub_rn(t[j], a[j]);
      u = fmaxf(u, t[j] > 0.f ? __fadd_rn(used, __fmul_rn(xl, sd[j])) / fmaxf(t[j], EPS) : 0.f);
    }
    skey[i] = u;
    sidx[i] = i;
    part += xl;
  }
  for (int i = n + tid; i < p; i += blockDim.x) skey[i] = INF, sidx[i] = i;
  const float deficit = fmaxf(__fsub_rn(remaining, block_sum(part, red)), 0.f);
  block_sort_pairs(skey, sidx, p);  // order = argsort(util_after), stable (:251)

  // The remainder in that order (:252-258): cum is the inclusive scan of
  // delta_sorted, kept in skey (the sorted keys are no longer needed).
  for (int j = tid; j < n; j += blockDim.x) skey[j] = s.delta[sidx[j]];
  __syncthreads();
  block_inclusive_scan(skey, skey, n, red);
  float take_part = 0.f;
  for (int j = tid; j < n; j += blockDim.x) {
    const int i = sidx[j];
    const float ds = s.delta[i];
    const float extra = fminf(fmaxf(__fsub_rn(deficit, __fsub_rn(skey[j], ds)), 0.f), ds);
    const float take = __fadd_rn(s.x_lo[i], extra);
    row_order[j] = i;
    row_take[j] = __float2int_rz(take);
    for (int c = 0; c < r; ++c)
      avail[i * r + c] = __fsub_rn(avail[i * r + c], __fmul_rn(take, sd[c]));
    take_part += take;
  }
  out.take_sum = block_sum(take_part, red);
  return out;
}

__global__ void __launch_bounds__(THREADS, 1)
schedule_classes_kernel(float* __restrict__ avail, const float* __restrict__ total,
                        const uint8_t* __restrict__ alive, const float* __restrict__ demands,
                        const int* __restrict__ counts, const int* __restrict__ prefs,
                        float threshold, int n, int r, int k, int* __restrict__ packed,
                        float* scratch_base) {
  extern __shared__ float4 smem4[];
  __shared__ float red[WARPS + 1];
  __shared__ float bcast[2];
  __shared__ float sd[MAX_R];
  __shared__ float res_frac[MAX_R], pressure[MAX_R];
  const int tid = threadIdx.x;
  int p = 1;  // the sort's size: n padded to a power of two
  while (p < n) p <<= 1;
  const Scratch s = carve(scratch_base, n, k);
  float* skey = p <= SMEM_SORT_MAX ? reinterpret_cast<float*>(smem4) : s.key;
  int* sidx = p <= SMEM_SORT_MAX ? reinterpret_cast<int*>(skey + p) : s.idx;
  const long long row = 4LL * n + 5;

  // Scarcity order of the classes (:137-155).
  float n_alive = 0.f;
  for (int i = tid; i < n; i += blockDim.x) n_alive += alive[i] ? 1.f : 0.f;
  n_alive = fmaxf(block_sum(n_alive, red), 1.f);
  for (int j = 0; j < r; ++j) {
    float has = 0.f, supply = 0.f;
    for (int i = tid; i < n; i += blockDim.x) {
      has += alive[i] && total[i * r + j] > 0.f ? 1.f : 0.f;
      supply += alive[i] ? avail[i * r + j] : 0.f;
    }
    has = block_sum(has, red);
    supply = block_sum(supply, red);
    if (tid == 0) {
      float demand = 0.f;
      for (int c = 0; c < k; ++c)
        demand = __fadd_rn(demand, __fmul_rn(static_cast<float>(counts[c]), demands[c * r + j]));
      res_frac[j] = has / n_alive;
      pressure[j] = demand / fmaxf(supply, EPS);
    }
  }
  __syncthreads();
  for (int c = tid; c < k; c += blockDim.x) {
    float rarity = INF, press = -INF;
    for (int j = 0; j < r; ++j) {
      if (demands[c * r + j] > 0.f) {
        rarity = fminf(rarity, res_frac[j]);
        press = fmaxf(press, pressure[j]);
      }
    }
    s.rarity[c] = counts[c] > 0 ? rarity : INF;
    s.npress[c] = -(counts[c] > 0 ? press : -INF);
  }
  __syncthreads();
  for (int c = tid; c < k; c += blockDim.x) {  // rank by (rarity, -pressure, index)
    int rank = 0;
    for (int o = 0; o < k; ++o) {
      const bool first = s.rarity[o] < s.rarity[c] ||
                         (s.rarity[o] == s.rarity[c] && before(s.npress[o], o, s.npress[c], c));
      rank += first;
    }
    s.perm[rank] = c;
  }
  __syncthreads();

  // The commit scan over classes (:263-265), then the residual pass
  // (:277-298) only when an admitted task was left unplaced.
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = 0; c < k; ++c) {
      const int cls = s.perm[c];
      for (int j = tid; j < r; j += blockDim.x) sd[j] = demands[cls * r + j];
      __syncthreads();
      const float countf = pass == 0 ? static_cast<float>(counts[cls]) : s.residual[c];
      int* out_row = packed + cls * row;
      const ClassOut o = fill_class(avail, total, alive, sd, n, r, p, countf,
                                    pass == 0 ? prefs[cls] : -1, threshold, s, skey, sidx,
                                    out_row + 5 + 2 * pass * n, out_row + 5 + (2 * pass + 1) * n,
                                    red, bcast);
      if (pass == 0 && tid == 0) {
        out_row[0] = __float2int_rz(o.local_take);
        out_row[1] = __float2int_rz(o.any_feasible);
        out_row[2] = __float2int_rz(o.fenced);
        out_row[3] = __float2int_rz(o.admitted);
        out_row[4] = __float2int_rz(o.upper);
        s.local[c] = o.local_take;
        s.admitted[c] = o.admitted;
        s.take_sum[c] = o.take_sum;
      }
      __syncthreads();
    }
    if (pass == 0) {
      if (tid == 0) {
        float total_residual = 0.f;
        for (int c = 0; c < k; ++c) {
          const float placed = fminf(__fadd_rn(s.local[c], s.take_sum[c]), s.admitted[c]);
          s.residual[c] = fmaxf(__fsub_rn(s.admitted[c], placed), 0.f);
          total_residual += s.residual[c];
        }
        bcast[1] = total_residual;
      }
      __syncthreads();
      if (!(bcast[1] > 0.f)) {
        for (long long e = tid; e < 2LL * n * k; e += blockDim.x) {
          const long long cls = e / (2LL * n);
          packed[cls * row + 5 + 2LL * n + e % (2LL * n)] = 0;
        }
        break;
      }
    }
  }
}

// ------------------------------------------------------ S2: pg_pack

// Feasibility and score of one row for one bundle (pg_kernel.py:56-73).
__device__ __forceinline__ float pack_score(const float* a, const float* t, bool alive, bool used,
                                            const float* d, int r, int mode, bool* can_out) {
  bool can = alive;
  float util = -INF;
  for (int j = 0; j < r; ++j) {
    if (d[j] > 0.f && !(__fadd_rn(a[j], EPS) >= d[j])) can = false;
    util = fmaxf(util, t[j] > 0.f ? __fsub_rn(t[j], a[j]) / fmaxf(t[j], EPS) : 0.f);
  }
  float score;
  if (mode == 0) {
    score = -util;
  } else if (mode == 1) {
    score = __fadd_rn(util, used ? SPREAD_PENALTY : 0.f);
  } else {
    score = util;
    can = can && !used;
  }
  *can_out = can;
  return can ? score : INF;
}

__global__ void __launch_bounds__(THREADS, 1)
pg_pack_kernel(float* __restrict__ avail, const float* __restrict__ total,
               const uint8_t* __restrict__ alive, const float* __restrict__ demands, int n, int r,
               int b, int mode, uint8_t* __restrict__ used, int* __restrict__ out) {
  __shared__ float rk[WARPS + 1];
  __shared__ int ri[WARPS + 1];
  __shared__ float sd[MAX_R];
  __shared__ int all_ok;
  const int tid = threadIdx.x;
  if (tid == 0) all_ok = 1;
  for (int bi = 0; bi < b; ++bi) {
    for (int j = tid; j < r; j += blockDim.x) sd[j] = demands[bi * r + j];
    __syncthreads();
    float best = INF;
    int best_i = 0x7fffffff;
    for (int i = tid; i < n; i += blockDim.x) {
      bool can;
      const float sc = pack_score(avail + i * r, total + i * r, alive[i], used[i], sd, r, mode, &can);
      if (before(sc, i, best, best_i)) best = sc, best_i = i;
    }
    const int idx = block_argmin(best, best_i, rk, ri);
    if (tid == 0) {
      bool ok;
      pack_score(avail + idx * r, total + idx * r, alive[idx], used[idx], sd, r, mode, &ok);
      if (ok)
        for (int j = 0; j < r; ++j) avail[idx * r + j] = __fsub_rn(avail[idx * r + j], sd[j]);
      used[idx] = used[idx] | ok;
      out[bi] = ok ? idx : -1;
      all_ok &= ok;
    }
    __syncthreads();
  }
  if (tid == 0) out[b] = all_ok;
}

// ------------------------------------------- S3: pg_pack_rank, pg_pack_batch

// Nodes in the order of the strategy's base score, dead rows last: the
// stable argsort that opens _pack_batch_kernel (:100-105). `ranked` holds
// 2 p ints: the order, then the keys when p > SMEM_SORT_MAX.
__global__ void __launch_bounds__(THREADS, 1)
pg_pack_rank_kernel(const float* __restrict__ avail, const float* __restrict__ total,
                    const uint8_t* __restrict__ alive, int n, int r, int mode, int* ranked) {
  extern __shared__ float4 smem4[];
  int p = 1;
  while (p < n) p <<= 1;
  float* key = p <= SMEM_SORT_MAX ? reinterpret_cast<float*>(smem4)
                                  : reinterpret_cast<float*>(ranked + p);
  int* idx = p <= SMEM_SORT_MAX ? reinterpret_cast<int*>(key + p) : ranked;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    float k = INF;
    if (i < n && alive[i]) {
      float util = -INF;
      for (int j = 0; j < r; ++j) {
        const float t = total[i * r + j];
        util = fmaxf(util, t > 0.f ? __fsub_rn(t, avail[i * r + j]) / fmaxf(t, EPS) : 0.f);
      }
      k = mode == 0 ? -util : util;
    }
    key[i] = k;
    idx[i] = i;
  }
  __syncthreads();
  block_sort_pairs(key, idx, p);
  if (idx != ranked)
    for (int i = threadIdx.x; i < n; i += blockDim.x) ranked[i] = idx[i];
}

// One CTA per group: the group's k candidate slots (ranks g, g+G, ...,
// modulo N) with their own copy of the availability, scanned over its
// bundles (:107-162). `slots` holds, per group, k x r availability values,
// then k node ids and k used flags (as floats' bits).
__global__ void __launch_bounds__(256, 1)
pg_pack_batch_kernel(const float* __restrict__ avail, const float* __restrict__ total,
                     const uint8_t* __restrict__ alive, const float* __restrict__ demands,
                     const uint8_t* __restrict__ valid, int n, int r, int g, int b, int k,
                     int mode, const int* __restrict__ ranked, float* __restrict__ slots,
                     int* __restrict__ out) {
  __shared__ float rk[WARPS + 1];
  __shared__ int ri[WARPS + 1];
  __shared__ float sd[MAX_R];
  __shared__ int chosen, ok_flag, all_ok;
  const int tid = threadIdx.x, grp = blockIdx.x;
  float* av = slots + static_cast<long long>(grp) * k * (r + 2);
  int* cidx = reinterpret_cast<int*>(av + static_cast<long long>(k) * r);
  int* used = cidx + k;
  for (int j = tid; j < k; j += blockDim.x) {
    const int node = ranked[(static_cast<long long>(j) * g + grp) % n];
    cidx[j] = node;
    used[j] = 0;
    for (int c = 0; c < r; ++c) av[j * r + c] = avail[node * r + c];
  }
  if (tid == 0) all_ok = 1;
  __syncthreads();
  for (int bi = 0; bi < b; ++bi) {
    const long long at = static_cast<long long>(grp) * b + bi;
    for (int j = tid; j < r; j += blockDim.x) sd[j] = demands[at * r + j];
    __syncthreads();
    float best = INF;
    int best_j = 0x7fffffff;
    for (int j = tid; j < k; j += blockDim.x) {
      bool can;
      const int node = cidx[j];
      const float sc =
          pack_score(av + j * r, total + node * r, alive[node], used[j], sd, r, mode, &can);
      if (before(sc, j, best, best_j)) best = sc, best_j = j;
    }
    const int jx = block_argmin(best, best_j, rk, ri);
    if (tid == 0) {
      bool can;
      const int node = cidx[jx];
      pack_score(av + jx * r, total + node * r, alive[node], used[jx], sd, r, mode, &can);
      const bool ok = can && valid[at];
      if (ok)
        for (int c = 0; c < r; ++c) av[jx * r + c] = __fsub_rn(av[jx * r + c], sd[c]);
      out[grp * (b + 1) + bi] = ok ? node : -1;
      all_ok &= ok || !valid[at];
      chosen = node;
      ok_flag = ok;
    }
    __syncthreads();
    // "used" by global node id: every slot dealt the chosen node (:150)
    if (ok_flag)
      for (int j = tid; j < k; j += blockDim.x)
        if (cidx[j] == chosen) used[j] = 1;
    __syncthreads();
  }
  if (tid == 0) out[grp * (b + 1) + b] = all_ok;
}

// Nothing: its launch measures the floor that any launch pays.
__global__ void empty_kernel() {}

int sort_smem_bytes(int n) {
  const int p = next_pow2(n);
  return p <= SMEM_SORT_MAX ? p * 8 : 0;
}

}  // namespace

// Floats of scratch that schedule_classes needs for n nodes and k classes.
extern "C" long long schedule_scratch_floats(int n, int k) { return scratch_floats(n, k); }

// avail, total: fp32 [n, r], avail updated in place; alive: bool [n];
// demands: fp32 [k, r]; counts, prefs: int32 [k]; packed: int32 [k, 4n+5];
// scratch: schedule_scratch_floats(n, k) floats.
extern "C" int schedule_classes(float* avail, const float* total, const uint8_t* alive,
                                const float* demands, const int* counts, const int* prefs,
                                float threshold, int n, int r, int k, int* packed, float* scratch,
                                long long scratch_len, void* stream) {
  if (n < 1 || r < 1 || r > MAX_R || k < 1 || n > (1 << 24) ||
      scratch_len < scratch_floats(n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sort_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(schedule_classes_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  schedule_classes_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      avail, total, alive, demands, counts, prefs, threshold, n, r, k, packed, scratch);
  return cudaGetLastError();
}

// avail: fp32 [n, r], the carried availability, updated in place; total:
// fp32 [n, r]; alive: bool [n]; demands: fp32 [b, r]; mode: 0 pack, 1
// spread, 2 strict_spread; used: bool [n], zeros; out: int32 [b + 1].
extern "C" int pg_pack(float* avail, const float* total, const uint8_t* alive,
                       const float* demands, int n, int r, int b, int mode, uint8_t* used, int* out,
                       void* stream) {
  if (n < 1 || r < 1 || r > MAX_R || b < 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  pg_pack_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      avail, total, alive, demands, n, r, b, mode, used, out);
  return cudaGetLastError();
}

// avail, total: fp32 [n, r]; alive: bool [n]; demands: fp32 [g, b, r];
// valid: bool [g, b]; ranked: int32 [2 next_pow2(n)]; slots: fp32
// [g, k, r + 2]; out: int32 [g, b + 1]. Two launches: the ranking, then
// one CTA per group.
extern "C" int pg_pack_batch(const float* avail, const float* total, const uint8_t* alive,
                             const float* demands, const uint8_t* valid, int n, int r, int g,
                             int b, int k, int mode, int* ranked, float* slots, int* out,
                             void* stream) {
  if (n < 1 || r < 1 || r > MAX_R || g < 1 || b < 0 || k < 1 || k > n || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = sort_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(pg_pack_rank_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pg_pack_rank_kernel<<<1, THREADS, smem, st>>>(avail, total, alive, n, r, mode, ranked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pg_pack_batch_kernel<<<g, 256, 0, st>>>(avail, total, alive, demands, valid, n, r, g, b, k,
                                          mode, ranked, slots, out);
  return cudaGetLastError();
}

// One launch of an empty kernel, for the launch floor beside each time.
extern "C" int scheduler_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
