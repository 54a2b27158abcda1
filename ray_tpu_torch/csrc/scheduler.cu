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
// - Orders are stable: (key, index) pairs compared by `before`, the index
//   breaking ties, which is jnp.argsort's order (and torch's with
//   stable=True); jnp.lexsort's (rarity, -pressure) order likewise.
// - Sums of integer-valued floats below 2^24 (capacities, placements) are
//   exact in any order. Two sums are not: the live supply of each
//   resource (it orders classes by pressure, and moves that order only
//   when two classes' pressures tie within an ulp) and sums past 2^24.
//   The supply is summed by one CTA over all nodes, as in the first
//   design; sums past 2^24 are summed in a fixed order, so they
//   are deterministic, and like the first design's they need not equal
//   the plain version's.
//
// What bounds them on this card. Each program moves little: at the
// scheduling benchmark's shape (10,000 nodes x 4 resources, 8 classes) the
// inputs are 0.3 MB and the output 1.3 MB, under a microsecond at 3.35
// TB/s. The time goes to a chain of dependent steps, each ending in a sum
// or an argmin over all nodes: per class a totals pass, 40 bisection
// steps, an ordering of the nodes and a scan; per bundle one argmin. The
// first design ran each chain in one CTA of 1024 threads with the node
// state read from L2 at every step (~720 us a class, ~12 us a bundle on an
// H100). This one runs it in one thread-block cluster of C CTAs, each
// owning a contiguous slice of ceil(N / C) nodes (rows), with the slice in
// its shared memory for the whole launch; the bound is the chain's length
// in exchanges between the CTAs, each ~1-2 us of warp shuffles, one CTA
// barrier, st.async into every CTA's shared memory and an mbarrier wait.
// C is 16 where the card admits a cluster of 16 (non-portable size), else
// 8 (CLUSTER_CHOICES): on an H100 (700 W) 16 took ~0.60 ms at the
// benchmark's shape against ~0.82 ms for 8, and both ~4.1 ms at
// schedule_batch's 1,024 nodes x 128 classes (512 threads a CTA, where
// 640 helped the first shape and slowed the second);
// ray_tpu_torch/tools/sched_design_sweep.py builds copies of this file
// with other cluster sizes and bisection levels and times them. A slice
// that does not fit (large N, or R near 64) stays in global memory, read
// as the first design read it, in the same cluster kernel.
//
// schedule_classes, per CTA: avail, total, used, alive, capacity, fill,
// sort keys and scan in shared memory (at 10,000 x 4 with C = 16: 625
// nodes and the other 15 slices' keys staged, ~166 KB). The steps, and why
// each gives the plain version's floats:
// - Hoisting. Per class, max(d, EPS) of each demanded resource and its
//   reciprocal, and in shared memory used = t - a of each node, computed
//   once with the ops x_of used before.
// - Exact quotients without the division's branch. floor((lam t - used) /
//   d) takes q = a y, r = fma(-q, d, a), q + r y with y = 1 / d rounded to
//   nearest (Markstein's theorem: a / d rounded to nearest, barring
//   overflow and underflow) where a range guard rules those out, and
//   IEEE / elsewhere (fast_quotient_ok).
// - Cluster sums. Each CTA sums its slice (warp shuffles that halve the
//   values a lane keeps, one barrier) and sends the partials to every CTA
//   with st.async; each thread adds the C partials in rank order. Every
//   sum here is of integer-valued floats, exact in any order below 2^24,
//   and each CTA adds the same values in the same order, so all hold the
//   same total and take the same branches.
// - The bisection evaluates 2^m - 1 midpoints a round: the next m levels
//   of the tree the sequential search walks, each 0.5 * (lo + hi) with
//   the same fp32 ops, then walks them. Every midpoint on the taken path is
//   the one the sequential search computes and its decision is the same
//   sum against the same bound, so the final (lo, hi) are identical for
//   any predicate; 40 steps become 40 / m rounds and 40 % m single steps.
//   m = 1 is the sequential search. m = 2 (LEVELS; 20 sums a class) took
//   ~0.60 ms at the benchmark's shape against ~0.62 ms for 3 and ~0.79 ms
//   for 1, and tied with 3 at schedule_batch's (~4.07 ms; 1: ~5.93 ms):
//   each further level halves the sums but doubles the midpoints a node
//   evaluates, and holds more values a sum in registers and shared memory.
// - No global sort. Each CTA sorts its slice's (util_after, index) keys,
//   packed into 64 bits in the order of `before`, with a bitonic network
//   whose strides below 32 run in registers with shuffles, scans its
//   sorted deltas, and pushes both to every other CTA with bulk copies
//   (cp.async.bulk, shared::cta to shared::cluster). A node's place in the
//   global stable order is its local rank plus, for every other CTA, the
//   number of that CTA's keys below its own (a binary search: merge-path
//   ranking); keys are distinct (distinct indices), so the rank is exact
//   and stable. Its cum, the inclusive scan of delta in that order, is its
//   local scan plus each other CTA's scan just below the search point,
//   integer-valued, so exact.
// - Everything else is the first design's: the class order (one CTA over
//   all nodes, as before), the commit scan, the residual pass, the packed
//   row layout.
//
// pg_pack: each CTA keeps its rows' avail, total, 1 / max(total, EPS),
// alive, used, base util (row_util's expression) and the bundles'
// demands in shared memory (1,024 rows a CTA at the solver's 16,384-row
// view, ~23 KB). A row's score does not depend on the bundle, only its
// feasibility does (a + EPS >= d, alive, !used for STRICT_SPREAD: no
// division), and only the placed row changes between bundles. Per bundle
// the (can ? score : INF, index) keys, packed into 64 bits, go to a warp
// shuffle, a shared-memory atomicMin and one barrier; the CTAs exchange
// their candidates with st.async and each thread takes the least. Min is
// exact in any order, so this is pack_plain's argmin (all rows infeasible:
// row 0, nothing placed). While the candidates travel, each thread scores
// its rows for the next bundle, exact for every row but the winner; the
// thread holding its CTA's candidate also prepares that row's state after
// winning (util by the exact quotient above where it applies) and its keys
// then, so the owner of the winner only commits. The bound is the
// scoring, a barrier and the exchange a bundle, ~1.9 us on an H100 (16
// CTAs: ~0.97 ms for 512 bundles against ~1.27 ms for 8 and ~1.85 ms for
// 4; 1024 threads a CTA were slower).
//
// pg_pack_batch (S3): the ranking of all N nodes, then G groups of B
// bundles over k candidates each. The first design sorted all N (key,
// index) pairs with a bitonic network in one CTA (a barrier a stage; in
// global memory past 16,384 keys) and gave each group a CTA of 256
// threads, its slots in global scratch and 4-5 block barriers a bundle:
// ~330 us at the benchmark's shape, ~310 of them the sort (2.1 ms at
// 40,000 nodes). Nothing here is bound by bytes (~0.1 us); each part is a
// chain of dependent steps. The ranking is one cluster with S1's tools
// (sort_slice, push_slice, merge_counts): each CTA keys its slice (the
// base score, INF for dead rows, packed with the index; each node's util
// kept in `ranked` for the groups), sorts it, pushes it to the other CTAs
// and places each key by merge path; where the other slices do not fit
// beside its own, they are searched in global memory. Then a grid of
// warps, one a group: lane l keeps slots l, l + 32, ... (4 at k = 128),
// their copies of avail and total, util, node and flags in shared memory
// (in `slots` where they do not fit). Per bundle a lane scores its slots
// from the cached util (no division, no branch), two __reduce_min_sync take
// the least (score, slot) key, which is argmin's first least slot, and the
// winner's lane commits it and recomputes its util; no barrier, and no
// global memory but the first loads. Its loops are not unrolled: the pass
// runs once, so code size is fetch time (an unrolled first version spent
// ~2 us a bundle there). The grid is the ranking's programmatic dependent
// launch: its CTAs start during the ranking, gather their bundles' demands
// and wait (griddepcontrol) before they read the order. Two launches, not
// one: the same solve inside the ranking's cluster (S3_FUSED) ties at 64
// groups but runs 1,024 groups in rounds over the cluster's warps at twice
// the time; clusters of 8 were slower at every shape
// (ray_tpu_torch/tools/sched_design_sweep.py times all four).
//
// Each entry point launches on the given stream, allocates nothing and
// returns a CUDA error code: 0, the launch's error, or
// cudaErrorInvalidValue for what it does not take. A cluster the card
// does not admit is refused with the launch's error; nothing falls back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 32;            // most warps of a CTA
constexpr int CT = 512;              // most threads of a cluster kernel's CTA
constexpr int CWARPS = CT / 32;
constexpr int MAX_C = 16;            // most CTAs of a cluster
// The cluster sizes a launch takes, the first the card admits (see the
// note above: 16 where it is admitted, else 8).
constexpr int CLUSTER_CHOICES[] = {16, 8};
constexpr int MAX_R = 64;            // resources a kernel takes
constexpr int LEVELS = 2;            // bisection levels a round
// Values a cluster sum carries: a round's 2^LEVELS - 1 midpoints, and at
// least the 3 of a class's opening sum.
constexpr int MAX_NV = (1 << LEVELS) - 1 > 3 ? (1 << LEVELS) - 1 : 3;
constexpr int BISECT_STEPS = 40;
constexpr float EPS = 1e-6f;
constexpr float UPPER_CLAMP = 1073741824.f;  // 2^30
constexpr float SPREAD_PENALTY = 1e3f;
constexpr float INF = __builtin_huge_valf();
constexpr unsigned FULL = 0xffffffffu;

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
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x + 31) / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
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

// A float key and a row index as one unsigned 64-bit key of the order of
// `before`: the float's bits folded so that unsigned order is float order
// (-0 taken as +0), the index below them.
__device__ __forceinline__ unsigned long long pack_key(float key, int idx) {
  const unsigned b = __float_as_uint(__fadd_rn(key, 0.f));
  const unsigned s = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(s) << 32) | static_cast<unsigned>(idx);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffull);
}

// The stages of a bitonic network with block sizes k_first..k_last whose
// strides are below 32, run in registers: each warp takes 32 consecutive
// keys at a time and exchanges them with shuffles.
__device__ void warp_stages(unsigned long long* key, int p, int k_first, int k_last) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < (p >> 5); g += blockDim.x >> 5) {
    const int at = (g << 5) | lane;
    unsigned long long kv = key[at];
    for (int k = k_first; k <= k_last; k <<= 1) {
      const bool ascending = (at & k) == 0;
      for (int j = min(k >> 1, 16); j > 0; j >>= 1) {
        const unsigned long long ko = __shfl_xor_sync(FULL, kv, j);
        // the lower slot of an ascending pair keeps the lesser, and so on
        const bool keep_less = ((at & j) == 0) == ascending;
        kv = keep_less == (ko < kv) ? ko : kv;
      }
    }
    key[at] = kv;
  }
}

// Sorts p >= 32 (a power of two) distinct keys ascending: a bitonic
// network whose strides below 32 run in registers (warp_stages), with one
// barrier per stride of 32 or more and one per block size for the register
// stages (15 + 5 barriers at 1024 keys, where one a stage takes 55).
__device__ void cta_sort(unsigned long long* key, int p) {
  warp_stages(key, p, 2, 32);
  __syncthreads();
  for (int k = 64; k <= p; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int t = threadIdx.x; t < (p >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // lower slot
        const unsigned long long ki = key[i], kl = key[i | j];
        if (((i & k) == 0) == (kl < ki)) key[i] = kl, key[i | j] = ki;
      }
      __syncthreads();
    }
    warp_stages(key, p, k, k);
    __syncthreads();
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
    const float y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < (blockDim.x + 31) / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    red[lane] = w;  // inclusive scan of warp totals
  }
  __syncthreads();
  float excl = __shfl_up_sync(FULL, incl, 1);  // this lane's chunks before it
  if (lane == 0) excl = 0.f;
  float run = (warp > 0 ? red[warp - 1] : 0.f) + excl;
  __syncthreads();
  for (int j = lo; j < hi; ++j) {
    run += x[j];
    out[j] = run;
  }
  __syncthreads();
}

// ------------------------------------------- exchanges without a barrier
//
// An exchange gives every CTA of the cluster one payload of each CTA
// without a cluster barrier: each CTA writes its payload
// into slot (t & 1) of every CTA's shared memory with st.async, whose
// completion is counted on that CTA's mbarrier for the slot, and each CTA
// waits on its own mbarrier (acquire at cluster scope; st.async releases at
// cluster scope, so what a CTA wrote before sending is visible after).
// `t` counts the exchanges, the same in every CTA. A slot is written again
// two exchanges later: a CTA sends exchange t + 2 only after it received
// t + 1 from every CTA, and each CTA sends t + 1 only after a barrier that
// follows every read of its slot for t.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory word in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival that announces `bytes` of st.async traffic to come.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void st_async(uint32_t remote, float4 v, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t remote, unsigned long long v, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(
                   remote),
               "l"(v), "r"(remote_bar)
               : "memory");
}

// Makes this CTA's shared-memory writes, ordered before by a barrier,
// visible to the bulk copies it issues next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// this CTA's shared memory to another CTA's, counted on that CTA's mbarrier.
__device__ __forceinline__ void bulk_push(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Both slots' mbarriers, initialised and armed for the first two
// exchanges of `bytes` each; a cluster barrier must follow before any CTA
// sends.
__device__ __forceinline__ void exchange_init(uint64_t* bar, uint32_t bytes) {
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar[0], bytes);
    mbar_expect(&bar[1], bytes);
  }
}

// Waits for exchange t's payloads, then rearms the slot for exchange t + 2.
__device__ __forceinline__ void exchange_wait(uint64_t* bar, int t, uint32_t bytes) {
  mbar_wait(&bar[t & 1], (t >> 1) & 1);
  if (threadIdx.x == 0) mbar_expect(&bar[t & 1], bytes);
}

constexpr int SUM_WORDS = 8;  // floats a CTA sends in a cluster sum
static_assert(SUM_WORDS >= MAX_NV && SUM_WORDS % 4 == 0, "a sum's payload holds its values");

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// Sums each of K (a power of two, at most 16) values over the warp with
// K - 1 + 5 - log2(K) shuffles: each step halves the values a lane keeps.
// Lane l returns the total of value l >> (5 - log2(K)). The order of the
// additions is fixed, so every warp that sums the same values gets the
// same totals.
template <int K>
__device__ __forceinline__ float warp_sum_many(float (&v)[K]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = K, o = 16; k > 1; k >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < k / 2; ++i) {
      const float send = upper ? v[i] : v[i + k / 2];
      const float keep = upper ? v[i + k / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  float x = v[0];
#pragma unroll
  for (int o = 16 >> log2_of(K); o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// The cluster's sums of v[0..NV), returned in v to every thread of every
// CTA: each CTA sums its threads' values (warp shuffles, one barrier), its
// first warp sends the partials to every CTA, and each thread adds the
// partials it received in rank order (the slots of absent ranks hold 0),
// so every CTA holds the same sums.
template <int NV>
__device__ void cluster_sum(float (&v)[MAX_NV], int& t, float (*wpart)[CWARPS],
                            float (*xbuf)[MAX_C][SUM_WORDS], uint64_t* xbar) {
  static_assert(NV <= MAX_NV, "v and wpart hold MAX_NV values");
  constexpr int K = pow2_at_least(NV), SHIFT = 5 - log2_of(K);
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = t & 1;
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = j < NV ? v[j] : 0.f;
  float x = warp_sum_many<K>(w);
  if ((lane & ((1 << SHIFT) - 1)) == 0 && (lane >> SHIFT) < NV) wpart[lane >> SHIFT][warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = j < NV && lane < nw ? wpart[j][lane] : 0.f;
    x = warp_sum_many<K>(w);
    float part[SUM_WORDS];
#pragma unroll
    for (int j = 0; j < SUM_WORDS; ++j) part[j] = j < NV ? __shfl_sync(FULL, x, j << SHIFT) : 0.f;
    if (lane < c) {
      const uint32_t dst = cluster_addr(&xbuf[slot][rank][0], lane);
      const uint32_t bar = cluster_addr(&xbar[slot], lane);
#pragma unroll
      for (int q = 0; q < SUM_WORDS / 4; ++q)
        st_async(dst + 16 * q, make_float4(part[4 * q], part[4 * q + 1], part[4 * q + 2],
                                           part[4 * q + 3]), bar);
    }
  }
  exchange_wait(xbar, t, c * SUM_WORDS * 4);
  float sum[4 * ((NV + 3) / 4)];
#pragma unroll
  for (int j = 0; j < 4 * ((NV + 3) / 4); ++j) sum[j] = 0.f;
#pragma unroll
  for (int o = 0; o < MAX_C; ++o) {
#pragma unroll
    for (int q = 0; q < (NV + 3) / 4; ++q) {
      const float4 p = reinterpret_cast<const float4*>(&xbuf[slot][o][0])[q];
      sum[4 * q] += p.x, sum[4 * q + 1] += p.y, sum[4 * q + 2] += p.z, sum[4 * q + 3] += p.w;
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = sum[j];
  ++t;
}

// The slice of rows a CTA of a cluster of c owns: [base, base + count).
struct Slice {
  int per, base, count;
};

__host__ __device__ Slice slice_of(int n, int c, int rank) {
  Slice s;
  s.per = (n + c - 1) / c;
  s.base = min(n, rank * s.per);
  s.count = min(n, s.base + s.per) - s.base;
  return s;
}

// Rows of the slice of `rank` when each slice holds `per`.
__host__ __device__ __forceinline__ int count_of(int n, int per, int rank) {
  return min(n, (rank + 1) * per) - min(n, rank * per);
}

__host__ __device__ int slice_sort_size(int per) { return max(32, next_pow2(per)); }

// ------------------------------------- merge-path ranking (S1 and S3)
//
// Each CTA sorts its slice's distinct packed keys; a key's place in the
// cluster's stable order is its place in its slice plus, for every other
// slice, the number of that slice's keys below it (a binary search). The
// other slices are staged beside a CTA's own in shared memory ([C - 1,
// spr] keys, by their place among the others: push_slice), or searched
// where they are in global memory, `stride` keys apart.

// Sorts the slice's cnt keys, padded to S with keys above all others.
__device__ __forceinline__ void sort_slice(unsigned long long* skey, int cnt, int S) {
  for (int i = cnt + threadIdx.x; i < S; i += blockDim.x) skey[i] = ~0ull;
  __syncthreads();
  cta_sort(skey, S);
}

// Rows of each other slice, by its place among the others.
__device__ __forceinline__ void peer_lengths(int n, int per, int rank, int c, int (&len)[MAX_C]) {
#pragma unroll
  for (int gi = 0; gi < MAX_C; ++gi) len[gi] = gi < c - 1 ? count_of(n, per, gi < rank ? gi : gi + 1) : 0;
}

// Bytes that the other CTAs push into this one's staging area: their keys
// and, with scans, their scans.
__host__ __device__ uint32_t staged_bytes(int n, int per, int rank, int c, bool scans) {
  uint32_t in = 0;
  for (int o = 0; o < c; ++o) {
    const int co = count_of(n, per, o);
    if (o != rank) in += 8u * ((co + 1) & ~1) + (scans ? 4u * ((co + 3) & ~3) : 0u);
  }
  return in;
}

// Pushes this CTA's sorted keys (and its scan, unless null) into every
// other CTA's staging area with bulk copies, counted on its `bar`; after a
// barrier that follows their last write.
__device__ __forceinline__ void push_slice(const unsigned long long* skey, const float* scan,
                                           unsigned long long* stage_key, float* stage_scan,
                                           int spr, int cnt, int rank, int c, uint64_t* bar) {
  const int na = scan ? 2 : 1, tid = threadIdx.x;
  if (tid < na * (c - 1) && cnt > 0) {
    const int o = tid / na < rank ? tid / na : tid / na + 1;  // the receiver
    const int at = rank < o ? rank : rank - 1;                // this slice there
    const uint32_t to = cluster_addr(bar, o);
    fence_proxy_async();
    if (tid % na == 1)
      bulk_push(cluster_addr(stage_scan + at * spr, o), scan, 4u * ((cnt + 3) & ~3), to);
    else
      bulk_push(cluster_addr(stage_key + at * spr, o), skey, 8u * ((cnt + 1) & ~1), to);
  }
}

// at[gi]: the keys below `me` in the gi-th other slice. Staged, `peers` is
// the staging area; else this CTA's keys in global memory.
template <bool STAGED>
__device__ __forceinline__ void merge_counts(unsigned long long me, int S, int rank,
                                             const unsigned long long* peers, long long stride,
                                             const int (&len)[MAX_C], int (&at)[MAX_C]) {
#pragma unroll
  for (int gi = 0; gi < MAX_C; ++gi) at[gi] = 0;
  for (int step = S; step > 0; step >>= 1) {
#pragma unroll
    for (int gi = 0; gi < MAX_C; ++gi) {
      const int next = at[gi] + step;
      if (next <= len[gi]) {
        const int o = gi < rank ? gi : gi + 1;
        const unsigned long long* keys = STAGED ? peers + gi * stride : peers + (o - rank) * stride;
        if (keys[next - 1] < me) at[gi] = next;
      }
    }
  }
}

// ------------------------------------------------- S1: schedule_classes

// The shared memory of a CTA that keeps its slice of `per` nodes there,
// with the other c - 1 slices' sorted keys and scans staged beside it
// (rows of per rounded up to 4): byte offsets of each array, each 16-byte
// aligned.
struct ScLayout {
  long long skey, stage_key, avail, total, used, cap, x_lo, delta, feas, scan, stage_scan, alive,
      bytes;
};

__host__ __device__ __forceinline__ long long bump(long long& at, long long bytes) {
  const long long here = at;
  at += (bytes + 15) / 16 * 16;
  return here;
}

__host__ __device__ ScLayout sc_layout(int per, int r, int c) {
  const long long sort = slice_sort_size(per), staged = (c - 1LL) * ((per + 3) & ~3);
  ScLayout l;
  long long at = 0;
  l.skey = bump(at, 8 * sort);          // sorted (util_after, index) keys
  l.stage_key = bump(at, 8 * staged);   // other slices' keys
  l.avail = bump(at, 4LL * per * r);
  l.total = bump(at, 4LL * per * r);
  l.used = bump(at, 4LL * per * r);
  l.cap = bump(at, 4LL * per);
  l.x_lo = bump(at, 4LL * per);
  l.delta = bump(at, 4LL * per);
  l.feas = bump(at, 4LL * per);
  l.scan = bump(at, 4 * sort);
  l.stage_scan = bump(at, 4 * staged);
  l.alive = bump(at, per);
  l.bytes = at;
  return l;
}

__host__ __device__ long long sc_smem_bytes(int per, int r, int c) {
  return sc_layout(per, r, c).bytes;
}

// Global scratch of the cluster kernel, in floats: the class order and the
// per-class records (k each, and per CTA), then, for slices kept in global
// memory, each CTA's sorted keys [S] (two floats each), scan [S] and cap,
// x_lo, delta, feasible [per].
__host__ __device__ long long sc_class_floats(int k) {
  return (3LL * k + 4LL * MAX_C * k + 3) / 4 * 4;
}

__host__ __device__ long long sc_slice_floats(int per) {
  return 3LL * slice_sort_size(per) + 4LL * per;
}

long long scratch_floats(int n, int k) {
  long long most = 0;
  for (int c : CLUSTER_CHOICES) {
    const long long f = c * sc_slice_floats((n + c - 1) / c);
    most = f > most ? f : most;
  }
  return sc_class_floats(k) + most;
}

// Per-class state of the launch, in global scratch. `perm` is written by
// CTA 0 before the first cluster barrier; the rest, [MAX_C][k] each, by
// each CTA for itself.
struct ClassState {
  int* perm;       // [k] commit order: perm[c] is the class committed c-th
  float* rarity;   // [k]
  float* npress;   // [k] -pressure
  float* local;    // local_take of the class committed c-th, this CTA's copy
  float* admitted;
  float* take_sum;
  float* residual;
};

__device__ ClassState class_state(float* base, int k, int rank) {
  ClassState s;
  s.perm = reinterpret_cast<int*>(base);
  s.rarity = base + k;
  s.npress = s.rarity + k;
  float* mine = s.npress + k + 4LL * k * rank;
  s.local = mine;
  s.admitted = mine + k;
  s.take_sum = mine + 2 * k;
  s.residual = mine + 3 * k;
  return s;
}

// The scarcity order of the classes (tpu_policy.py:137-155), by one CTA
// over all nodes, as the first design computed it: perm, rarity, npress.
__device__ void class_order(const float* avail, const float* total, const uint8_t* alive,
                            const float* demands, const int* counts, int n, int r, int k,
                            const ClassState& s, float* red, float* res_frac, float* pressure) {
  const int tid = threadIdx.x;
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
}

// One CTA's view of its slice, in shared memory (SMEM) or in global
// memory; `used` and the staging area only in shared memory.
struct NodeSlice {
  float* avail;              // [count, r]
  const float* total;        // [count, r]
  const uint8_t* alive;      // [count]
  float* used;               // [count, r], SMEM only
  float* cap;                // [count]
  float* x_lo;
  float* delta;
  float* feas;               // 1 where the class fits the node's totals
  unsigned long long* skey;  // [S] the slice's (util_after, index) keys, sorted
  float* scan;               // [S] inclusive scan of delta in that order
  unsigned long long* stage_key;  // [C - 1, per] other slices' keys, SMEM only
  float* stage_scan;              // [C - 1, per] and their scans
};

// used = t - a of local node i, resource j; `qrow` replaces the avail row
// of the preferred node `q` (local index, or -1) during its class.
template <bool SMEM>
__device__ __forceinline__ float used_of(const NodeSlice& ns, int r, int i, int j, int q,
                                         const float* qrow) {
  if (SMEM) return ns.used[i * r + j];
  const float a = i == q ? qrow[j] : ns.avail[i * r + j];
  return __fsub_rn(ns.total[i * r + j], a);
}

// x_n(lam) of local node i (tpu_policy.py:225-232): the tasks it absorbs
// before exceeding utilization lam, clipped to [0, cap]; `jd` lists the
// class's nd demanded resources, `dsafe` their max(d, EPS).
template <bool SMEM>
__device__ __forceinline__ float x_at(float lam, const NodeSlice& ns, int r, int i, const int* jd,
                                      const float* dsafe, int nd, int q, const float* qrow) {
  float m = INF;
  for (int jj = 0; jj < nd; ++jj) {
    const int j = jd[jj];
    const float head = __fsub_rn(__fmul_rn(lam, ns.total[i * r + j]),
                                 used_of<SMEM>(ns, r, i, j, q, qrow));
    m = fminf(m, floorf(head / dsafe[jj]));
  }
  return fminf(fmaxf(m, 0.f), ns.cap[i]);
}

// a / d rounded to nearest, for d = dsafe[jj] with y = 1 / d rounded to
// nearest: q = a y, r = a - q d (exact by the fma), q + r y rounded
// (Markstein's theorem: with y within half an ulp of 1 / d and q within
// one ulp of a / d, that is a / d rounded to nearest, barring overflow and
// underflow). Three instructions and no branch, where / takes a dozen and
// a branch to its slow path. Taken only where fast_quotient_ok holds.
__device__ __forceinline__ float fast_quotient(float a, float d, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, d, a), y, q);
}

// Where a = lam t - used (lam in [2^-41, 1], or 0) stays in the range that
// fast_quotient takes exactly: t and used each 0 or of magnitude in
// [2^-60, 2^60], and d at most 2^20 (d >= EPS > 2^-20 always). Then a is 0
// or at least 2^-124 in magnitude and a / d at least 2^-144: never rounded
// to zero, of a's sign, and below 2^81; floor() of it is that of a / d.
__device__ __forceinline__ bool fast_quotient_ok(float t, float used, bool d_ok) {
  const float at = fabsf(t), au = fabsf(used);
  return d_ok && (t == 0.f || (at >= 0x1p-60f && at <= 0x1p60f)) &&
         (used == 0.f || (au >= 0x1p-60f && au <= 0x1p60f));
}

// One bisection round of L levels: the 2^L - 1 midpoints of the next L
// levels of the sequential search's tree (heap order), the cluster's sums
// of x_n at each, then the walk down the tree; lo and hi become what L
// sequential steps give. `ydsafe` holds 1 / dsafe, `d_ok` whether every
// dsafe is at most 2^20.
template <bool SMEM, int L>
__device__ __forceinline__ void bisect_round(float& lo, float& hi, float remaining,
                                             const NodeSlice& ns, int r, int cnt, const int* jd,
                                             const float* dsafe, const float* ydsafe, bool d_ok,
                                             int nd, int q, const float* qrow, float (&v)[MAX_NV],
                                             int& t, float (*wpart)[CWARPS],
                                             float (*xbuf)[MAX_C][SUM_WORDS], uint64_t* xbar) {
  constexpr int NV = (1 << L) - 1;
  float mid[NV + 1], lo_h[NV + 1], hi_h[NV + 1];
  lo_h[1] = lo, hi_h[1] = hi;
#pragma unroll
  for (int h = 1; h <= NV; ++h) {
    mid[h] = __fmul_rn(0.5f, __fadd_rn(lo_h[h], hi_h[h]));
    if (2 * h + 1 <= NV) {
      lo_h[2 * h] = lo_h[h], hi_h[2 * h] = mid[h];
      lo_h[2 * h + 1] = mid[h], hi_h[2 * h + 1] = hi_h[h];
    }
  }
#pragma unroll
  for (int h = 0; h < NV; ++h) v[h] = 0.f;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    float m[NV];
#pragma unroll
    for (int h = 0; h < NV; ++h) m[h] = INF;
    for (int jj = 0; jj < nd; ++jj) {
      const int j = jd[jj];
      const float tj = ns.total[i * r + j];
      const float u = used_of<SMEM>(ns, r, i, j, q, qrow);
      const float dj = dsafe[jj];
      if (fast_quotient_ok(tj, u, d_ok)) {
        const float y = ydsafe[jj];
#pragma unroll
        for (int h = 0; h < NV; ++h)
          m[h] = fminf(m[h], floorf(fast_quotient(__fsub_rn(__fmul_rn(mid[h + 1], tj), u), dj, y)));
      } else {
#pragma unroll
        for (int h = 0; h < NV; ++h)
          m[h] = fminf(m[h], floorf(__fsub_rn(__fmul_rn(mid[h + 1], tj), u) / dj));
      }
    }
    const float cap = ns.cap[i];
#pragma unroll
    for (int h = 0; h < NV; ++h) v[h] += fminf(fmaxf(m[h], 0.f), cap);
  }
  cluster_sum<NV>(v, t, wpart, xbuf, xbar);
  // the walk: heap index h, and the last turns right (lo) and left (hi)
  int h = 1, at_lo = 0, at_hi = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float vh = 0.f;
#pragma unroll
    for (int x = 1 << l; x < 2 << l; ++x)
      if (x == h) vh = v[x - 1];
    const bool ge = vh >= remaining;
    at_hi = ge ? h : at_hi;
    at_lo = ge ? at_lo : h;
    h = 2 * h + (ge ? 0 : 1);
  }
#pragma unroll
  for (int x = 1; x <= NV; ++x) {
    if (x == at_lo) lo = mid[x];
    if (x == at_hi) hi = mid[x];
  }
}

// The cluster kernel: K classes (tpu_policy.py:156-311) over the slices
// of one cluster of C CTAs, the other slices staged in shared memory
// (SMEM).
template <bool SMEM>
__global__ void __launch_bounds__(CT, 1)
schedule_classes_cluster(float* __restrict__ avail, const float* __restrict__ total,
                         const uint8_t* __restrict__ alive, const float* __restrict__ demands,
                         const int* __restrict__ counts, const int* __restrict__ prefs,
                         float threshold, int n, int r, int k, int* __restrict__ packed,
                         float* scratch) {
  extern __shared__ float4 smem4[];
  __shared__ float wpart[MAX_NV][CWARPS];
  __shared__ __align__(16) float xbuf[2][MAX_C][SUM_WORDS];
  __shared__ uint64_t xbar[2];
  __shared__ float red[WARPS + 1];
  __shared__ float sd[MAX_R], dsafe[MAX_R], ydsafe[MAX_R], qrow[MAX_R];
  __shared__ float res_frac[MAX_R], pressure[MAX_R];
  __shared__ int jd[MAX_R];
  __shared__ int nd_s, d_ok_s;
  __shared__ uint64_t stage_bar;  // the other slices' keys and scans pushed here
  __shared__ float bcast[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, T = blockDim.x;
  const Slice sl = slice_of(n, C, rank);
  const int cnt = sl.count, base = sl.base, per = sl.per;
  const int S = slice_sort_size(per);
  const long long row = 4LL * n + 5;
  const long long region = sc_slice_floats(per);  // a CTA's scratch, SMEM off
  const ClassState cs = class_state(scratch, k, rank);

  NodeSlice ns;
  if (SMEM) {
    char* sm = reinterpret_cast<char*>(smem4);
    const ScLayout l = sc_layout(per, r, C);
    ns.skey = reinterpret_cast<unsigned long long*>(sm + l.skey);
    ns.stage_key = reinterpret_cast<unsigned long long*>(sm + l.stage_key);
    ns.avail = reinterpret_cast<float*>(sm + l.avail);
    float* t = reinterpret_cast<float*>(sm + l.total);
    ns.total = t;
    ns.used = reinterpret_cast<float*>(sm + l.used);
    ns.cap = reinterpret_cast<float*>(sm + l.cap);
    ns.x_lo = reinterpret_cast<float*>(sm + l.x_lo);
    ns.delta = reinterpret_cast<float*>(sm + l.delta);
    ns.feas = reinterpret_cast<float*>(sm + l.feas);
    ns.scan = reinterpret_cast<float*>(sm + l.scan);
    ns.stage_scan = reinterpret_cast<float*>(sm + l.stage_scan);
    uint8_t* al = reinterpret_cast<uint8_t*>(sm + l.alive);
    ns.alive = al;
    // the slice, loaded once: 16-byte loads where the rows align
    const long long off = static_cast<long long>(base) * r, len = static_cast<long long>(cnt) * r;
    if ((off & 3) == 0 && (len & 3) == 0) {
      const float4* a4 = reinterpret_cast<const float4*>(avail + off);
      const float4* t4 = reinterpret_cast<const float4*>(total + off);
      for (long long e = tid; e < len / 4; e += T) {
        reinterpret_cast<float4*>(ns.avail)[e] = a4[e];
        reinterpret_cast<float4*>(t)[e] = t4[e];
      }
    } else {
      for (long long e = tid; e < len; e += T) ns.avail[e] = avail[off + e], t[e] = total[off + e];
    }
    for (int i = tid; i < cnt; i += T) al[i] = alive[base + i];
  } else {
    float* mine = scratch + sc_class_floats(k) + rank * region;
    ns.avail = avail + static_cast<long long>(base) * r;
    ns.total = total + static_cast<long long>(base) * r;
    ns.alive = alive + base;
    ns.used = nullptr;
    ns.skey = reinterpret_cast<unsigned long long*>(mine);
    ns.scan = mine + 2 * S;
    ns.cap = ns.scan + S;
    ns.x_lo = ns.cap + per;
    ns.delta = ns.x_lo + per;
    ns.feas = ns.delta + per;
    ns.stage_key = nullptr;
    ns.stage_scan = nullptr;
  }
  for (int e = tid; e < 2 * MAX_C * SUM_WORDS; e += T) (&xbuf[0][0][0])[e] = 0.f;
  exchange_init(xbar, C * SUM_WORDS * 4);
  // In shared memory, each CTA pushes its sorted keys and scan to every
  // other CTA with bulk copies; these are the bytes a CTA receives at each
  // class.
  const int spr = (per + 3) & ~3;  // a staged slice's row
  const uint32_t pushed_in = staged_bytes(n, per, rank, C, true);
  if (SMEM && tid == 0) {
    mbar_init(&stage_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&stage_bar, pushed_in);
  }
  int merges = 0;  // classes merged so far (the parity of stage_bar)
  if (rank == 0) {
    class_order(avail, total, alive, demands, counts, n, r, k, cs, red, res_frac, pressure);
    __threadfence();
  }
  cluster.sync();  // perm, every slice loaded, the exchange's barriers armed

  int t_sum = 0;          // cluster sums so far
  float take_part = 0.f;  // this thread's takes of the last class, summed at the next sum
  float v[MAX_NV];        // the values of a cluster sum
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = 0; c < k; ++c) {
      const int cls = cs.perm[c];
      __syncthreads();  // every thread is past the last class's use of sd and qrow
      for (int j = tid; j < r; j += T) sd[j] = demands[cls * r + j];
      if (tid == 0) {
        int nd = 0, d_ok = 1;
        for (int j = 0; j < r; ++j) {
          const float d = demands[cls * r + j];
          if (d > 0.f) {
            jd[nd] = j, dsafe[nd] = fmaxf(d, EPS), ydsafe[nd] = 1.f / dsafe[nd], ++nd;
            d_ok &= dsafe[nd - 1] <= 0x1p20f;
          }
        }
        nd_s = nd, d_ok_s = d_ok;
      }
      __syncthreads();
      const int nd = nd_s;
      const bool d_ok = d_ok_s != 0;
      const float countf = pass == 0 ? static_cast<float>(counts[cls]) : cs.residual[c];
      const int pref = pass == 0 ? prefs[cls] : -1;
      int* out_row = packed + cls * row;
      int* row_order = out_row + 5 + 2LL * pass * n;
      int* row_take = out_row + 5 + (2LL * pass + 1) * n;

      // The capacity bound from node totals, the fence (:168-181); the
      // takes of the class before ride along.
      {
        float sum_tot = 0.f, n_feas = 0.f;
        for (int i = tid; i < cnt; i += T) {
          float m = INF;
          for (int jj = 0; jj < nd; ++jj)
            m = fminf(m, __fadd_rn(ns.total[i * r + jd[jj]], EPS) / dsafe[jj]);
          const float cap_tot = ns.alive[i] ? floorf(m) : 0.f;
          ns.feas[i] = cap_tot >= 1.f ? 1.f : 0.f;
          sum_tot += cap_tot;
          n_feas += cap_tot >= 1.f ? 1.f : 0.f;
        }
        v[0] = sum_tot, v[1] = n_feas, v[2] = take_part;
        cluster_sum<3>(v, t_sum, wpart, xbuf, xbar);
        take_part = 0.f;
        if (pass == 0 && c > 0 && tid == 0) cs.take_sum[c - 1] = v[2];
      }
      const float upper = fminf(v[0], UPPER_CLAMP);
      const float any_feasible = v[1] > 0.f ? 1.f : 0.f;
      float fenced = fmaxf(__fsub_rn(countf, upper), 0.f);
      fenced = countf > 0.f ? fenced : 0.f;
      const float target = __fsub_rn(countf, fenced);

      // Phase 1 (:198-215): every CTA computes the preferred node's take
      // from its row (its owner's shared memory, read before the owner
      // changes it at the class's end); the owner keeps the row after it.
      float lt = 0.f;
      int q_local = -1;
      if (pref >= 0) {
        const int q = pref;
        const int owner = q / per;
        if (tid == 0) {
          const int ql = q - owner * per;
          const float* aq = SMEM ? cluster.map_shared_rank(ns.avail, owner) + ql * r
                                 : avail + static_cast<long long>(q) * r;
          const float* tq = total + static_cast<long long>(q) * r;
          float m_tot = INF, m = INF, util = -INF, c_min = INF;
          for (int j = 0; j < r; ++j) {
            const float a = aq[j], tj = tq[j];
            const float used = __fsub_rn(tj, a);
            util = fmaxf(util, tj > 0.f ? used / fmaxf(tj, EPS) : 0.f);
            if (sd[j] > 0.f) {
              const float dj = fmaxf(sd[j], EPS);
              m_tot = fminf(m_tot, __fadd_rn(tj, EPS) / dj);
              m = fminf(m, __fadd_rn(a, EPS) / dj);
              c_min = fminf(c_min, ceilf(__fsub_rn(__fmul_rn(threshold, tj), used) / dj));
            }
          }
          const bool feas = (alive[q] ? floorf(m_tot) : 0.f) >= 1.f;
          const float cap_q = feas ? fminf(floorf(m), target) : 0.f;
          const float c_thresh = fmaxf(c_min, 0.f);
          float take = util < threshold ? fminf(fminf(c_thresh, cap_q), target) : 0.f;
          take = countf > 0.f ? take : 0.f;
          bcast[0] = take;
          if (owner == rank)
            for (int j = 0; j < r; ++j) qrow[j] = __fsub_rn(aq[j], __fmul_rn(take, sd[j]));
        }
        __syncthreads();
        lt = bcast[0];
        if (owner == rank) q_local = q - owner * per;
      }
      const float remaining = __fsub_rn(target, lt);

      // Per-node capacity now (:183-191) and, in shared memory, used.
      float sum_cap = 0.f;
      for (int i = tid; i < cnt; i += T) {
        float m = INF;
        for (int jj = 0; jj < nd; ++jj)
          m = fminf(m, __fadd_rn(ns.avail[i * r + jd[jj]], EPS) / dsafe[jj]);
        const float cap = ns.feas[i] != 0.f ? fminf(floorf(m), target) : 0.f;
        sum_cap += cap;
        ns.cap[i] = i == q_local ? __fsub_rn(cap, lt) : cap;
        if (SMEM) {
          const float* a = i == q_local ? qrow : ns.avail + i * r;
          for (int j = 0; j < r; ++j) ns.used[i * r + j] = __fsub_rn(ns.total[i * r + j], a[j]);
        }
      }

      // Phase 2 (:225-242): the bisection, 2^LEVELS - 1 midpoints a sum,
      // then single steps for the last BISECT_STEPS % LEVELS.
      float lo = 0.f, hi = 1.f;
      if (remaining > 0.f) {
        for (int round = 0; round < BISECT_STEPS / LEVELS; ++round)
          bisect_round<SMEM, LEVELS>(lo, hi, remaining, ns, r, cnt, jd, dsafe, ydsafe, d_ok, nd,
                                     q_local, qrow, v, t_sum, wpart, xbuf, xbar);
        for (int step = 0; step < BISECT_STEPS % LEVELS; ++step)
          bisect_round<SMEM, 1>(lo, hi, remaining, ns, r, cnt, jd, dsafe, ydsafe, d_ok, nd,
                                q_local, qrow, v, t_sum, wpart, xbuf, xbar);
      } else {  // every sum is >= 0 >= remaining: the search only lowers hi
        for (int step = 0; step < BISECT_STEPS; ++step) hi = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      }

      // x_lo, delta and the post-fill utilization (:243-250); each CTA
      // sorts its slice and scans its deltas in that order.
      float sum_xl = 0.f;
      for (int i = tid; i < cnt; i += T) {
        const float xl = x_at<SMEM>(lo, ns, r, i, jd, dsafe, nd, q_local, qrow);
        ns.x_lo[i] = xl;
        ns.delta[i] = fmaxf(__fsub_rn(x_at<SMEM>(hi, ns, r, i, jd, dsafe, nd, q_local, qrow), xl), 0.f);
        float u = -INF;
        for (int j = 0; j < r; ++j) {
          const float tj = ns.total[i * r + j];
          const float used = used_of<SMEM>(ns, r, i, j, q_local, qrow);
          u = fmaxf(u, tj > 0.f ? __fadd_rn(used, __fmul_rn(xl, sd[j])) / fmaxf(tj, EPS) : 0.f);
        }
        ns.skey[i] = pack_key(u, base + i);
        sum_xl += xl;
      }
      sort_slice(ns.skey, cnt, S);
      for (int p = tid; p < cnt; p += T) ns.scan[p] = ns.delta[key_index(ns.skey[p]) - base];
      __syncthreads();
      block_inclusive_scan(ns.scan, ns.scan, cnt, red);
      if (SMEM) push_slice(ns.skey, ns.scan, ns.stage_key, ns.stage_scan, spr, cnt, rank, C, &stage_bar);
      v[0] = sum_xl, v[1] = sum_cap;
      cluster_sum<2>(v, t_sum, wpart, xbuf, xbar);  // every slice sorted and scanned
      const float deficit = fmaxf(__fsub_rn(remaining, v[0]), 0.f);
      if (tid == 0 && pass == 0) {
        cs.local[c] = lt;
        cs.admitted[c] = fminf(target, v[1]);
        if (rank == 0) {
          out_row[0] = __float2int_rz(lt);
          out_row[1] = __float2int_rz(any_feasible);
          out_row[2] = __float2int_rz(fenced);
          out_row[3] = __float2int_rz(fminf(target, v[1]));
          out_row[4] = __float2int_rz(upper);
        }
      }

      // Each node's place in the global order and its cum, by merge-path
      // ranking against the other slices (pushed here, in shared memory,
      // or searched where they are, in global memory), then the remainder
      // in that order (:252-258).
      if (SMEM && C > 1) {
        mbar_wait(&stage_bar, merges & 1);
        if (tid == 0) mbar_expect(&stage_bar, pushed_in);
        ++merges;
      }
      int len[MAX_C];
      peer_lengths(n, per, rank, C, len);
      for (int p = tid; p < cnt; p += T) {
        const unsigned long long me = ns.skey[p];
        int at[MAX_C];
        merge_counts<SMEM>(me, S, rank, SMEM ? ns.stage_key : ns.skey, SMEM ? spr : region / 2,
                           len, at);
        int place = p;
        float cum = ns.scan[p];
#pragma unroll
        for (int gi = 0; gi < MAX_C; ++gi) {
          if (at[gi] > 0) {
            const int o = gi < rank ? gi : gi + 1;
            place += at[gi];
            cum += SMEM ? ns.stage_scan[gi * spr + at[gi] - 1] : (ns.scan + (o - rank) * region)[at[gi] - 1];
          }
        }
        const int gnode = key_index(me);
        const int i = gnode - base;
        const float ds = ns.delta[i];
        const float extra = fminf(fmaxf(__fsub_rn(deficit, __fsub_rn(cum, ds)), 0.f), ds);
        const float take = __fadd_rn(ns.x_lo[i], extra);
        row_order[place] = gnode;
        row_take[place] = __float2int_rz(take);
        const float* a = i == q_local ? qrow : ns.avail + i * r;
        for (int j = 0; j < r; ++j) ns.avail[i * r + j] = __fsub_rn(a[j], __fmul_rn(take, sd[j]));
        take_part += take;
      }
    }

    // The last class's takes; then the residual pass (:277-298) only when
    // an admitted task was left unplaced.
    v[0] = take_part;
    cluster_sum<1>(v, t_sum, wpart, xbuf, xbar);
    take_part = 0.f;
    if (pass == 1) break;
    if (tid == 0) {
      cs.take_sum[k - 1] = v[0];
      float total_residual = 0.f;
      for (int c = 0; c < k; ++c) {
        const float placed = fminf(__fadd_rn(cs.local[c], cs.take_sum[c]), cs.admitted[c]);
        cs.residual[c] = fmaxf(__fsub_rn(cs.admitted[c], placed), 0.f);
        total_residual += cs.residual[c];
      }
      bcast[1] = total_residual;
    }
    __syncthreads();
    if (!(bcast[1] > 0.f)) {
      const long long all = 2LL * n * k;
      for (long long e = static_cast<long long>(rank) * T + tid; e < all;
           e += static_cast<long long>(C) * T) {
        const long long cls = e / (2LL * n);
        packed[cls * row + 5 + 2LL * n + e % (2LL * n)] = 0;
      }
      break;
    }
  }

  if (SMEM) {
    __syncthreads();
    const long long off = static_cast<long long>(base) * r, len = static_cast<long long>(cnt) * r;
    for (long long e = tid; e < len; e += T) avail[off + e] = ns.avail[e];
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

// ------------------------------------------------------ S2: pg_pack

__device__ __forceinline__ unsigned long long warp_min64(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Critical utilization of a row (pg_kernel.py:60): max_r of used / total.
__device__ __forceinline__ float row_util(const float* a, const float* t, int r) {
  float util = -INF;
  for (int j = 0; j < r; ++j)
    util = fmaxf(util, t[j] > 0.f ? __fsub_rn(t[j], a[j]) / fmaxf(t[j], EPS) : 0.f);
  return util;
}

// Feasibility and score of one row for one bundle (pg_kernel.py:56-73),
// from its utilization.
__device__ __forceinline__ float row_score(const float* a, float util, bool alive, bool used,
                                           const float* d, int r, int mode, bool* can_out) {
  bool can = alive;
#pragma unroll 4
  for (int j = 0; j < r; ++j) can = can & (!(d[j] > 0.f) || __fadd_rn(a[j], EPS) >= d[j]);
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

// Demands a pg_pack CTA keeps in shared memory (more stay in global).
constexpr int PG_SMEM_DEMANDS = 8192;

// Shared memory of a pg_pack CTA keeping its slice of `per` rows: avail,
// total and 1 / max(total, EPS) [per, r], util [per], the bundles' demands
// [b, r] where they fit, alive and used [per].
__host__ __device__ long long pg_smem_bytes(int per, int r, int b) {
  const long long dem = 1LL * b * r <= PG_SMEM_DEMANDS ? 1LL * b * r : 0;
  return ((12LL * per * r + 4LL * per + 4 * dem + 2LL * per) + 15) / 16 * 16;
}

// A pg_pack CTA's rows: avail, total [count, r], util and 1 / max(total,
// EPS) (SMEM only), alive and used [count].
struct PackRows {
  float* av;
  const float* tt;
  float* util;
  const float* yt;
  uint8_t* al;
  uint8_t* us;
  int count, base, r, mode;
};

// The least keys of this thread's rows for bundle bj, from the rows as
// they stand: over all of them, and over all but row `skip` (local, or -1).
template <bool SMEM>
__device__ __forceinline__ void next_keys(const PackRows& rows, const float* dem, int b, int bj,
                                          int skip, unsigned long long* all,
                                          unsigned long long* but_skip) {
  unsigned long long least = ~0ull, least_but = ~0ull;
  if (bj < b) {
    const int r = rows.r;
    const float* d = dem + static_cast<long long>(bj) * r;
    for (int i = threadIdx.x; i < rows.count; i += blockDim.x) {
      bool can;
      const float* a = rows.av + i * r;
      const float u = SMEM ? rows.util[i] : row_util(a, rows.tt + i * r, r);
      const float sc = row_score(a, u, rows.al[i], rows.us[i], d, r, rows.mode, &can);
      const unsigned long long key = pack_key(sc, rows.base + i);
      least = key < least ? key : least;
      if (i != skip) least_but = key < least_but ? key : least_but;
    }
  }
  *all = least, *but_skip = least_but;
}

// x / D rounded to nearest, D = max(t, EPS) and y = 1 / D rounded to
// nearest, by fast_quotient where it is exact: D at most 2^60 and x 0 or
// of magnitude in [2^-60, 2^60], so every step is a normal float.
__device__ __forceinline__ float util_quotient(float x, float t, float y) {
  const float dd = fmaxf(t, EPS), ax = fabsf(x);
  const bool fast = dd <= 0x1p60f && (x == 0.f || (ax >= 0x1p-60f && ax <= 0x1p60f));
  return fast ? fast_quotient(x, dd, y) : x / dd;
}

// util of local row i after d is taken from it (row_util's expression).
template <bool SMEM>
__device__ __forceinline__ float util_after(const PackRows& rows, int i, const float* d) {
  float u = -INF;
  for (int j = 0; j < rows.r; ++j) {
    const int e = i * rows.r + j;
    const float t = rows.tt[e];
    const float x = __fsub_rn(t, __fsub_rn(rows.av[e], d[j]));
    u = fmaxf(u, t > 0.f ? (SMEM ? util_quotient(x, t, rows.yt[e]) : x / fmaxf(t, EPS)) : 0.f);
  }
  return u;
}

// The key of local row i for bundle demand d once it has won demand d_win:
// avail less d_win, util u_win, used set.
__device__ __forceinline__ unsigned long long won_key(const PackRows& rows, int i, const float* d,
                                                      const float* d_win, float u_win) {
  const float* a = rows.av + i * rows.r;
  bool can = rows.al[i] != 0;
  for (int j = 0; j < rows.r; ++j)
    can = can & (!(d[j] > 0.f) || __fadd_rn(__fsub_rn(a[j], d_win[j]), EPS) >= d[j]);
  float sc = rows.mode == 0 ? -u_win : rows.mode == 1 ? __fadd_rn(u_win, SPREAD_PENALTY) : u_win;
  can = can && rows.mode != 2;  // STRICT_SPREAD: the row is used now
  return pack_key(can ? sc : INF, rows.base + i);
}

// Thread tid of a CTA owns local rows tid, tid + T, ...; the owner of the
// winner updates it, so no barrier orders that update before the next
// bundle's scoring. Per bundle: the CTA's least key by warp shuffles and a
// shared-memory atomicMin (slot bi & 1 of `best_s`), one barrier, an
// exchange of the C candidates (`cand`), then each thread takes the least.
// While the exchange travels, each thread scores its rows for the next
// bundle, and the thread holding the CTA's candidate prepares its row's
// state after winning, so that the owner of the winner only commits.
// (Reducing the next candidate for both outcomes during the exchange, to
// send it without a barrier, measured slower: the barrier is not the
// bound, the scoring is.)
template <bool SMEM>
__global__ void __launch_bounds__(CT, 1)
pg_pack_cluster(float* __restrict__ avail, const float* __restrict__ total,
                const uint8_t* __restrict__ alive, const float* __restrict__ demands, int n,
                int r, int b, int mode, uint8_t* __restrict__ used, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  // The CTA's least key of bundle bi in best_s[bi % 3]: filled before
  // bundle bi's barrier, read after it, emptied after bundle bi + 1's and
  // filled again before bundle bi + 3's, each step past a barrier.
  __shared__ unsigned long long best_s[3];
  __shared__ __align__(16) unsigned long long cand[2][MAX_C];
  __shared__ uint64_t xbar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const Slice sl = slice_of(n, C, rank);
  const int cnt = sl.count, base = sl.base;
  const float* tt = total + static_cast<long long>(base) * r;
  const float* dem = demands;
  float* av;
  float* util = nullptr;
  const float* yt = nullptr;
  uint8_t *al, *us;
  if (SMEM) {
    av = reinterpret_cast<float*>(smem4);
    float* ts = av + sl.per * r;
    float* ys = ts + sl.per * r;
    yt = ys;
    util = ys + sl.per * r;
    float* ds = util + sl.per;
    const bool dem_here = 1LL * b * r <= PG_SMEM_DEMANDS;
    al = reinterpret_cast<uint8_t*>(ds + (dem_here ? b * r : 0));
    us = al + sl.per;
    for (int e = tid; e < cnt * r; e += T) {
      av[e] = avail[static_cast<long long>(base) * r + e];
      ts[e] = tt[e];
      ys[e] = 1.f / fmaxf(tt[e], EPS);
    }
    if (dem_here) {
      for (int e = tid; e < b * r; e += T) ds[e] = demands[e];
      dem = ds;
    }
    __syncthreads();
    tt = ts;
    for (int i = tid; i < cnt; i += T) {
      al[i] = alive[base + i];
      us[i] = used[base + i];
      util[i] = row_util(av + i * r, tt + i * r, r);
    }
  } else {
    av = avail + static_cast<long long>(base) * r;
    al = const_cast<uint8_t*>(alive) + base;
    us = used + base;
  }
  const PackRows rows{av, tt, util, yt, al, us, cnt, base, r, mode};
  if (tid < 3) best_s[tid] = ~0ull;
  if (tid < 2 * MAX_C) (&cand[0][0])[tid] = ~0ull;  // absent ranks' slots stay empty
  exchange_init(xbar, C * 8);
  cluster.sync();  // the exchange's barriers armed in every CTA

  unsigned long long mine, unused;
  next_keys<SMEM>(rows, dem, b, 0, -1, &mine, &unused);
  for (int bi = 0; bi < b; ++bi) {
    const int slot = bi & 1;
    const float* d = dem + static_cast<long long>(bi) * r;
    const unsigned long long best = warp_min64(mine);
    if (lane == 0 && best != ~0ull) atomicMin(&best_s[bi % 3], best);
    __syncthreads();
    const unsigned long long cta_best = best_s[bi % 3];
    if (tid == 0) best_s[(bi + 2) % 3] = ~0ull;  // bundle bi - 1's, read before this barrier
    if (tid < C) st_async(cluster_addr(&cand[slot][rank], tid), cta_best, cluster_addr(&xbar[slot], tid));
    __syncwarp();
    // While the candidates travel: the next bundle's keys, exact for every
    // row but this bundle's winner. The winner is the CTA candidate of its
    // CTA, so the thread holding that candidate also prepares the case
    // that its row wins: its util after the bundle, and its keys then.
    const int li_mine = mine == cta_best && mine != ~0ull ? key_index(mine) - base : -1;
    const bool ok_mine = li_mine >= 0 && (mine >> 32) != (pack_key(INF, 0) >> 32);
    unsigned long long if_lost, if_won;
    next_keys<SMEM>(rows, dem, b, bi + 1, li_mine, &if_lost, &if_won);
    float u_win = 0.f;
    if (ok_mine) {
      u_win = util_after<SMEM>(rows, li_mine, d);
      if (bi + 1 < b) {
        const unsigned long long k =
            won_key(rows, li_mine, dem + static_cast<long long>(bi + 1) * r, d, u_win);
        if_won = k < if_won ? k : if_won;
      }
    }
    exchange_wait(xbar, bi, C * 8);
    unsigned long long w = ~0ull;
#pragma unroll
    for (int o = 0; o < MAX_C; ++o) w = cand[slot][o] < w ? cand[slot][o] : w;
    mine = if_lost;
    if (li_mine >= 0 && key_index(w) - base == li_mine) {  // the winner is this thread's row
      if (ok_mine) {
        for (int j = 0; j < r; ++j) av[li_mine * r + j] = __fsub_rn(av[li_mine * r + j], d[j]);
        if (SMEM) util[li_mine] = u_win;
        us[li_mine] = 1;
        mine = if_won;
      }
      out[bi] = ok_mine ? key_index(w) : -1;
    }
  }

  if (SMEM) {
    for (int i = tid; i < cnt; i += T) {
      for (int j = 0; j < r; ++j) avail[(static_cast<long long>(base) + i) * r + j] = av[i * r + j];
      used[base + i] = us[i];
    }
  }
  __threadfence();
  cluster.sync();  // every out[bi] written
  if (rank == 0) {
    int ok = 1;
    for (int e = tid; e < b; e += T) ok &= out[e] >= 0;
    ok = __syncthreads_and(ok);
    if (tid == 0) out[b] = ok;
  }
}

// ------------------------------------------------------ S3: pg_pack_batch

// The S3 design: the ranking and the groups' solves in one cluster launch
// (true), or the ranking, then a grid of CTAs of GROUP_WARPS warps (false;
// pg_kernel.py's BATCH_LAUNCHES counts these two launches). Only copies
// that tools/sched_design_sweep.py builds set it true.
constexpr bool S3_FUSED = false;
constexpr int GROUP_WARPS = 4;

// A cluster barrier in two halves: arrive (release), later wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Node i's key in the ranking (:100-105): its util (row_util's
// expression, its row read 4 values at a time, the loads before the
// divisions; into *util), negated for PACK, INF for a dead row, with its
// index.
__device__ __forceinline__ unsigned long long rank_key(const float* __restrict__ avail,
                                                       const float* __restrict__ total,
                                                       const uint8_t* __restrict__ alive, int i,
                                                       int r, int mode, float* util) {
  const long long row = static_cast<long long>(i) * r;
  float u = -INF;
  for (int c = 0; c < r; c += 4) {
    float a[4], t[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = c + q < r ? avail[row + c + q] : 0.f;
      t[q] = c + q < r ? total[row + c + q] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c + q < r) u = fmaxf(u, t[q] > 0.f ? __fsub_rn(t[q], a[q]) / fmaxf(t[q], EPS) : 0.f);
  }
  *util = u;
  return pack_key(alive[i] ? (mode == 0 ? -u : u) : INF, i);
}

// `ranked` holds the order [n], each node's util [n] (both to a multiple
// of 4 words), then the sorted slices kept in global memory.
__host__ __device__ long long order_ints(int n) { return (n + 3LL) & ~3LL; }

// Floats of a row of a group's state: r, to a multiple of 4 (float4 loads).
__host__ __device__ __forceinline__ int row4(int r) { return (r + 3) & ~3; }

// Bytes of a group's state: its k slots' copies of their nodes'
// availability and total [k, row4(r)], its bundles' demands [b, row4(r)],
// the slots' util [k], node [k] and flags [k] (alive, used), the bundles'
// valid [b]; a multiple of 16.
__host__ __device__ long long group_bytes(int k, int r, int b) {
  return (8LL * k * row4(r) + 4LL * k + 4LL * b * row4(r) + 5LL * k + b + 15) / 16 * 16;
}

constexpr uint8_t SLOT_ALIVE = 1, SLOT_USED = 2;

struct GroupSlots {
  float* av;
  float* tt;
  float* ut;
  float* dm;
  int* node;
  uint8_t* fl;
  uint8_t* val;
};

__device__ __forceinline__ GroupSlots group_slots(char* mem, int k, int r, int b) {
  GroupSlots s;
  s.av = reinterpret_cast<float*>(mem);  // rows of row4(r) floats, 16-byte aligned
  s.tt = s.av + static_cast<long long>(k) * row4(r);
  s.dm = s.tt + static_cast<long long>(k) * row4(r);
  s.ut = s.dm + static_cast<long long>(b) * row4(r);
  s.node = reinterpret_cast<int*>(s.ut + k);
  s.fl = reinterpret_cast<uint8_t*>(s.node + k);
  s.val = s.fl + k;
  return s;
}

// Whether a slot's row a (row4(r) floats, padding 0) takes demand d (its
// padding 0): a + EPS >= d wherever d > 0, row_score's test, without a
// branch.
__device__ __forceinline__ bool slot_fits(const float* a, const float* d, int r4) {
  bool can = true;
#pragma unroll 1
  for (int c = 0; c < r4; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(d + c);
    can = can & (!(y.x > 0.f) | (__fadd_rn(x.x, EPS) >= y.x)) &
          (!(y.y > 0.f) | (__fadd_rn(x.y, EPS) >= y.y)) &
          (!(y.z > 0.f) | (__fadd_rn(x.z, EPS) >= y.z)) &
          (!(y.w > 0.f) | (__fadd_rn(x.w, EPS) >= y.w));
  }
  return can;
}

// A slot's key for demand d: (can ? its row_score from the cached util :
// INF, slot), and whether it can take d.
__device__ __forceinline__ unsigned long long slot_key(const GroupSlots& s, int j, const float* d,
                                                       int r4, int mode, bool* can_out) {
  const uint8_t fl = s.fl[j];
  const bool used = (fl & SLOT_USED) != 0;
  const float u = s.ut[j];
  const bool can = ((fl & SLOT_ALIVE) != 0) & !(mode == 2 & used) & slot_fits(s.av + j * r4, d, r4);
  const float sc = mode == 0 ? -u : mode == 1 ? __fadd_rn(u, used ? SPREAD_PENALTY : 0.f) : u;
  *can_out = can;
  return pack_key(can ? sc : INF, j);
}

// Group grp's bundles (:107-162) by one warp, its state at `mem`
// (group_slots): slots j < k hold ranks (j G + grp) mod n, lane l slots l,
// l + 32, ... The state is gathered first, each step's loads in flight
// together. The code is kept small (loops not unrolled): one pass runs
// once per launch, so every instruction it issues is a first fetch. Per
// bundle each lane scores its slots from their cached util
// (slot_key: no division, no branch), two warp reductions (__reduce_min_sync
// of the key's high word, then of the low word among the lanes holding the
// least high word) take the least (score, slot) key, argmin's first least
// slot (all infeasible: slot 0, unplaced); the winner's lane commits it,
// marks it used and recomputes its util with row_util's expression. Where
// the deal wraps (k G > n) slots alias, and every lane also marks each of
// its slots that holds the chosen node (by node id, as :143-150 does). A
// slot is its lane's alone, so nothing waits on a barrier.
template <bool WAIT>
__device__ __forceinline__ void solve_group(int grp, const float* __restrict__ avail,
                            const float* __restrict__ total, const uint8_t* __restrict__ alive,
                            const float* __restrict__ demands, const uint8_t* __restrict__ valid,
                            int n, int r, int g, int b, int k, int mode, const int* ranked,
                            char* mem, int* out) {
  const int lane = threadIdx.x & 31, r4 = row4(r);
  const GroupSlots s = group_slots(mem, k, r, b);
  // The bundles' demands and valid flags first: they do not depend on the
  // ranking, which a dependent launch waits for only here.
  const float* dg = demands + static_cast<long long>(grp) * b * r;
#pragma unroll 1
  for (int e = lane; e < b * r4; e += 32) s.dm[e] = e % r4 < r ? dg[e / r4 * r + e % r4] : 0.f;
#pragma unroll 1
  for (int e = lane; e < b; e += 32) s.val[e] = valid[static_cast<long long>(grp) * b + e];
  if (WAIT) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // The lane's slots four at a time, each step's loads in flight together:
  // node ids, then alive, util (the ranking's) and the rows (16 bytes a
  // load where r is a multiple of 4).
  const float* util_of = reinterpret_cast<const float*>(ranked + order_ints(n));
  const bool rows16 = (r & 3) == 0 && (reinterpret_cast<uintptr_t>(avail) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(total) & 15) == 0;
#pragma unroll 1
  for (int j0 = lane; j0 < k; j0 += 128) {
    int node[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      node[u] = j0 + 32 * u < k ? ranked[(static_cast<long long>(j0 + 32 * u) * g + grp) % n] : 0;
    uint8_t al[4];
    float ut[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) al[u] = alive[node[u]], ut[u] = util_of[node[u]];
    if (rows16) {
#pragma unroll 1
      for (int c = 0; c < r; c += 4) {
        float4 a[4], t[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long at = static_cast<long long>(node[u]) * r + c;
          a[u] = *reinterpret_cast<const float4*>(avail + at);
          t[u] = *reinterpret_cast<const float4*>(total + at);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + 32 * u < k) {
            *reinterpret_cast<float4*>(s.av + (j0 + 32 * u) * r4 + c) = a[u];
            *reinterpret_cast<float4*>(s.tt + (j0 + 32 * u) * r4 + c) = t[u];
          }
        }
      }
    } else {
#pragma unroll 1
      for (int c = 0; c < r4; ++c) {
        float a[4], t[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long at = static_cast<long long>(node[u]) * r + c;
          a[u] = c < r ? avail[at] : 0.f;
          t[u] = c < r ? total[at] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j0 + 32 * u < k) s.av[(j0 + 32 * u) * r4 + c] = a[u], s.tt[(j0 + 32 * u) * r4 + c] = t[u];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 32 * u;
      if (j < k) s.node[j] = node[u], s.fl[j] = al[u] ? SLOT_ALIVE : 0, s.ut[j] = ut[u];
    }
  }
  __syncwarp();
  // Within a group, slots hold distinct nodes unless the deal wraps
  // (k G > n): then marking `used` looks for every slot of the chosen node.
  const bool aliased = static_cast<long long>(k) * g > n;
  int* row = out + static_cast<long long>(grp) * (b + 1);
  bool all_ok = true;
  for (int bi = 0; bi < b; ++bi) {
    const float* d = s.dm + bi * r4;
    unsigned long long least = ~0ull;
#pragma unroll 4
    for (int j = lane; j < k; j += 32) {
      bool can;
      const unsigned long long key = slot_key(s, j, d, r4, mode, &can);
      least = key < least ? key : least;
    }
    const unsigned hi = __reduce_min_sync(FULL, static_cast<unsigned>(least >> 32));
    const unsigned lo =
        __reduce_min_sync(FULL, static_cast<unsigned>(least >> 32) == hi ? static_cast<unsigned>(least) : ~0u);
    const int w = static_cast<int>(lo);
    bool ok = false;
    if (lane == (w & 31)) {
      slot_key(s, w, d, r4, mode, &ok);
      ok = ok && s.val[bi];
      if (ok) {
        float* av = s.av + w * r4;
#pragma unroll 1
        for (int c = 0; c < r4; c += 4) {  // the padding stays 0 - 0
          float4 x = *reinterpret_cast<float4*>(av + c);
          const float4 y = *reinterpret_cast<const float4*>(d + c);
          x.x = __fsub_rn(x.x, y.x), x.y = __fsub_rn(x.y, y.y);
          x.z = __fsub_rn(x.z, y.z), x.w = __fsub_rn(x.w, y.w);
          *reinterpret_cast<float4*>(av + c) = x;
        }
        s.ut[w] = row_util(av, s.tt + w * r4, r);
        s.fl[w] |= SLOT_USED;
      }
      row[bi] = ok ? s.node[w] : -1;
    }
    ok = __shfl_sync(FULL, static_cast<int>(ok), w & 31) != 0;
    all_ok = all_ok && (ok || !s.val[bi]);
    if (ok && aliased) {
      const int chosen = s.node[w];
#pragma unroll 1
      for (int j = lane; j < k; j += 32)
        if (s.node[j] == chosen) s.fl[j] |= SLOT_USED;
    }
  }
  if (lane == 0) row[b] = all_ok;
}

// The ranking (:100-105) in one cluster: each CTA keys its slice, sorts
// it (sort_slice) in shared memory (own_smem) or in global memory, and
// pushes it to the others (STAGED) or leaves it in global memory for them;
// each key's place by merge path; ranked[place] = node. Then, S3_FUSED,
// the groups, a warp each, in rounds over the cluster's warps, their state
// in the shared memory the ranking used (slots_smem) or in `slots`.
template <bool STAGED>
__global__ void __launch_bounds__(CT, 1)
pg_pack_batch_cluster(const float* __restrict__ avail, const float* __restrict__ total,
                      const uint8_t* __restrict__ alive, const float* __restrict__ demands,
                      const uint8_t* __restrict__ valid, int n, int r, int g, int b, int k,
                      int mode, int* ranked, float* slots, int* out, int own_smem,
                      int slots_smem) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t stage_bar;  // the other slices' keys pushed here
  // the groups' launch (S3_FUSED false) may start now; it waits for this
  // grid's end before it reads the order
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, T = blockDim.x;
  const Slice sl = slice_of(n, C, rank);
  const int cnt = sl.count, base = sl.base, per = sl.per;
  const int S = slice_sort_size(per), spr = (per + 3) & ~3;
  // this slice's sorted keys in global memory, S apart, past the order and
  // the utils
  unsigned long long* gkeys = reinterpret_cast<unsigned long long*>(ranked + 2 * order_ints(n)) +
                              static_cast<long long>(rank) * S;
  unsigned long long* skey = own_smem ? reinterpret_cast<unsigned long long*>(smem4) : gkeys;
  if (STAGED) {
    if (tid == 0) {
      mbar_init(&stage_bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect(&stage_bar, staged_bytes(n, per, rank, C, false));
    }
    cluster_arrive();  // waited for before the first push
  }
  float* util_of = reinterpret_cast<float*>(ranked + order_ints(n));  // read by the groups
  for (int i = tid; i < cnt; i += T) skey[i] = rank_key(avail, total, alive, base + i, r, mode, util_of + base + i);
  sort_slice(skey, cnt, S);
  int len[MAX_C];
  peer_lengths(n, per, rank, C, len);
  if (STAGED) {
    cluster_wait();
    push_slice(skey, nullptr, skey + S, nullptr, spr, cnt, rank, C, &stage_bar);
    if (C > 1) mbar_wait(&stage_bar, 0);
  } else {
    if (skey != gkeys)
      for (int i = tid; i < cnt; i += T) gkeys[i] = skey[i];
    __threadfence();
    cluster.sync();  // every slice sorted in global memory
  }
  for (int p = tid; p < cnt; p += T) {
    const unsigned long long me = skey[p];
    int at[MAX_C];
    merge_counts<STAGED>(me, S, rank, STAGED ? skey + S : gkeys, STAGED ? spr : S, len, at);
    int place = p;
#pragma unroll
    for (int gi = 0; gi < MAX_C; ++gi) place += at[gi];
    ranked[place] = key_index(me);
  }
  __threadfence();
  cluster.sync();  // the order written, every push landed
  if (S3_FUSED) {
    const int W = T >> 5, warp = tid >> 5;
    const long long gb = group_bytes(k, r, b);
    for (int grp = warp * C + rank; grp < g; grp += C * W) {  // spread over the CTAs
      if (slots_smem)  // two calls, so that the first addresses shared memory as such
        solve_group<false>(grp, avail, total, alive, demands, valid, n, r, g, b, k, mode,
                           ranked, reinterpret_cast<char*>(smem4) + warp * gb, out);
      else
        solve_group<false>(grp, avail, total, alive, demands, valid, n, r, g, b, k, mode,
                           ranked, reinterpret_cast<char*>(slots) + grp * gb, out);
    }
  }
}

// S3_FUSED false: the groups' solves after the ranking's launch, a warp
// each, their state in shared memory (slots_smem) or in `slots`. It is
// launched as the ranking's programmatic dependent, so its CTAs start
// while the ranking runs, gather their demands and wait for it there.
__global__ void __launch_bounds__(GROUP_WARPS * 32)
pg_pack_groups(const float* __restrict__ avail, const float* __restrict__ total,
               const uint8_t* __restrict__ alive, const float* __restrict__ demands,
               const uint8_t* __restrict__ valid, int n, int r, int g, int b, int k, int mode,
               const int* ranked, float* slots, int* out, int slots_smem) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, grp = blockIdx.x * GROUP_WARPS + warp;
  if (grp >= g) return;
  const long long gb = group_bytes(k, r, b);
  if (slots_smem)  // two calls, so that the first addresses shared memory as such
    solve_group<true>(grp, avail, total, alive, demands, valid, n, r, g, b, k, mode, ranked,
                      reinterpret_cast<char*>(smem4) + warp * gb, out);
  else
    solve_group<true>(grp, avail, total, alive, demands, valid, n, r, g, b, k, mode, ranked,
                      reinterpret_cast<char*>(slots) + grp * gb, out);
}

// Nothing: its launch measures the floor that any launch pays.
__global__ void empty_kernel() {}

// --------------------------------------------------------- cluster launches

// The launch shape of a cluster kernel: C CTAs of `threads`, `smem` bytes
// of dynamic shared memory, the slice in shared memory or not (S3: the
// other slices staged there or not, its own keys there or not, the
// groups' state there or not).
struct Shape {
  int c, threads;
  long long smem;
  bool in_smem;
  bool own_smem = false, slots_smem = false;
};

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

int smem_optin() {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, current_device());
  return bytes;
}

// Whether `bytes` of dynamic shared memory fit beside the kernel's static.
bool fits(const void* kernel, long long bytes) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return false;
  return bytes + static_cast<long long>(attr.sharedSizeBytes) <= smem_optin();
}

// Threads of a CTA owning `per` rows: one row a thread up to CT, at least
// four warps.
int cta_threads(int per) { return min(CT, max(128, next_pow2(per))); }

// The slices stay in shared memory when they fit with the other slices
// staged beside them, else in global memory.
Shape schedule_shape(int n, int r, int c) {
  Shape s;
  s.c = c;
  const int per = (n + c - 1) / c;
  s.threads = cta_threads(per);
  const long long bytes = sc_smem_bytes(per, r, c);
  s.in_smem = fits(reinterpret_cast<const void*>(&schedule_classes_cluster<true>), bytes);
  s.smem = s.in_smem ? bytes : 0;
  return s;
}

Shape pack_shape(int n, int r, int b, int c) {
  Shape s;
  s.c = c;
  const int per = (n + c - 1) / c;
  s.threads = cta_threads(per);
  const long long bytes = pg_smem_bytes(per, r, b);
  s.in_smem = fits(reinterpret_cast<const void*>(&pg_pack_cluster<true>), bytes);
  s.smem = s.in_smem ? bytes : 0;
  return s;
}

// S3 at n x r, b bundles and k candidates a group: the other slices
// staged beside a CTA's keys in shared memory where they fit (in_smem),
// else searched in global memory, the CTA's own sorted in shared memory
// where they fit (own_smem); fused, the groups' state in the same shared
// memory where it fits.
Shape batch_shape(int n, int r, int b, int k, int c) {
  Shape s;
  s.c = c;
  const int per = (n + c - 1) / c;
  s.threads = cta_threads(per);
  const void* kernel = reinterpret_cast<const void*>(&pg_pack_batch_cluster<true>);
  const long long keys = 8LL * slice_sort_size(per);
  const long long staged = keys + 8LL * (c - 1) * ((per + 3) & ~3);
  const long long slot = S3_FUSED ? (s.threads / 32) * group_bytes(k, r, b) : 0;
  s.slots_smem = S3_FUSED ? fits(kernel, slot)
                          : fits(reinterpret_cast<const void*>(&pg_pack_groups),
                                 GROUP_WARPS * group_bytes(k, r, b));
  const long long slots = S3_FUSED && s.slots_smem ? slot : 0;
  s.in_smem = fits(kernel, staged > slots ? staged : slots);
  s.own_smem = s.in_smem || fits(kernel, keys > slots ? keys : slots);
  const long long ranking = s.in_smem ? staged : s.own_smem ? keys : 0;
  s.smem = ranking > slots ? ranking : slots;
  return s;
}

cudaLaunchConfig_t cluster_config(const Shape& s, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.c, 1, 1);
  cfg.blockDim = dim3(s.threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(s.smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = s.c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's attributes for shape s on the current device (they are
// per device): its dynamic shared memory limit only ever grows, so a
// shape chosen before still launches.
template <typename... Args>
cudaError_t prepare(void (*kernel)(Args...), const Shape& s, bool cluster = true) {
  static std::mutex lock;
  static std::map<std::pair<int, const void*>, long long> granted;
  std::lock_guard<std::mutex> hold(lock);
  long long& have = granted[{current_device(), reinterpret_cast<const void*>(kernel)}];
  if (have == 0) {
    const cudaError_t err =
        cluster ? cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
                : cudaSuccess;
    if (err != cudaSuccess) return err;
    have = -1;
  }
  if (s.smem > have) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s.smem));
    if (err != cudaSuccess) return err;
    have = s.smem;
  }
  return cudaSuccess;
}

// Clusters of this shape the card can hold at once (0: not admitted).
template <typename... Args>
int admitted(void (*kernel)(Args...), const Shape& s) {
  if (prepare(kernel, s) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(s, nullptr, &attr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, reinterpret_cast<const void*>(kernel), &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

// One launch of a cluster kernel of shape s, or the error that refused it.
template <typename... Args, typename... Actual>
cudaError_t launch(void (*kernel)(Args...), const Shape& s, cudaStream_t stream,
                   Actual&&... args) {
  cudaError_t err = prepare(kernel, s);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(s, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Actual&&>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shapes chosen so far, by (device, program, n, r, the demands' part
// of pg_pack's shape): choosing one asks the runtime for attributes and
// occupancy, which costs more host time than a launch.
using ShapeKey = std::tuple<int, int, int, int, int, int>;

std::mutex shapes_lock;
std::map<ShapeKey, std::pair<Shape, int>> shapes;

Shape schedule_choice(int n, int r, int* held) {
  {
    std::lock_guard<std::mutex> hold(shapes_lock);
    const auto it = shapes.find(ShapeKey(current_device(), 0, n, r, 0, 0));
    if (it != shapes.end()) {
      *held = it->second.second;
      return it->second.first;
    }
  }
  Shape s;
  for (int c : CLUSTER_CHOICES) {
    s = schedule_shape(n, r, c);
    *held = s.in_smem ? admitted(schedule_classes_cluster<true>, s)
                      : admitted(schedule_classes_cluster<false>, s);
    if (*held > 0) break;
  }
  std::lock_guard<std::mutex> hold(shapes_lock);
  shapes[ShapeKey(current_device(), 0, n, r, 0, 0)] = {s, *held};
  return s;
}

Shape pack_choice(int n, int r, int b, int* held) {
  const int dem = 1LL * b * r <= PG_SMEM_DEMANDS ? b : -1;  // the demands' part of the shape
  {
    std::lock_guard<std::mutex> hold(shapes_lock);
    const auto it = shapes.find(ShapeKey(current_device(), 1, n, r, dem, 0));
    if (it != shapes.end()) {
      *held = it->second.second;
      return it->second.first;
    }
  }
  Shape s;
  for (int c : CLUSTER_CHOICES) {
    s = pack_shape(n, r, b, c);
    *held = s.in_smem ? admitted(pg_pack_cluster<true>, s) : admitted(pg_pack_cluster<false>, s);
    if (*held > 0) break;
  }
  std::lock_guard<std::mutex> hold(shapes_lock);
  shapes[ShapeKey(current_device(), 1, n, r, dem, 0)] = {s, *held};
  return s;
}

Shape batch_choice(int n, int r, int b, int k, int* held) {
  {
    std::lock_guard<std::mutex> hold(shapes_lock);
    const auto it = shapes.find(ShapeKey(current_device(), 2, n, r, b, k));
    if (it != shapes.end()) {
      *held = it->second.second;
      return it->second.first;
    }
  }
  Shape s;
  for (int c : CLUSTER_CHOICES) {
    s = batch_shape(n, r, b, k, c);
    *held = s.in_smem ? admitted(pg_pack_batch_cluster<true>, s)
                      : admitted(pg_pack_batch_cluster<false>, s);
    if (*held > 0) break;
  }
  std::lock_guard<std::mutex> hold(shapes_lock);
  shapes[ShapeKey(current_device(), 2, n, r, b, k)] = {s, *held};
  return s;
}

// Ints of `ranked`: the order and the utils, then each CTA's sorted keys
// where the slices stay in global memory, for the largest of the cluster
// choices.
long long batch_ranked_ints(int n) {
  long long most = 0;
  for (int c : CLUSTER_CHOICES) {
    const long long f = 2LL * c * slice_sort_size((n + c - 1) / c);
    most = f > most ? f : most;
  }
  return 2 * order_ints(n) + most;
}

// S3 on the stream: the ranking into `ranked`, then, for g > 0, the
// groups' solves into `out` (in the same launch where S3_FUSED).
cudaError_t s3_launch(const float* avail, const float* total, const uint8_t* alive,
                      const float* demands, const uint8_t* valid, int n, int r, int g, int b,
                      int k, int mode, int* ranked, float* slots, int* out, cudaStream_t st) {
  int held;
  const Shape s = batch_choice(n, r, b, k, &held);
  const int in_launch = S3_FUSED ? g : 0;  // groups the cluster solves
  const int own = s.own_smem, slots_smem = s.slots_smem;
  cudaError_t err =
      s.in_smem ? launch(pg_pack_batch_cluster<true>, s, st, avail, total, alive, demands, valid, n,
                         r, in_launch, b, k, mode, ranked, slots, out, own, slots_smem)
                : launch(pg_pack_batch_cluster<false>, s, st, avail, total, alive, demands, valid,
                         n, r, in_launch, b, k, mode, ranked, slots, out, own, slots_smem);
  if (err != cudaSuccess || S3_FUSED || g == 0) return err;
  Shape gs;  // a warp a group, GROUP_WARPS a CTA
  gs.c = (g + GROUP_WARPS - 1) / GROUP_WARPS;
  gs.threads = GROUP_WARPS * 32;
  gs.in_smem = s.slots_smem;
  gs.smem = gs.in_smem ? GROUP_WARPS * group_bytes(k, r, b) : 0;
  err = prepare(pg_pack_groups, gs, false);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};  // a programmatic dependent of the ranking
  cfg.gridDim = dim3(gs.c, 1, 1);
  cfg.blockDim = dim3(gs.threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(gs.smem);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pg_pack_groups, avail, total, alive, demands, valid, n, r, g, b,
                           k, mode, static_cast<const int*>(ranked), slots, out,
                           static_cast<int>(gs.in_smem));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  if (n < 1 || r < 1 || r > MAX_R || k < 1 || n > (1 << 24) || scratch_len < scratch_floats(n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  int held;
  const Shape s = schedule_choice(n, r, &held);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s.in_smem ? launch(schedule_classes_cluster<true>, s, st, avail, total, alive, demands,
                            counts, prefs, threshold, n, r, k, packed, scratch)
                   : launch(schedule_classes_cluster<false>, s, st, avail, total, alive, demands,
                            counts, prefs, threshold, n, r, k, packed, scratch);
}

// avail: fp32 [n, r], the carried availability, updated in place; total:
// fp32 [n, r]; alive: bool [n]; demands: fp32 [b, r]; mode: 0 pack, 1
// spread, 2 strict_spread; used: bool [n], zeros; out: int32 [b + 1].
extern "C" int pg_pack(float* avail, const float* total, const uint8_t* alive,
                       const float* demands, int n, int r, int b, int mode, uint8_t* used, int* out,
                       void* stream) {
  if (n < 1 || r < 1 || r > MAX_R || b < 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int held;
  const Shape s = pack_choice(n, r, b, &held);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s.in_smem ? launch(pg_pack_cluster<true>, s, st, avail, total, alive, demands, n, r, b,
                            mode, used, out)
                   : launch(pg_pack_cluster<false>, s, st, avail, total, alive, demands, n, r, b,
                            mode, used, out);
}

// The launch shape that schedule_classes (program 0) at n x r, or pg_pack
// (program 1) at n x r with b bundles, takes: out[0..4] = CTAs, threads a
// CTA, dynamic shared memory bytes, 1 if the slices are in shared memory,
// clusters of that shape the card holds at once.
extern "C" int scheduler_launch_shape(int program, int n, int r, int b, long long* out) {
  if (n < 1 || r < 1 || r > MAX_R || b < 0 || program < 0 || program > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int held;
  const Shape s = program == 0 ? schedule_choice(n, r, &held) : pack_choice(n, r, b, &held);
  out[0] = s.c, out[1] = s.threads, out[2] = s.smem, out[3] = s.in_smem, out[4] = held;
  return 0;
}

// The launch shape of pg_pack_batch's cluster at n x r, b bundles and k
// candidates a group: out[0..6] = CTAs, threads a CTA, dynamic shared
// memory bytes, 1 if the other slices are staged in shared memory,
// clusters of that shape the card holds at once, 1 if a CTA sorts its
// slice in shared memory, 1 if the groups' state is there.
extern "C" int pg_pack_batch_shape(int n, int r, int b, int k, long long* out) {
  if (n < 1 || r < 1 || r > MAX_R || b < 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int held;
  const Shape s = batch_choice(n, r, b, k, &held);
  out[0] = s.c, out[1] = s.threads, out[2] = s.smem, out[3] = s.in_smem, out[4] = held;
  out[5] = s.own_smem, out[6] = s.slots_smem;
  return 0;
}

// The scratch pg_pack_batch takes at n nodes x r, g groups of b bundles
// and k candidates: out[0] ints of `ranked`, out[1] floats of `slots`.
extern "C" int pg_pack_batch_scratch(int n, int r, int g, int b, int k, long long* out) {
  if (n < 1 || r < 1 || r > MAX_R || g < 0 || b < 0 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = batch_ranked_ints(n);
  out[1] = g * group_bytes(k, r, b) / 4;
  return 0;
}

// avail, total: fp32 [n, r]; alive: bool [n]; demands: fp32 [g, b, r];
// valid: bool [g, b]; ranked and slots: pg_pack_batch_scratch's ints and
// floats; out: int32 [g, b + 1].
extern "C" int pg_pack_batch(const float* avail, const float* total, const uint8_t* alive,
                             const float* demands, const uint8_t* valid, int n, int r, int g,
                             int b, int k, int mode, int* ranked, float* slots, int* out,
                             void* stream) {
  if (n < 1 || r < 1 || r > MAX_R || g < 1 || b < 0 || k < 1 || k > n || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return s3_launch(avail, total, alive, demands, valid, n, r, g, b, k, mode, ranked, slots, out,
                   static_cast<cudaStream_t>(stream));
}

// pg_pack_batch's ranking alone, one launch: the first n ints of `ranked`
// (pg_pack_batch_scratch's, any g and k) become the nodes in the stable
// order of the strategy's base score, dead rows last (rank_nodes_plain).
extern "C" int pg_pack_rank(const float* avail, const float* total, const uint8_t* alive, int n,
                            int r, int mode, int* ranked, void* stream) {
  if (n < 1 || r < 1 || r > MAX_R || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return s3_launch(avail, total, alive, nullptr, nullptr, n, r, 0, 0, 1, mode, ranked, nullptr,
                   nullptr, static_cast<cudaStream_t>(stream));
}

// One launch of an empty kernel, for the launch floor beside each time.
extern "C" int scheduler_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
