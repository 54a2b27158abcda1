// Native (C++) hybrid scheduling policy — the CPU baseline the TPU
// kernel is measured against, and the production-grade fallback when
// no accelerator is present.
//
// The port's own copy of native/scheduler.cc, built with g++ at first use
// by ray_tpu_torch/_private/native_loader.py::scheduler_lib.
//
// Reference semantics: royf/ray
// src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.cc
// [UNVERIFIED — reference mount empty, see SURVEY.md §0]: prefer the
// local/preferred node while its critical-resource utilization stays
// under the spread threshold, otherwise pick the least-utilized
// feasible+available node with a randomized top-k tie-break. The batch
// packs against a mutable availability view so one batch cannot
// oversubscribe a node.
//
// Exposed as a flat C ABI (dense [nodes, resources] float32 matrices)
// so the Python binding is a single ctypes call per batch — the same
// matrix layout the TPU policy uses, which keeps the two baselines
// directly comparable.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

namespace {

constexpr float kEps = 1e-9f;

struct View {
  const float* avail;  // mutable copy owned by caller wrapper
  const float* total;
  const uint8_t* alive;
  int n_nodes;
  int n_res;
};

inline bool is_feasible(const float* total_row, const float* demand,
                        int n_res) {
  for (int r = 0; r < n_res; ++r) {
    if (total_row[r] + kEps < demand[r]) return false;
  }
  return true;
}

inline bool is_available(const float* avail_row, const float* demand,
                         int n_res) {
  for (int r = 0; r < n_res; ++r) {
    if (avail_row[r] + kEps < demand[r]) return false;
  }
  return true;
}

inline float critical_utilization(const float* avail_row,
                                  const float* total_row, int n_res) {
  float worst = 0.0f;
  for (int r = 0; r < n_res; ++r) {
    if (total_row[r] <= 0.0f) continue;
    float used = total_row[r] - avail_row[r];
    float u = used / total_row[r];
    if (u > worst) worst = u;
  }
  return worst;
}

// xorshift64* — deterministic, seedable, no libc rand state.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
  int below(int n) { return static_cast<int>(next() % (uint64_t)n); }
};

}  // namespace

extern "C" {

// Schedules n_req requests sequentially against `avail` (mutated in
// place). demands: [n_req, n_res]. preferred: per-request node index or
// -1. out_nodes: chosen node index or -1. out_infeasible: 1 when no
// node could EVER fit the demand.
void rtpu_hybrid_schedule(float* avail, const float* total,
                          const uint8_t* alive, int n_nodes, int n_res,
                          const float* demands, const int32_t* preferred,
                          int n_req, float spread_threshold,
                          int top_k_abs, float top_k_frac, uint64_t seed,
                          int32_t* out_nodes, uint8_t* out_infeasible) {
  Rng rng(seed);
  std::vector<std::pair<float, int>> scored;
  scored.reserve(n_nodes);
  for (int t = 0; t < n_req; ++t) {
    const float* demand = demands + (size_t)t * n_res;
    out_nodes[t] = -1;
    out_infeasible[t] = 0;

    // 1. prefer the submitting node while under-utilized
    int pref = preferred[t];
    if (pref >= 0 && pref < n_nodes && alive[pref]) {
      float* arow = avail + (size_t)pref * n_res;
      const float* trow = total + (size_t)pref * n_res;
      if (critical_utilization(arow, trow, n_res) < spread_threshold &&
          is_available(arow, demand, n_res)) {
        for (int r = 0; r < n_res; ++r) arow[r] -= demand[r];
        out_nodes[t] = pref;
        continue;
      }
    }

    // 2. least-utilized feasible+available node, top-k tie-break
    scored.clear();
    bool any_feasible = false;
    for (int n = 0; n < n_nodes; ++n) {
      if (!alive[n]) continue;
      const float* trow = total + (size_t)n * n_res;
      if (!is_feasible(trow, demand, n_res)) continue;
      any_feasible = true;
      float* arow = avail + (size_t)n * n_res;
      if (!is_available(arow, demand, n_res)) continue;
      scored.emplace_back(critical_utilization(arow, trow, n_res), n);
    }
    if (scored.empty()) {
      out_infeasible[t] = any_feasible ? 0 : 1;
      continue;
    }
    int k = top_k_abs;
    int frac_k = static_cast<int>(scored.size() * top_k_frac);
    if (frac_k > k) k = frac_k;
    if (k > (int)scored.size()) k = (int)scored.size();
    if (k < 1) k = 1;
    // partial selection of the k lowest scores
    std::nth_element(scored.begin(), scored.begin() + (k - 1),
                     scored.end());
    int pick = rng.below(k);
    int chosen = scored[pick].second;
    float* arow = avail + (size_t)chosen * n_res;
    for (int r = 0; r < n_res; ++r) arow[r] -= demand[r];
    out_nodes[t] = chosen;
  }
}

// Class-fill variant: the exact workload shape of the benchmark/TPU
// kernel — K classes with per-class demand + count, filled under the
// hybrid policy. Returns per-(class, node) take counts.
// takes: [n_classes, n_nodes] int32 output.
void rtpu_hybrid_schedule_classes(float* avail, const float* total,
                                  const uint8_t* alive, int n_nodes,
                                  int n_res, const float* demands,
                                  const int32_t* counts,
                                  const int32_t* preferred, int n_classes,
                                  float spread_threshold,
                                  int32_t* takes) {
  std::vector<std::pair<float, int>> scored;
  for (int k = 0; k < n_classes; ++k) {
    const float* demand = demands + (size_t)k * n_res;
    int remaining = counts[k];
    int32_t* take_row = takes + (size_t)k * n_nodes;
    std::memset(take_row, 0, sizeof(int32_t) * n_nodes);
    if (remaining <= 0) continue;

    // preferred-node pack phase
    int pref = preferred[k];
    if (pref >= 0 && pref < n_nodes && alive[pref]) {
      float* arow = avail + (size_t)pref * n_res;
      const float* trow = total + (size_t)pref * n_res;
      while (remaining > 0 &&
             critical_utilization(arow, trow, n_res) < spread_threshold &&
             is_available(arow, demand, n_res)) {
        for (int r = 0; r < n_res; ++r) arow[r] -= demand[r];
        ++take_row[pref];
        --remaining;
      }
    }

    // spread phase: fill nodes in utilization order up to capacity
    scored.clear();
    for (int n = 0; n < n_nodes; ++n) {
      if (!alive[n]) continue;
      const float* trow = total + (size_t)n * n_res;
      if (!is_feasible(trow, demand, n_res)) continue;
      float* arow = avail + (size_t)n * n_res;
      scored.emplace_back(critical_utilization(arow, trow, n_res), n);
    }
    std::sort(scored.begin(), scored.end());
    for (auto& [score, n] : scored) {
      if (remaining <= 0) break;
      float* arow = avail + (size_t)n * n_res;
      // capacity = floor(min_r avail/demand)
      int cap = remaining;
      for (int r = 0; r < n_res; ++r) {
        if (demand[r] <= 0.0f) continue;
        int c = static_cast<int>((arow[r] + kEps) / demand[r]);
        if (c < cap) cap = c;
      }
      if (cap <= 0) continue;
      for (int r = 0; r < n_res; ++r) arow[r] -= demand[r] * cap;
      take_row[n] += cap;
      remaining -= cap;
    }
  }
}

}  // extern "C"
