// Native greedy allocate baseline — the reference's hot loop, faithfully.
//
// Reimplements the per-task sequential scan of kube-batch's allocate action
// (actions/allocate/allocate.go:43-191: per task, PredicateNodes over all
// nodes -> PrioritizeNodes -> SelectBestNode -> allocate) as tight C++ on
// the same columnar arrays the batched solver consumes. Purpose:
//
//  1. an HONEST measured baseline for bench.py — the reference publishes no
//     numbers, so "vs the greedy loop" must be measured, and a
//     compiled-native loop is the fair stand-in for the reference's Go
//     (extrapolating the Python action's wall time would inflate the
//     speedup ~50x);
//  2. a production fallback path when no accelerator is present.
//
// Scoring mirrors plugins/nodeorder.py least_requested/balanced (k8s
// formulas) and the epsilon fit mirrors api/resource_info.py less_equal
// (resource_info.go:253-277). Tie-break: first best (the reference picks
// randomly among max-score nodes, scheduler_helper.go:188-208; fixed order
// changes placement, not cost). Queue gating mirrors proportion's Overused
// (deserved <= allocated on every dim, proportion.go:198).
//
// OpenMP (when compiled with -fopenmp) parallelizes the per-task node scan
// like the reference's 16-goroutine fan-out (scheduler_helper.go:84,137).

#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>
#include <cmath>

namespace {

constexpr double kMaxPriority = 10.0;
constexpr int kCpuDim = 0;
constexpr int kMemDim = 1;

inline bool fits(const float* req, const float* idle, const float* eps,
                 int64_t R) {
  for (int64_t d = 0; d < R; ++d) {
    if (!(req[d] - idle[d] < eps[d])) return false;
  }
  return true;
}

inline bool overused(const float* deserved, const float* alloc,
                     const float* eps, int64_t R) {
  // proportion.go:198: deserved LessEqual allocated (every dim).
  for (int64_t d = 0; d < R; ++d) {
    if (!(deserved[d] - alloc[d] < eps[d])) return false;
  }
  return true;
}

inline double score(const float* req, const float* idle, const float* cap,
                    double lr_w, double br_w) {
  // LeastRequested + BalancedResourceAllocation over {cpu, mem}.
  double lr = 0.0;
  double frac[2];
  for (int d = 0; d < 2; ++d) {
    double c = cap[d == 0 ? kCpuDim : kMemDim];
    double remaining = idle[d == 0 ? kCpuDim : kMemDim] -
                       req[d == 0 ? kCpuDim : kMemDim];
    if (c > 0) {
      lr += (remaining > 0 ? remaining : 0.0) * kMaxPriority / c;
      frac[d] = 1.0 - remaining / c;
    } else {
      frac[d] = 1.0;
    }
  }
  lr /= 2.0;
  double br = 0.0;
  if (frac[0] < 1.0 && frac[1] < 1.0) {
    double diff = frac[0] - frac[1];
    if (diff < 0) diff = -diff;
    br = kMaxPriority - diff * kMaxPriority;
  }
  return lr_w * lr + br_w * br;
}

// Lazy per-signature score heap (the masked loop's fast path).
//
// Tasks sharing (req, fit, predicate group) see the same score surface, and
// a node's score only changes when an allocation lands on it. One max-heap
// per signature class — entries (score, node), smallest node wins ties to
// match the scan's first-best — turns the O(T·N) rescan into
// O((T + N·S + allocations·S)·log). Stale entries are discarded on pop by
// comparing against cur[]; removals are sound because idle only decreases
// within a solve (a node that stopped fitting a signature never fits it
// again) and pod-count caps only fill up.
//
// cur[n] sentinel states: finite = live score; -inf = fit-removed (still
// counts as predicate-feasible for the job-break verdict, matching the
// scan's any_feasible which is set BEFORE the fit check); NaN = cap-removed
// or statically infeasible (not feasible for job-break purposes).
struct SigEntryLess {
  bool operator()(const std::pair<double, int32_t>& a,
                  const std::pair<double, int32_t>& b) const {
    if (a.first != b.first) return a.first < b.first;
    return a.second > b.second;  // equal scores: lowest node index on top
  }
};

struct SigHeap {
  std::priority_queue<std::pair<double, int32_t>,
                      std::vector<std::pair<double, int32_t>>, SigEntryLess>
      heap;
  std::vector<double> cur;     // per-node sentinel/score (see above)
  const float* rep_req = nullptr;  // representative rows (identical across
  const float* rep_fit = nullptr;  // every task of the signature)
  int64_t feas_uncapped = 0;   // statically feasible & not cap-removed
  bool init = false;
};

// Below ~1M (task, node) pairs the plain scan wins: heap init plus the
// per-allocation refresh across signature classes costs more than it
// saves (measured: 1k x 100 runs 4x faster scanned). Settable so tests
// can force the heap path on small instances.
int64_t g_heap_pair_threshold = int64_t{1} << 20;

}  // namespace

extern "C" {

void greedy_set_heap_threshold(int64_t pairs) {
  g_heap_pair_threshold = pairs;
}

// Runs the greedy allocate loop. Arrays are row-major float32/int32.
// node_idle and queue_alloc are COPIED internally; out_assign[T] receives
// the chosen node index or -1. Returns the number of tasks placed.
int64_t greedy_allocate(const float* task_req,      // [T, R]
                        const int32_t* task_queue,  // [T]
                        const float* node_idle0,    // [N, R]
                        const float* node_cap,      // [N, R]
                        const float* queue_deserved,// [Q, R]
                        const float* queue_alloc0,  // [Q, R]
                        const float* eps,           // [R]
                        double lr_w, double br_w,
                        int64_t T, int64_t N, int64_t Q, int64_t R,
                        int32_t* out_assign) {
  std::vector<float> idle(node_idle0, node_idle0 + N * R);
  std::vector<float> qalloc(queue_alloc0, queue_alloc0 + Q * R);
  int64_t placed = 0;

  for (int64_t t = 0; t < T; ++t) {
    out_assign[t] = -1;
    const float* req = task_req + t * R;
    const int64_t q = task_queue[t];
    if (q >= 0 && q < Q &&
        overused(queue_deserved + q * R, qalloc.data() + q * R, eps, R)) {
      continue;  // allocate.go:94-95
    }

    int64_t best = -1;
    double best_score = -1.0;
#ifdef _OPENMP
#pragma omp parallel
    {
      int64_t lbest = -1;
      double lscore = -1.0;
#pragma omp for nowait
      for (int64_t n = 0; n < N; ++n) {
        if (!fits(req, idle.data() + n * R, eps, R)) continue;
        double s = score(req, idle.data() + n * R, node_cap + n * R,
                         lr_w, br_w);
        if (s > lscore || (s == lscore && (lbest < 0 || n < lbest))) {
          lscore = s;
          lbest = n;
        }
      }
#pragma omp critical
      {
        if (lbest >= 0 &&
            (lscore > best_score ||
             (lscore == best_score && (best < 0 || lbest < best)))) {
          best_score = lscore;
          best = lbest;
        }
      }
    }
#else
    for (int64_t n = 0; n < N; ++n) {
      if (!fits(req, idle.data() + n * R, eps, R)) continue;
      double s = score(req, idle.data() + n * R, node_cap + n * R,
                       lr_w, br_w);
      if (s > best_score) {
        best_score = s;
        best = n;
      }
    }
#endif

    if (best < 0) continue;
    float* nidle = idle.data() + best * R;
    for (int64_t d = 0; d < R; ++d) nidle[d] -= req[d];
    if (q >= 0 && q < Q) {
      float* qa = qalloc.data() + q * R;
      for (int64_t d = 0; d < R; ++d) qa[d] += req[d];
    }
    out_assign[t] = static_cast<int32_t>(best);
    ++placed;
  }
  return placed;
}

// Feasibility-aware greedy allocate: the production CPU fallback.
//
// Same sequential loop as greedy_allocate, but consuming the FULL
// factorized snapshot the TPU solver consumes (solver/kernels.py
// SolverInputs): per-task predicate rows (group/pair factorization,
// masks.py), node pod-count caps (predicates.py MaxTaskNum), the
// fit-vs-subtract resreq split (job_info.go InitResreq vs Resreq), static
// affinity score rows, and the reference's job-break semantics
// (allocate.go:144-148: first no-feasible-node verdict skips the rest of
// that job for the cycle). Indices in out_assign refer to the UNfiltered
// node table, so the caller can map straight back to ctx.nodes.
//
// pair_idx and score_idx must be ascending (tensorize emits them sorted);
// tasks are processed in ascending index order = global priority order.
int64_t greedy_allocate_masked(
    const float* task_req,        // [T, R] subtracted on allocate
    const float* task_fit,        // [T, R] fit-checked (init resreq)
    const int32_t* task_queue,    // [T]
    const int32_t* task_job,      // [T]
    const uint8_t* task_valid,    // [T]
    const int32_t* task_group,    // [T] feasibility group
    const uint8_t* node_feas,     // [N] node-level predicate column
    const uint8_t* group_feas,    // [G, N]
    const int32_t* pair_idx,      // [P] ascending
    const uint8_t* pair_feas,     // [P, N]
    const int32_t* score_idx,     // [S] ascending
    const float* score_rows,      // [S, N]
    const float* node_idle0,      // [N, R]
    const float* node_cap,        // [N, R]
    const int32_t* node_task_count0,  // [N]
    const int32_t* node_max_tasks,    // [N] 0 = unlimited
    const float* queue_deserved,  // [Q, R]
    const float* queue_alloc0,    // [Q, R]
    const float* eps,             // [R]
    double lr_w, double br_w,
    int64_t T, int64_t N, int64_t Q, int64_t R,
    int64_t G, int64_t P, int64_t S,
    int32_t* out_assign) {
  std::vector<float> idle(node_idle0, node_idle0 + N * R);
  std::vector<float> qalloc(queue_alloc0, queue_alloc0 + Q * R);
  std::vector<int32_t> ntask(node_task_count0, node_task_count0 + N);
  std::vector<uint8_t> job_failed(T, 0);  // task_job is a dense index < T
  int64_t placed = 0;
  int64_t pcur = 0, scur = 0;

  constexpr double kNegInf = -std::numeric_limits<double>::infinity();
  constexpr int64_t kMinHeapTasks = 4;   // singletons scan; classes heap
  constexpr size_t kMaxHeaps = 256;      // bound heap memory at N doubles each
  const bool use_heaps = T * N >= g_heap_pair_threshold;

  // Pass 1: signature classes (req bytes + fit bytes + group id) for tasks
  // with no private pair/score row. Exact byte keys — tasks of one class
  // share rows, so a representative pointer suffices later.
  std::unordered_map<std::string, int32_t> sig_ids;
  std::vector<int32_t> task_sig(T, -1);
  std::vector<int64_t> sig_count;
  if (use_heaps) {
    int64_t pc = 0, sc = 0;
    std::string key;
    for (int64_t t = 0; t < T; ++t) {
      while (pc < P && pair_idx[pc] < t) ++pc;
      while (sc < S && score_idx[sc] < t) ++sc;
      if (!task_valid[t]) continue;
      if (pc < P && pair_idx[pc] == t) continue;   // private predicate row
      if (sc < S && score_idx[sc] == t) continue;  // private score row
      key.assign(reinterpret_cast<const char*>(task_req + t * R),
                 R * sizeof(float));
      key.append(reinterpret_cast<const char*>(task_fit + t * R),
                 R * sizeof(float));
      const int32_t g = task_group[t];
      key.append(reinterpret_cast<const char*>(&g), sizeof(g));
      auto it = sig_ids.find(key);
      if (it == sig_ids.end()) {
        it = sig_ids.emplace(key, static_cast<int32_t>(sig_ids.size())).first;
        sig_count.push_back(0);
      }
      task_sig[t] = it->second;
      ++sig_count[it->second];
    }
  }
  std::vector<SigHeap> heaps(sig_ids.size());
  std::vector<int32_t> live_heaps;  // initialized heap sig ids

  // Every allocation (either path) refreshes the landed node's entry in
  // each live heap; all other nodes' scores are untouched.
  auto apply_allocate = [&](int64_t t, int64_t n) {
    const float* req = task_req + t * R;
    float* nidle = idle.data() + n * R;
    for (int64_t d = 0; d < R; ++d) nidle[d] -= req[d];
    ntask[n] += 1;
    const int64_t q = task_queue[t];
    if (q >= 0 && q < Q) {
      float* qa = qalloc.data() + q * R;
      for (int64_t d = 0; d < R; ++d) qa[d] += req[d];
    }
    out_assign[t] = static_cast<int32_t>(n);
    ++placed;
    const bool capped = node_max_tasks[n] > 0 && ntask[n] >= node_max_tasks[n];
    for (const int32_t s : live_heaps) {
      SigHeap& h = heaps[s];
      const double c = h.cur[n];
      if (std::isnan(c)) continue;  // already cap-removed / infeasible
      if (capped) {
        h.cur[n] = std::numeric_limits<double>::quiet_NaN();
        --h.feas_uncapped;
        continue;
      }
      if (c == kNegInf) continue;  // fit-removed stays removed (idle shrank)
      const double ns =
          score(h.rep_req, nidle, node_cap + n * R, lr_w, br_w);
      h.cur[n] = ns;
      h.heap.push({ns, static_cast<int32_t>(n)});
    }
  };

  for (int64_t t = 0; t < T; ++t) {
    out_assign[t] = -1;
    // Advance the sparse-row cursors regardless of skips below so they
    // stay aligned with ascending t.
    while (pcur < P && pair_idx[pcur] < t) ++pcur;
    while (scur < S && score_idx[scur] < t) ++scur;
    const uint8_t* prow =
        (pcur < P && pair_idx[pcur] == t) ? pair_feas + pcur * N : nullptr;
    const float* srow =
        (scur < S && score_idx[scur] == t) ? score_rows + scur * N : nullptr;

    if (!task_valid[t]) continue;
    const int64_t j = task_job[t];
    if (j >= 0 && j < T && job_failed[j]) continue;  // allocate.go:144-148
    const float* req = task_req + t * R;
    const float* fit = task_fit + t * R;
    const int64_t q = task_queue[t];
    if (q >= 0 && q < Q &&
        overused(queue_deserved + q * R, qalloc.data() + q * R, eps, R)) {
      continue;  // allocate.go:94-95
    }
    const uint8_t* grow =
        (task_group[t] >= 0 && task_group[t] < G)
            ? group_feas + task_group[t] * N
            : nullptr;

    // ---- heap fast path ------------------------------------------------
    const int32_t sig = task_sig[t];
    if (use_heaps && sig >= 0 && sig_count[sig] >= kMinHeapTasks &&
        (heaps[sig].init || live_heaps.size() < kMaxHeaps)) {
      SigHeap& h = heaps[sig];
      if (!h.init) {
        h.init = true;
        h.rep_req = req;
        h.rep_fit = fit;
        h.cur.assign(N, std::numeric_limits<double>::quiet_NaN());
        for (int64_t n = 0; n < N; ++n) {
          if (!node_feas[n]) continue;
          if (grow && !grow[n]) continue;
          if (node_max_tasks[n] > 0 && ntask[n] >= node_max_tasks[n])
            continue;
          ++h.feas_uncapped;
          const double s0 =
              score(req, idle.data() + n * R, node_cap + n * R, lr_w, br_w);
          h.cur[n] = s0;
          h.heap.push({s0, static_cast<int32_t>(n)});
        }
        live_heaps.push_back(sig);
      }
      int64_t hbest = -1;
      while (!h.heap.empty()) {
        const auto top = h.heap.top();
        const int64_t n = top.second;
        if (top.first != h.cur[n]) {  // stale (NaN/-inf compare false too)
          h.heap.pop();
          continue;
        }
        if (!fits(h.rep_fit, idle.data() + n * R, eps, R)) {
          h.cur[n] = kNegInf;  // permanent: idle only decreases
          h.heap.pop();
          continue;
        }
        hbest = n;
        break;
      }
      if (hbest < 0) {
        if (h.feas_uncapped == 0 && j >= 0 && j < T) job_failed[j] = 1;
        continue;
      }
      apply_allocate(t, hbest);
      continue;
    }

    // ---- scan path (private rows, rare signatures) ---------------------
    int64_t best = -1;
    double best_score = -1.0e300;
    bool any_feasible = false;
#ifdef _OPENMP
#pragma omp parallel
    {
      int64_t lbest = -1;
      double lscore = -1.0e300;
      bool lfeas = false;
#pragma omp for nowait
      for (int64_t n = 0; n < N; ++n) {
        if (!node_feas[n]) continue;
        if (grow && !grow[n]) continue;
        if (prow && !prow[n]) continue;
        if (node_max_tasks[n] > 0 && ntask[n] >= node_max_tasks[n]) continue;
        lfeas = true;
        if (!fits(fit, idle.data() + n * R, eps, R)) continue;
        double s = score(req, idle.data() + n * R, node_cap + n * R,
                         lr_w, br_w);
        if (srow) s += srow[n];
        if (s > lscore || (s == lscore && (lbest < 0 || n < lbest))) {
          lscore = s;
          lbest = n;
        }
      }
#pragma omp critical
      {
        any_feasible = any_feasible || lfeas;
        if (lbest >= 0 &&
            (lscore > best_score ||
             (lscore == best_score && (best < 0 || lbest < best)))) {
          best_score = lscore;
          best = lbest;
        }
      }
    }
#else
    for (int64_t n = 0; n < N; ++n) {
      if (!node_feas[n]) continue;
      if (grow && !grow[n]) continue;
      if (prow && !prow[n]) continue;
      if (node_max_tasks[n] > 0 && ntask[n] >= node_max_tasks[n]) continue;
      any_feasible = true;
      if (!fits(fit, idle.data() + n * R, eps, R)) continue;
      double s = score(req, idle.data() + n * R, node_cap + n * R,
                       lr_w, br_w);
      if (srow) s += srow[n];
      if (s > best_score) {
        best_score = s;
        best = n;
      }
    }
#endif

    if (best < 0) {
      // No node took the task. The job-break verdict applies only when
      // NO node was predicate-feasible for the task at all; a task that
      // merely failed the resource fit can still pipeline onto Releasing
      // resources in the epilogue (solver job_blocked mirrors this via
      // fits_releasing).
      if (!any_feasible && j >= 0 && j < T) job_failed[j] = 1;
      continue;
    }
    apply_allocate(t, best);
  }
  return placed;
}

// Candidate-sparsified greedy allocate: the CPU half of the top-K
// sparse solve (solver/topk.py selects; this consumes).
//
// Same sequential semantics as greedy_allocate_masked, but each
// candidate CLASS (tasks sharing predicate group + req/fit + private
// rows; task_cand maps task -> class) keeps a lazy max-heap over only
// its K candidate nodes instead of all N. The win is twofold: heap
// state shrinks from O(classes * N) to O(classes * K), and — the
// masked loop's dominant cost at 50k x 5k — the per-allocation refresh
// walks only the classes whose SLAB contains the landed node (a CSR
// inverted index), not every live heap. Expected refreshes per
// allocation drop from #classes to #classes * K / N.
//
// Exhaustion (class heap runs dry) follows the kernel's refill
// semantics: a slab that held every feasible-and-fitting-at-snapshot
// node (cand_total <= K) is a FINAL verdict — idle only shrinks, so
// nothing outside it can ever start fitting; a truncated slab WIDENS
// to a full-N heap (the per-class refill round, counted in
// out_stats[0]) and behaves like a masked SigHeap from then on. Past
// kMaxWidened the refill falls back to a per-task dense scan
// (out_stats[1]) so memory stays bounded. Job-break verdicts come from
// cand_anyfeas (predicate-level feasibility at snapshot, matching the
// masked scan's any_feasible; a node cap-saturated mid-solve is not
// re-checked — its class simply never places there, same placements).
int64_t greedy_allocate_sparse(
    const float* task_req,        // [T, R]
    const float* task_fit,        // [T, R]
    const int32_t* task_queue,    // [T]
    const int32_t* task_job,      // [T]
    const uint8_t* task_valid,    // [T]
    const int32_t* task_group,    // [T]
    const uint8_t* node_feas,     // [N]
    const uint8_t* group_feas,    // [G, N]
    const int32_t* pair_idx,      // [P] ascending
    const uint8_t* pair_feas,     // [P, N]
    const int32_t* score_idx,     // [S] ascending
    const float* score_rows,      // [S, N]
    const float* node_idle0,      // [N, R]
    const float* node_cap,        // [N, R]
    const int32_t* node_task_count0,  // [N]
    const int32_t* node_max_tasks,    // [N]
    const float* queue_deserved,  // [Q, R]
    const float* queue_alloc0,    // [Q, R]
    const float* eps,             // [R]
    double lr_w, double br_w,
    int64_t T, int64_t N, int64_t Q, int64_t R,
    int64_t G, int64_t P, int64_t S,
    const int32_t* task_cand,     // [T] class id (out of range -> scan)
    const int32_t* cand_idx,      // [C, K] node ids ascending, >= N pad
    const float* cand_static,     // [C, K] static score slab
    const int32_t* cand_total,    // [C] feasible+fit@snapshot count
    const int32_t* cand_anyfeas,  // [C] any predicate-feasible node
    int64_t C, int64_t K,
    int64_t* out_stats,           // [4] refills, scans, inits, widened
    int32_t* out_assign) {
  std::vector<float> idle(node_idle0, node_idle0 + N * R);
  std::vector<float> qalloc(queue_alloc0, queue_alloc0 + Q * R);
  std::vector<int32_t> ntask(node_task_count0, node_task_count0 + N);
  std::vector<uint8_t> job_failed(T, 0);
  int64_t placed = 0;
  int64_t pcur = 0, scur = 0;
  int64_t refills = 0, scans = 0, inits = 0;

  constexpr double kNegInf = -std::numeric_limits<double>::infinity();
  constexpr size_t kMaxWidened = 256;  // full-N heaps are N doubles each

  struct SlabHeap {
    std::priority_queue<std::pair<double, int32_t>,
                        std::vector<std::pair<double, int32_t>>,
                        SigEntryLess>
        heap;
    // Per-slot sentinels pre-widen ([K], slots ascend by node id so the
    // comparator's lowest-index tie rule still means lowest node), per
    // NODE post-widen ([N]). NaN = removed/infeasible, -inf =
    // fit-removed (permanent: idle only decreases), finite = live.
    std::vector<double> cur;
    const float* rep_req = nullptr;
    const float* rep_fit = nullptr;
    const uint8_t* grow = nullptr;
    const uint8_t* prow = nullptr;
    const float* srow = nullptr;
    int64_t feas_uncapped = 0;  // maintained when widened (job verdicts)
    bool init = false;
    bool widened = false;
  };
  std::vector<SlabHeap> heaps(C);
  std::vector<int32_t> widened_list;

  // CSR inverted index node -> (class, slot) over the slabs, so an
  // allocation refreshes only the classes that can still bid its node.
  std::vector<int64_t> inv_start(N + 1, 0);
  std::vector<int32_t> inv_class(static_cast<size_t>(C) * K);
  std::vector<int32_t> inv_slot(static_cast<size_t>(C) * K);
  {
    for (int64_t c = 0; c < C; ++c)
      for (int64_t s2 = 0; s2 < K; ++s2) {
        const int32_t n = cand_idx[c * K + s2];
        if (n >= 0 && n < N) ++inv_start[n + 1];
      }
    for (int64_t n = 0; n < N; ++n) inv_start[n + 1] += inv_start[n];
    std::vector<int64_t> fill(inv_start.begin(), inv_start.end() - 1);
    for (int64_t c = 0; c < C; ++c)
      for (int64_t s2 = 0; s2 < K; ++s2) {
        const int32_t n = cand_idx[c * K + s2];
        if (n < 0 || n >= N) continue;
        const int64_t at = fill[n]++;
        inv_class[at] = static_cast<int32_t>(c);
        inv_slot[at] = static_cast<int32_t>(s2);
      }
  }

  auto node_score = [&](const SlabHeap& h, int64_t n) {
    double s2 = score(h.rep_req, idle.data() + n * R, node_cap + n * R,
                      lr_w, br_w);
    if (h.srow) s2 += h.srow[n];
    return s2;
  };

  auto widen = [&](SlabHeap& h) {
    h.widened = true;
    h.heap = {};
    h.cur.assign(N, std::numeric_limits<double>::quiet_NaN());
    h.feas_uncapped = 0;
    for (int64_t n = 0; n < N; ++n) {
      if (!node_feas[n]) continue;
      if (h.grow && !h.grow[n]) continue;
      if (h.prow && !h.prow[n]) continue;
      if (node_max_tasks[n] > 0 && ntask[n] >= node_max_tasks[n]) continue;
      ++h.feas_uncapped;
      const double s2 = node_score(h, n);
      h.cur[n] = s2;
      h.heap.push({s2, static_cast<int32_t>(n)});
    }
  };

  auto apply_allocate = [&](int64_t t, int64_t n) {
    const float* req = task_req + t * R;
    float* nidle = idle.data() + n * R;
    for (int64_t d = 0; d < R; ++d) nidle[d] -= req[d];
    ntask[n] += 1;
    const int64_t q = task_queue[t];
    if (q >= 0 && q < Q) {
      float* qa = qalloc.data() + q * R;
      for (int64_t d = 0; d < R; ++d) qa[d] += req[d];
    }
    out_assign[t] = static_cast<int32_t>(n);
    ++placed;
    const bool capped =
        node_max_tasks[n] > 0 && ntask[n] >= node_max_tasks[n];
    // Slab classes holding node n (the sparse win: ~C*K/N of them).
    for (int64_t at = inv_start[n]; at < inv_start[n + 1]; ++at) {
      SlabHeap& h = heaps[inv_class[at]];
      if (!h.init || h.widened) continue;
      const int32_t slot = inv_slot[at];
      const double c2 = h.cur[slot];
      if (std::isnan(c2)) continue;
      if (capped) {
        h.cur[slot] = std::numeric_limits<double>::quiet_NaN();
        continue;
      }
      if (c2 == kNegInf) continue;
      const double ns =
          score(h.rep_req, nidle, node_cap + n * R, lr_w, br_w) +
          cand_static[static_cast<int64_t>(inv_class[at]) * K + slot];
      h.cur[slot] = ns;
      h.heap.push({ns, slot});
    }
    // Widened classes see every node (masked SigHeap behavior).
    for (const int32_t c : widened_list) {
      SlabHeap& h = heaps[c];
      const double c2 = h.cur[n];
      if (std::isnan(c2)) continue;
      if (capped) {
        h.cur[n] = std::numeric_limits<double>::quiet_NaN();
        --h.feas_uncapped;
        continue;
      }
      if (c2 == kNegInf) continue;
      const double ns = node_score(h, n);
      h.cur[n] = ns;
      h.heap.push({ns, static_cast<int32_t>(n)});
    }
  };

  for (int64_t t = 0; t < T; ++t) {
    out_assign[t] = -1;
    while (pcur < P && pair_idx[pcur] < t) ++pcur;
    while (scur < S && score_idx[scur] < t) ++scur;
    const uint8_t* prow =
        (pcur < P && pair_idx[pcur] == t) ? pair_feas + pcur * N : nullptr;
    const float* srow =
        (scur < S && score_idx[scur] == t) ? score_rows + scur * N : nullptr;

    if (!task_valid[t]) continue;
    const int64_t j = task_job[t];
    if (j >= 0 && j < T && job_failed[j]) continue;
    const float* req = task_req + t * R;
    const float* fit = task_fit + t * R;
    const int64_t q = task_queue[t];
    if (q >= 0 && q < Q &&
        overused(queue_deserved + q * R, qalloc.data() + q * R, eps, R)) {
      continue;
    }
    const uint8_t* grow =
        (task_group[t] >= 0 && task_group[t] < G)
            ? group_feas + task_group[t] * N
            : nullptr;

    // Full dense scan (fallback for out-of-range class ids and for
    // widen-budget overflow): the masked loop's scan path, serial.
    auto scan_allocate = [&]() {
      int64_t best = -1;
      double best_score = -1.0e300;
      bool any_feasible = false;
      for (int64_t n = 0; n < N; ++n) {
        if (!node_feas[n]) continue;
        if (grow && !grow[n]) continue;
        if (prow && !prow[n]) continue;
        if (node_max_tasks[n] > 0 && ntask[n] >= node_max_tasks[n])
          continue;
        any_feasible = true;
        if (!fits(fit, idle.data() + n * R, eps, R)) continue;
        double s2 = score(req, idle.data() + n * R, node_cap + n * R,
                          lr_w, br_w);
        if (srow) s2 += srow[n];
        if (s2 > best_score) {
          best_score = s2;
          best = n;
        }
      }
      if (best >= 0) {
        apply_allocate(t, best);
      } else if (!any_feasible && j >= 0 && j < T) {
        job_failed[j] = 1;
      }
    };

    const int64_t cid = task_cand ? task_cand[t] : -1;
    if (cid < 0 || cid >= C) {
      ++scans;
      scan_allocate();
      continue;
    }
    SlabHeap& h = heaps[cid];
    if (!h.init) {
      h.init = true;
      ++inits;
      h.rep_req = req;
      h.rep_fit = fit;
      h.grow = grow;
      h.prow = prow;
      h.srow = srow;
      h.cur.assign(K, std::numeric_limits<double>::quiet_NaN());
      for (int64_t s2 = 0; s2 < K; ++s2) {
        const int32_t n = cand_idx[cid * K + s2];
        if (n < 0 || n >= N) continue;
        // Selection vetted predicates/fit at snapshot; caps may have
        // filled since (this very solve), so re-check them here.
        if (node_max_tasks[n] > 0 && ntask[n] >= node_max_tasks[n])
          continue;
        const double sc =
            score(req, idle.data() + n * R, node_cap + n * R, lr_w,
                  br_w) +
            cand_static[cid * K + s2];
        h.cur[s2] = sc;
        h.heap.push({sc, static_cast<int32_t>(s2)});
      }
    }

    auto pop_best = [&]() -> int64_t {
      while (!h.heap.empty()) {
        const auto top = h.heap.top();
        const int32_t i = top.second;
        if (top.first != h.cur[i]) {  // stale (NaN/-inf compare false)
          h.heap.pop();
          continue;
        }
        const int64_t n = h.widened ? i : cand_idx[cid * K + i];
        if (!fits(h.rep_fit, idle.data() + n * R, eps, R)) {
          h.cur[i] = kNegInf;  // permanent: idle only decreases
          h.heap.pop();
          continue;
        }
        return n;
      }
      return -1;
    };

    int64_t best = pop_best();
    if (best < 0 && !h.widened && cand_total[cid] > K) {
      // Truncated slab exhausted: refill. Widen to a full-N heap when
      // the budget allows, else per-task dense scan.
      if (widened_list.size() < kMaxWidened) {
        widen(h);
        widened_list.push_back(static_cast<int32_t>(cid));
        ++refills;
        best = pop_best();
      } else {
        ++scans;
        scan_allocate();
        continue;
      }
    }
    if (best < 0) {
      if (h.widened) {
        // Widened heaps track cap removals exactly like a masked
        // SigHeap: feas_uncapped IS the current any_feasible.
        if (h.feas_uncapped == 0 && j >= 0 && j < T) job_failed[j] = 1;
      } else if (cand_anyfeas[cid] == 0) {
        // No predicate-feasible cap-open node even at snapshot time;
        // caps only saturate, so none exists now either.
        if (j >= 0 && j < T) job_failed[j] = 1;
      } else {
        // Complete slab exhausted but the class HAD feasible nodes at
        // snapshot: the job-break verdict depends on CURRENT pod-count
        // caps (a node saturating mid-solve must break the job exactly
        // like the masked loop). The scan cannot place the task — the
        // slab held every feasible+fit@snapshot node and idle only
        // shrinks — but it recomputes any_feasible at current state,
        // giving the masked loop's verdict bit-for-bit.
        ++scans;
        scan_allocate();
      }
      continue;
    }
    apply_allocate(t, best);
  }
  if (out_stats) {
    out_stats[0] = refills;
    out_stats[1] = scans;
    out_stats[2] = inits;
    out_stats[3] = static_cast<int64_t>(widened_list.size());
  }
  return placed;
}

}  // extern "C"
