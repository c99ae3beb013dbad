// Native SPASE scheduler core: joint (strategy, block, start-time) assignment.
//
// The reference delegated all native scheduling work to external C++ —
// Gurobi/CBC branch-and-bound behind PuLP (saturn/solver/milp.py:322-327) and
// Ray's C++ raylet for placement (saturn/executor/executor.py:59-62). This is
// the in-tree native equivalent for the TPU rebuild: a list-scheduling
// constructor plus time-bounded stochastic local search over task orderings.
// It consumes the same inputs as the Python MILP (per-task options of
// (block offset, block size, runtime) over a ring of `capacity` devices) and
// produces the same outputs (chosen option, start time per task, makespan).
//
// Used as the fast path for large batches and as the fallback when the MILP
// hits its time limit; the Python side validates the plan (no overlap on any
// device) before trusting it.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <random>
#include <utility>
#include <vector>

namespace {

struct Option {
  int offset;
  int size;
  double runtime;
};

struct Instance {
  int n_tasks = 0;
  int capacity = 0;
  double slack = 0.0;
  std::vector<std::vector<Option>> opts;
};

// Place tasks one by one in `order`; each task takes the (option, earliest
// aligned slot) pair minimizing its own finish time given what is already
// placed — unless `forced[t] >= 0` pins its option (the local-search move
// that escapes the myopic per-task choice, e.g. everyone-grabs-the-big-block
// schedules that a narrower option would parallelize). Occupied windows are
// extended by `slack` so consecutive tasks on a shared device keep the same
// separation the MILP's ordering constraints enforce. Returns the makespan
// (finish times exclude the slack pad).
double evaluate(const Instance& inst, const std::vector<int>& order,
                const std::vector<int>& forced, std::vector<int>& chosen,
                std::vector<double>& starts) {
  std::vector<std::vector<std::pair<double, double>>> busy(inst.capacity);
  double makespan = 0.0;
  chosen.assign(inst.n_tasks, -1);
  starts.assign(inst.n_tasks, 0.0);
  std::vector<std::pair<double, double>> merged;

  for (int t : order) {
    double best_fin = 1e300, best_start = 0.0;
    int best_opt = -1;
    const auto& topts = inst.opts[t];
    for (int oi = 0; oi < static_cast<int>(topts.size()); ++oi) {
      if (forced[t] >= 0 && forced[t] != oi) continue;
      const Option& o = topts[oi];
      merged.clear();
      for (int d = o.offset; d < o.offset + o.size; ++d)
        merged.insert(merged.end(), busy[d].begin(), busy[d].end());
      std::sort(merged.begin(), merged.end());
      const double dur = o.runtime + inst.slack;
      double t0 = 0.0;
      for (const auto& iv : merged) {
        if (t0 + dur <= iv.first) break;
        t0 = std::max(t0, iv.second);
      }
      const double fin = t0 + o.runtime;
      if (fin < best_fin) {
        best_fin = fin;
        best_start = t0;
        best_opt = oi;
      }
    }
    const Option& o = topts[best_opt];
    for (int d = o.offset; d < o.offset + o.size; ++d)
      busy[d].emplace_back(best_start, best_start + o.runtime + inst.slack);
    chosen[t] = best_opt;
    starts[t] = best_start;
    makespan = std::max(makespan, best_fin);
  }
  return makespan;
}

}  // namespace

extern "C" {

// Inputs are flattened: task t's options live at indices
// [opt_starts[t], opt_starts[t] + opt_counts[t]) of the *_flat arrays.
// warm_opt (nullable) warm-starts the search from a previous plan: warm_opt[t]
// is the option index to pin task t to in a second constructor pass (-1 = no
// pin); the local search then starts from whichever constructor won. This is
// the native analog of the reference's Gurobi warmStart seeding
// (saturn/solver/milp.py:103-104,151-155,323).
// Returns 0 on success, nonzero on malformed input.
// (v2: the warm_opt parameter was inserted in round 2 — the symbol is
// versioned so a stale prebuilt .so fails symbol lookup and the caller
// falls back gracefully instead of writing through a misplaced pointer.)
int spase_solve_v2(int n_tasks, const int* opt_counts, const int* opt_offset_flat,
                const int* opt_size_flat, const double* opt_runtime_flat,
                int capacity, double time_limit_s, double ordering_slack,
                uint64_t seed, const int* warm_opt, int* chosen_out,
                double* start_out, double* makespan_out) {
  if (n_tasks <= 0 || capacity <= 0) return 1;

  Instance inst;
  inst.n_tasks = n_tasks;
  inst.capacity = capacity;
  inst.slack = ordering_slack;
  inst.opts.resize(n_tasks);
  int flat = 0;
  for (int t = 0; t < n_tasks; ++t) {
    if (opt_counts[t] <= 0) return 2;  // task with no feasible option
    for (int i = 0; i < opt_counts[t]; ++i, ++flat) {
      Option o{opt_offset_flat[flat], opt_size_flat[flat],
               opt_runtime_flat[flat]};
      if (o.offset < 0 || o.size <= 0 || o.offset + o.size > capacity ||
          o.runtime < 0.0)
        return 3;
      inst.opts[t].push_back(o);
    }
  }

  // Constructor: longest-minimum-runtime first (the classic LPT rule, and
  // the same order the Python greedy uses).
  std::vector<int> order(n_tasks);
  for (int t = 0; t < n_tasks; ++t) order[t] = t;
  std::vector<double> min_rt(n_tasks);
  for (int t = 0; t < n_tasks; ++t) {
    double m = 1e300;
    for (const auto& o : inst.opts[t]) m = std::min(m, o.runtime);
    min_rt[t] = m;
  }
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return min_rt[a] > min_rt[b]; });

  std::vector<int> chosen, best_chosen;
  std::vector<double> starts, best_starts;
  std::vector<int> forced(n_tasks, -1);
  double best = evaluate(inst, order, forced, best_chosen, best_starts);

  // Warm constructor: pin each task to its previous plan's option and
  // re-evaluate; adopt if it beats (or ties) the LPT constructor so the
  // local search walks out from the incumbent schedule.
  if (warm_opt != nullptr) {
    std::vector<int> wforced(n_tasks, -1);
    bool any = false;
    for (int t = 0; t < n_tasks; ++t) {
      if (warm_opt[t] >= 0 && warm_opt[t] < static_cast<int>(inst.opts[t].size())) {
        wforced[t] = warm_opt[t];
        any = true;
      }
    }
    if (any) {
      std::vector<int> wchosen;
      std::vector<double> wstarts;
      const double wm = evaluate(inst, order, wforced, wchosen, wstarts);
      if (wm <= best) {
        best = wm;
        best_chosen = wchosen;
        best_starts = wstarts;
        forced = wforced;
      }
    }
  }

  // Local search: random order swap / reinsertion / option-pinning moves,
  // deterministic seed. Pinning a task's option (forced) is what escapes the
  // constructor's myopic min-finish choice — but a single pin usually lands
  // on a plateau (same makespan), so acceptance is "not worse": the walk
  // drifts sideways and coordinated multi-pin improvements can accumulate.
  // The strictly-best schedule is tracked separately and is what's returned.
  std::vector<int> cur_order = order, cur_forced = forced;
  double cur = best;
  const auto t_begin = std::chrono::steady_clock::now();
  const auto deadline =
      t_begin + std::chrono::duration<double>(std::max(0.0, time_limit_s));
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int> pick(0, n_tasks - 1);

  int stale = 0;
  const int max_stale = 20000;
  while (n_tasks > 0 && stale < max_stale &&
         std::chrono::steady_clock::now() < deadline) {
    order = cur_order;
    forced = cur_forced;
    const uint64_t move = rng() % 3;
    if (move == 0 && n_tasks > 1) {
      const int a = pick(rng);
      int b = pick(rng);
      while (b == a) b = pick(rng);
      std::swap(order[a], order[b]);
    } else if (move == 1 && n_tasks > 1) {
      const int a = pick(rng);
      int b = pick(rng);
      while (b == a) b = pick(rng);
      const int v = order[a];
      order.erase(order.begin() + a);
      order.insert(order.begin() + b, v);
    } else {
      const int t = pick(rng);
      const int nopt = static_cast<int>(inst.opts[t].size());
      // pin a random option, or release an existing pin.
      if (forced[t] >= 0 && (rng() & 1))
        forced[t] = -1;
      else
        forced[t] = static_cast<int>(rng() % nopt);
    }
    const double m = evaluate(inst, order, forced, chosen, starts);
    if (m <= cur + 1e-12) {  // accept sideways: plateau random walk
      cur = m;
      cur_order = order;
      cur_forced = forced;
    }
    if (m < best - 1e-12) {
      best = m;

      best_chosen = chosen;
      best_starts = starts;
      stale = 0;
    } else {
      ++stale;
    }
  }

  for (int t = 0; t < n_tasks; ++t) {
    chosen_out[t] = best_chosen[t];
    start_out[t] = best_starts[t];
  }
  *makespan_out = best;
  return 0;
}

}  // extern "C"
