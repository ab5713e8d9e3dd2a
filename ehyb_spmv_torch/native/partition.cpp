// Multilevel k-way graph partitioner (mt-metis replacement).
//
// Role of the reference's prebuilt libmtmetis.a (MTMETIS_PartGraphKway,
// mtmetis.h:150, invoked at reordering.c:126-139 and reordering.c:280-293):
// given a CSR adjacency graph, compute a balanced k-way vertex partition with a
// small edge cut.  In the EHYB pipeline the edge cut is exactly the number of
// out-of-window (ER) matrix entries, so cut quality = kernel regularity;
// correctness never depends on it.
//
// Classic multilevel scheme (Karypis-Kumar style, written from scratch):
//   1. coarsen by heavy-edge matching until the graph is small;
//   2. initial partition by greedy region growing on the coarsest graph;
//   3. uncoarsen, projecting the partition and applying greedy boundary
//      refinement (FM-lite sweeps) under a balance constraint at every level.
//
// Plain C ABI for ctypes (no pybind11).  Single-threaded; the host
// preprocessing is one-time and off the measured path (cf. SURVEY.md §3.1).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <random>
#include <vector>

namespace {

using i32 = int32_t;
using i64 = int64_t;

struct Graph {
  i32 n = 0;
  std::vector<i32> xadj;    // [n+1]
  std::vector<i32> adjncy;  // [m]
  std::vector<i32> adjwgt;  // [m] edge weights (1 on the finest level)
  std::vector<i32> vwgt;    // [n] vertex weights (1 on the finest level)
  i64 total_vwgt = 0;
};

// ---------------------------------------------------------------------------
// Coarsening: heavy-edge matching + contraction.
// ---------------------------------------------------------------------------

// Match each vertex with its heaviest-edge unmatched neighbor (random visit
// order).  Returns coarse vertex count; fills cmap[v] = coarse id.
i32 heavy_edge_matching(const Graph& g, std::vector<i32>* cmap,
                        std::mt19937* rng) {
  std::vector<i32> order(g.n);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), *rng);
  std::vector<i32> match(g.n, -1);
  for (i32 v : order) {
    if (match[v] != -1) continue;
    i32 best = -1;
    i32 best_w = -1;
    for (i32 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
      const i32 u = g.adjncy[e];
      if (u == v || match[u] != -1) continue;
      if (g.adjwgt[e] > best_w) {
        best_w = g.adjwgt[e];
        best = u;
      }
    }
    if (best != -1) {
      match[v] = best;
      match[best] = v;
    } else {
      match[v] = v;
    }
  }
  i32 cn = 0;
  cmap->assign(g.n, -1);
  for (i32 v = 0; v < g.n; ++v) {
    if ((*cmap)[v] != -1) continue;
    const i32 u = match[v];
    (*cmap)[v] = cn;
    if (u != v) (*cmap)[u] = cn;
    ++cn;
  }
  return cn;
}

Graph contract(const Graph& g, const std::vector<i32>& cmap, i32 cn) {
  Graph cg;
  cg.n = cn;
  cg.vwgt.assign(cn, 0);
  for (i32 v = 0; v < g.n; ++v) cg.vwgt[cmap[v]] += g.vwgt[v];
  cg.total_vwgt = g.total_vwgt;

  // Counting-sort fine vertices by coarse id (no per-vertex vectors — the
  // vector-of-vectors formulation spent most of its time in the allocator
  // at 1M-vertex scale), then merge duplicate targets per coarse vertex
  // with a scratch "seen" table.
  std::vector<i32> coff(cn + 1, 0);
  for (i32 v = 0; v < g.n; ++v) ++coff[cmap[v] + 1];
  for (i32 c = 0; c < cn; ++c) coff[c + 1] += coff[c];
  std::vector<i32> verts(g.n);
  {
    std::vector<i32> pos(coff.begin(), coff.end() - 1);
    for (i32 v = 0; v < g.n; ++v) verts[pos[cmap[v]]++] = v;
  }

  cg.xadj.assign(cn + 1, 0);
  cg.adjncy.reserve(g.adjncy.size());
  cg.adjwgt.reserve(g.adjncy.size());
  std::vector<i32> seen(cn, -1);
  std::vector<i32> tmp_nbr;
  std::vector<i32> tmp_wgt;
  for (i32 c = 0; c < cn; ++c) {
    tmp_nbr.clear();
    tmp_wgt.clear();
    for (i32 i = coff[c]; i < coff[c + 1]; ++i) {
      const i32 v = verts[i];
      for (i32 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        const i32 cu = cmap[g.adjncy[e]];
        if (cu == c) continue;  // internal edge vanishes
        if (seen[cu] == -1) {
          seen[cu] = static_cast<i32>(tmp_nbr.size());
          tmp_nbr.push_back(cu);
          tmp_wgt.push_back(g.adjwgt[e]);
        } else {
          tmp_wgt[seen[cu]] += g.adjwgt[e];
        }
      }
    }
    for (i32 u : tmp_nbr) seen[u] = -1;
    cg.xadj[c + 1] = cg.xadj[c] + static_cast<i32>(tmp_nbr.size());
    cg.adjncy.insert(cg.adjncy.end(), tmp_nbr.begin(), tmp_nbr.end());
    cg.adjwgt.insert(cg.adjwgt.end(), tmp_wgt.begin(), tmp_wgt.end());
  }
  return cg;
}

// ---------------------------------------------------------------------------
// Initial partition: greedy region growing on the coarsest graph.
// ---------------------------------------------------------------------------

void initial_partition(const Graph& g, i32 nparts, double max_wgt,
                       std::vector<i32>* part, std::mt19937* rng) {
  part->assign(g.n, -1);
  std::vector<i64> pw(nparts, 0);
  std::vector<i32> frontier;
  std::uniform_int_distribution<i32> pick(0, g.n - 1);

  for (i32 p = 0; p < nparts - 1; ++p) {
    // Seed: an unassigned vertex (prefer one adjacent to assigned regions'
    // boundary being closed off; random is fine in practice).
    i32 seed = -1;
    for (i32 t = 0; t < 64 && seed == -1; ++t) {
      const i32 c = pick(*rng);
      if ((*part)[c] == -1) seed = c;
    }
    if (seed == -1) {
      for (i32 v = 0; v < g.n; ++v)
        if ((*part)[v] == -1) { seed = v; break; }
    }
    if (seed == -1) break;

    // BFS-ish growth until the part reaches its target weight.
    frontier.clear();
    frontier.push_back(seed);
    (*part)[seed] = p;
    pw[p] += g.vwgt[seed];
    size_t head = 0;
    const i64 target = static_cast<i64>(g.total_vwgt / nparts);
    while (head < frontier.size() && pw[p] < target &&
           pw[p] < static_cast<i64>(max_wgt)) {
      const i32 v = frontier[head++];
      for (i32 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        const i32 u = g.adjncy[e];
        if ((*part)[u] != -1) continue;
        if (pw[p] + g.vwgt[u] > static_cast<i64>(max_wgt)) continue;
        (*part)[u] = p;
        pw[p] += g.vwgt[u];
        frontier.push_back(u);
        if (pw[p] >= target) break;
      }
    }
  }
  // Remainder → last part, spilling to the lightest part if overweight.
  for (i32 v = 0; v < g.n; ++v) {
    if ((*part)[v] == -1) {
      (*part)[v] = nparts - 1;
      pw[nparts - 1] += g.vwgt[v];
    }
  }
  // Rebalance pass: move vertices out of overweight parts greedily.
  for (i32 v = g.n - 1; v >= 0; --v) {
    const i32 p = (*part)[v];
    if (pw[p] <= static_cast<i64>(max_wgt)) continue;
    const i32 lightest =
        static_cast<i32>(std::min_element(pw.begin(), pw.end()) - pw.begin());
    if (lightest == p) continue;
    (*part)[v] = lightest;
    pw[p] -= g.vwgt[v];
    pw[lightest] += g.vwgt[v];
  }
}

// ---------------------------------------------------------------------------
// Refinement: greedy boundary sweeps (FM-lite) under a balance constraint.
// ---------------------------------------------------------------------------

void refine(const Graph& g, i32 nparts, double max_wgt, std::vector<i32>* part,
            int passes) {
  std::vector<i64> pw(nparts, 0);
  for (i32 v = 0; v < g.n; ++v) pw[(*part)[v]] += g.vwgt[v];

  std::vector<i64> conn(nparts, 0);  // scratch: edge weight to each part
  std::vector<i32> touched;
  // Boundary-restricted sweeps: pass 0 visits every vertex; later passes
  // only vertices whose neighborhood changed (a move can only alter the
  // gain of the mover's neighbors).  On structureless graphs the full
  // sweeps dominated the partition cost — 4 passes x O(m) random access
  // per uncoarsen level was the bulk of a 261 s powerlaw_1m partition.
  std::vector<uint8_t> active(g.n, 1);
  std::vector<uint8_t> next_active(g.n, 0);
  for (int pass = 0; pass < passes; ++pass) {
    i64 moved = 0;
    for (i32 v = 0; v < g.n; ++v) {
      if (!active[v]) continue;
      const i32 pv = (*part)[v];
      touched.clear();
      for (i32 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        const i32 u = g.adjncy[e];
        const i32 pu = (*part)[u];
        if (conn[pu] == 0) touched.push_back(pu);
        conn[pu] += g.adjwgt[e];
      }
      // Best destination: max external connectivity, gain > 0, fits balance.
      i32 best = pv;
      i64 best_gain = 0;
      for (i32 p : touched) {
        if (p == pv) continue;
        const i64 gain = conn[p] - conn[pv];
        if (gain > best_gain &&
            pw[p] + g.vwgt[v] <= static_cast<i64>(max_wgt)) {
          best_gain = gain;
          best = p;
        }
      }
      for (i32 p : touched) conn[p] = 0;
      if (best != pv) {
        (*part)[v] = best;
        pw[pv] -= g.vwgt[v];
        pw[best] += g.vwgt[v];
        ++moved;
        next_active[v] = 1;
        for (i32 e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
          next_active[g.adjncy[e]] = 1;
      }
    }
    // Diminishing returns: stop when a pass moves (almost) nothing.
    if (moved <= g.n / 2000) break;
    active.swap(next_active);
    std::fill(next_active.begin(), next_active.end(), 0);
  }
}

i64 edge_cut(const Graph& g, const std::vector<i32>& part) {
  i64 cut = 0;
  for (i32 v = 0; v < g.n; ++v)
    for (i32 e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
      if (part[v] != part[g.adjncy[e]]) cut += g.adjwgt[e];
  return cut / 2;
}

}  // namespace

extern "C" {

// Returns the edge cut (>= 0) on success, -1 on invalid input.
// API shape mirrors MTMETIS_PartGraphKway (mtmetis.h:150).
long long ehyb_partition_kway(int n, const int* xadj, const int* adjncy,
                              int nparts, double imbalance, int seed,
                              int* part_out) {
  if (n <= 0 || nparts <= 0 || !xadj || !adjncy || !part_out) return -1;
  if (nparts == 1) {
    std::memset(part_out, 0, sizeof(int) * n);
    return 0;
  }
  std::mt19937 rng(static_cast<uint32_t>(seed) * 2654435761u + 12345u);

  Graph g;
  g.n = n;
  g.xadj.assign(xadj, xadj + n + 1);
  g.adjncy.assign(adjncy, adjncy + xadj[n]);
  g.adjwgt.assign(xadj[n], 1);
  g.vwgt.assign(n, 1);
  g.total_vwgt = n;

  const bool verbose = std::getenv("EHYB_PART_VERBOSE") != nullptr;
  const auto t0 = std::chrono::steady_clock::now();
  auto secs = [&t0]() {
    return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
        .count();
  };

  // Coarsen.
  std::vector<Graph> levels;
  std::vector<std::vector<i32>> cmaps;
  levels.push_back(std::move(g));
  const i32 coarse_target = std::max(256, 16 * nparts);
  while (levels.back().n > coarse_target) {
    std::vector<i32> cmap;
    const Graph& fine = levels.back();
    const i32 cn = heavy_edge_matching(fine, &cmap, &rng);
    if (cn >= fine.n * 95 / 100) break;  // matching stalled
    Graph coarse = contract(fine, cmap, cn);
    if (verbose)
      std::fprintf(stderr, "[part] %6.2fs level %zu: %d -> %d (m %zu)\n",
                   secs(), levels.size(), fine.n, cn, coarse.adjncy.size());
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(coarse));
  }

  // Initial partition on the coarsest level (+ heavy refinement there).
  const double max_wgt =
      imbalance * (static_cast<double>(levels[0].total_vwgt) / nparts) + 1.0;
  std::vector<i32> part;
  initial_partition(levels.back(), nparts, max_wgt, &part, &rng);
  if (verbose)
    std::fprintf(stderr, "[part] %6.2fs initial partition (n %d)\n", secs(),
                 levels.back().n);
  refine(levels.back(), nparts, max_wgt, &part, /*passes=*/8);
  if (verbose) std::fprintf(stderr, "[part] %6.2fs coarsest refine\n", secs());

  // Uncoarsen + refine at each level.
  for (i32 lvl = static_cast<i32>(levels.size()) - 2; lvl >= 0; --lvl) {
    const std::vector<i32>& cmap = cmaps[lvl];
    std::vector<i32> fine_part(levels[lvl].n);
    for (i32 v = 0; v < levels[lvl].n; ++v) fine_part[v] = part[cmap[v]];
    part = std::move(fine_part);
    refine(levels[lvl], nparts, max_wgt, &part, /*passes=*/lvl == 0 ? 2 : 4);
  }
  if (verbose) std::fprintf(stderr, "[part] %6.2fs uncoarsen+refine\n", secs());

  std::memcpy(part_out, part.data(), sizeof(int) * n);
  return edge_cut(levels[0], part);
}

}  // extern "C"
