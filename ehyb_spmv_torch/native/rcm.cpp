// Native pseudo-RCM: the level-set BFS ordering of core/ordering.py::
// rcm_order as one C++ pass, bit-for-bit identical output.
//
// Why native: at permuted_poisson_4096 scale (16.7M vertices, 84M adjacency
// entries) the NumPy per-level formulation spent ~190 s — each level pays a
// frontier-neighbor unique() (full sort) plus a degree argsort, and a
// scrambled stencil graph has thousands of shallow levels.  Here a level is
// one linear gather (dedupe via the visited bitmap) + one (deg, id) sort of
// the level only; total O(E + V log V_level).  The ordering phase is host
// preprocessing, off the measured path (reference analog: the reorder pass,
// reordering.c:231-378, also host-side C).
//
// Exact-equivalence contract with the NumPy path (pinned by
// tests/test_ordering.py::test_native_rcm_equivalence): seeds are the
// unvisited vertex of minimum (degree, id); each level's members are the
// unvisited neighbors of the previous level sorted by (degree, id) —
// np.unique gives the id sort, the stable degree argsort layers (deg, id)
// on top.  Output is the REVERSED concatenation of levels (new_to_old).
#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Symmetrized CSR adjacency (A ∪ Aᵀ pattern, self-loops removed) — the
// graph the reference feeds METIS (reordering.c:50-89).  Counting-sort by
// row then per-row sort+unique replaces the NumPy fused-key global sort
// (~70 s over a 168M-key int64 sort at permuted_poisson_4096 scale; this is
// O(E + Σ deg·log deg) ≈ seconds).  Output contract (pinned by
// tests/test_plan_reorder.py::test_native_adjacency_equivalence): per-row
// neighbor lists ascending, deduplicated, diagonal dropped — bit-identical
// to partition.py::adjacency_csr.
//
// adjncy must have room for 2*nnz entries; returns the compacted adjacency
// length (<= 2*nnz), or <0 on error.  xadj [n+1] out.
long long ehyb_adjacency(long long nnz, const int64_t *row,
                         const int64_t *col, long long n, int32_t *xadj,
                         int32_t *adjncy) {
    if (nnz < 0 || n < 0) return -1;
    std::vector<int64_t> cnt(n + 1, 0);
    for (long long i = 0; i < nnz; ++i) {
        if (row[i] != col[i]) {
            ++cnt[row[i] + 1];
            ++cnt[col[i] + 1];
        }
    }
    std::vector<int64_t> base(n + 1);
    base[0] = 0;
    for (long long v = 0; v < n; ++v) base[v + 1] = base[v] + cnt[v + 1];
    std::vector<int64_t> head(base.begin(), base.end() - 1);
    std::vector<int32_t> buf(base[n]);
    for (long long i = 0; i < nnz; ++i) {
        if (row[i] != col[i]) {
            buf[head[row[i]]++] = (int32_t)col[i];
            buf[head[col[i]]++] = (int32_t)row[i];
        }
    }
    long long out = 0;
    xadj[0] = 0;
    for (long long v = 0; v < n; ++v) {
        int32_t *b = buf.data() + base[v], *e = buf.data() + base[v + 1];
        std::sort(b, e);
        int32_t prev = -1;
        for (int32_t *p = b; p < e; ++p) {
            if (*p != prev) adjncy[out++] = prev = *p;
        }
        xadj[v + 1] = (int32_t)out;
    }
    return out;
}

// xadj [n+1], adjncy [xadj[n]]: CSR adjacency (symmetric, no self loops
// required).  out [n]: new_to_old permutation.  Returns 0, or <0 on error.
long long ehyb_rcm(long long n, const int32_t *xadj, const int32_t *adjncy,
                   int64_t *out) {
    if (n < 0) return -1;
    std::vector<uint8_t> visited(n, 0);
    std::vector<int64_t> order;
    order.reserve(n);

    // Seed scan order: (degree, id) ascending == np.argsort(deg, stable).
    std::vector<int64_t> seed_order(n);
    for (int64_t i = 0; i < n; ++i) seed_order[i] = i;
    std::stable_sort(seed_order.begin(), seed_order.end(),
                     [&](int64_t a, int64_t b) {
                         return xadj[a + 1] - xadj[a] < xadj[b + 1] - xadj[b];
                     });

    std::vector<int64_t> frontier, next;
    int64_t seed_ptr = 0;
    while ((int64_t)order.size() < n) {
        while (seed_ptr < n && visited[seed_order[seed_ptr]]) ++seed_ptr;
        if (seed_ptr >= n) {  // unreachable (every vertex is a seed candidate)
            for (int64_t v = 0; v < n; ++v)
                if (!visited[v]) order.push_back(v);
            break;
        }
        int64_t s = seed_order[seed_ptr];
        visited[s] = 1;
        frontier.assign(1, s);
        while (!frontier.empty()) {
            order.insert(order.end(), frontier.begin(), frontier.end());
            next.clear();
            for (int64_t u : frontier) {
                for (int32_t e = xadj[u]; e < xadj[u + 1]; ++e) {
                    int64_t v = adjncy[e];
                    if (!visited[v]) {
                        visited[v] = 1;
                        next.push_back(v);
                    }
                }
            }
            // (deg, id) ascending: plain sort on the composite key — ids are
            // unique so the comparator is a strict weak order with no ties.
            std::sort(next.begin(), next.end(), [&](int64_t a, int64_t b) {
                int32_t da = xadj[a + 1] - xadj[a], db = xadj[b + 1] - xadj[b];
                return da != db ? da < db : a < b;
            });
            frontier.swap(next);
        }
    }
    if ((int64_t)order.size() != n) return -2;
    for (int64_t i = 0; i < n; ++i) out[i] = order[n - 1 - i];  // reverse
    return 0;
}

}  // extern "C"
