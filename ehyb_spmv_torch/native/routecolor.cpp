// Bipartite edge coloring for the routing engine's stage-B step assignment
// (core/route.py).  Each dst-slice ("pair") is an independent bipartite
// multigraph: dst lanes (128) on one side, source lanes ("slots", 128) on the
// other, one edge per routed entry.  A valid stage-B schedule assigns every
// edge a step ("color") such that within a (pair, step) no lane and no slot
// repeats — exactly proper edge coloring.  König: Δ(pair) colors suffice; the
// sequential lowest-free-color greedy with 64-bit masks gets within ~1 round
// of Δ in practice, where the vectorized round-election in Python plateaued
// at ~1.5Δ (13% spill on random matrices).
//
// Role in the reference: the GPU ER phase needs no such schedule because
// global-memory gathers are hardware (the reference's kernel.cu:169-194);
// on TPU the schedule IS the gather.  Plain C ABI, loaded via ctypes like
// partition.cpp.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of spilled edges (color_out = -1), or -1 on bad args.
// pair[i] in [0, n_pairs); lane[i], slot[i] in [0, 128); order = processing
// sequence (indices into the edge arrays); max_colors <= 64.
long long ehyb_color_edges(long long n_edges,
                           const int32_t* pair,
                           const int16_t* lane,
                           const int16_t* slot,
                           const int64_t* order,
                           int32_t n_pairs,
                           int32_t max_colors,
                           int32_t* color_out) {
  if (n_edges < 0 || n_pairs <= 0 || max_colors < 1 || max_colors > 64)
    return -1;
  const uint64_t cap_mask =
      (max_colors == 64) ? ~0ull : ((1ull << max_colors) - 1ull);
  std::vector<uint64_t> lmask((size_t)n_pairs * 128, 0);
  std::vector<uint64_t> smask((size_t)n_pairs * 128, 0);
  long long spilled = 0;
  for (long long k = 0; k < n_edges; ++k) {
    const int64_t e = order[k];
    const size_t base = (size_t)pair[e] * 128;
    uint64_t& lm = lmask[base + (uint16_t)lane[e]];
    uint64_t& sm = smask[base + (uint16_t)slot[e]];
    const uint64_t free = ~(lm | sm) & cap_mask;
    if (!free) {
      color_out[e] = -1;
      ++spilled;
      continue;
    }
    const int c = __builtin_ctzll(free);
    const uint64_t bit = 1ull << c;
    lm |= bit;
    sm |= bit;
    color_out[e] = c;
  }
  return spilled;
}

// Class-aware variant for the routing engine's stage A.  There the "slot" is
// a lane of the gathered x vreg and carries a class attribution (the sublane
// index hi): two edges may share (color, slot) iff their classes are EQUAL —
// both lanes then read the same gathered element — while lane conflicts are
// unconditional.  This is the relaxed packer's election condition
// (convert.py _pack_steps_relaxed) run as a sequential lowest-free-color
// greedy; the vectorized round election left ~8x the structural cell-
// overflow floor unplaced on random_1m (210k vs 25k of 16.7M).
// cls[i] in [0, 256).  Returns spilled count, or -1 on bad args.
long long ehyb_color_edges_cls(long long n_edges,
                               const int32_t* pair,
                               const int16_t* lane,
                               const int16_t* slot,
                               const int16_t* cls,
                               const int64_t* order,
                               int32_t n_pairs,
                               int32_t max_colors,
                               int32_t* color_out) {
  if (n_edges < 0 || n_pairs <= 0 || max_colors < 1 || max_colors > 64)
    return -1;
  const uint64_t cap_mask =
      (max_colors == 64) ? ~0ull : ((1ull << max_colors) - 1ull);
  std::vector<uint64_t> lmask((size_t)n_pairs * 128, 0);
  std::vector<uint64_t> smask((size_t)n_pairs * 128, 0);
  // class stored per (pair, slot, color); only read under smask bits.
  std::vector<uint8_t> shi((size_t)n_pairs * 128 * max_colors, 0);
  long long spilled = 0;
  for (long long k = 0; k < n_edges; ++k) {
    const int64_t e = order[k];
    const size_t base = (size_t)pair[e] * 128;
    uint64_t& lm = lmask[base + (uint16_t)lane[e]];
    const size_t sb = base + (uint16_t)slot[e];
    uint64_t& sm = smask[sb];
    const uint8_t c8 = (uint8_t)cls[e];
    uint8_t* hi = &shi[sb * max_colors];
    // colors whose slot is occupied by a DIFFERENT class are forbidden
    uint64_t bad = 0;
    uint64_t occ = sm;
    while (occ) {
      const int c = __builtin_ctzll(occ);
      occ &= occ - 1;
      if (hi[c] != c8) bad |= 1ull << c;
    }
    const uint64_t free = ~(lm | bad) & cap_mask;
    if (!free) {
      color_out[e] = -1;
      ++spilled;
      continue;
    }
    // prefer a color where the slot already holds this class (free ride —
    // no new slot pressure), else the lowest fresh color
    const uint64_t ride = free & sm;
    const int c = __builtin_ctzll(ride ? ride : free);
    const uint64_t bit = 1ull << c;
    lm |= bit;
    sm |= bit;
    hi[c] = c8;
    color_out[e] = c;
  }
  return spilled;
}

// Stage-A colorer with B-side slot balancing.  The stripe chosen here fixes
// the entry's position in its band's transposed group, and stage B's select
// schedule is edge-colored with that position's lane (flat_g % 128) as the
// slot — per-slice widths bind on the MAX slot load (Poisson max ~2x mean on
// random matrices).  So among the stage-A-feasible stripes, pick the one
// whose resulting B slot currently has the lowest load for the entry's dst
// slice: slot(c) = (w*P + perm[w*P + c]) % 128 (perm = the stripe scramble
// applied by the builder afterwards).  Free rides (slot already holds this
// class) win ties — they add no A-slot pressure.
long long ehyb_color_edges_cls_bal(long long n_edges,
                                   const int32_t* pair,
                                   const int16_t* lane,
                                   const int16_t* slot,
                                   const int16_t* cls,
                                   const int32_t* win,
                                   const int32_t* dslice,
                                   const int16_t* perm,
                                   const int64_t* order,
                                   int32_t n_pairs,
                                   int32_t n_dslices,
                                   int32_t P,
                                   int32_t* color_out) {
  if (n_edges < 0 || n_pairs <= 0 || n_dslices <= 0 || P < 1 || P > 64)
    return -1;
  const uint64_t cap_mask = (P == 64) ? ~0ull : ((1ull << P) - 1ull);
  std::vector<uint64_t> lmask((size_t)n_pairs * 128, 0);
  std::vector<uint64_t> smask((size_t)n_pairs * 128, 0);
  std::vector<uint8_t> shi((size_t)n_pairs * 128 * P, 0);
  std::vector<int32_t> bload((size_t)n_dslices * 128, 0);
  long long spilled = 0;
  for (long long k = 0; k < n_edges; ++k) {
    const int64_t e = order[k];
    const size_t base = (size_t)pair[e] * 128;
    uint64_t& lm = lmask[base + (uint16_t)lane[e]];
    const size_t sb = base + (uint16_t)slot[e];
    uint64_t& sm = smask[sb];
    const uint8_t c8 = (uint8_t)cls[e];
    uint8_t* hi = &shi[sb * P];
    uint64_t bad = 0;
    uint64_t occ = sm;
    while (occ) {
      const int c = __builtin_ctzll(occ);
      occ &= occ - 1;
      if (hi[c] != c8) bad |= 1ull << c;
    }
    uint64_t free = ~(lm | bad) & cap_mask;
    if (!free) {
      color_out[e] = -1;
      ++spilled;
      continue;
    }
    const int64_t wP = (int64_t)win[e] * P;
    int32_t* bl = &bload[(size_t)dslice[e] * 128];
    int best = -1;
    int64_t best_cost = INT64_MAX;
    while (free) {
      const int c = __builtin_ctzll(free);
      free &= free - 1;
      const int bslot = (int)((wP + perm[wP + c]) & 127);
      // x2: balance dominates; -1: prefer a free ride at equal load
      const int64_t cost = 2 * (int64_t)bl[bslot] - ((sm >> c) & 1);
      if (cost < best_cost) {
        best_cost = cost;
        best = c;
      }
    }
    const uint64_t bit = 1ull << best;
    lm |= bit;
    sm |= bit;
    hi[best] = c8;
    bl[(wP + perm[wP + best]) & 127] += 1;
    color_out[e] = best;
  }
  return spilled;
}

// Relaxed SELL-body step assignment (convert.py::_sell_pack_relaxed): the
// same class-aware condition as ehyb_color_edges_cls — per (pair, step) each
// lane at most once, each slot single-class — but with UNBOUNDED colors (the
// body never spills; a pair's step count is whatever its Δ demands) and the
// objective "minimize per-pair max color" (padded stream size), served by
// the same lowest-free-color greedy.  Replaces the vectorized round
// election (_pack_steps_relaxed), which cost ~5.5 min at 84M nnz on
// permuted_poisson_4096 AND packs ~1.1-1.5x looser (the election assigns
// one step per round; the greedy backfills).  Reference economics analog:
// the one-pass C converter, convert.c:170-311.
//
// order MUST be grouped by pair (entries of one pair contiguous) — the
// caller's hint sort is pair-primary.  Masks are word-chunked uint64 with
// per-pair epochs (no O(n_pairs) state, no per-pair memset).  Returns the
// max color used + 1, or -1 on bad args, -2 if some pair exceeds MAXC.
long long ehyb_pack_relaxed(long long n_edges,
                            const int64_t* pair,
                            const int16_t* lane,
                            const int16_t* slot,
                            const int16_t* cls,
                            const int64_t* order,
                            int32_t* color_out) {
  if (n_edges < 0) return -1;
  constexpr int W = 256;             // 16384-color cap per pair
  constexpr int MAXC = W * 64;
  static_assert(MAXC <= INT16_MAX + 1, "hub cap");
  std::vector<uint64_t> lmask(128 * W, 0), smask(128 * W, 0);
  std::vector<int64_t> lepoch(128, -1), sepoch(128, -1);
  std::vector<int32_t> lhi(128, 0), shi_hi(128, 0);  // high-water word + 1
  // class per (slot, color); valid only under smask bits of this epoch
  std::vector<uint8_t> scls((size_t)128 * MAXC, 0);
  int64_t cur = -1;
  long long maxc = 0;
  for (long long k = 0; k < n_edges; ++k) {
    const int64_t e = order[k];
    if (pair[e] != cur) cur = pair[e];
    const int la = (uint16_t)lane[e], sl = (uint16_t)slot[e];
    uint64_t* lm = &lmask[(size_t)la * W];
    uint64_t* sm = &smask[(size_t)sl * W];
    if (lepoch[la] != cur) {
      std::memset(lm, 0, (size_t)lhi[la] * 8);
      lepoch[la] = cur;
      lhi[la] = 0;
    }
    if (sepoch[sl] != cur) {
      std::memset(sm, 0, (size_t)shi_hi[sl] * 8);
      sepoch[sl] = cur;
      shi_hi[sl] = 0;
    }
    const uint8_t c8 = (uint8_t)cls[e];
    uint8_t* hi = &scls[(size_t)sl * MAXC];
    int c = -1;
    for (int w = 0; w < W; ++w) {
      // free ride first: slot occupied by the SAME class and lane free
      uint64_t occ = sm[w] & ~lm[w];
      uint64_t ride = 0;
      while (occ) {
        const int b = __builtin_ctzll(occ);
        occ &= occ - 1;
        if (hi[w * 64 + b] == c8) { ride = 1ull << b; break; }
      }
      if (ride) { c = w * 64 + __builtin_ctzll(ride); }
      else {
        const uint64_t freeb = ~(lm[w] | sm[w]);
        if (freeb) c = w * 64 + __builtin_ctzll(freeb);
      }
      if (c >= 0) {
        const uint64_t bit = 1ull << (c & 63);
        lm[w] |= bit;
        sm[w] |= bit;
        hi[c] = c8;
        if (w + 1 > lhi[la]) lhi[la] = w + 1;
        if (w + 1 > shi_hi[sl]) shi_hi[sl] = w + 1;
        break;
      }
    }
    if (c < 0) return -2;
    color_out[e] = c;
    if (c + 1 > maxc) maxc = c + 1;
  }
  return maxc;
}

}  // extern "C"
