// Native DIA extraction: the O(nnz) count + scatter passes of
// core/convert.py::extract_diagonals in two tight C loops.
//
// The reference's converter is one C pass over nnz (convert.c:170-311); the
// TPU framework's DIA phase has no reference analog (GPUs gather x from
// global memory, so the reference never densifies diagonals), but its cost
// profile must match the reference's converter economics: measured on the
// audikw-class fem3d_68 (74.2M nnz), the NumPy formulation spent ~50 s in
// ~14 full-size array passes (mask building, double fancy-indexing, i64
// temporaries).  These two passes touch each entry twice at memory speed.
//
// Pass 1 (count):  counts[d - lo]++ for every in-band entry, d = col - row.
// Pass 2 (fill):   after the caller picks the dense offsets and builds
//                  off_rank, scatter-add values into the (K, dim_r) dense
//                  diagonal block and emit the per-entry keep mask.
//
// Accumulation is f64 regardless of the target dtype (duplicate COO entries
// must sum exactly like the dense semantics; the caller downcasts once).
#include <cstdint>

extern "C" {

// counts must be zero-initialized, length (hi - lo + 1).
long long ehyb_dia_count(long long nnz, const int64_t *row,
                         const int64_t *col, int64_t lo, int64_t hi,
                         int64_t *counts) {
    if (nnz < 0 || hi < lo) return -1;
    for (long long i = 0; i < nnz; ++i) {
        int64_t d = col[i] - row[i];
        if (d >= lo && d <= hi) counts[d - lo]++;
    }
    return 0;
}

// off_rank: length (hi - lo + 1), rank in [0, K) for extracted offsets,
// -1 otherwise.  dia: zero-initialized (K * dim_r) f64.  keep: nnz u8 out.
long long ehyb_dia_fill(long long nnz, const int64_t *row, const int64_t *col,
                        const double *val, int64_t lo, int64_t hi,
                        const int32_t *off_rank, int64_t dim_r, double *dia,
                        uint8_t *keep) {
    if (nnz < 0 || hi < lo || dim_r <= 0) return -1;
    long long kept = 0;
    for (long long i = 0; i < nnz; ++i) {
        int64_t d = col[i] - row[i];
        int32_t r = (d >= lo && d <= hi) ? off_rank[d - lo] : -1;
        if (r >= 0) {
            dia[(int64_t)r * dim_r + row[i]] += val[i];
            keep[i] = 1;
            ++kept;
        } else {
            keep[i] = 0;
        }
    }
    return kept;
}

}  // extern "C"
