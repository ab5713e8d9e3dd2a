// Fast Matrix Market entry parser (native data-loader).
//
// The reference parses entries with fscanf in the main read loop
// (solver_test.c:196-206, 235-260) — C speed.  The Python reader's
// token-by-token float() costs minutes at audikw_1 scale (231M tokens);
// this parser restores C speed through a single forward scan with
// strtoll/strtod, skipping '%' comment lines inline.
//
// C ABI only (ctypes binding; no pybind11 in this environment).
#include <cstdlib>
#include <cstdint>

extern "C" {

// Parse whitespace-separated coordinate entries from buf (null-terminated,
// len bytes of payload).  ncols = 2 (pattern: i j) or 3 (i j value).
// Writes up to max_entries into row/col/val (val ignored when ncols == 2
// or val == nullptr).  Returns the number parsed, or a negative error:
//   -1/-2/-3 malformed token in field 1/2/3, -4 trailing garbage,
//   -5 more entries than max_entries present.
long long ehyb_parse_entries(const char* buf, long long len, int ncols,
                             long long max_entries,
                             long long* row, long long* col, double* val) {
    const char* p = buf;
    const char* end = buf + len;
    long long n = 0;
    while (p < end) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r')) ++p;
        if (p >= end) break;
        if (*p == '%') {                  // comment line
            while (p < end && *p != '\n') ++p;
            continue;
        }
        if (n >= max_entries) return -5;
        char* q;
        long long i = strtoll(p, &q, 10);
        if (q == p) return -1;
        p = q;
        long long j = strtoll(p, &q, 10);
        if (q == p) return -2;
        p = q;
        row[n] = i;
        col[n] = j;
        if (ncols == 3) {
            double v = strtod(p, &q);
            if (q == p) return -3;
            p = q;
            if (val) val[n] = v;  // val is n_entries long only when ncols==3
        }
        ++n;
    }
    return n;
}

}  // extern "C"
