// DIA body of the EHYB format: y[i] = sum_k dia_val[k, i] * x[i + d_k].
//
// Replaces ehyb_spmv_gpu_tpu/ops/dia_pallas.py::make_dia_pallas_apply (the
// Pallas kernel K9), both of its variants: x resident in VMEM (inner
// `kernel` at :131) and x streamed as block pairs (:115).  One kernel serves
// both here, since the card reads x from device memory at any size.
//
// For i < dim_r, with the K static offsets d_k (sorted ascending):
//
//   y[i] = sum over k of dia_val[k * dim_r + i] * x[i + d_k]
//
// and an x index outside [0, n_x) reads as zero (the padding of the plain
// torch op, ops/torch_ops.py::ehyb_dia).  An x base (the sharded apply's
// diagonals, which read a shard's x_ext past its left halo: row i reads
// x[x_base + i + d_k]) is the host plan's: it shifts every offset by the
// base (ops/dia.py::make_plan), so the kernel reads x[i + d] as ever.
// The terms are added in order of k, each product rounded on its own, as
// the plain version adds them.
//
// What the TPU needed and this leaves behind: pack_dia's (nb, K*Brows, 128)
// blocking, the lane roll and the sublane select that build each shifted x
// window in registers.  Here dia_val stays (K, dim_r) row-major.
//
// Bound on the H100: bytes.  Each call reads dia_val once and x and writes y:
// (K * dim_r + 2 * dim_r) * 4 B, ~381 MB at fem3d_68 (~114 us at 3.35 TB/s;
// twice that in float64).  Design:
//
// * Bytes in flight.  A thread owns quads of 4 consecutive rows and reads
//   each diagonal's 4 values with one 16-B streaming load (__ldcs: read
//   once, evicted first, so x keeps the caches).  STEP diagonals' loads are
//   issued together before any is summed, and several blocks share an SM,
//   so tens of KB per SM are requested at any time.
// * A persistent grid.  The host plan (ops/dia.py::make_plan) launches as
//   many blocks as stay resident, and deals equal tiles of at most
//   tile_quads quads to them round-robin: block b takes tiles b, b + grid,
//   b + 2 * grid, ..., as many as every other block give or take one (no
//   wave tail).  All
//   blocks then stream one window of each array at a time, which the card's
//   memory serves faster than one far-apart chunk of rows per block
//   (chip_dia_sweep.py: 4-6%).
// * x in one of two modes (the plan's x_mode):
//   - LDG: x through __ldg, from L1 and L2 (x is 3.77 MB at fem3d_68 and
//     stays in the 50 MB L2).  A tile whose reads all lie inside x takes an
//     unguarded path; in the few tiles at x's ends each thread checks its
//     own reads.
//   - STAGED: x per offset run (the plan's maximal runs of offsets with
//     small gaps; 9 runs of 11 at fem3d_68), one window of
//     T + span + 8 values per run and tile, zero-filled outside x.  The
//     windows of tile j + 1 are filled by cp.async while tile j is summed
//     (two buffers), so staging overlaps the value stream.
// * Shifted x without scalar loads: the quad at row i (a multiple of 4)
//   needs x[i + d .. i + d + 3], which starts d & 3 past a 16-B boundary
//   for every thread alike.  Two aligned 16-B loads and a select on that
//   warp-uniform shift give the four values.
//
// * float64 (the precision mode, ops/dword.py: f64 values, x, y and sums,
//   where the TPU carries (hi, lo) float pairs).  The tile stays four rows
//   a thread wide, so the plan's tiles, runs and walk are the float
//   kernel's; what 16 B hold changes.  A quad's four values are two 16-B
//   loads, and its shifted x is two aligned 16-B loads (three where
//   d is odd) and a select on the warp-uniform d & 1: every load stays
//   16-B aligned for every offset, where a two-rows-wide tile would halve
//   the bytes a thread has in flight.  The x windows are 16-B aligned in
//   doubles (wlo even), and the edge tests count two doubles a 16-B load.
//
// * Accumulate mode (ACC; the flagship's apply, ops/ehyb_stream.py): K1
//   writes y first (the body and the EHYB tail), and K9 finishes it in
//   place: each row's diagonal sum, formed in registers as in the write
//   mode, is added once into y (y[i] = y[i] + s), read and written with
//   the same 16-B accesses.  It costs y read once more; it saves the
//   separate DIA output, its fill and the add that combined them.  Built
//   at the default geometry's (STEP, QUADS) in float and double.
//
// Template parameters: T the value type (float or double), STEP diagonals
// per step, QUADS quads per thread per tile, STAGED x mode, VEC 16-B value
// loads (dim_r a multiple of 4 and dia_val 16-B aligned; else four guarded
// scalar loads), EDGE guarded x reads, ACC the accumulate mode.
//
// * The spread form (dia_kernel_spread, below): for DIA parts whose quads
//   are too few to fill the card, a block takes a tile of rows and spreads
//   its diagonals' products over its threads; each row is still summed in
//   order of k by one thread.  ops/dia.py::choose_geometry picks it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

template <typename T>
struct DiaArgs {
  const T* val;        // (n_diag, dim_r) row-major
  const int* table;    // [d_0..d_{K-1}, xo_0..xo_{K-1}, 4 ints per run]
  const T* x;          // n_x values, 16-B aligned
  T* y;                // dim_r values
  long long dim_r, n_x;
  int n_diag, n_runs;
  int d_min, d_max;    // first and last offset
  int tile_quads;      // most quads in a tile (threads * QUADS)
  int stage_floats;    // values of one buffer of staged windows
};

// Four rows' doubles: two 16-B halves.
struct dquad {
  double x, y, z, w;
};

// The quad type of a value type, and how many values one 16-B load holds
// (kVec, 2^kVecShift).
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
  static constexpr int kVec = 4, kVecShift = 2;
};
template <>
struct Quad<double> {
  using type = dquad;
  static constexpr int kVec = 2, kVecShift = 1;
};
template <typename T>
using quad_t = typename Quad<T>::type;

template <typename T>
__device__ __forceinline__ quad_t<T> zero_quad() {
  return quad_t<T>{T(0), T(0), T(0), T(0)};
}

// Block b's tiles: n_tiles of tq quads, the j-th starting at quad
// first + j * stride, cut at end (ops/dia.py::DiaPlan.tiles).  Tiles of one
// size, as many for every block, dealt round-robin.
struct Walk {
  long long first, stride, tq, n_tiles, end;
};

template <typename T>
__device__ __forceinline__ Walk block_walk(const DiaArgs<T>& a) {
  const long long nq = (a.dim_r + 3) / 4;
  const long long g = gridDim.x, b = blockIdx.x;
  const long long rounds = (nq + g * a.tile_quads - 1) / (g * a.tile_quads);
  Walk w;
  w.tq = (nq + g * rounds - 1) / (g * rounds);
  w.first = b * w.tq;
  w.stride = g * w.tq;
  w.n_tiles = w.first < nq ? (nq - w.first + w.stride - 1) / w.stride : 0;
  w.end = nq;
  return w;
}

__device__ __forceinline__ float4 shift4(float4 a, float4 b, int sh) {
  // values sh .. sh + 3 of the eight a.x .. b.w; sh is warp-uniform
  float4 r;
  r.x = sh == 0 ? a.x : sh == 1 ? a.y : sh == 2 ? a.z : a.w;
  r.y = sh == 0 ? a.y : sh == 1 ? a.z : sh == 2 ? a.w : b.x;
  r.z = sh == 0 ? a.z : sh == 1 ? a.w : sh == 2 ? b.x : b.y;
  r.w = sh == 0 ? a.w : sh == 1 ? b.x : sh == 2 ? b.y : b.z;
  return r;
}

template <bool VEC>
__device__ __forceinline__ float4 load_val(const float* vk, long long i,
                                           long long dim_r) {
  if (VEC) return __ldcs(reinterpret_cast<const float4*>(vk + i));
  float4 v;
  v.x = i < dim_r ? __ldcs(vk + i) : 0.0f;
  v.y = i + 1 < dim_r ? __ldcs(vk + i + 1) : 0.0f;
  v.z = i + 2 < dim_r ? __ldcs(vk + i + 2) : 0.0f;
  v.w = i + 3 < dim_r ? __ldcs(vk + i + 3) : 0.0f;
  return v;
}

template <bool VEC>
__device__ __forceinline__ dquad load_val(const double* vk, long long i,
                                          long long dim_r) {
  if (VEC) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(vk + i));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(vk + i + 2));
    return dquad{a.x, a.y, b.x, b.y};
  }
  dquad v;
  v.x = i < dim_r ? __ldcs(vk + i) : 0.0;
  v.y = i + 1 < dim_r ? __ldcs(vk + i + 1) : 0.0;
  v.z = i + 2 < dim_r ? __ldcs(vk + i + 2) : 0.0;
  v.w = i + 3 < dim_r ? __ldcs(vk + i + 3) : 0.0;
  return v;
}

__device__ __forceinline__ float add_rn_t(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ double add_rn_t(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ float ldg_or_zero(const float* x, long long n_x,
                                             long long g) {
  return (g >= 0 && g < n_x) ? __ldg(x + g) : 0.0f;
}

__device__ __forceinline__ double ldg_or_zero(const double* x, long long n_x,
                                              long long g) {
  return (g >= 0 && g < n_x) ? __ldg(x + g) : 0.0;
}

// x[a + sh .. a + sh + 3] from three 16-B pairs p0, p1, p2 at a, a + 2 and
// a + 4; sh (0 or 1) is warp-uniform.
__device__ __forceinline__ dquad shift2(double2 p0, double2 p1, double2 p2,
                                        int sh) {
  return sh ? dquad{p0.y, p1.x, p1.y, p2.x} : dquad{p0.x, p0.y, p1.x, p1.y};
}

// x[g .. g + 3] through L1/L2; g = i + d with i a multiple of 4.  In an
// edge tile only a thread whose pair of 16-B loads crosses an end of x reads
// the four values one by one, guarded.
template <bool EDGE>
__device__ __forceinline__ float4 load_x(const float* x, long long n_x,
                                         long long g) {
  const int sh = (int)(g & 3);
  const long long a = g - sh;
  if (EDGE && (a < 0 || a + 8 > n_x)) {
    return make_float4(ldg_or_zero(x, n_x, g), ldg_or_zero(x, n_x, g + 1),
                       ldg_or_zero(x, n_x, g + 2), ldg_or_zero(x, n_x, g + 3));
  }
  const float4 lo = __ldg(reinterpret_cast<const float4*>(x + a));
  const float4 hi =
      sh ? __ldg(reinterpret_cast<const float4*>(x + a + 4)) : lo;
  return shift4(lo, hi, sh);
}

// x[g .. g + 3] in doubles: g = a + sh with a even, pairs at a, a + 2 and
// (sh = 1) a + 4.  In an edge tile a thread whose pairs cross an end of x
// reads the four values one by one, guarded.
template <bool EDGE>
__device__ __forceinline__ dquad load_x(const double* x, long long n_x,
                                        long long g) {
  const int sh = (int)(g & 1);
  const long long a = g - sh;
  if (EDGE && (a < 0 || a + 6 > n_x)) {
    return dquad{ldg_or_zero(x, n_x, g), ldg_or_zero(x, n_x, g + 1),
                 ldg_or_zero(x, n_x, g + 2), ldg_or_zero(x, n_x, g + 3)};
  }
  const double2* p = reinterpret_cast<const double2*>(x + a);
  const double2 p0 = __ldg(p), p1 = __ldg(p + 1);
  return shift2(p0, p1, sh ? __ldg(p + 2) : p1, sh);
}

// x[i + d .. i + d + 3] in doubles from a staged window: w is the window
// at xo_k + (i - t0), x[i + (d & ~1)], 16-B aligned.
__device__ __forceinline__ dquad read_staged(const double* w, int d) {
  const int sh = d & 1;
  const double2* p = reinterpret_cast<const double2*>(w);
  return shift2(p[0], p[1], sh ? p[2] : p[1], sh);
}

__device__ __forceinline__ float4 add_products(float4 acc, float4 v,
                                               float4 xv) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, xv.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, xv.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, xv.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, xv.w));
  return acc;
}

__device__ __forceinline__ dquad add_products(dquad acc, dquad v, dquad xv) {
  acc.x = __dadd_rn(acc.x, __dmul_rn(v.x, xv.x));
  acc.y = __dadd_rn(acc.y, __dmul_rn(v.y, xv.y));
  acc.z = __dadd_rn(acc.z, __dmul_rn(v.z, xv.z));
  acc.w = __dadd_rn(acc.w, __dmul_rn(v.w, xv.w));
  return acc;
}

// A whole quad of y with 16-B stores.
__device__ __forceinline__ void store_quad(float* y, float4 v) {
  *reinterpret_cast<float4*>(y) = v;
}

__device__ __forceinline__ void store_quad(double* y, dquad v) {
  reinterpret_cast<double2*>(y)[0] = make_double2(v.x, v.y);
  reinterpret_cast<double2*>(y)[1] = make_double2(v.z, v.w);
}

// The accumulate mode's quad: y[i .. i + 3] read with 16-B loads, each
// row's sum added once (y + s, rounded to nearest), written back.
__device__ __forceinline__ void add_quad(float* y, float4 s) {
  float4 v = *reinterpret_cast<const float4*>(y);
  v.x = __fadd_rn(v.x, s.x);
  v.y = __fadd_rn(v.y, s.y);
  v.z = __fadd_rn(v.z, s.z);
  v.w = __fadd_rn(v.w, s.w);
  *reinterpret_cast<float4*>(y) = v;
}

__device__ __forceinline__ void add_quad(double* y, dquad s) {
  double2* p = reinterpret_cast<double2*>(y);
  const double2 a = p[0], b = p[1];
  p[0] = make_double2(__dadd_rn(a.x, s.x), __dadd_rn(a.y, s.y));
  p[1] = make_double2(__dadd_rn(b.x, s.z), __dadd_rn(b.y, s.w));
}

// One row's sum into y: written (the write mode) or added (ACC).
template <bool ACC, typename T>
__device__ __forceinline__ void put_row(T* y, T s) {
  if (ACC) {
    *y = add_rn_t(*y, s);
  } else {
    *y = s;
  }
}

// One tile: quads [qa, qb) of the rows, x from `xs` (STAGED: the tile's
// windows, holding x[4 * qa + wlo_r + j] at xs[base_r + j]) or from x.
template <typename T, int STEP, int QUADS, bool STAGED, bool VEC, bool EDGE,
          bool ACC>
__device__ __forceinline__ void tile_sums(const DiaArgs<T>& a, const int* s_d,
                                          const int* s_xo, const T* xs,
                                          long long qa, long long qb) {
  using Q = quad_t<T>;
  long long row[QUADS];
  bool live[QUADS];
  Q acc[QUADS];
#pragma unroll
  for (int p = 0; p < QUADS; ++p) {
    const long long q = qa + threadIdx.x + (long long)p * blockDim.x;
    row[p] = 4 * q;
    live[p] = q < qb;
    acc[p] = zero_quad<T>();
  }
  const long long t0 = 4 * qa;
  for (int k0 = 0; k0 < a.n_diag; k0 += STEP) {
    Q v[STEP][QUADS];
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      const int k = k0 + u;
      const T* vk = a.val + (size_t)k * a.dim_r;
#pragma unroll
      for (int p = 0; p < QUADS; ++p)
        v[u][p] = (k < a.n_diag && live[p])
                      ? load_val<VEC>(vk, row[p], a.dim_r)
                      : zero_quad<T>();
    }
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      const int k = k0 + u;
      if (k >= a.n_diag) break;
      const int d = s_d[k];
#pragma unroll
      for (int p = 0; p < QUADS; ++p) {
        if (!live[p]) continue;
        Q xv;
        if constexpr (STAGED && sizeof(T) == 4) {
          // written out, not through read_staged: the float kernels keep
          // the SASS they had before the double variant, instruction for
          // instruction (a call here schedules the loads differently)
          const int sh = d & 3;
          const float* w = xs + s_xo[k] + (int)(row[p] - t0);
          const float4 lo = *reinterpret_cast<const float4*>(w);
          const float4 hi = sh ? *reinterpret_cast<const float4*>(w + 4) : lo;
          xv = shift4(lo, hi, sh);
        } else if constexpr (STAGED) {
          xv = read_staged(xs + s_xo[k] + (int)(row[p] - t0), d);
        } else {
          xv = load_x<EDGE>(a.x, a.n_x, row[p] + d);
        }
        acc[p] = add_products(acc[p], v[u][p], xv);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < QUADS; ++p) {
    if (!live[p]) continue;
    const long long i = row[p];
    if (VEC && ACC) {
      add_quad(a.y + i, acc[p]);
    } else if (VEC) {
      store_quad(a.y + i, acc[p]);
    } else {
      put_row<ACC>(a.y + i, acc[p].x);
      if (i + 1 < a.dim_r) put_row<ACC>(a.y + i + 1, acc[p].y);
      if (i + 2 < a.dim_r) put_row<ACC>(a.y + i + 2, acc[p].z);
      if (i + 3 < a.dim_r) put_row<ACC>(a.y + i + 3, acc[p].w);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// Fill one buffer with the windows of the tile that starts at row t0:
// run r's window holds x[t0 + wlo_r + j] for j < width_r at buf[base_r + j],
// zero outside [0, n_x).
template <typename T>
__device__ __forceinline__ void stage_windows(const DiaArgs<T>& a,
                                              const int* s_run, T* buf,
                                              long long t0) {
  constexpr int kVec = Quad<T>::kVec;
  for (int r = 0; r < a.n_runs; ++r) {
    const int base = s_run[4 * r], wlo = s_run[4 * r + 1];
    const int chunks = s_run[4 * r + 2] >> Quad<T>::kVecShift;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const long long g = t0 + wlo + kVec * c;  // a multiple of kVec
      long long n = g >= 0 ? (a.n_x - g) * (long long)sizeof(T) : 0;
      n = n < 0 ? 0 : (n > 16 ? 16 : n);
      cp_async16(buf + base + kVec * c, n ? a.x + g : a.x, (int)n);
    }
  }
}

template <typename T, int STEP, int QUADS, bool STAGED, bool VEC, bool ACC>
__global__ void __launch_bounds__(kMaxThreads) dia_kernel(DiaArgs<T> a) {
  constexpr int kVec = Quad<T>::kVec;
  extern __shared__ __align__(16) float smem[];
  // staged buffers first (16-B aligned), then the table
  T* bufs = reinterpret_cast<T*>(smem);
  int* s_d = reinterpret_cast<int*>(bufs + (STAGED ? 2 * a.stage_floats : 0));
  int* s_xo = s_d + a.n_diag;
  int* s_run = s_xo + a.n_diag;
  const int n_table = (STAGED ? 2 * a.n_diag + 4 * a.n_runs : a.n_diag);
  for (int j = threadIdx.x; j < n_table; j += blockDim.x)
    s_d[j] = a.table[j];

  const Walk w = block_walk(a);
  __syncthreads();

  if (STAGED) {
    if (w.n_tiles > 0) stage_windows(a, s_run, bufs, 4 * w.first);
    asm volatile("cp.async.commit_group;\n" ::);
    for (long long j = 0; j < w.n_tiles; ++j) {
      const long long qa = w.first + j * w.stride;
      const long long qb = qa + w.tq < w.end ? qa + w.tq : w.end;
      if (j + 1 < w.n_tiles)
        stage_windows(a, s_run, bufs + ((j + 1) & 1) * a.stage_floats,
                      4 * (qa + w.stride));
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      tile_sums<T, STEP, QUADS, true, VEC, false, ACC>(
          a, s_d, s_xo, bufs + (j & 1) * a.stage_floats, qa, qb);
      __syncthreads();
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (long long j = 0; j < w.n_tiles; ++j) {
      const long long qa = w.first + j * w.stride;
      const long long qb = qa + w.tq < w.end ? qa + w.tq : w.end;
      // every 16-B x load of the tile inside [0, n_x)?
      const bool inside = 4 * qa + (a.d_min & ~(kVec - 1)) >= 0 &&
                          4 * qb + (a.d_max & ~(kVec - 1)) + kVec <= a.n_x;
      if (inside)
        tile_sums<T, STEP, QUADS, false, VEC, false, ACC>(a, s_d, s_xo,
                                                          nullptr, qa, qb);
      else
        tile_sums<T, STEP, QUADS, false, VEC, true, ACC>(a, s_d, s_xo,
                                                         nullptr, qa, qb);
    }
  }
}

// ---------------------------------------------------------------------------
// The spread form: DIA parts too small to fill the card.
//
// The quad kernel gives a thread 4 rows and all K diagonals, so a part of
// 13,824 rows (stencil27_24) is 27 blocks on 132 SMs, each thread walking
// 27 diagonals in 7 rounds of loads: the card waits on latency.  Here a
// block takes a tile of R = 2^rows_log2 consecutive rows and splits the
// tile's K * R / 4 quad products (one diagonal's values at 4 consecutive
// rows times their shifted x) over its threads, consecutive threads on
// consecutive quads of one diagonal: dia_val's rows read coalesced in 16-B
// loads, the shifted x as two aligned 16-B loads and a select, as the quad
// kernel reads them.  Each product, rounded on its own, goes to shared
// memory at [k][r]; after a barrier the thread that owns row r (threads
// 0 .. R - 1) adds s[0][r] .. s[K-1][r] in order of k from zero, as the
// plain version adds them, so every value is the plain version's bit for
// bit.  Where K * R products would take too much shared memory the
// diagonals come in chunks of `chunk`, the owner carrying its sum across
// them in a register.  The tiles are dealt round-robin to the resident
// blocks.  Values and x are read through __ldg: the parts this form serves
// fit in L2, and stay there between calls.  VEC: 16-B value loads (dim_r a
// multiple of 4, dia_val 16-B aligned), else four guarded scalar loads.
// ---------------------------------------------------------------------------

template <typename T>
struct SpreadArgs {
  const T* val;        // (n_diag, dim_r) row-major
  const int* table;    // [d_0..d_{K-1}]
  const T* x;          // n_x values, 16-B aligned
  T* y;                // dim_r values
  long long dim_r, n_x;
  int n_diag;
  int rows_log2;       // R = 2^rows_log2 rows a tile, 4 <= R <= blockDim.x
  int chunk;           // most diagonals a chunk
};

// Quad products a thread issues together before any is stored.
constexpr int kSpreadUnroll = 2;

template <bool VEC>
__device__ __forceinline__ float4 ldg_val(const float* vk, long long i,
                                          long long dim_r) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(vk + i));
  return make_float4(i < dim_r ? __ldg(vk + i) : 0.0f,
                     i + 1 < dim_r ? __ldg(vk + i + 1) : 0.0f,
                     i + 2 < dim_r ? __ldg(vk + i + 2) : 0.0f,
                     i + 3 < dim_r ? __ldg(vk + i + 3) : 0.0f);
}

template <bool VEC>
__device__ __forceinline__ dquad ldg_val(const double* vk, long long i,
                                         long long dim_r) {
  if (VEC) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(vk + i));
    const double2 b = __ldg(reinterpret_cast<const double2*>(vk + i + 2));
    return dquad{a.x, a.y, b.x, b.y};
  }
  return dquad{i < dim_r ? __ldg(vk + i) : 0.0,
               i + 1 < dim_r ? __ldg(vk + i + 1) : 0.0,
               i + 2 < dim_r ? __ldg(vk + i + 2) : 0.0,
               i + 3 < dim_r ? __ldg(vk + i + 3) : 0.0};
}

__device__ __forceinline__ float4 mul_quad(float4 v, float4 x) {
  return make_float4(__fmul_rn(v.x, x.x), __fmul_rn(v.y, x.y),
                     __fmul_rn(v.z, x.z), __fmul_rn(v.w, x.w));
}

__device__ __forceinline__ dquad mul_quad(dquad v, dquad x) {
  return dquad{__dmul_rn(v.x, x.x), __dmul_rn(v.y, x.y),
               __dmul_rn(v.z, x.z), __dmul_rn(v.w, x.w)};
}

template <typename T, bool VEC, bool ACC>
__global__ void __launch_bounds__(kMaxThreads)
    dia_kernel_spread(SpreadArgs<T> a) {
  using Q = quad_t<T>;
  extern __shared__ __align__(16) float smem[];
  // a chunk's products, [k][r] (quad j at 4 * j), then the offsets
  T* s = reinterpret_cast<T*>(smem);
  int* s_d = reinterpret_cast<int*>(s + ((size_t)a.chunk << a.rows_log2));
  for (int j = threadIdx.x; j < a.n_diag; j += blockDim.x)
    s_d[j] = a.table[j];
  __syncthreads();

  const int shift = a.rows_log2;
  const int qshift = shift - 2;          // R / 4 quads a tile
  const int qmask = (1 << qshift) - 1;
  const long long n_tiles = (a.dim_r + (1 << shift) - 1) >> shift;
  const int r_own = threadIdx.x;         // the row this thread sums
  const bool owner = r_own < (1 << shift);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long t0 = t << shift;
    T sum = T(0);
    for (int k0 = 0; k0 < a.n_diag; k0 += a.chunk) {
      const int kn = min(a.chunk, a.n_diag - k0);
      const int n = kn << qshift;
      for (int j0 = threadIdx.x; j0 < n; j0 += kSpreadUnroll * blockDim.x) {
        Q v[kSpreadUnroll], xv[kSpreadUnroll];
#pragma unroll
        for (int u = 0; u < kSpreadUnroll; ++u) {
          const int j = j0 + u * (int)blockDim.x;
          const int k = k0 + (j >> qshift);
          const long long i = t0 + 4 * (j & qmask);
          const bool live = j < n && i < a.dim_r;
          v[u] = live ? ldg_val<VEC>(a.val + (size_t)k * a.dim_r, i, a.dim_r)
                      : zero_quad<T>();
          xv[u] = live ? load_x<true>(a.x, a.n_x, i + s_d[k])
                       : zero_quad<T>();
        }
#pragma unroll
        for (int u = 0; u < kSpreadUnroll; ++u) {
          const int j = j0 + u * (int)blockDim.x;
          if (j < n) store_quad(s + 4 * (size_t)j, mul_quad(v[u], xv[u]));
        }
      }
      __syncthreads();
      if (owner) {
        const T* col = s + r_own;
        for (int kk = 0; kk < kn; ++kk)
          sum = add_rn_t(sum, col[(size_t)kk << shift]);
      }
      __syncthreads();
    }
    const long long i = t0 + r_own;
    if (owner && i < a.dim_r) put_row<ACC>(a.y + i, sum);
  }
}

// A kernel variant, as the runtime API takes it (the variants' parameter
// types differ with the value type).
using KernelFn = const void*;

template <typename T, int STEP, int QUADS, bool ACC = false>
KernelFn pick_xv(int staged, int vec) {
  if (staged)
    return vec ? (KernelFn)dia_kernel<T, STEP, QUADS, true, true, ACC>
               : (KernelFn)dia_kernel<T, STEP, QUADS, true, false, ACC>;
  return vec ? (KernelFn)dia_kernel<T, STEP, QUADS, false, true, ACC>
             : (KernelFn)dia_kernel<T, STEP, QUADS, false, false, ACC>;
}

template <typename T>
KernelFn pick_spread_t(int vec, int acc) {
  if (vec)
    return acc ? (KernelFn)dia_kernel_spread<T, true, true>
               : (KernelFn)dia_kernel_spread<T, true, false>;
  return acc ? (KernelFn)dia_kernel_spread<T, false, true>
             : (KernelFn)dia_kernel_spread<T, false, false>;
}

KernelFn pick_spread(int f64, int vec, int acc) {
  return f64 ? pick_spread_t<double>(vec, acc)
             : pick_spread_t<float>(vec, acc);
}

// The kernel variant (the double one where `f64`, the accumulate mode
// where `acc`), or nullptr where none is built.  `rows` > 0 picks the
// spread form (tiles of that many rows; step, quads and staged unused),
// built in float and double, in both modes, with and without 16-B value
// loads.  Of the quad form
// double is built only at the default geometry's (STEP, QUADS), and the
// accumulate mode only at it, in float and double.
KernelFn pick(int step, int quads, int staged, int vec, int f64, int acc,
              int rows) {
  if (rows > 0) return pick_spread(f64, vec, acc);
  if (acc) {
    if (step != 4 || quads != 1) return nullptr;
    return f64 ? pick_xv<double, 4, 1, true>(staged, vec)
               : pick_xv<float, 4, 1, true>(staged, vec);
  }
  if (f64) {
    return step == 4 && quads == 1 ? pick_xv<double, 4, 1>(staged, vec)
                                   : nullptr;
  }
  switch (step * 10 + quads) {
    case 21: return pick_xv<float, 2, 1>(staged, vec);
    case 41: return pick_xv<float, 4, 1>(staged, vec);
    case 81: return pick_xv<float, 8, 1>(staged, vec);
    case 42: return pick_xv<float, 4, 2>(staged, vec);
    default: return nullptr;
  }
}

int allow_smem(KernelFn fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch(KernelFn fn, const void* val, const int* table,
                   int n_diag, int n_runs, int d_min, int d_max,
                   long long dim_r, const void* x, long long n_x, void* y,
                   int threads, int grid, int tile_quads, int stage_floats,
                   size_t smem, cudaStream_t stream) {
  DiaArgs<T> a;
  a.val = static_cast<const T*>(val);
  a.table = table;
  a.x = static_cast<const T*>(x);
  a.y = static_cast<T*>(y);
  a.dim_r = dim_r;
  a.n_x = n_x;
  a.n_diag = n_diag;
  a.n_runs = n_runs;
  a.d_min = d_min;
  a.d_max = d_max;
  a.tile_quads = tile_quads;
  a.stage_floats = stage_floats;
  void* args[] = {&a};
  return cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, smem, stream);
}

template <typename T>
cudaError_t launch_spread(KernelFn fn, const void* val, const int* table,
                          int n_diag, long long dim_r, const void* x,
                          long long n_x, void* y, int rows_log2, int chunk,
                          int threads, int grid, size_t smem,
                          cudaStream_t stream) {
  SpreadArgs<T> a;
  a.val = static_cast<const T*>(val);
  a.table = table;
  a.x = static_cast<const T*>(x);
  a.y = static_cast<T*>(y);
  a.dim_r = dim_r;
  a.n_x = n_x;
  a.n_diag = n_diag;
  a.rows_log2 = rows_log2;
  a.chunk = chunk;
  void* args[] = {&a};
  return cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, smem, stream);
}

// log2 of a tile's rows in the spread form, or -1 where the kernel cannot
// walk them: not a power of two of at least one quad.  Which sizes are
// used is ops/dia.py's (SpreadGeometry).
int rows_log2_of(int rows) {
  if (rows < 4 || (rows & (rows - 1)) != 0) return -1;
  return __builtin_ctz((unsigned)rows);
}

}  // namespace

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that stay resident on one SM for a variant (0 where none can), or a
// negative CUDA error.  cudaErrorInvalidValue (-1) where no such variant is
// built.
extern "C" int ehyb_dia_resident_blocks(int step, int quads, int staged,
                                        int vec, int f64, int acc, int rows,
                                        int threads, long long smem) {
  const KernelFn fn = pick(step, quads, staged, vec, f64, acc, rows);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  int rc = allow_smem(fn, (size_t)smem);
  if (rc != 0) return -rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, threads, (size_t)smem);
  return rc != 0 ? -rc : blocks;
}

// Registers a thread of a variant takes (cudaFuncGetAttributes), or a
// negative CUDA error.
extern "C" int ehyb_dia_registers(int step, int quads, int staged, int vec,
                                  int f64, int acc, int rows) {
  const KernelFn fn = pick(step, quads, staged, vec, f64, acc, rows);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const int rc = (int)cudaFuncGetAttributes(&attr, fn);
  return rc != 0 ? -rc : attr.numRegs;
}

// Launches the DIA body on `stream` (a cudaStream_t) and returns
// cudaGetLastError(); 0 means the launch was accepted.  `val`, `x` and `y`
// are float (double where `f64`); `table` is the plan's device array
// (ops/dia.py::DiaPlan.table); `grid`, `threads`, `tile_quads`,
// `stage_floats` (values) and `smem` are the plan's.  With `acc` each row's
// sum is added into y[i] (y holds at least dim_r values, 16-B aligned
// where `vec`), else written there.  `rows` > 0 launches the spread form
// (tiles of `rows` rows, a power of two up to `threads`; `chunk`
// diagonals a chunk; the table holds the offsets alone).
extern "C" int ehyb_dia(const void* val, const int* table, int n_diag,
                        int n_runs, int d_min, int d_max, long long dim_r,
                        const void* x, long long n_x, void* y, int step,
                        int quads, int staged, int vec, int f64, int acc,
                        int rows, int chunk, int threads, int grid,
                        int tile_quads, int stage_floats, long long smem,
                        void* stream) {
  if (dim_r <= 0 || n_diag <= 0) return 0;
  const KernelFn fn = pick(step, quads, staged, vec, f64, acc, rows);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int rows_log2 = rows > 0 ? rows_log2_of(rows) : 0;
  if (rows_log2 < 0 || rows > threads || (rows > 0 && chunk <= 0))
    return (int)cudaErrorInvalidValue;
  const int rc = allow_smem(fn, (size_t)smem);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t launched =
      rows > 0
          ? (f64 ? launch_spread<double> : launch_spread<float>)(
                fn, val, table, n_diag, dim_r, x, n_x, y, rows_log2, chunk,
                threads, grid, (size_t)smem, st)
          : (f64 ? launch<double> : launch<float>)(
                fn, val, table, n_diag, n_runs, d_min, d_max, dim_r, x, n_x,
                y, threads, grid, tile_quads, stage_floats, (size_t)smem,
                st);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}
