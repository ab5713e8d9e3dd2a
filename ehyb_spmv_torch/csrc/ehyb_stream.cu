// Streamed SELL body of the EHYB format, x resident in device memory, over
// K1's compact plan, in float32 or float64.
//
// Replaces ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py::_make_stream_resident_kernel
// (the Pallas kernel K1), and serves the bodies the TPU gives to K2, K5 and
// K6.  For every body row it computes the sum over the row's cells, in
// step order, of value * x[col], plain or with Neumaier compensation
// (KAHAN), each product rounded on its own (__fmul_rn, __dmul_rn) so the
// compiler cannot contract it into the sum.
//
// The value type Val is float, or double for the precision mode
// (ops/dword.py: f64 values, x, y and sums, where the TPU carries (hi, lo)
// float pairs) and for a float64 config (--dtype float64, with or without
// --compensated, on the flagship and on the sharded path).  A double takes
// 8 B, as a TPU pair does, and the card adds it natively.  In double both
// kernels are built at one row a thread with x through L1/L2, plain or
// Neumaier (__dadd_rn, __dsub_rn, fabs), with or without a row-block
// list: this one over a plan in the table form and the body's row order,
// and stream_body_f64_kernel (below), a design of its own, over the
// plan's forms for a scattered body (direct columns, grouped rows).
//
// What the TPU needed and this leaves behind: the 128-lane width steps of
// window-local or relaxed lo-slot columns, padded to each slice's width and
// to what two-stage gathers address (50% padding at permuted_poisson_512,
// 76% at permuted_poisson_4096), and the sequential grid that carries a
// running sum across steps.  The host plan
// (ops/stream_cells.py::build_stream_cells) decodes the body once and keeps
// its real cells in row blocks of 32 rows with one width each; a cell is a
// value (float32, or float64 in the precision mode) and a uint16 index
// slot * 128 + lane into the row block's table of x rows (128 values
// each), stored column-major (cell k of row r at cell0 + 32 k + r).  A row
// block whose cells touch more than 512 x rows is cut between its steps
// into pieces, chained by `next`.  A row's cells
// keep their step order, so the sums equal the padded body's bit for bit
// for finite x.
//
// Bound on the H100: bytes.  It moves the plan's cells (6 B each, 10 B in
// float64), its pieces and tables, x once and y once: ~8.7 MB at
// permuted_poisson_512 in float32, ~2.6 us at 3.35 TB/s, where a kernel
// launch costs a few us.  Design:
//
// * A persistent grid.  The wrapper launches as many blocks as stay
//   resident (at most blocks_per_sm on each SM), and each warp takes groups
//   of V row blocks round-robin (warp w: groups w, w + warps, ...), so
//   neighbouring warps stream neighbouring cells and every SM is busy.
// * Loads in flight.  A group of 32 / V threads owns one row block; a
//   thread owns V neighbouring rows and reads their cells of one column
//   with one 4 V-byte value load and one 2 V-byte index load (16 B and 8 B
//   at V = 4), kUnroll columns before it sums any, with streaming loads
//   (__ldcs: read once, evicted first, so x keeps the caches).  Warps in
//   flight matter most: chip_k1_sweep.py chose V = 1 and four blocks of
//   512 threads an SM, so permuted_poisson_512's 8,192 row blocks give
//   every warp one.
// * x in one of two modes (STAGED):
//   - ldg: x[table[slot] * 128 + lane] through __ldg, from L1 and L2 (x is
//     1 MB at permuted_poisson_512, 4 MB at permuted_poisson_1024, both
//     well inside the 50 MB L2);
//   - staged: the group copies its piece's table rows into its own
//     kStageRows x 512 B of shared memory with cp.async and reads x there
//     by the cell's index; a piece whose table is larger reads through
//     __ldg.
// * No host work and no device sync per call, so a call can be captured in
//   a CUDA graph.
// * A row-block list (optional, a variant of its own).  The sharded path
//   (ehyb_spmv_torch/parallel/) launches K1 twice per apply over one
//   shard's plan, once over the row blocks whose x rows are all local
//   (before the halos arrive) and once over the rest, into one y: with a
//   list, group j takes row block list[j * V + g] in place of j * V + g and
//   only the listed rows of y are written.  LIST is a template flag, so
//   the full walk the flagship launches keeps a body with no list test.
//   This replaces the TPU's _stream_call
//   (ehyb_spmv_gpu_tpu/parallel/spmv.py:511), which runs K1 over the
//   interior or boundary tile group at a tile offset and combines the two
//   by take and mask.
// * Split variants for heavy-tailed bodies (one row a thread, in float and
//   double, plain and Kahan; stream_body_split_kernel and
//   stream_body_split_any_kernel below), over a plan whose long row blocks
//   are cut into chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;        // rows of a row block
constexpr int kLanes = 128;      // floats of an x row
constexpr int kUnroll = 4;       // cell columns a thread loads before summing
constexpr int kStageRows = 16;   // x rows a group stages (staged mode)
constexpr int kMaxThreads = 512;

__device__ __forceinline__ void neumaier_add(float& sum, float& comp,
                                             float v) {
  const float t = __fadd_rn(sum, v);
  if (fabsf(sum) >= fabsf(v)) {
    comp += __fadd_rn(__fsub_rn(sum, t), v);
  } else {
    comp += __fadd_rn(__fsub_rn(v, t), sum);
  }
  sum = t;
}

__device__ __forceinline__ void neumaier_add(double& sum, double& comp,
                                             double v) {
  const double t = __dadd_rn(sum, v);
  if (fabs(sum) >= fabs(v)) {
    comp += __dadd_rn(__dsub_rn(sum, t), v);
  } else {
    comp += __dadd_rn(__dsub_rn(v, t), sum);
  }
  sum = t;
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <bool KAHAN, typename T>
__device__ __forceinline__ void add(T& sum, T& comp, T p) {
  if (KAHAN) {
    neumaier_add(sum, comp, p);
  } else {
    sum = add_rn(sum, p);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Cells c .. c + V - 1 (V neighbouring rows of one column): values and
// indices, with one streaming load each (V > 1: float only).
template <int V, typename T>
__device__ __forceinline__ void load_cells(const T* __restrict__ val,
                                           const uint16_t* __restrict__ idx,
                                           int c, T (&v)[V], int (&j)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(val + c));
    const uint2 i = __ldcs(reinterpret_cast<const uint2*>(idx + c));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
    j[0] = (int)(i.x & 0xffffu);
    j[1] = (int)(i.x >> 16);
    j[2] = (int)(i.y & 0xffffu);
    j[3] = (int)(i.y >> 16);
  } else if constexpr (V == 2) {
    const float2 f = __ldcs(reinterpret_cast<const float2*>(val + c));
    const unsigned i = __ldcs(reinterpret_cast<const unsigned*>(idx + c));
    v[0] = f.x;
    v[1] = f.y;
    j[0] = (int)(i & 0xffffu);
    j[1] = (int)(i >> 16);
  } else {
    v[0] = __ldcs(val + c);
    j[0] = (int)__ldcs(idx + c);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_rows(T* y, const T (&s)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(y), make_float4(s[0], s[1], s[2], s[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(y), make_float2(s[0], s[1]));
  } else {
    __stcs(y, s[0]);
  }
}

// x at a cell's index: from the staged rows, or through the table and L1/L2.
template <typename T>
__device__ __forceinline__ T read_x(bool staged, const T* stage,
                                    const int* __restrict__ tab,
                                    const T* __restrict__ x, int j) {
  if (staged) return stage[j];
  return __ldg(x + (size_t)__ldg(tab + (j >> 7)) * kLanes + (j & (kLanes - 1)));
}

// piece[p] = (first cell, first table row, next piece or -1, row block);
// piece[p + 1] ends both ranges.
template <typename Val, int V, bool STAGED, bool KAHAN, bool LIST>
__global__ void __launch_bounds__(kMaxThreads) stream_body_kernel(
    const int4* __restrict__ piece, const int* __restrict__ rows,
    const Val* __restrict__ cell_val, const uint16_t* __restrict__ cell_idx,
    const Val* __restrict__ x, Val* __restrict__ y, int n_rb,
    const int* __restrict__ rb_list, int n_list) {
  constexpr int T = kRows / V;  // threads of a row block
  // 16-B copies of an x row, and log2 of their count
  constexpr int kCopies = kLanes * (int)sizeof(Val) / 16;
  constexpr int kCopyShift = sizeof(Val) == 4 ? 5 : 6;
  extern __shared__ __align__(16) float xs[];
  const int lane = threadIdx.x & 31;
  const int g = lane / T;
  const int t = lane % T;
  constexpr unsigned kGroupLanes =
      T >= 32 ? 0xffffffffu : (1u << (T & 31)) - 1u;
  const unsigned mask = kGroupLanes << (g * T);  // the group's lanes
  const int warps = blockDim.x >> 5;
  const int n_warps = gridDim.x * warps;
  Val* stage = STAGED ? reinterpret_cast<Val*>(xs) +
                            ((threadIdx.x >> 5) * V + g) *
                                (kStageRows * kLanes)
                      : nullptr;
  const int n_items = LIST ? n_list : n_rb;
  const int n_groups = (n_items + V - 1) / V;
  for (int j = blockIdx.x * warps + (threadIdx.x >> 5); j < n_groups;
       j += n_warps) {
    const int item = j * V + g;
    if (item >= n_items) continue;  // the whole group skips
    const int rb = LIST ? __ldg(rb_list + item) : item;
    Val sum[V], comp[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sum[i] = Val(0);
      comp[i] = Val(0);
    }
    int p = rb;
    do {
      const int4 a = __ldg(piece + p);
      const int4 b = __ldg(piece + p + 1);
      const int* tab = rows + a.y;
      bool staged = false;
      if (STAGED && b.y - a.y <= kStageRows) {
        staged = true;
        __syncwarp(mask);  // the group's previous piece is consumed
        const int n = (b.y - a.y) * kCopies;
        for (int q = t; q < n; q += T) {
          const int r = q >> kCopyShift;
          const int o = (q & (kCopies - 1)) * (16 / (int)sizeof(Val));
          cp_async16(stage + r * kLanes + o,
                     x + (size_t)__ldg(tab + r) * kLanes + o);
        }
        cp_async_wait_all();
        __syncwarp(mask);
      }
      int c = a.x + V * t;
      for (; c + (kUnroll - 1) * kRows < b.x; c += kUnroll * kRows) {
        Val v[kUnroll][V];
        int ix[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          load_cells<V>(cell_val, cell_idx, c + u * kRows, v[u], ix[u]);
        }
        Val xv[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            xv[u][i] = read_x(staged, stage, tab, x, ix[u][i]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            add<KAHAN>(sum[i], comp[i], mul_rn(v[u][i], xv[u][i]));
          }
        }
      }
      for (; c < b.x; c += kRows) {
        Val v[V];
        int ix[V];
        load_cells<V>(cell_val, cell_idx, c, v, ix);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          add<KAHAN>(sum[i], comp[i],
                     mul_rn(v[i], read_x(staged, stage, tab, x, ix[i])));
        }
      }
      p = a.z;
    } while (p >= 0);
    if (KAHAN) {
#pragma unroll
      for (int i = 0; i < V; ++i) sum[i] = sum[i] + comp[i];
    }
    store_rows<V>(y + (size_t)rb * kRows + V * t, sum);
  }
}

// The double kernel.  Each x value is 8 B of a 32-B sector, so where a
// body's columns are scattered (the precision mode's unordered body: about
// one x row of 128 values a cell) every cell's x read costs a sector of
// L2 traffic, and the table form adds a dependent, scattered table read
// before it.  The plan answers both (ops/stream_cells.py):
//
// * a piece with no table (direct form) holds each cell's x column as an
//   int32 (cell_col, column-major like the values): per cell a coalesced
//   8-B value and 4-B column, then x, two dependent loads where the table
//   form takes three;
// * where the body is scattered the plan groups rows that read the same x
//   into row blocks (a partition of the body's pattern into parts of
//   2,048 rows, RCM inside), so repeated x reads hit L1 and fewer sectors
//   come from L2, and writes each row's sum through row_map (plan row ->
//   body row; nullptr where the plan keeps the body's order).
//
// A piece whose table is empty is direct; the others read x through their
// table as the float kernel does at one row a thread.  A warp takes one
// row block (warp w: row blocks w, w + warps, ...); a row's sum keeps its
// step order, so the sums equal the plain version's bit for bit.
//
// Measured at permuted_poisson_512 --dword (chip_k1_sweep.py --f64, H100
// 80GB HBM3 at 700 W): the table form 11.05 us, direct columns in body
// order 10.71, grouped 8.85, where the same work's bound at HBM's rate is
// 5.00.  What is left is sectors: in the grouped plan the row map's
// scattered 8-B y writes cost ~3.2 us and x's scattered reads ~2.3 us over
// a 4.0 us floor (timing-only variants of the plan).  Warps in flight do
// not move it: at 256 or 512 threads and 2 to 16 blocks an SM the grouped
// plan reads 8.85-9.11 us.  More rows a thread and deeper unrolls are not
// built: a row there holds 4 cells, which one unroll covers, and the
// 8,192 row blocks give every warp of one wave one.
template <typename Val>
struct DirectCols {
  const int* __restrict__ col;
  __device__ __forceinline__ int load(int c) const { return __ldcs(col + c); }
  __device__ __forceinline__ Val x_at(const Val* __restrict__ x,
                                      int j) const {
    return __ldg(x + j);
  }
};

template <typename Val>
struct TableCols {
  const uint16_t* __restrict__ idx;
  const int* __restrict__ tab;
  __device__ __forceinline__ int load(int c) const {
    return (int)__ldcs(idx + c);
  }
  __device__ __forceinline__ Val x_at(const Val* __restrict__ x,
                                      int j) const {
    return read_x(false, (const Val*)nullptr, tab, x, j);
  }
};

// A thread's cells c, c + 32, ... < end of one piece, added to its row's
// sum: kUnroll columns' values and indices loaded before any x, and every
// x before any sum.
template <bool KAHAN, typename Cols>
__device__ __forceinline__ void sum_piece(const double* __restrict__ val,
                                          Cols cols,
                                          const double* __restrict__ x,
                                          int c, int end, double& sum,
                                          double& comp) {
  for (; c + (kUnroll - 1) * kRows < end; c += kUnroll * kRows) {
    double v[kUnroll];
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldcs(val + c + u * kRows);
      j[u] = cols.load(c + u * kRows);
    }
    double xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = cols.x_at(x, j[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add<KAHAN>(sum, comp, mul_rn(v[u], xv[u]));
    }
  }
  for (; c < end; c += kRows) {
    add<KAHAN>(sum, comp,
               mul_rn(__ldcs(val + c), cols.x_at(x, cols.load(c))));
  }
}

template <bool KAHAN, bool LIST>
__global__ void __launch_bounds__(kMaxThreads) stream_body_f64_kernel(
    const int4* __restrict__ piece, const int* __restrict__ rows,
    const double* __restrict__ cell_val,
    const uint16_t* __restrict__ cell_idx, const int* __restrict__ cell_col,
    const int* __restrict__ row_map, const double* __restrict__ x,
    double* __restrict__ y, int n_rb, const int* __restrict__ rb_list,
    int n_list) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int n_warps = gridDim.x * warps;
  const int n_items = LIST ? n_list : n_rb;
  for (int j = blockIdx.x * warps + (threadIdx.x >> 5); j < n_items;
       j += n_warps) {
    const int rb = LIST ? __ldg(rb_list + j) : j;
    const int out = row_map != nullptr ? __ldg(row_map + rb * kRows + lane)
                                       : rb * kRows + lane;
    double sum = 0.0, comp = 0.0;
    int p = rb;
    do {
      const int4 a = __ldg(piece + p);
      const int4 b = __ldg(piece + p + 1);
      if (a.y == b.y) {
        sum_piece<KAHAN>(cell_val, DirectCols<double>{cell_col}, x,
                         a.x + lane, b.x, sum, comp);
      } else {
        sum_piece<KAHAN>(cell_val, TableCols<double>{cell_idx, rows + a.y}, x,
                         a.x + lane, b.x, sum, comp);
      }
      p = a.z;
    } while (p >= 0);
    if (KAHAN) sum = sum + comp;
    __stcs(y + out, sum);
  }
}

// The split variant.  In a heavy-tailed body a row block's width is its
// longest row's, so a block holding a hub row is thousands of steps wide
// (112,744 at powerlaw_1m's dense sub-matrix) where its peers take tens:
// walked by one warp, as above, it is the whole launch.  The plan's split
// form (ops/stream_cells.py, split_steps) cuts every row block wider than
// split_steps into chunks of at most that many steps, on piece boundaries,
// and lists the work items longest first: a chunk (first piece, pieces,
// partial slot, chunked row block) or a whole row block (slot -1).  A warp
// takes items round-robin, sums its 32 rows over the item's pieces in
// step order, and writes y (a whole row block) or its slot of 32 partials.
// A chunked row block's partials are added into y in chunk order, a fixed
// order, so the sums equal the plain version's bit for bit (no atomics on
// y, unlike the reference's longRowKernel, kernel.cu:43-67): a chunk's
// warp writes its partials, fences, and counts itself done on its row
// block's counter; the last of them reads every partial through L2,
// writes y and puts the counter back to 0, so the next launch (or graph
// replay) starts from 0.
//
// Measured (chip_k1_sweep.py --long, H100 80GB HBM3 at 700 W): at
// split_steps 48, 128 threads, 16 blocks an SM, powerlaw_1m's dense body
// (11.18M entries, 23.7M compact cells) takes 185.4 us where the walk of
// the table form takes 23,513 us, and powerlaw_16k's body 12.8 us against
// 502.9; their same-work bounds are 22.5 and 0.74 us.  At 1m the cells
// stream (a layout bound of 54.5 us) and more chunks cost (155.7 us at 96
// steps); at 16k a chunk's walk is the time, so shorter chunks help there
// (19.1 us at 96).  Earlier sweeps chose 16 columns a round over 4 and 8,
// the combine in the launch over a second launch (183.6 us at 1m, 17.4 at
// 16k, both at 96 steps), and x through L1/L2 over staging it.

constexpr int kSplitUnroll = 16;  // cell columns a round of a chunk's walk

// A thread's cells c, c + 32, ... < end of one piece, added to its row's
// sum in order: kSplitUnroll columns' values and indices loaded before any
// x, and every x before any sum.  The last round's columns past the piece
// re-read its first (every load stays unconditional, so the compiler keeps
// all of a round's loads in flight) and are not added; end - c is a
// multiple of 32, so a warp takes every branch together.  A warp's walk of
// a chunk is latency-bound (value, table row, x: three dependent loads a
// round), so the columns a round set how many steps one round covers.
__device__ __forceinline__ void sum_piece_split(
    const float* __restrict__ val, const uint16_t* __restrict__ idx,
    const int* __restrict__ tab, const float* __restrict__ x, int c, int end,
    float& sum) {
  constexpr int U = kSplitUnroll;
  for (; c < end; c += U * kRows) {
    float v[U];
    int j[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cu = c + u * kRows < end ? c + u * kRows : c;
      v[u] = __ldcs(val + cu);
      j[u] = (int)__ldcs(idx + cu);
    }
    float xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xv[u] = read_x(false, (const float*)nullptr, tab, x, j[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c + u * kRows < end) sum = __fadd_rn(sum, __fmul_rn(v[u], xv[u]));
    }
  }
}

// item[j] = (first piece, pieces, partial slot or -1, chunked row block or
// -1); chunked row block i owns the slots chunk_first[i] ..
// chunk_first[i + 1] - 1.
__global__ void __launch_bounds__(kMaxThreads) stream_body_split_kernel(
    const int4* __restrict__ piece, const int* __restrict__ rows,
    const float* __restrict__ cell_val, const uint16_t* __restrict__ cell_idx,
    const int4* __restrict__ item, const int* __restrict__ chunk_first,
    float* partial, int* counter, const float* __restrict__ x,
    float* __restrict__ y, int n_items) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int n_warps = gridDim.x * warps;
  for (int j = blockIdx.x * warps + (threadIdx.x >> 5); j < n_items;
       j += n_warps) {
    const int4 it = __ldg(item + j);
    int p = it.x;
    const int rb = __ldg(piece + p).w;
    float sum = 0.0f;
    for (int q = 0; q < it.y; ++q) {
      const int4 a = __ldg(piece + p);
      const int4 b = __ldg(piece + p + 1);
      sum_piece_split(cell_val, cell_idx, rows + a.y, x, a.x + lane, b.x,
                      sum);
      p = a.z;
    }
    if (it.z < 0) {
      __stcs(y + (size_t)rb * kRows + lane, sum);
      continue;
    }
    __stcg(partial + (size_t)it.z * kRows + lane, sum);
    __threadfence();  // the partials before the count
    __syncwarp();
    const int s0 = __ldg(chunk_first + it.w);
    const int s1 = __ldg(chunk_first + it.w + 1);
    int last = 0;
    if (lane == 0) last = atomicAdd(counter + it.w, 1) == s1 - s0 - 1;
    if (__shfl_sync(0xffffffffu, last, 0)) {
      __threadfence();  // the count before the partials
      float t = 0.0f;  // the row block's partials, in chunk order
      for (int s = s0; s < s1; ++s) {
        t = __fadd_rn(t, __ldcg(partial + (size_t)s * kRows + lane));
      }
      __stcs(y + (size_t)rb * kRows + lane, t);
      if (lane == 0) counter[it.w] = 0;
    }
  }
}

// The split variant in double and the compensated split variants
// (Neumaier, in float and double), over the same work items.  Beside the
// float kernel above it reads every piece form of the double plans: a
// chunk's pieces are table pieces (16-bit index into the piece's table) or
// direct pieces (int32 column, one dependent load fewer a round), and in a
// grouped plan a row block's 32 rows go to y through row_map, a whole row
// block's by its item's warp and a chunked one's by its last chunk.
//
// With KAHAN each chunk carries a (sum, compensation) pair a row, walked
// with the Neumaier step of the compensated kernels above, and writes both
// into its two slots of partials (2 s: the sums, 2 s + 1: the
// compensations); a whole row block writes sum + comp, as the other
// kernels do.  The last chunk folds the row block's pairs in chunk order
// with one fixed arithmetic, which the plain version
// (ops/ehyb_stream.py::fold_pairs) repeats step for step:
//
//   (S, C) = (0, 0)
//   for each chunk i in chunk order, with pair (s_i, c_i):
//     t = S + s_i
//     C = C + ((S - t) + s_i)   where |S| >= |s_i|, else C + ((s_i - t) + S)
//     S = t
//     C = C + c_i
//   y = S + C
//
// every operation rounded to nearest on its own.  In double the sums equal
// the plain version's bit for bit (it sums a chunk's places with the same
// Neumaier step, then folds the pairs); in float the plain version sums in
// double and rounds once, which the compensated variant reaches to about
// an ulp.
//
// A double at 8 B doubles a round's registers: 16 columns take 32 for the
// values and 32 for x beside 16 indices (64 registers a thread in double
// and in float Kahan, 112 in double Kahan).  The wrapper reads the
// registers and the resident blocks back (ehyb_stream_registers,
// ehyb_stream_resident_blocks) and launches no more blocks than fit.  A
// direct piece saves a round one dependent load (value and column, then
// x), but the round stays 16 columns: one walk serves both piece forms.
//
// Measured (chip_k1_sweep.py --long --f64, H100 80GB HBM3 at 700 W), as
// shipped (chunks of 80 steps in double, 48 in float; 128 threads, 16
// blocks an SM asked, 8 resident): powerlaw_16k's body takes 11.12 us in
// --dtype float64, 12.61 with --compensated, 15.08 in --dword and 13.70
// in float compensated, where one warp a row block took 951, 1,025 and
// 995 us in double; powerlaw_1m takes 111.9 us in --dword (15,090) and
// 287.4 in --dtype float64 (42,633), against cuSPARSE in double at 94.3
// and 224.0 us; its dense rows 339.8 us in float compensated, 225.6
// plain, at the same 62-64 registers.
// A round's products added in order: with Neumaier's step (KAHAN), or
// plain from a products array, which keeps a double round's loads in
// flight (added as they arrive, ptxas fed them one at a time: 30 registers
// and 2-3x the time at powerlaw_16k).  In the last round of a piece
// (!FULL) the columns at or past `end` are not added.
template <bool KAHAN, bool FULL, int U, typename Val>
__device__ __forceinline__ void add_round(const Val (&v)[U],
                                          const Val (&xv)[U], int c, int end,
                                          Val& sum, Val& comp) {
  if (KAHAN) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (FULL || c + u * kRows < end) {
        add<true>(sum, comp, mul_rn(v[u], xv[u]));
      }
    }
  } else {
    Val pr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) pr[u] = mul_rn(v[u], xv[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (FULL || c + u * kRows < end) sum = add_rn(sum, pr[u]);
    }
  }
}

// A thread's cells c, c + 32, ... < end of one piece, added to its row's
// (sum, comp) in order: full rounds of kSplitUnroll columns (values and
// indices, then x, then the sums), then the last round, whose columns past
// the piece re-read its first and are not added.
template <bool KAHAN, typename Val, typename Cols>
__device__ __forceinline__ void sum_chunk_piece(const Val* __restrict__ val,
                                                Cols cols,
                                                const Val* __restrict__ x,
                                                int c, int end, Val& sum,
                                                Val& comp) {
  constexpr int U = kSplitUnroll;
  for (; c + (U - 1) * kRows < end; c += U * kRows) {
    Val v[U];
    int j[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = __ldcs(val + c + u * kRows);
      j[u] = cols.load(c + u * kRows);
    }
    Val xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) xv[u] = cols.x_at(x, j[u]);
    add_round<KAHAN, true>(v, xv, c, end, sum, comp);
  }
  for (; c < end; c += U * kRows) {
    Val v[U];
    int j[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cu = c + u * kRows < end ? c + u * kRows : c;
      v[u] = __ldcs(val + cu);
      j[u] = cols.load(cu);
    }
    Val xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) xv[u] = cols.x_at(x, j[u]);
    add_round<KAHAN, false>(v, xv, c, end, sum, comp);
  }
}

template <typename Val, bool KAHAN>
__global__ void __launch_bounds__(kMaxThreads) stream_body_split_any_kernel(
    const int4* __restrict__ piece, const int* __restrict__ rows,
    const Val* __restrict__ cell_val, const uint16_t* __restrict__ cell_idx,
    const int* __restrict__ cell_col, const int* __restrict__ row_map,
    const int4* __restrict__ item, const int* __restrict__ chunk_first,
    Val* partial, int* counter, const Val* __restrict__ x,
    Val* __restrict__ y, int n_items) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int n_warps = gridDim.x * warps;
  for (int j = blockIdx.x * warps + (threadIdx.x >> 5); j < n_items;
       j += n_warps) {
    const int4 it = __ldg(item + j);
    int p = it.x;
    const int rb = __ldg(piece + p).w;
    Val sum = Val(0), comp = Val(0);
    for (int q = 0; q < it.y; ++q) {
      const int4 a = __ldg(piece + p);
      const int4 b = __ldg(piece + p + 1);
      if (a.y == b.y) {
        sum_chunk_piece<KAHAN>(cell_val, DirectCols<Val>{cell_col}, x,
                               a.x + lane, b.x, sum, comp);
      } else {
        sum_chunk_piece<KAHAN>(cell_val, TableCols<Val>{cell_idx, rows + a.y},
                               x, a.x + lane, b.x, sum, comp);
      }
      p = a.z;
    }
    const int out = row_map != nullptr ? __ldg(row_map + rb * kRows + lane)
                                       : rb * kRows + lane;
    if (it.z < 0) {
      __stcs(y + out, KAHAN ? add_rn(sum, comp) : sum);
      continue;
    }
    if (KAHAN) {
      __stcg(partial + (size_t)(2 * it.z) * kRows + lane, sum);
      __stcg(partial + (size_t)(2 * it.z + 1) * kRows + lane, comp);
    } else {
      __stcg(partial + (size_t)it.z * kRows + lane, sum);
    }
    __threadfence();  // the partials before the count
    __syncwarp();
    const int s0 = __ldg(chunk_first + it.w);
    const int s1 = __ldg(chunk_first + it.w + 1);
    int last = 0;
    if (lane == 0) last = atomicAdd(counter + it.w, 1) == s1 - s0 - 1;
    if (__shfl_sync(0xffffffffu, last, 0)) {
      __threadfence();  // the count before the partials
      Val t = Val(0), tc = Val(0);  // the row block's partials, in order
      for (int s = s0; s < s1; ++s) {
        if (KAHAN) {
          const Val* pair = partial + (size_t)(2 * s) * kRows + lane;
          neumaier_add(t, tc, __ldcg(pair));
          tc = add_rn(tc, __ldcg(pair + kRows));
        } else {
          t = add_rn(t, __ldcg(partial + (size_t)s * kRows + lane));
        }
      }
      __stcs(y + out, KAHAN ? add_rn(t, tc) : t);
      if (lane == 0) counter[it.w] = 0;
    }
  }
}

// The small form, for heavy-tailed bodies too small to fill the card
// (powerlaw_16k: 16,384 rows, 389,666 entries, a widest row of 5,426).
// There the split form's work items (840 of at most 48 steps in float,
// 681 of 80 in double) fill a fifth of the card's resident warps, each
// chunk's walk is rounds of three dependent loads, a hub's row block pads
// its 31 short rows to the hub's width (2.86x cells for entries there),
// and the widest row block's last chunk adds 114 partials one after
// another.  The plan's small form (ops/stream_cells.py, small_steps,
// hub_steps) answers each:
//
// * Hub rows apart.  Every row of more than small_steps (40) cells leaves
//   its row block: its cells are stored row-major (hub_val, hub_col: int32
//   columns), 32 consecutive entries a step, so a warp's value and column
//   loads coalesce and no short row is padded to a hub's width.  The row
//   blocks keep their other rows at their own width, at most three rounds
//   (kSplitUnroll columns each) of the walk, in table or direct pieces,
//   through the row map where there is one; a row-block item carries the
//   mask of its hub lanes (it.w), which it does not write.
// * Short items.  A hub's steps are cut into chunks of hub_steps (32: two
//   rounds a lane), each a work item; the hub items come first in the
//   persistent grid's order, then the row blocks, longest first.  An item
//   carries what its walk reads (cells, table, slots, y row) in two 16-B
//   loads, so a row-block item is three dependent loads (cells, table row,
//   x) and a hub item two (cells, x).
// * A short fold in a fixed order.  A lane adds its entries of a chunk in
//   order (entries l, l + 32, ...); the warp's 32 lane sums meet in a fixed
//   tree (shfl_down at 16, 8, 4, 2, 1: lane l < k combines its own with
//   lane l + k's); a hub of one chunk writes lane 0's sum.  A longer hub's
//   chunks write their sums to partial slots and count themselves on its
//   counter; the last adds the hub's slots lane by lane (lane l: slots l,
//   l + 32, ... in order, from 0), then the same tree, writes y and puts
//   the counter back to 0.  The chain is at most ceil(chunks / 32) + 5
//   adds: 1 + 5 for powerlaw_16k's widest hub (6 chunks).  No atomics
//   on y.
// * x through L1/L2.  Staging all of the x a plan reads (64 KB in float
//   at powerlaw_16k, 128 KB in double) into each block's shared memory
//   with cp.async won only in float, by 4%, and lost in double, where 128
//   KB leave one block an SM (chip_k1_sweep.py --small; PERF.md):
//   x is read through L1/L2, as in the other variants.
//
// With KAHAN a lane walks with the Neumaier step, and pairs combine as the
// split variants' fold does: (S, C) + (s, c) is t = S + s, C += (S - t) + s
// where |S| >= |s|, else (s - t) + S, S = t, then C += c; a row is S + C.
// In double the sums equal the plain version (ops/ehyb_stream.py::
// hub_sums_plain for the hubs, stream_body_plain for the row blocks) bit
// for bit; in float Kahan the plain version sums in double and rounds once.
//
// Measured (chip_k1_sweep.py --small, H100 80GB HBM3 at 700 W),
// hubs past 40 cells in chunks of 32 steps, 128 threads: powerlaw_16k's
// body 6.44 us in float (the split form 12.89-13.12, cuSPARSE 9.84), 6.50
// in float Kahan (12.78-12.82), 7.42 in double (10.52-10.54, cuSPARSE
// 9.93), 7.63 in double Kahan (12.88-13.05, 10.68), 7.71 in --dword
// (14.50-14.72, 10.62).  The items are fewer than a wave (2,063 of 4,224
// resident warps): cutting the hubs finer to fill one (hubs past 32 in
// chunks of 2 steps, 4,531 items) took float to 10.0 us, each
// chunk a partial, a fence and an atomic, and a warp's second item
// waiting on its first.

// (s, c) takes the pair (os, oc): plain, s + os.
template <bool KAHAN, typename Val>
__device__ __forceinline__ void combine(Val& s, Val& c, Val os, Val oc) {
  if (KAHAN) {
    neumaier_add(s, c, os);
    c = add_rn(c, oc);
  } else {
    s = add_rn(s, os);
  }
}

// The warp's fixed tree: lane 0 ends with the combine of the 32 lanes'
// pairs (the other lanes' pairs are not used).
template <bool KAHAN, typename Val>
__device__ __forceinline__ void warp_tree(Val& s, Val& c) {
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1) {
    const Val os = __shfl_down_sync(0xffffffffu, s, k);
    const Val oc = KAHAN ? __shfl_down_sync(0xffffffffu, c, k) : Val(0);
    combine<KAHAN>(s, c, os, oc);
  }
}

// A piece's cells from c to end, added to a lane's (sum, comp): table or
// direct.
template <bool KAHAN, typename Val>
__device__ __forceinline__ void sum_small_piece(
    const Val* __restrict__ cell_val, const uint16_t* __restrict__ cell_idx,
    const int* __restrict__ cell_col, const int* __restrict__ tab,
    const Val* __restrict__ x, int c, int end, Val& sum, Val& comp) {
  if (tab == nullptr) {
    sum_chunk_piece<KAHAN>(cell_val, DirectCols<Val>{cell_col}, x, c, end,
                           sum, comp);
  } else {
    sum_chunk_piece<KAHAN>(cell_val, TableCols<Val>{cell_idx, tab}, x, c,
                           end, sum, comp);
  }
}

// An item is two int4s, read together: item[2 j] = (row block, pieces, -1,
// hub lanes), item[2 j + 1] = (its first piece's first cell, end cell,
// first table row or -1 where the piece is direct, 0), its later pieces
// chained by piece[p].z; hub_item[2 j] = (first cell, steps, partial slot
// or -1, hub), hub_item[2 j + 1] = (the hub's first slot, its end slot,
// its y row, 0).
template <typename Val, bool KAHAN>
__global__ void __launch_bounds__(kMaxThreads) stream_body_small_kernel(
    const int4* __restrict__ piece, const int* __restrict__ rows,
    const Val* __restrict__ cell_val, const uint16_t* __restrict__ cell_idx,
    const int* __restrict__ cell_col, const int* __restrict__ row_map,
    const int4* __restrict__ item, int n_items,
    const int4* __restrict__ hub_item, int n_hub_items,
    const Val* __restrict__ hub_val, const int* __restrict__ hub_col,
    Val* partial, int* counter, const Val* __restrict__ x,
    Val* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int n_warps = gridDim.x * warps;
  const int n_all = n_hub_items + n_items;
  for (int j = blockIdx.x * warps + (threadIdx.x >> 5); j < n_all;
       j += n_warps) {
    Val sum = Val(0), comp = Val(0);
    if (j < n_hub_items) {
      const int4 h = __ldg(hub_item + 2 * j);
      const int4 f = __ldg(hub_item + 2 * j + 1);  // slots f.x .. f.y, y row
      sum_chunk_piece<KAHAN>(hub_val, DirectCols<Val>{hub_col}, x,
                             h.x + lane, h.x + h.y * kRows, sum, comp);
      warp_tree<KAHAN>(sum, comp);
      if (h.z >= 0) {
        if (lane == 0) {
          __stcg(partial + 2 * (size_t)h.z, sum);
          if (KAHAN) __stcg(partial + 2 * (size_t)h.z + 1, comp);
        }
        __threadfence();  // the partial before the count
        __syncwarp();
        int last = 0;
        if (lane == 0) last = atomicAdd(counter + h.w, 1) == f.y - f.x - 1;
        if (!__shfl_sync(0xffffffffu, last, 0)) continue;
        __threadfence();  // the count before the partials
        sum = Val(0);
        comp = Val(0);
        for (int s = f.x + lane; s < f.y; s += 32) {
          combine<KAHAN>(sum, comp, __ldcg(partial + 2 * (size_t)s),
                         KAHAN ? __ldcg(partial + 2 * (size_t)s + 1)
                               : Val(0));
        }
        warp_tree<KAHAN>(sum, comp);
        if (lane == 0) counter[h.w] = 0;
      }
      if (lane == 0) __stcs(y + f.z, KAHAN ? add_rn(sum, comp) : sum);
      continue;
    }
    const int4 it = __ldg(item + 2 * (j - n_hub_items));
    const int4 pc = __ldg(item + 2 * (j - n_hub_items) + 1);  // its cells
    const int rb = it.x;
    // the y row, read while the cells stream
    const int out = row_map != nullptr ? __ldg(row_map + rb * kRows + lane)
                                       : rb * kRows + lane;
    sum_small_piece<KAHAN>(cell_val, cell_idx, cell_col,
                           pc.z < 0 ? nullptr : rows + pc.z, x, pc.x + lane,
                           pc.y, sum, comp);
    // a row block cut between its steps (16-bit tables): its later pieces
    for (int q = 1, p = rb; q < it.y; ++q) {
      p = __ldg(piece + p).z;
      const int4 a = __ldg(piece + p);
      const int4 b = __ldg(piece + p + 1);
      sum_small_piece<KAHAN>(cell_val, cell_idx, cell_col,
                             a.y == b.y ? nullptr : rows + a.y, x,
                             a.x + lane, b.x, sum, comp);
    }
    if (((unsigned)it.w >> lane) & 1u) continue;  // a hub's lane
    __stcs(y + out, KAHAN ? add_rn(sum, comp) : sum);
  }
}

// A kernel variant, as the runtime API takes it (the variants' parameter
// types differ with the value type).
using KernelFn = const void*;

// The small form's variant.
KernelFn pick_small(int kahan, int f64) {
  if (f64) {
    return kahan ? (KernelFn)stream_body_small_kernel<double, true>
                 : (KernelFn)stream_body_small_kernel<double, false>;
  }
  return kahan ? (KernelFn)stream_body_small_kernel<float, true>
               : (KernelFn)stream_body_small_kernel<float, false>;
}

template <int V, bool LIST>
KernelFn pick_v(int staged, int kahan) {
  if (staged) {
    return kahan ? (KernelFn)stream_body_kernel<float, V, true, true, LIST>
                 : (KernelFn)stream_body_kernel<float, V, true, false, LIST>;
  }
  return kahan ? (KernelFn)stream_body_kernel<float, V, false, true, LIST>
               : (KernelFn)stream_body_kernel<float, V, false, false, LIST>;
}

template <bool LIST>
KernelFn pick_l(int rows_per_thread, int staged, int kahan) {
  switch (rows_per_thread) {
    case 1: return pick_v<1, LIST>(staged, kahan);
    case 2: return pick_v<2, LIST>(staged, kahan);
    case 4: return pick_v<4, LIST>(staged, kahan);
    default: return nullptr;
  }
}

template <bool LIST>
KernelFn pick_f64(int kahan, int scattered) {
  if (scattered) {
    return kahan ? (KernelFn)stream_body_f64_kernel<true, LIST>
                 : (KernelFn)stream_body_f64_kernel<false, LIST>;
  }
  return kahan ? (KernelFn)stream_body_kernel<double, 1, false, true, LIST>
               : (KernelFn)stream_body_kernel<double, 1, false, false, LIST>;
}

// The kernel variant (the list variant where `list`, the double one where
// `f64`, the split variant where `split`), or nullptr where none is built.
// In double the variants are built at one row a thread with x through
// L1/L2: plain or Kahan, with or without a list, over the table form in the
// body's row order, or (`scattered`) over a plan with direct pieces or a
// row map.  The split variants are built at one row a thread, without a
// list, with x through L1/L2: in float plain (stream_body_split_kernel)
// and Kahan over the table form, in double plain and Kahan over every
// piece form (stream_body_split_any_kernel).
KernelFn pick(int rows_per_thread, int staged, int kahan, int f64,
              bool list = false, int scattered = 0, int split = 0) {
  if (split) {
    if (rows_per_thread != 1 || staged || list || (scattered && !f64)) {
      return nullptr;
    }
    if (f64) {
      return kahan ? (KernelFn)stream_body_split_any_kernel<double, true>
                   : (KernelFn)stream_body_split_any_kernel<double, false>;
    }
    return kahan ? (KernelFn)stream_body_split_any_kernel<float, true>
                 : (KernelFn)stream_body_split_kernel;
  }
  if (f64) {
    if (rows_per_thread != 1 || staged) return nullptr;
    return list ? pick_f64<true>(kahan, scattered)
                : pick_f64<false>(kahan, scattered);
  }
  return list ? pick_l<true>(rows_per_thread, staged, kahan)
              : pick_l<false>(rows_per_thread, staged, kahan);
}

size_t smem_bytes(int rows_per_thread, int staged, int threads, int f64) {
  return staged ? (size_t)(threads / 32) * rows_per_thread * kStageRows *
                      kLanes * (f64 ? sizeof(double) : sizeof(float))
                : 0;
}

// A failed call also leaves its error for the next cudaGetLastError(): take
// it back, so that a refused geometry does not fail a later launch.
int clear(cudaError_t rc) {
  if (rc != cudaSuccess) (void)cudaGetLastError();
  return (int)rc;
}

int allow_smem(KernelFn fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return clear(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

}  // namespace

// Bytes of dynamic shared memory a block of the variant takes.
extern "C" long long ehyb_stream_smem_bytes(int rows_per_thread, int staged,
                                            int threads, int f64) {
  return (long long)smem_bytes(rows_per_thread, staged, threads, f64);
}

// Blocks of `threads` threads of a variant (the list variant where `list`,
// the scattered body's double kernel where `scattered`, the split variant
// where `split`) that stay resident on one SM (0 where none can), or a
// negative CUDA error; -cudaErrorInvalidValue where no such variant is
// built.
extern "C" int ehyb_stream_resident_blocks(int rows_per_thread, int staged,
                                           int kahan, int f64, int threads,
                                           int list, int scattered,
                                           int split) {
  const KernelFn fn = pick(rows_per_thread, staged, kahan, f64, list != 0,
                           scattered, split);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rows_per_thread, staged, threads, f64);
  int rc = allow_smem(fn, smem);
  if (rc != 0) return -rc;
  int blocks = 0;
  rc = clear(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                           threads, smem));
  return rc != 0 ? -rc : blocks;
}

// Registers a thread of a variant takes, or a negative CUDA error.
extern "C" int ehyb_stream_registers(int rows_per_thread, int staged,
                                     int kahan, int f64, int scattered,
                                     int split) {
  const KernelFn fn = pick(rows_per_thread, staged, kahan, f64, false,
                           scattered, split);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const int rc = clear(cudaFuncGetAttributes(&attr, fn));
  return rc != 0 ? -rc : attr.numRegs;
}

// Launches the body on `stream` (a cudaStream_t): `grid` blocks of
// `threads` threads over the plan's n_rb row blocks, or over the n_list
// row blocks of `rb_list` where it is not null, rows_per_thread row blocks
// a warp at a time; returns cudaGetLastError(), 0 when the launch was
// accepted.  `piece` is (n_pieces + 1, 4) int32, `cell_idx` uint16,
// `cell_val`, `x` and `y` float (double where `f64`), every buffer 16-byte
// aligned.  Where either of `cell_col` (int32, the direct pieces' columns)
// and `row_map` (int32 plan row -> body row) is not null the plan is a
// scattered body's, which only the double kernel reads.
extern "C" int ehyb_stream_body(const void* piece, const int* rows,
                                const void* cell_val, const void* cell_idx,
                                const int* cell_col, const int* row_map,
                                const void* x, void* y, int n_rb,
                                const int* rb_list, int n_list,
                                int rows_per_thread, int staged, int kahan,
                                int f64, int threads, int grid,
                                void* stream) {
  if (n_rb <= 0 || (rb_list != nullptr && n_list <= 0)) return 0;
  const int scattered = cell_col != nullptr || row_map != nullptr;
  if (scattered && !f64) return (int)cudaErrorInvalidValue;
  const KernelFn fn = pick(rows_per_thread, staged, kahan, f64,
                           /*list=*/rb_list != nullptr, scattered);
  if (fn == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(rows_per_thread, staged, threads, f64);
  const int rc = allow_smem(fn, smem);
  if (rc != 0) return rc;
  void* args[] = {&piece, &rows, &cell_val, &cell_idx, &x,
                  &y,     &n_rb, &rb_list,  &n_list};
  void* args_scattered[] = {&piece, &rows,    &cell_val, &cell_idx,
                            &cell_col, &row_map, &x,  &y,
                            &n_rb,     &rb_list, &n_list};
  const cudaError_t launched =
      cudaLaunchKernel(fn, dim3(grid), dim3(threads),
                       scattered ? args_scattered : args, smem,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

// Launches a split variant on `stream` over a plan in the split form:
// `grid` blocks of `threads` threads over its n_items work items, x through
// L1/L2, Neumaier-compensated where `kahan`; returns cudaGetLastError(), 0
// when the launch was accepted.  `item` is (n_items, 4) int32,
// `chunk_first` (chunked row blocks + 1) int32, `partial` float (double
// where `f64`; two slots of 32 a chunk), `counter` int32 (one a chunked row
// block, 0 between calls), `cell_col` and `row_map` as ehyb_stream_body's
// (null where the plan has none; a float plan has neither), the rest as
// ehyb_stream_body's, every buffer 16-byte aligned.
extern "C" int ehyb_stream_body_split(
    const void* piece, const int* rows, const void* cell_val,
    const void* cell_idx, const int* cell_col, const int* row_map,
    const void* item, const int* chunk_first, void* partial, int* counter,
    const void* x, void* y, int n_items, int kahan, int f64, int threads,
    int grid, void* stream) {
  if (n_items <= 0) return 0;
  const int scattered = cell_col != nullptr || row_map != nullptr;
  const KernelFn fn = pick(1, 0, kahan, f64, false, scattered, 1);
  if (fn == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&piece, &rows,    &cell_val, &cell_idx, &item, &chunk_first,
                  &partial, &counter, &x,      &y,        &n_items};
  void* args_any[] = {&piece,       &rows,    &cell_val, &cell_idx,
                      &cell_col,    &row_map, &item,     &chunk_first,
                      &partial,     &counter, &x,        &y,
                      &n_items};
  const bool plain_float = !f64 && !kahan;
  const cudaError_t launched =
      cudaLaunchKernel(fn, dim3(grid), dim3(threads),
                       plain_float ? args : args_any, 0,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

// Blocks of `threads` threads of the small form's variant that stay
// resident on one SM (0 where none can), or a negative CUDA error.
extern "C" int ehyb_stream_small_resident_blocks(int kahan, int f64,
                                                 int threads) {
  int blocks = 0;
  const int rc = clear(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pick_small(kahan, f64), threads, 0));
  return rc != 0 ? -rc : blocks;
}

// Registers a thread of the small form's variant takes, or a negative
// CUDA error.
extern "C" int ehyb_stream_small_registers(int kahan, int f64) {
  cudaFuncAttributes attr;
  const int rc = clear(cudaFuncGetAttributes(&attr, pick_small(kahan, f64)));
  return rc != 0 ? -rc : attr.numRegs;
}

// Launches the small form's variant on `stream` over a plan in the small
// form: `grid` blocks of `threads` threads over its n_hub_items hub items,
// then its n_items row-block items, x through L1/L2, Neumaier-compensated
// where `kahan`; returns cudaGetLastError(), 0 when the launch was
// accepted.  `item` and `hub_item` are (n, 8) int32, `hub_val`, `partial`
// (a sum and a compensation a hub slot), `x` and `y` float (double where
// `f64`), `counter` int32 (one a hub, 0 between calls), `piece`, `rows`,
// `cell_val`, `cell_idx`, `cell_col` and `row_map` as ehyb_stream_body's
// (null where the plan has none), every buffer 16-byte aligned.
extern "C" int ehyb_stream_body_small(
    const void* piece, const int* rows, const void* cell_val,
    const void* cell_idx, const int* cell_col, const int* row_map,
    const void* item, int n_items, const void* hub_item, int n_hub_items,
    const void* hub_val, const int* hub_col, void* partial, int* counter,
    const void* x, void* y, int kahan, int f64, int threads, int grid,
    void* stream) {
  if (n_items + n_hub_items <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&piece,   &rows,     &cell_val, &cell_idx,    &cell_col,
                  &row_map, &item,     &n_items,  &hub_item,    &n_hub_items,
                  &hub_val, &hub_col,  &partial,  &counter,     &x,
                  &y};
  const cudaError_t launched =
      cudaLaunchKernel(pick_small(kahan, f64), dim3(grid), dim3(threads),
                       args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}
