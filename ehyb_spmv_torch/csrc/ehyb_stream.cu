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
// 8 B, as a TPU pair does, and the card adds it natively.  The double
// kernel is built at one row a thread with x through L1/L2, plain or
// Neumaier (__dadd_rn, __dsub_rn, fabs), with or without a row-block
// list; the cells' values are 8 B wide and their indices as they are.
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

// A kernel variant, as the runtime API takes it (the variants' parameter
// types differ with the value type).
using KernelFn = const void*;

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
KernelFn pick_f64(int kahan) {
  return kahan ? (KernelFn)stream_body_kernel<double, 1, false, true, LIST>
               : (KernelFn)stream_body_kernel<double, 1, false, false, LIST>;
}

// The kernel variant (the list variant where `list`, the double one where
// `f64`), or nullptr where none is built.  In double the variants are built
// at one row a thread with x through L1/L2: plain or Kahan, with or without
// a list.
KernelFn pick(int rows_per_thread, int staged, int kahan, int f64,
              bool list = false) {
  if (f64) {
    if (rows_per_thread != 1 || staged) return nullptr;
    return list ? pick_f64<true>(kahan) : pick_f64<false>(kahan);
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

// Blocks of `threads` threads of a variant (the list variant where `list`)
// that stay resident on one SM (0 where none can), or a negative CUDA
// error; -cudaErrorInvalidValue where no such variant is built.
extern "C" int ehyb_stream_resident_blocks(int rows_per_thread, int staged,
                                           int kahan, int f64, int threads,
                                           int list) {
  const KernelFn fn = pick(rows_per_thread, staged, kahan, f64, list != 0);
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
                                     int kahan, int f64) {
  const KernelFn fn = pick(rows_per_thread, staged, kahan, f64);
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
// aligned.
extern "C" int ehyb_stream_body(const void* piece, const int* rows,
                                const void* cell_val, const void* cell_idx,
                                const void* x, void* y, int n_rb,
                                const int* rb_list, int n_list,
                                int rows_per_thread, int staged, int kahan,
                                int f64, int threads, int grid,
                                void* stream) {
  if (n_rb <= 0 || (rb_list != nullptr && n_list <= 0)) return 0;
  const KernelFn fn = pick(rows_per_thread, staged, kahan, f64,
                           /*list=*/rb_list != nullptr);
  if (fn == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(rows_per_thread, staged, threads, f64);
  const int rc = allow_smem(fn, smem);
  if (rc != 0) return rc;
  void* args[] = {&piece, &rows, &cell_val, &cell_idx, &x,
                  &y,     &n_rb, &rb_list,  &n_list};
  const cudaError_t launched =
      cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}
