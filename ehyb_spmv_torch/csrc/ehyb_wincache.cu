// Streamed SELL body with an explicit x-window cache in shared memory, over
// a compact cell layout of its own.
//
// Replaces the Pallas kernels K3 and K4 of ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py
// (_make_stream_hbm_kernel and _make_stream_hbm_big_kernel): the body of a
// matrix whose x the TPU cannot keep resident, with every x read served from
// x rows staged on chip.  That is the paper's "explicit caching": the
// reference stages each partition's x slice in shared memory and reads it
// through int16 window-local columns, one width per 32-row block.
//
// It computes what K1 (csrc/ehyb_stream.cu) computes: for every body row,
// the sum over its cells in step order of value * x[col], plain or with the
// same Neumaier compensation, each product rounded on its own (__fmul_rn,
// __dmul_rn), in float or, for a float64 config, in double (Val).
// The cells it reads are not the TPU's.  The TPU gathers in two stages
// (dynamic_gather with a lo-slot index), so each 128-lane step of its
// relaxed layout addresses at most 4 windows and most cells are padding
// (76% on permuted_poisson_4096).  Shared memory can be read at any index,
// so the host plan (ops/ehyb_wincache.py::build_wincache_plan) decodes the
// lo-slot layout once and keeps only the real cells:
//   * a stage is a run of whole slices whose windows' x rows (128 values,
//     512 B each in float, 1 KB in double) fit `slot_rows`, or the steps of
//     one slice whose own rows do not fit; it lists its rows, sorted, and
//     they are staged contiguously in shared memory with cp.async, 16 B (4
//     floats or 2 doubles) a thread;
//   * each stage's rows are cut into row blocks of 32 (one warp), each with
//     one width; a cell is a value (Val) and a uint16 index
//     slot * 128 + lane into the stage's staged rows (it counts values, so
//     it is the same in both types), stored column-major
//     (cell k of row r at base + 32 k + r) so a warp's loads coalesce.  A
//     row's cells keep their step order, so the sums equal K1's bit for
//     bit for finite x (the dropped cells are zeros);
//   * a block walks one stage, or the stages of one slice split over
//     several; its warps take the stage's row blocks in turn (warp w:
//     blocks w, w + warps, ...), a thread owns one row and writes it once.
//     A split slice has 4 row blocks per stage, always on warps 0-3, which
//     carry their sums from stage to stage in registers;
//   * staging is not overlapped within a block: two blocks share an SM, and
//     one stages while the other sums.  A double row takes twice the shared
//     memory, so the float64 plan stages fewer rows in blocks of 512
//     threads (ops/ehyb_wincache.py, SLOT_ROWS_F64 and GROUPS_F64) to keep
//     two blocks an SM.
// Cells are read with streaming loads (read once; L2 keeps the x rows that
// neighbouring stages share).
//
// Bound on the H100: bytes.  What the kernel moves is its compact cells
// (6 B each, 10 B in double), its staged rows (x once plus what
// neighbouring stages stage again) and y once; the same work in any layout
// moves each body entry's value and 16-bit column, x once and y once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 32;          // rows of a cell block: one warp
constexpr int kMaxThreads = 1024;  // at most 8 groups of 128 threads
constexpr int kMaxThreadsF64 = 512;  // in double, at most 4 groups
constexpr int kUnroll = 4;         // cells of a row loaded before summing

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

template <bool KAHAN, typename Val>
__device__ __forceinline__ void add(Val& sum, Val& comp, Val p) {
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copies of stage t's x rows into buf (every thread of the block),
// 16 B a copy: 32 copies an x row in float, 64 in double.
template <typename Val>
__device__ __forceinline__ void stage_rows(
    int t, Val* buf, const int* __restrict__ stage_row_ptr,
    const int* __restrict__ rows, const Val* __restrict__ x) {
  constexpr int kCopies = kLanes * (int)sizeof(Val) / 16;  // of a row
  constexpr int kShift = sizeof(Val) == 4 ? 5 : 6;         // log2 kCopies
  constexpr int kPer = 16 / (int)sizeof(Val);              // values a copy
  const int r0 = stage_row_ptr[t];
  const int n_piece = (stage_row_ptr[t + 1] - r0) * kCopies;
  for (int p = threadIdx.x; p < n_piece; p += blockDim.x) {
    const int r = p >> kShift;
    const int q = (p & (kCopies - 1)) * kPer;
    cp_async16(buf + r * kLanes + q, x + (size_t)rows[r0 + r] * kLanes + q);
  }
}

// MAX_THREADS bounds a block, so that two blocks an SM get the registers:
// 1024 threads (32 registers) for float, 512 (up to 64 registers) for
// double, which spills at 1024.
template <typename Val, bool KAHAN, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 2) wincache_kernel(
    const Val* __restrict__ cell_val,
    const uint16_t* __restrict__ cell_idx, const int* __restrict__ rb_cell,
    const int* __restrict__ stage_rb, const int* __restrict__ slice_offset,
    const int* __restrict__ block_stage, const int* __restrict__ stage_slice,
    const int* __restrict__ stage_step, const int* __restrict__ stage_row_ptr,
    const int* __restrict__ rows, const Val* __restrict__ x,
    Val* __restrict__ y) {
  extern __shared__ __align__(16) float xs_[];
  Val* xs = reinterpret_cast<Val*>(xs_);  // slot_rows x 128
  const int lane = threadIdx.x % kRows;
  const int warp = threadIdx.x / kRows;
  const int n_warps = blockDim.x / kRows;
  const int t0 = block_stage[blockIdx.x];
  const int t1 = block_stage[blockIdx.x + 1];
  Val sum = Val(0);
  Val comp = Val(0);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous stage is fully consumed
    stage_rows(t, xs, stage_row_ptr, rows, x);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // stage t's rows are in xs
    const int s_lo = stage_slice[2 * t];
    const int s_hi = stage_slice[2 * t + 1];
    // a stage may start inside its first slice or end inside its last
    const bool fresh0 = stage_step[t] <= slice_offset[s_lo];
    const bool done_last = stage_step[t + 1] >= slice_offset[s_hi];
    const int rb0 = stage_rb[t];
    const int n_rb = stage_rb[t + 1] - rb0;
    for (int i = warp; i < n_rb; i += n_warps) {
      if (i >= kLanes / kRows || fresh0) {
        sum = Val(0);
        comp = Val(0);
      }
      const int c_end = rb_cell[rb0 + i + 1];
      int c = rb_cell[rb0 + i] + lane;
      for (; c + (kUnroll - 1) * kRows < c_end; c += kUnroll * kRows) {
        Val v[kUnroll];
        int j[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = __ldcs(cell_val + c + u * kRows);
          j[u] = __ldcs(cell_idx + c + u * kRows);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          add<KAHAN>(sum, comp, mul_rn(v[u], xs[j[u]]));
        }
      }
      for (; c < c_end; c += kRows) {
        add<KAHAN>(sum, comp,
                   mul_rn(__ldcs(cell_val + c), xs[__ldcs(cell_idx + c)]));
      }
      if (i < n_rb - kLanes / kRows || done_last) {
        y[(size_t)s_lo * kLanes + i * kRows + lane] = KAHAN ? sum + comp : sum;
      }
    }
  }
}

template <typename Val, bool KAHAN, int MAX_THREADS>
int launch(int n_blocks, int threads, size_t smem, cudaStream_t stream,
           const void* cell_val, const uint16_t* cell_idx,
           const int* rb_cell, const int* stage_rb, const int* slice_offset,
           const int* block_stage, const int* stage_slice,
           const int* stage_step, const int* stage_row_ptr, const int* rows,
           const void* x, void* y) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wincache_kernel<Val, KAHAN, MAX_THREADS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  wincache_kernel<Val, KAHAN, MAX_THREADS>
      <<<n_blocks, threads, smem, stream>>>(
      static_cast<const Val*>(cell_val), cell_idx, rb_cell, stage_rb,
      slice_offset, block_stage, stage_slice, stage_step, stage_row_ptr,
      rows, static_cast<const Val*>(x), static_cast<Val*>(y));
  return 0;
}

using Launch = int (*)(int, int, size_t, cudaStream_t, const void*,
                       const uint16_t*, const int*, const int*, const int*,
                       const int*, const int*, const int*, const int*,
                       const int*, const void*, void*);

// The most threads a block of the value type's kernel takes.
int max_threads(int f64) { return f64 ? kMaxThreadsF64 : kMaxThreads; }

// The kernel (and its launcher) of a value type and Kahan flag.
template <bool KAHAN>
const void* pick_k(int f64, Launch* run) {
  if (!f64) {
    *run = launch<float, KAHAN, kMaxThreads>;
    return (const void*)wincache_kernel<float, KAHAN, kMaxThreads>;
  }
  *run = launch<double, KAHAN, kMaxThreadsF64>;
  return (const void*)wincache_kernel<double, KAHAN, kMaxThreadsF64>;
}

const void* pick(int kahan, int f64, Launch* run) {
  return kahan ? pick_k<true>(f64, run) : pick_k<false>(f64, run);
}

size_t smem_bytes(int slot_rows, int f64) {
  return (size_t)slot_rows * kLanes * (f64 ? sizeof(double) : sizeof(float));
}

// A failed call also leaves its error for the next cudaGetLastError(): take
// it back, so that a refused query does not fail a later launch.
int clear(cudaError_t rc) {
  if (rc != cudaSuccess) (void)cudaGetLastError();
  return (int)rc;
}

}  // namespace

// Blocks of `groups` * 128 threads staging `slot_rows` x rows that stay
// resident on one SM (0 where none can), or a negative CUDA error.
extern "C" int ehyb_wincache_resident_blocks(int slot_rows, int groups,
                                             int kahan, int f64) {
  if (groups < 1 || groups * kLanes > max_threads(f64)) {
    return -(int)cudaErrorInvalidValue;
  }
  Launch run;
  const void* fn = pick(kahan, f64, &run);
  const size_t smem = smem_bytes(slot_rows, f64);
  int rc = smem > 48 * 1024
               ? clear(cudaFuncSetAttribute(
                     fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     (int)smem))
               : 0;
  if (rc != 0) return -rc;
  int blocks = 0;
  rc = clear(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, groups * kLanes, smem));
  return rc != 0 ? -rc : blocks;
}

// Registers a thread of the kernel for `groups` * 128 threads takes, or a
// negative CUDA error.
extern "C" int ehyb_wincache_registers(int groups, int kahan, int f64) {
  if (groups < 1 || groups * kLanes > max_threads(f64)) {
    return -(int)cudaErrorInvalidValue;
  }
  Launch run;
  cudaFuncAttributes attr;
  const int rc = clear(cudaFuncGetAttributes(&attr, pick(kahan, f64, &run)));
  return rc != 0 ? -rc : attr.numRegs;
}

// Launches the window-cache body on `stream` (a cudaStream_t): n_blocks
// blocks of groups * 128 threads (at most 1024 in float, 512 in double;
// more is cudaErrorInvalidValue) with slot_rows x 128 values of dynamic
// shared memory; returns cudaGetLastError(), 0 when the launch was
// accepted.  cell_val, x and y are float, or double where `f64`; cell_idx
// holds uint16 stage indices; every map is int32, stage_slice
// (n_stages, 2).  x must be 16-byte aligned.
extern "C" int ehyb_wincache_body(
    const void* cell_val, const void* cell_idx, const int* rb_cell,
    const int* stage_rb, const int* slice_offset, const int* block_stage,
    const int* stage_slice, const int* stage_step, const int* stage_row_ptr,
    const int* stage_rows, int slot_rows, int groups, int kahan, int f64,
    const void* x, void* y, int n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  if (groups < 1 || groups * kLanes > max_threads(f64) || slot_rows < 1
      || slot_rows * kLanes > 65536) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(slot_rows, f64);
  const int threads = groups * kLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* idx = static_cast<const uint16_t*>(cell_idx);
  Launch run;
  (void)pick(kahan, f64, &run);
  const int rc = run(n_blocks, threads, smem, s, cell_val, idx, rb_cell,
                     stage_rb, slice_offset, block_stage, stage_slice,
                     stage_step, stage_row_ptr, stage_rows, x, y);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
