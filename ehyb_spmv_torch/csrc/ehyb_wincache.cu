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
// same Neumaier compensation, each product rounded on its own (__fmul_rn).
// The cells it reads are not the TPU's.  The TPU gathers in two stages
// (dynamic_gather with a lo-slot index), so each 128-lane step of its
// relaxed layout addresses at most 4 windows and most cells are padding
// (76% on permuted_poisson_4096).  Shared memory can be read at any index,
// so the host plan (ops/ehyb_wincache.py::build_wincache_plan) decodes the
// lo-slot layout once and keeps only the real cells:
//   * a stage is a run of whole slices whose windows' x rows (128 floats,
//     512 B each) fit `slot_rows`, or the steps of one slice whose own rows
//     do not fit; it lists its rows, sorted, and they are staged
//     contiguously in shared memory with cp.async, 16 B a thread;
//   * each stage's rows are cut into row blocks of 32 (one warp), each with
//     one width; a cell is a float32 value and a uint16 index
//     slot * 128 + lane into the stage's staged rows, stored column-major
//     (cell k of row r at base + 32 k + r) so a warp's loads coalesce.  A
//     row's cells keep their step order, so the sums equal K1's bit for
//     bit for finite x (the dropped cells are zeros);
//   * a block walks one stage, or the stages of one slice split over
//     several; its warps take the stage's row blocks in turn (warp w:
//     blocks w, w + warps, ...), a thread owns one row and writes it once.
//     A split slice has 4 row blocks per stage, always on warps 0-3, which
//     carry their sums from stage to stage in registers;
//   * staging is not overlapped within a block: two blocks share an SM, and
//     one stages while the other sums.
// Cells are read with streaming loads (read once; L2 keeps the x rows that
// neighbouring stages share).
//
// Bound on the H100: bytes.  What the kernel moves is its compact cells
// (6 B each), its staged rows (x once plus what neighbouring stages stage
// again) and y once; the same work in any layout moves body nnz * 6 B, x
// once and y once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 32;          // rows of a cell block: one warp
constexpr int kMaxThreads = 1024;  // at most 8 groups of 128 threads
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

template <bool KAHAN>
__device__ __forceinline__ void add(float& sum, float& comp, float p) {
  if (KAHAN) {
    neumaier_add(sum, comp, p);
  } else {
    sum = __fadd_rn(sum, p);
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

// Start the copies of stage t's x rows into buf (every thread of the block).
__device__ __forceinline__ void stage_rows(
    int t, float* buf, const int* __restrict__ stage_row_ptr,
    const int* __restrict__ rows, const float* __restrict__ x) {
  const int r0 = stage_row_ptr[t];
  const int n_piece = (stage_row_ptr[t + 1] - r0) * (kLanes / 4);
  for (int p = threadIdx.x; p < n_piece; p += blockDim.x) {
    const int r = p >> 5;
    const int q = (p & 31) * 4;
    cp_async16(buf + r * kLanes + q, x + (size_t)rows[r0 + r] * kLanes + q);
  }
}

template <bool KAHAN>
__global__ void __launch_bounds__(kMaxThreads, 2) wincache_kernel(
    const float* __restrict__ cell_val,
    const uint16_t* __restrict__ cell_idx, const int* __restrict__ rb_cell,
    const int* __restrict__ stage_rb, const int* __restrict__ slice_offset,
    const int* __restrict__ block_stage, const int* __restrict__ stage_slice,
    const int* __restrict__ stage_step, const int* __restrict__ stage_row_ptr,
    const int* __restrict__ rows, const float* __restrict__ x,
    float* __restrict__ y) {
  extern __shared__ __align__(16) float xs[];  // slot_rows x 128
  const int lane = threadIdx.x % kRows;
  const int warp = threadIdx.x / kRows;
  const int n_warps = blockDim.x / kRows;
  const int t0 = block_stage[blockIdx.x];
  const int t1 = block_stage[blockIdx.x + 1];
  float sum = 0.0f;
  float comp = 0.0f;
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
        sum = 0.0f;
        comp = 0.0f;
      }
      const int c_end = rb_cell[rb0 + i + 1];
      int c = rb_cell[rb0 + i] + lane;
      for (; c + (kUnroll - 1) * kRows < c_end; c += kUnroll * kRows) {
        float v[kUnroll];
        int j[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = __ldcs(cell_val + c + u * kRows);
          j[u] = __ldcs(cell_idx + c + u * kRows);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          add<KAHAN>(sum, comp, __fmul_rn(v[u], xs[j[u]]));
        }
      }
      for (; c < c_end; c += kRows) {
        add<KAHAN>(sum, comp,
                   __fmul_rn(__ldcs(cell_val + c), xs[__ldcs(cell_idx + c)]));
      }
      if (i < n_rb - kLanes / kRows || done_last) {
        y[(size_t)s_lo * kLanes + i * kRows + lane] = KAHAN ? sum + comp : sum;
      }
    }
  }
}

template <bool KAHAN>
int launch(int n_blocks, int threads, size_t smem, cudaStream_t stream,
           const float* cell_val, const uint16_t* cell_idx,
           const int* rb_cell, const int* stage_rb, const int* slice_offset,
           const int* block_stage, const int* stage_slice,
           const int* stage_step, const int* stage_row_ptr, const int* rows,
           const float* x, float* y) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wincache_kernel<KAHAN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  wincache_kernel<KAHAN><<<n_blocks, threads, smem, stream>>>(
      cell_val, cell_idx, rb_cell, stage_rb, slice_offset, block_stage,
      stage_slice, stage_step, stage_row_ptr, rows, x, y);
  return 0;
}

}  // namespace

// Launches the window-cache body on `stream` (a cudaStream_t): n_blocks
// blocks of groups * 128 threads with slot_rows * 512 B of dynamic shared
// memory; returns cudaGetLastError(), 0 when the launch was accepted.
// cell_idx holds uint16 stage indices; every map is int32, stage_slice
// (n_stages, 2).  x must be 16-byte aligned.
extern "C" int ehyb_wincache_body(
    const float* cell_val, const void* cell_idx, const int* rb_cell,
    const int* stage_rb, const int* slice_offset, const int* block_stage,
    const int* stage_slice, const int* stage_step, const int* stage_row_ptr,
    const int* stage_rows, int slot_rows, int groups, int kahan,
    const float* x, float* y, int n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  if (groups < 1 || groups * kLanes > kMaxThreads || slot_rows < 1
      || slot_rows * kLanes > 65536) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)slot_rows * kLanes * sizeof(float);
  const int threads = groups * kLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* idx = static_cast<const uint16_t*>(cell_idx);
  const int rc =
      kahan ? launch<true>(n_blocks, threads, smem, s, cell_val, idx, rb_cell,
                           stage_rb, slice_offset, block_stage, stage_slice,
                           stage_step, stage_row_ptr, stage_rows, x, y)
            : launch<false>(n_blocks, threads, smem, s, cell_val, idx,
                            rb_cell, stage_rb, slice_offset, block_stage,
                            stage_slice, stage_step, stage_row_ptr,
                            stage_rows, x, y);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
