// Streamed SELL body with an explicit x-window cache in shared memory.
//
// Replaces the Pallas kernels K3 and K4 of ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py
// (_make_stream_hbm_kernel and _make_stream_hbm_big_kernel): the body of a
// matrix whose x the TPU cannot keep resident, with every x read served from
// 1024-float windows staged on chip.  That is the paper's "explicit caching"
// (the reference stages each partition's x slice in shared memory).  The two
// TPU kernels differ only in where their maps live (scalar prefetch or meta
// blocks in HBM); here every map is read from device memory, so one kernel
// serves both.
//
// It computes what K1 (csrc/ehyb_stream.cu) computes, for slice s and lane
// l: y[s*128 + l] = sum over the slice's steps of ell_val * x[col], with the
// same column decode (nwin 1: window-local column; nwin 2/4: the lo-slot
// (sel, hi) attributes read at lane lo of the same step row) and the same
// Neumaier variant.  The difference is where x comes from.
//
// The plan (ops/ehyb_wincache.py::build_wincache_plan).  The TPU's plan is
// an LRU over a grid that runs in order, with slots that persist from tile
// to tile; CUDA blocks run in no order, so the GPU has a plan of its own:
//   * a block walks a list of stages; a stage is a run of WHOLE slices
//     whose windows' x rows (128 floats, 512 B each) fit `slot_rows`, or a
//     range of steps of one slice whose own rows do not fit (such a slice
//     is walked in several stages, re-staging between them);
//   * a stage lists its x rows, sorted, and stages them contiguously in
//     shared memory.  A window is 8 consecutive x rows, all in the list, so
//     it lands on 8 consecutive slots: each step carries, per window
//     selector, the slot of its window's first row, and an entry reads
//     xs[(slot + hi) * 128 + lo].  Sliding (128-aligned) windows that
//     overlap share their rows instead of being staged twice;
//   * the block has `groups` groups of 128 threads that share the staged
//     rows.  The groups take the stage's slices one at a time from a
//     shared-memory counter (the reference kernel work-steals its ELL
//     blocks the same way, kernel.cu:164-167), and thread l of a group owns
//     lane l of its slice: the running sum stays in one thread's
//     registers, as in K1.  A slice split over stages is walked by group 0
//     alone, which carries its sum from stage to stage.
// As in K1, each group stages a chunk of its slice's column rows in shared
// memory before it reads them (many loads in flight per thread, and the
// lo-slot attribute read becomes a shared-memory load); a group syncs on
// its own named barrier, so the groups never wait on each other between
// stages.  Rows are staged with cp.async, 16 B a thread.  TMA and double-buffering
// (staging stage i+1 under stage i's arithmetic) are later work.
//
// Bound on the H100: bytes.  The streamed col/val bytes (6 B per cell with
// int16 columns) plus the slot maps, x once and y once; the plan's staged
// rows beyond x once come from L2 where the neighbouring blocks share them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxThreads = 1024;  // at most 8 groups of 128 threads
constexpr int kChunk = 16;        // column rows a group stages per pass

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Barrier of the 128 threads of group g (named barrier g + 1; barrier 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(kLanes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Group g's lanes walk slice s over the steps of the current stage,
// [a, b), reading x from the staged rows xs; the slice's sum starts where
// the slice starts and is written where it ends.
template <int NWIN, bool KAHAN, typename IdxT>
__device__ __forceinline__ void walk_slice(
    int s, int a, int b, int l, int g, const IdxT* __restrict__ ell_col,
    const float* __restrict__ ell_val, const int* __restrict__ slice_offset,
    const int* __restrict__ step_slot, long long slot_stride,
    const float* xs, IdxT* s_col, float* __restrict__ y, float& sum,
    float& comp) {
  const int s_beg = slice_offset[s];
  const int s_end = slice_offset[s + 1];
  const int end = min(b, s_end);
  if (a <= s_beg) {  // the slice starts in this stage
    sum = 0.0f;
    comp = 0.0f;
  }
  for (int base = max(a, s_beg); base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    if (NWIN > 1) {
      group_sync(g);  // the group's previous chunk is fully consumed
      for (int k = 0; k < n; ++k) {
        s_col[k * kLanes + l] = ell_col[(size_t)(base + k) * kLanes + l];
      }
      group_sync(g);
    }
    for (int k = 0; k < n; ++k) {
      const int step = base + k;
      const size_t cell = (size_t)step * kLanes + l;
      int xi;
      if (NWIN == 1) {
        xi = step_slot[step] * kLanes + (int)ell_col[cell];
      } else {
        const int lo = (int)s_col[k * kLanes + l] & 127;
        const int attr = (int)s_col[k * kLanes + lo];
        const int sel = attr >> 10;
        const int hi = (attr >> 7) & 7;
        xi = (step_slot[sel * slot_stride + step] + hi) * kLanes + lo;
      }
      const float p = __fmul_rn(ell_val[cell], xs[xi]);
      if (KAHAN) {
        neumaier_add(sum, comp, p);
      } else {
        sum += p;
      }
    }
  }
  if (end == s_end) y[(size_t)s * kLanes + l] = KAHAN ? sum + comp : sum;
}

template <int NWIN, bool KAHAN, typename IdxT>
__global__ void __launch_bounds__(kMaxThreads, 2) wincache_kernel(
    const IdxT* __restrict__ ell_col, const float* __restrict__ ell_val,
    const int* __restrict__ slice_offset, const int* __restrict__ step_slot,
    long long slot_stride, const int* __restrict__ block_stage,
    const int* __restrict__ stage_slice, const int* __restrict__ stage_step,
    const int* __restrict__ stage_row_ptr, const int* __restrict__ stage_rows,
    int slot_rows, const float* __restrict__ x, float* __restrict__ y) {
  extern __shared__ __align__(16) float xs[];  // slot_rows x 128, then
  const int l = threadIdx.x % kLanes;          // per group kChunk x 128
  const int g = threadIdx.x / kLanes;          // staged columns
  IdxT* s_col = reinterpret_cast<IdxT*>(xs + slot_rows * kLanes)
      + (size_t)g * kChunk * kLanes;
  __shared__ int s_next;                   // next slice of the stage
  __shared__ int s_pick[kMaxThreads / kLanes];  // each group's slice
  float sum = 0.0f;
  float comp = 0.0f;
  const int st_end = block_stage[blockIdx.x + 1];
  for (int st = block_stage[blockIdx.x]; st < st_end; ++st) {
    const int r0 = stage_row_ptr[st];
    const int n_piece = (stage_row_ptr[st + 1] - r0) * (kLanes / 4);
    __syncthreads();  // the previous stage is fully consumed
    if (threadIdx.x == 0) s_next = stage_slice[2 * st];
    for (int p = threadIdx.x; p < n_piece; p += blockDim.x) {
      const int r = p >> 5;
      const int q = (p & 31) * 4;
      cp_async16(xs + r * kLanes + q,
                 x + (size_t)stage_rows[r0 + r] * kLanes + q);
    }
    cp_async_wait_all();
    __syncthreads();
    const int a = stage_step[st];
    const int b = stage_step[st + 1];
    const int s_lo = stage_slice[2 * st];
    const int s_hi = stage_slice[2 * st + 1];
    if (s_hi - s_lo == 1) {  // one slice, maybe split over stages
      if (g == 0) walk_slice<NWIN, KAHAN>(s_lo, a, b, l, g, ell_col, ell_val,
                                          slice_offset, step_slot,
                                          slot_stride, xs, s_col, y, sum,
                                          comp);
      continue;
    }
    while (true) {
      if (l == 0) s_pick[g] = atomicAdd(&s_next, 1);
      group_sync(g);
      const int s = s_pick[g];
      group_sync(g);  // every lane has read the pick
      if (s >= s_hi) break;
      walk_slice<NWIN, KAHAN>(s, a, b, l, g, ell_col, ell_val, slice_offset,
                              step_slot, slot_stride, xs, s_col, y, sum,
                              comp);
    }
  }
}

struct Args {
  const void* ell_col;
  const float* ell_val;
  const int* slice_offset;
  const int* step_slot;
  long long slot_stride;
  const int* block_stage;
  const int* stage_slice;
  const int* stage_step;
  const int* stage_row_ptr;
  const int* stage_rows;
  const float* x;
  float* y;
  int slot_rows;
  int n_blocks;
  int groups;
  cudaStream_t stream;
};

template <int NWIN, bool KAHAN, typename IdxT>
int launch(const Args& a) {
  const size_t smem = (size_t)a.slot_rows * kLanes * sizeof(float)
      + (NWIN > 1 ? (size_t)a.groups * kChunk * kLanes * sizeof(IdxT) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wincache_kernel<NWIN, KAHAN, IdxT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  wincache_kernel<NWIN, KAHAN, IdxT><<<a.n_blocks, a.groups * kLanes, smem,
                                       a.stream>>>(
      static_cast<const IdxT*>(a.ell_col), a.ell_val, a.slice_offset,
      a.step_slot, a.slot_stride, a.block_stage, a.stage_slice, a.stage_step,
      a.stage_row_ptr, a.stage_rows, a.slot_rows, a.x, a.y);
  return 0;
}

template <typename IdxT>
int dispatch(int nwin, int kahan, const Args& a) {
  if (nwin == 1) return kahan ? launch<1, true, IdxT>(a)
                              : launch<1, false, IdxT>(a);
  if (nwin == 2) return kahan ? launch<2, true, IdxT>(a)
                              : launch<2, false, IdxT>(a);
  if (nwin == 4) return kahan ? launch<4, true, IdxT>(a)
                              : launch<4, false, IdxT>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the window-cache body on `stream` (a cudaStream_t): n_blocks
// blocks of groups * 128 threads with slot_rows * 512 B of dynamic shared
// memory (plus each group's column chunk for nwin 2/4); returns cudaGetLastError(), 0 when the launch was accepted.
// idx_bytes is 2 for int16 columns and 4 for int32; step_slot is
// (nwin, slot_stride) int32, stage_slice (n_stages, 2) int32.  x must be
// 16-byte aligned.
extern "C" int ehyb_wincache_body(
    const void* ell_col, int idx_bytes, const float* ell_val,
    const int* slice_offset, const int* step_slot, long long slot_stride,
    int nwin, int kahan, const int* block_stage, const int* stage_slice,
    const int* stage_step, const int* stage_row_ptr, const int* stage_rows,
    int slot_rows, int groups, const float* x, float* y, int n_blocks,
    void* stream) {
  if (n_blocks <= 0) return 0;
  if (groups < 1 || groups * kLanes > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{ell_col, ell_val, slice_offset, step_slot, slot_stride,
               block_stage, stage_slice, stage_step, stage_row_ptr,
               stage_rows, x, y, slot_rows, n_blocks, groups,
               static_cast<cudaStream_t>(stream)};
  int rc;
  if (idx_bytes == 2) {
    rc = dispatch<int16_t>(nwin, kahan, a);
  } else if (idx_bytes == 4) {
    rc = dispatch<int32_t>(nwin, kahan, a);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
