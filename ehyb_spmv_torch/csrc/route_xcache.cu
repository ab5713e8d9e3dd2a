// The routed apply in one pass over the schedule's entries, the rows' sums
// kept in shared memory, no product array in device memory: x chunks staged
// in shared memory where a chunk carries many entries (random_1m), x[col]
// read through L2 where it carries few (random_4m).
//
// Replaces the Pallas kernels K7 and K8 of ehyb_spmv_gpu_tpu/ops/route_pallas.py
// (_route_at_kernel, stages A+T, and _make_route_b_kernel, stage B) and the
// spill tail that make_routed_apply adds after them.  It computes the routed
// apply's dst-space y: y[r] = sum of val * x[col] over the schedule's entries
// of dst row r, routed and spilled, over all of a matrix's column blocks in
// one launch.
//
// The TPU cannot gather from device memory, so its schedule routes every
// product through a column-grouped stage A, a transpose into a band-major
// product array T in HBM, and a band-grouped stage B.  On the H100 that design
// costs a round trip of every product through device memory, half-empty A and
// B cells, and 16-bit attributes read at another lane.  What the schedule has
// that a row-major (CSR) kernel lacks is its column grouping: the paper's
// explicit x cache.  The host plan (ops/route_xcache.py::tile_entries)
// decodes the schedules once and keeps only their entries:
//   * a tile is a group of `group_rows` consecutive dst rows and a part of
//     the x chunks (`chunk_cols` columns each, whole 1024-column windows).
//     Its entries come in segments that read one chunk each; an entry is an
//     int32 pass << 29 | row_in_group << col_bits | col_in_chunk and an f32
//     value, read once with streaming loads, a warp's on consecutive
//     addresses;
//   * one block per tile keeps its rows' sums in dynamic shared memory and
//     walks its segments.  A segment's entries run in passes, a barrier
//     after each: a pass holds a row at most once, so a thread adds
//     val * x[col] into the row's sum with a plain read and write.  The plan
//     puts a row's k-th entry of a chunk in pass k (at most 8 passes a
//     segment; a ninth entry starts a new segment of the same chunk).  A
//     shared f32 atomicAdd, which this card runs as a compare-and-swap loop,
//     would cost more and add in no fixed order;
//   * the block writes its sums to partial y number `part`.  The last block
//     of a row group to arrive (one atomic counter per group, reset by that
//     block for the next launch) adds the group's partials in part order and
//     writes y.  With one part the block writes y itself.
// Sum order: fixed, so y is the same bit for bit from run to run; a row's
// products are added in plan order (__fmul_rn, __fadd_rn), then the partials
// in part order.  Launches of one plan must not overlap (they share the
// counters).
//
// Two kernels walk the plan:
//   * route_xcache_kernel (a staged plan, 13 column bits): the next chunk is
//     copied from x with cp.async into the other of two buffers, and each
//     thread loads its first entries of the next segment, while the current
//     segment is summed (the maps are read one segment earlier still), so
//     the loads' latency overlaps the sums and the barriers;
//   * route_direct_kernel (a direct plan): nothing staged, x[col] read
//     through L2, in chunks as wide as the entry's bits allow; each
//     segment's entries load two segments ahead and their x one ahead, so a
//     pass only adds.
// Bound on the H100: bytes.  The kernel moves through device memory its
// entries (8 B each), x once, the partials written and read back, y once, and
// its maps; the same work in any layout moves each entry's value and 32-bit
// column, x and y once.  Beside them, L2: a staged plan copies every chunk
// of its part once per row group, 4 * chunk_cols / (entries of a chunk in a
// group) bytes an entry; a direct plan reads one 32-byte sector an entry.
// At random_1m a staged chunk carries 4,096 entries (8 B of L2 an entry) and
// the staged plan runs in 0.1073 ms against the fastest direct plan's
// 0.1533.  At random_4m it carries 512 (64 B an entry), and the segments
// between barriers are too short to hide the copy: staged it takes 0.9288
// ms against 0.2981 ms direct (4,096-row groups, 2^17-column chunks, 256
// threads; chip_routed_sweep.py, NVIDIA H100 80GB HBM3, 700 W).  Thread
// block clusters that multicast each chunk to 8 row groups' blocks (8 B an
// entry from L2) took 1.1364 ms there, and lost at random_1m too, so the
// kernel has none: the plan's rule reads x directly where a chunk carries
// few entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 5;  // entries a thread loads before it sums them
// An entry: pass << 29 | row_in_group << 13 | col_in_chunk (a staged plan;
// a direct plan's column field is `col_bits` wide).
constexpr int kPassShift = 29;
constexpr int kRowShift = 13;
constexpr uint32_t kRowMask = 0xFFFFu;
constexpr uint32_t kColMask = 0x1FFFu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of x chunk `chunk` into buf (every thread of the block).
// x holds n_x floats, a multiple of 4: the last chunk may be short.
__device__ __forceinline__ void stage_chunk(int chunk, float* buf,
                                            const float* __restrict__ x,
                                            long long n_x, int chunk_cols) {
  const long long c0 = (long long)chunk * chunk_cols;
  const long long left = n_x - c0;
  const int n_piece = (int)((left < chunk_cols ? left : chunk_cols) >> 2);
  for (int p = threadIdx.x; p < n_piece; p += blockDim.x) {
    cp_async16(buf + 4 * p, x + c0 + 4 * p);
  }
}

// Load this thread's next kUnroll entries from e (stride blockDim.x).
__device__ __forceinline__ void load_entries(
    int e, int e_end, const uint32_t* __restrict__ ent_idx,
    const float* __restrict__ ent_val, uint32_t (&idx)[kUnroll],
    float (&val)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = e + u * (int)blockDim.x;
    idx[u] = i < e_end ? __ldcs(ent_idx + i) : 0u;
    val[u] = i < e_end ? __ldcs(ent_val + i) : 0.0f;
  }
}

// Gather x[chunk * chunk_cols + col] of this thread's loaded entries from
// e (a direct plan: x is read through L2, nothing is staged).
__device__ __forceinline__ void gather_x(
    int e, int e_end, const float* __restrict__ xc, uint32_t col_mask,
    const uint32_t (&idx)[kUnroll], float (&xv)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    xv[u] = e + u * (int)blockDim.x < e_end ? __ldg(xc + (idx[u] & col_mask))
                                            : 0.0f;
  }
}

// The block's sums of its group's rows (complete, after a barrier) into y,
// or into partial y number `part` and, by the group's last block to
// arrive, the group's partials added in part order into y.
__device__ __forceinline__ void write_sums(
    const float* sums, int g, int row0, int rows, int part, int parts,
    int n_rows, float* __restrict__ partial, unsigned* __restrict__ arrivals,
    float* __restrict__ y, bool* s_last) {
  if (parts == 1) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) y[row0 + r] = sums[r];
    return;
  }
  float* mine = partial + (size_t)part * n_rows + row0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) mine[r] = sums[r];
  __threadfence();  // the partial is visible before the arrival is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_last = atomicAdd(&arrivals[g], 1u) == (unsigned)(parts - 1);
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float acc = 0.0f;
    for (int q = 0; q < parts; ++q) {
      acc += __ldcg(partial + (size_t)q * n_rows + row0 + r);
    }
    y[row0 + r] = acc;
  }
  if (threadIdx.x == 0) arrivals[g] = 0u;
}

// A staged plan: the chunks staged in shared memory.
__global__ void __launch_bounds__(kMaxThreads, 1) route_xcache_kernel(
    const uint32_t* __restrict__ ent_idx, const float* __restrict__ ent_val,
    const int* __restrict__ tile_seg, const int* __restrict__ seg_chunk,
    const int* __restrict__ seg_ent, const int* __restrict__ seg_npass,
    const float* __restrict__ x, long long n_x, int chunk_cols,
    int group_rows, int n_rows, int parts, float* __restrict__ partial,
    unsigned* __restrict__ arrivals, float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool s_last;
  float* sums = smem;                 // group_rows
  float* xbuf = smem + group_rows;    // two chunks of chunk_cols
  const int tile = blockIdx.x;
  const int g = tile / parts;
  const int part = tile - g * parts;
  const int row0 = g * group_rows;
  const int rows = min(group_rows, n_rows - row0);
  const int step = kUnroll * (int)blockDim.x;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) sums[r] = 0.0f;

  const int s0 = tile_seg[tile];
  const int s1 = tile_seg[tile + 1];
  // This thread's first batch of the current segment and of the next.  The
  // maps of a segment are read two iterations before its entries, so no
  // iteration waits on them.
  uint32_t idx[kUnroll], next_idx[kUnroll];
  float val[kUnroll], next_val[kUnroll];
  int e_beg = 0, e_end = 0, n_pass = 0;
  int next_end = 0, next_chunk = 0, next_npass = 0;
  if (s0 < s1) {
    e_beg = seg_ent[s0];
    e_end = seg_ent[s0 + 1];
    n_pass = seg_npass[s0];
    if (s0 + 1 < s1) {
      next_end = seg_ent[s0 + 2];
      next_chunk = seg_chunk[s0 + 1];
      next_npass = seg_npass[s0 + 1];
    }
    stage_chunk(seg_chunk[s0], xbuf, x, n_x, chunk_cols);
    load_entries(e_beg + threadIdx.x, e_end, ent_idx, ent_val, idx, val);
  }
  cp_async_commit();
  for (int s = s0; s < s1; ++s) {
    const float* xs = xbuf + ((s - s0) & 1) * chunk_cols;
    const bool after = s + 2 < s1;
    const int after_end = after ? seg_ent[s + 3] : 0;
    const int after_chunk = after ? seg_chunk[s + 2] : 0;
    const int after_npass = after ? seg_npass[s + 2] : 0;
    if (s + 1 < s1) {
      // the other buffer was released by the previous iteration's last
      // barrier; the next segment's first entries load while this one is
      // summed
      stage_chunk(next_chunk, xbuf + ((s + 1 - s0) & 1) * chunk_cols, x, n_x,
                  chunk_cols);
      load_entries(e_end + threadIdx.x, next_end, ent_idx, ent_val, next_idx,
                   next_val);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of chunk s have landed
    __syncthreads();     // everyone's have (and the sums are zero)
    // batches and passes are the same for every thread: the barriers match
    for (int e0 = e_beg; e0 < e_end; e0 += step) {
      if (e0 != e_beg) {
        load_entries(e0 + threadIdx.x, e_end, ent_idx, ent_val, idx, val);
      }
      for (int q = 0; q < n_pass; ++q) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e0 + (int)threadIdx.x + u * (int)blockDim.x < e_end
              && (idx[u] >> kPassShift) == (uint32_t)q) {
            // a pass holds a row at most once: no other thread adds to it
            // before the barrier
            float& sum = sums[(idx[u] >> kRowShift) & kRowMask];
            sum = __fadd_rn(sum, __fmul_rn(val[u], xs[idx[u] & kColMask]));
          }
        }
        __syncthreads();  // the last one also releases chunk s's buffer
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      idx[u] = next_idx[u];
      val[u] = next_val[u];
    }
    e_beg = e_end;
    e_end = next_end;
    n_pass = next_npass;
    next_end = after_end;
    next_chunk = after_chunk;
    next_npass = after_npass;
  }
  cp_async_wait<0>();
  __syncthreads();  // the sums are complete (also with no segment at all)
  write_sums(sums, g, row0, rows, part, parts, n_rows, partial, arrivals, y,
             &s_last);
}

// A direct plan: nothing staged, x[col] read through L2, in chunks wider
// than shared memory could hold (`col_bits` column bits an entry).  Each
// segment's first entries load two segments ahead and their x one segment
// ahead, so a pass only adds.
__global__ void __launch_bounds__(kMaxThreads, 1) route_direct_kernel(
    const uint32_t* __restrict__ ent_idx, const float* __restrict__ ent_val,
    const int* __restrict__ tile_seg, const int* __restrict__ seg_chunk,
    const int* __restrict__ seg_ent, const int* __restrict__ seg_npass,
    const float* __restrict__ x, int chunk_cols, int col_bits,
    int group_rows, int n_rows, int parts, float* __restrict__ partial,
    unsigned* __restrict__ arrivals, float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool s_last;
  float* sums = smem;  // group_rows
  const int tile = blockIdx.x;
  const int g = tile / parts;
  const int part = tile - g * parts;
  const int row0 = g * group_rows;
  const int rows = min(group_rows, n_rows - row0);
  const int step = kUnroll * (int)blockDim.x;
  const uint32_t col_mask = (1u << col_bits) - 1u;
  const uint32_t row_mask = (1u << (kPassShift - col_bits)) - 1u;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) sums[r] = 0.0f;
  __syncthreads();

  const int s0 = tile_seg[tile];
  const int n_steps = tile_seg[tile + 1] - s0;
  // segments s (a: entries and x), s + 1 (b: entries and x in flight) and
  // s + 2 (c: entries in flight)
  uint32_t a_idx[kUnroll], b_idx[kUnroll], c_idx[kUnroll];
  float a_val[kUnroll], b_val[kUnroll], c_val[kUnroll];
  float a_x[kUnroll], b_x[kUnroll];
  int a_beg = 0, a_end = 0, a_pass = 0, a_chunk = 0;
  int b_end = 0, b_pass = 0, b_chunk = 0;
  int c_end = 0, c_pass = 0, c_chunk = 0;
  if (n_steps > 0) {
    a_beg = seg_ent[s0];
    a_end = seg_ent[s0 + 1];
    a_pass = seg_npass[s0];
    a_chunk = seg_chunk[s0];
    load_entries(a_beg + threadIdx.x, a_end, ent_idx, ent_val, a_idx, a_val);
    gather_x(a_beg + threadIdx.x, a_end,
             x + (long long)a_chunk * chunk_cols, col_mask, a_idx, a_x);
  }
  if (n_steps > 1) {
    b_end = seg_ent[s0 + 2];
    b_pass = seg_npass[s0 + 1];
    b_chunk = seg_chunk[s0 + 1];
    load_entries(a_end + threadIdx.x, b_end, ent_idx, ent_val, b_idx, b_val);
  }
  for (int s = 0; s < n_steps; ++s) {
    if (s + 2 < n_steps) {
      c_end = seg_ent[s0 + s + 3];
      c_pass = seg_npass[s0 + s + 2];
      c_chunk = seg_chunk[s0 + s + 2];
      load_entries(b_end + threadIdx.x, c_end, ent_idx, ent_val, c_idx,
                   c_val);
    }
    if (s + 1 < n_steps) {
      gather_x(a_end + threadIdx.x, b_end,
               x + (long long)b_chunk * chunk_cols, col_mask, b_idx, b_x);
    }
    for (int e0 = a_beg; e0 < a_end; e0 += step) {
      if (e0 != a_beg) {
        load_entries(e0 + threadIdx.x, a_end, ent_idx, ent_val, a_idx, a_val);
        gather_x(e0 + threadIdx.x, a_end,
                 x + (long long)a_chunk * chunk_cols, col_mask, a_idx, a_x);
      }
      for (int q = 0; q < a_pass; ++q) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e0 + (int)threadIdx.x + u * (int)blockDim.x < a_end
              && (a_idx[u] >> kPassShift) == (uint32_t)q) {
            // a pass holds a row at most once (as in the staged kernel)
            float& sum = sums[(a_idx[u] >> col_bits) & row_mask];
            sum = __fadd_rn(sum, __fmul_rn(a_val[u], a_x[u]));
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a_idx[u] = b_idx[u];
      a_val[u] = b_val[u];
      a_x[u] = b_x[u];
      b_idx[u] = c_idx[u];
      b_val[u] = c_val[u];
    }
    a_beg = a_end;
    a_end = b_end;
    a_pass = b_pass;
    a_chunk = b_chunk;
    b_end = c_end;
    b_pass = c_pass;
    b_chunk = c_chunk;
  }
  __syncthreads();
  write_sums(sums, g, row0, rows, part, parts, n_rows, partial, arrivals, y,
             &s_last);
}

}  // namespace

// Launches the one-pass routed apply on `stream` (a cudaStream_t): n_tiles
// blocks of `threads` threads.  A staged plan (entries of 13 column bits)
// takes (group_rows + 2 * chunk_cols) * 4 B of dynamic shared memory; a
// direct plan (`direct`, entries of `col_bits` column bits) reads x through
// L2 with group_rows * 4 B.  Returns cudaGetLastError(), 0 when the launch
// was accepted.  ent_idx holds uint32 entries; the maps are int32.  partial
// holds parts * n_rows floats (unused with one part); arrivals holds one
// zeroed counter per row group.  x must be 16-byte aligned.
extern "C" int ehyb_route_xcache(
    const void* ent_idx, const float* ent_val, const int* tile_seg,
    const int* seg_chunk, const int* seg_ent, const int* seg_npass,
    const float* x, long long n_x, int chunk_cols, int group_rows, int n_rows,
    int parts, float* partial, void* arrivals, float* y, int n_tiles,
    int threads, int direct, int col_bits, void* stream) {
  if (n_tiles <= 0) return 0;
  const int row_bits = kPassShift - col_bits;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || parts < 1
      || group_rows < 32 || group_rows % 32 || n_x % 4 || n_rows < 1
      || col_bits < 2 || row_bits < 5 || group_rows > (1 << row_bits)
      || chunk_cols < 4 || chunk_cols % 4 || chunk_cols > (1 << col_bits)
      || (!direct && col_bits != kRowShift)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (direct) {
    const size_t smem = (size_t)group_rows * 4;
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          route_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    route_direct_kernel<<<n_tiles, threads, smem, st>>>(
        static_cast<const uint32_t*>(ent_idx), ent_val, tile_seg, seg_chunk,
        seg_ent, seg_npass, x, chunk_cols, col_bits, group_rows, n_rows,
        parts, partial, static_cast<unsigned*>(arrivals), y);
  } else {
    const size_t smem = (size_t)(group_rows + 2 * (size_t)chunk_cols) * 4;
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          route_xcache_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    route_xcache_kernel<<<n_tiles, threads, smem, st>>>(
        static_cast<const uint32_t*>(ent_idx), ent_val, tile_seg, seg_chunk,
        seg_ent, seg_npass, x, n_x, chunk_cols, group_rows, n_rows, parts,
        partial, static_cast<unsigned*>(arrivals), y);
  }
  return (int)cudaGetLastError();
}
