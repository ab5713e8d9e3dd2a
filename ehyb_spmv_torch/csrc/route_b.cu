// Routed stage B: route the band-major products to their rows and reduce.
//
// Replaces ehyb_spmv_gpu_tpu/ops/route_pallas.py::_make_route_b_kernel (the
// Pallas kernel K8).  The B stream holds 8-step sub-tiles of 128 lanes.
// Sub-tile k reads the band group b_gmap[k / s_b] (block_rows rows of the
// product array t, viewed as (rows, 128)) at row offset b_boff[k].  For a
// step row r of sub-tile k and lane l:
//
//   iv   = b_idx[r, l];  src = iv & 127
//   a    = b_idx[r, src]                    (the slot attribute at lane src)
//   sel  = (a >> 10) & 15  (0 when >= chain),  srow = (a >> 7) & 7
//   g    = iv >> 14 ? 0 : t[(gmap * block_rows + boff + sel*8 + srow), src]
//
// Slice layout: a segment is one dst slice, its sub-tiles
// [seg_first, seg_last]; y[seg * 128 + l] = sum of g over their 8 rows.
// Octet layout: a segment is 8 dst slices, row s of each sub-tile belongs to
// slice 8 * seg + s; y[(8 * seg + s) * 128 + l] = sum of g over sub-tiles.
//
// Bound on the H100: bytes.  2 B per b_idx slot and 4 B per product read
// once, plus y.  One band's products (n_win * P floats, 64 KB at random_1m)
// are read by the few slices of that band, so repeat reads hit L2.
//
// Design.  The TPU carries the running sum across a sequential grid with a
// reset flag per sub-tile, then gathers each slice's last sub-tile.  CUDA
// blocks run in no order, so each segment is one block of 128 threads
// (thread = lane) that walks its own sub-tiles from seg_first to seg_last,
// computed once on the host at upload, and writes the finished sums straight
// into y: no atomics, no per-sub-tile output stream, no gather afterwards,
// and the result is deterministic.  Each sub-tile's 8 index rows are staged
// in shared memory because the (sel, srow) bits are read at another lane.
// Masked slots load nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTS = 8;

template <bool OCTET>
__global__ void __launch_bounds__(kLanes) route_b_kernel(
    const int16_t* __restrict__ b_idx, const int* __restrict__ b_gmap,
    const int* __restrict__ b_boff, const int* __restrict__ seg_first,
    const int* __restrict__ seg_last, const float* __restrict__ t,
    float* __restrict__ y, int s_b, int block_rows, int chain) {
  __shared__ int16_t s_idx[kTS][kLanes];
  const int seg = blockIdx.x;
  const int l = threadIdx.x;
  const int first = seg_first[seg];
  const int last = seg_last[seg];
  float acc[OCTET ? kTS : 1];
#pragma unroll
  for (int s = 0; s < (OCTET ? kTS : 1); ++s) acc[s] = 0.0f;
  for (int k = first; k <= last; ++k) {
    __syncthreads();  // the previous sub-tile's rows are fully consumed
#pragma unroll
    for (int s = 0; s < kTS; ++s) {
      s_idx[s][l] = b_idx[((size_t)k * kTS + s) * kLanes + l];
    }
    __syncthreads();
    const size_t base =
        (size_t)b_gmap[k / s_b] * block_rows + (size_t)b_boff[k];
    float part = 0.0f;
#pragma unroll
    for (int s = 0; s < kTS; ++s) {
      const int iv = s_idx[s][l];
      float g = 0.0f;
      if ((iv >> 14) == 0) {
        const int src = iv & 127;
        const int a = s_idx[s][src];
        int sel = (a >> 10) & 15;
        if (sel >= chain) sel = 0;
        const int srow = (a >> 7) & 7;
        g = __ldg(t + (base + sel * kTS + srow) * kLanes + src);
      }
      if constexpr (OCTET) {
        acc[s] += g;
      } else {
        part += g;
      }
    }
    if constexpr (!OCTET) acc[0] += part;
  }
  if constexpr (OCTET) {
#pragma unroll
    for (int s = 0; s < kTS; ++s) {
      y[((size_t)seg * kTS + s) * kLanes + l] = acc[s];
    }
  } else {
    y[(size_t)seg * kLanes + l] = acc[0];
  }
}

}  // namespace

// Launches K8 on `stream` (a cudaStream_t) over n_segs segments and returns
// cudaGetLastError(); 0 means the launch was accepted.  y holds n_segs * 128
// floats (slice layout) or n_segs * 8 * 128 (octet layout).
extern "C" int ehyb_route_b(const int16_t* b_idx, const int* b_gmap,
                            const int* b_boff, const int* seg_first,
                            const int* seg_last, const float* t, float* y,
                            int n_segs, int s_b, int block_rows, int chain,
                            int octet, void* stream) {
  if (n_segs <= 0) return 0;
  if (s_b <= 0 || block_rows <= 0 || chain <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (octet) {
    route_b_kernel<true><<<n_segs, kLanes, 0, st>>>(
        b_idx, b_gmap, b_boff, seg_first, seg_last, t, y, s_b, block_rows,
        chain);
  } else {
    route_b_kernel<false><<<n_segs, kLanes, 0, st>>>(
        b_idx, b_gmap, b_boff, seg_first, seg_last, t, y, s_b, block_rows,
        chain);
  }
  return (int)cudaGetLastError();
}
