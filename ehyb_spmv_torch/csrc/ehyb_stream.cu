// Streamed SELL body of the EHYB format, x resident in device memory.
//
// Replaces ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py::_make_stream_resident_kernel
// (the Pallas kernel K1).  For slice s, whose width-steps are
// [slice_offset[s], slice_offset[s+1]), and lane l in 0..127:
//
//   y[s*128 + l] = sum over steps of ell_val[step, l] * x[col(step, l)]
//   nwin = 1:    col = step_win[step] + ell_col[step, l]
//   nwin = 2, 4: lo = ell_col[step, l] & 127,  a = ell_col[step, lo],
//                sel = a >> 10,  hi = (a >> 7) & 7,
//                col = win_sel[step] + (hi << 7) + lo
//
// The (sel, hi) bits are the slot attributes at lane lo of the SAME step
// row, not the entry's own bits.  Each chunk of steps is staged in shared
// memory so that read is a shared-memory load.
//
// Design.  The TPU grid runs in order and carries a running sum across grid
// steps, resetting it at slice starts; the caller then gathers each slice's
// last sub-tile.  CUDA blocks run in no order, so each slice is one block of
// 128 threads and thread l owns row lane l: it loops over the slice's steps
// and writes its finished sum.  No reset flags, no gather, no atomics, and
// the result is deterministic.  The kernel masks its own ragged edge, so
// ell_col/ell_val need no stream-tile padding.
//
// Bound on the H100: the streamed bytes (6 B per slot with int16 columns)
// plus the x gathers, which hit L1/L2 (a 1 MB x sits in the 50 MB L2).  This
// first version keeps the simple one-block-per-slice shape; TMA streaming,
// shared-memory x windows and persistent blocks are later work.
//
// Compensated variant (kahan): the same loop with a Neumaier compensation
// register.  Products are rounded on their own (__fmul_rn) so the compiler
// cannot contract them into the two-sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 32;  // steps staged in shared memory per pass

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

template <int NWIN, bool KAHAN, typename IdxT>
__global__ void __launch_bounds__(kLanes) stream_body_kernel(
    const IdxT* __restrict__ ell_col, const float* __restrict__ ell_val,
    const int* __restrict__ slice_offset, const int* __restrict__ win0,
    const int* __restrict__ win1, const int* __restrict__ win2,
    const int* __restrict__ win3, const float* __restrict__ x,
    float* __restrict__ y) {
  __shared__ IdxT s_col[NWIN > 1 ? kChunk : 1][kLanes];
  const int s = blockIdx.x;
  const int l = threadIdx.x;
  const int beg = slice_offset[s];
  const int end = slice_offset[s + 1];
  float sum = 0.0f;
  float comp = 0.0f;
  for (int base = beg; base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    if (NWIN > 1) {
      __syncthreads();  // the previous chunk is fully consumed
      for (int k = 0; k < n; ++k) {
        s_col[k][l] = ell_col[(size_t)(base + k) * kLanes + l];
      }
      __syncthreads();
    }
    for (int k = 0; k < n; ++k) {
      const int step = base + k;
      const size_t cell = (size_t)step * kLanes + l;
      int c;
      if (NWIN == 1) {
        c = win0[step] + (int)ell_col[cell];
      } else {
        const int lo = (int)s_col[k][l] & 127;
        const int a = (int)s_col[k][lo];
        const int sel = a >> 10;
        const int hi = (a >> 7) & 7;
        int w = win0[step];
        if (sel == 1) w = win1[step];
        if (NWIN == 4) {
          if (sel == 2) w = win2[step];
          if (sel == 3) w = win3[step];
        }
        c = w + (hi << 7) + lo;
      }
      const float p = __fmul_rn(ell_val[cell], __ldg(x + c));
      if (KAHAN) {
        neumaier_add(sum, comp, p);
      } else {
        sum += p;
      }
    }
  }
  y[(size_t)s * kLanes + l] = KAHAN ? sum + comp : sum;
}

template <int NWIN, bool KAHAN, typename IdxT>
void launch(const void* ell_col, const float* ell_val,
            const int* slice_offset, const int* w0, const int* w1,
            const int* w2, const int* w3, const float* x, float* y,
            int n_slices, cudaStream_t stream) {
  stream_body_kernel<NWIN, KAHAN, IdxT><<<n_slices, kLanes, 0, stream>>>(
      static_cast<const IdxT*>(ell_col), ell_val, slice_offset, w0, w1, w2,
      w3, x, y);
}

template <typename IdxT>
int dispatch(int nwin, int kahan, const void* ell_col, const float* ell_val,
             const int* slice_offset, const int* w0, const int* w1,
             const int* w2, const int* w3, const float* x, float* y,
             int n_slices, cudaStream_t st) {
#define EHYB_LAUNCH(NW, K)                                                  \
  launch<NW, K, IdxT>(ell_col, ell_val, slice_offset, w0, w1, w2, w3, x, y, \
                      n_slices, st)
  if (nwin == 1) {
    kahan ? EHYB_LAUNCH(1, true) : EHYB_LAUNCH(1, false);
  } else if (nwin == 2) {
    kahan ? EHYB_LAUNCH(2, true) : EHYB_LAUNCH(2, false);
  } else if (nwin == 4) {
    kahan ? EHYB_LAUNCH(4, true) : EHYB_LAUNCH(4, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef EHYB_LAUNCH
  return 0;
}

}  // namespace

// Launches the body on `stream` (a cudaStream_t) and returns
// cudaGetLastError(); 0 means the launch was accepted.  idx_bytes is 2 for
// int16 columns and 4 for int32.  Unused window maps may alias win0.
extern "C" int ehyb_stream_body(const void* ell_col, int idx_bytes,
                                const float* ell_val,
                                const int* slice_offset, const int* win0,
                                const int* win1, const int* win2,
                                const int* win3, int nwin, int kahan,
                                const float* x, float* y, int n_slices,
                                void* stream) {
  if (n_slices <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (idx_bytes == 2) {
    rc = dispatch<int16_t>(nwin, kahan, ell_col, ell_val, slice_offset, win0,
                           win1, win2, win3, x, y, n_slices, st);
  } else if (idx_bytes == 4) {
    rc = dispatch<int32_t>(nwin, kahan, ell_col, ell_val, slice_offset, win0,
                           win1, win2, win3, x, y, n_slices, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
