// Routed stages A+T: gather-multiply, written out band-major.
//
// Replaces ehyb_spmv_gpu_tpu/ops/route_pallas.py::_route_at_kernel (the
// Pallas kernel K7).  The A stream holds `steps` width-steps of 128 lanes,
// band-group-major: grid step g = b * nq + q (b the band group, q a chunk of
// 8 product rows, nq = gr / 8) owns steps [g * 1024, (g + 1) * 1024).  For a
// step at offset t in [0, 1024) of grid step (b, q), and lane l:
//
//   lo  = a_col[step, l] & 127
//   hi  = a_col[step, lo] >> 7          (the slot attribute at lane lo)
//   p   = a_val[step, l] * x[(a_win[step / 8] + hi) * 128 + lo]
//   out[b, l, q * 8 + t / 128, t % 128] = p      (out is (n_bg, 128, gr, 128))
//
// Bound on the H100: bytes.  Each A slot is read once (2 B column + 4 B
// value) and each product is written once (4 B); x (4 MB at random_1m) and
// the window map stay in the 50 MB L2.
//
// Design.  On the TPU this kernel turns a two-stage VMEM gather into full
// vregs and then transposes (128, 128) tiles in registers.  On Hopper each
// product is one direct __ldg gather from x, so the transpose is only the
// output address.  A block takes 32 steps x 128 lanes: it stages the column
// tile in shared memory (the hi bits come from another lane of the same
// step), forms the products into a padded shared tile with coalesced reads of
// the A stream, and writes the tile out transposed, one warp per lane: 32
// consecutive floats (128 B) of one output row per store.  Products are
// single rounded multiplies (__fmul_rn), so the kernel equals its plain
// version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTS = 8;                      // steps per sub-tile (one window)
constexpr int kQC = 8;                      // product rows per grid step
constexpr int kGridSteps = kQC * kLanes;    // 1024 steps per (b, q)
constexpr int kTile = 32;                   // steps per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) route_at_kernel(
    const int16_t* __restrict__ a_col, const float* __restrict__ a_val,
    const int* __restrict__ a_win, const float* __restrict__ x,
    float* __restrict__ out, int nq, int gr) {
  __shared__ int16_t s_col[kTile][kLanes];
  __shared__ float s_prod[kTile][kLanes + 1];  // +1: conflict-free columns
  const int tid = threadIdx.x;
  const long long step0 = (long long)blockIdx.x * kTile;
  const size_t cell0 = (size_t)step0 * kLanes;
  for (int i = tid; i < kTile * kLanes; i += kThreads) {
    s_col[i / kLanes][i % kLanes] = a_col[cell0 + i];
  }
  __syncthreads();
  for (int i = tid; i < kTile * kLanes; i += kThreads) {
    const int k = i / kLanes;
    const int l = i % kLanes;
    const int lo = s_col[k][l] & 127;
    const int hi = s_col[k][lo] >> 7;
    const int w = a_win[(step0 + k) / kTS];
    const float xv = __ldg(x + (size_t)(w + hi) * kLanes + lo);
    s_prod[k][l] = __fmul_rn(a_val[cell0 + i], xv);
  }
  __syncthreads();
  const long long g = step0 / kGridSteps;
  const long long b = g / nq;
  const int q = (int)(g % nq);
  const int t0 = (int)(step0 % kGridSteps);
  const int row = q * kQC + t0 / kLanes;
  const int col0 = t0 % kLanes;
  const int warp = tid / 32;
  const int k = tid % 32;
  for (int l = warp; l < kLanes; l += kThreads / 32) {
    out[((size_t)(b * kLanes + l) * gr + row) * kLanes + col0 + k] =
        s_prod[k][l];
  }
}

}  // namespace

// Launches K7 on `stream` (a cudaStream_t) and returns cudaGetLastError();
// 0 means the launch was accepted.  steps must equal n_bg * gr * 128 (a whole
// number of 1024-step grid steps), gr a multiple of 8.
extern "C" int ehyb_route_at(const int16_t* a_col, const float* a_val,
                             const int* a_win, const float* x, float* out,
                             long long steps, int gr, void* stream) {
  if (steps <= 0) return 0;
  if (gr <= 0 || gr % kQC != 0 || steps % kGridSteps != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = steps / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  route_at_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      a_col, a_val, a_win, x, out, gr / kQC, gr);
  return (int)cudaGetLastError();
}
