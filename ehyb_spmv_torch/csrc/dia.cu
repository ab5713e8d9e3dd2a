// DIA body of the EHYB format: y[i] = sum_k dia_val[k, i] * x[i + d_k].
//
// Replaces ehyb_spmv_gpu_tpu/ops/dia_pallas.py::make_dia_pallas_apply (the
// Pallas kernel K9), both of its variants: x resident in VMEM (inner
// `kernel` at :131) and x streamed as block pairs (:115).  One kernel serves
// both here, since the card reads x from device memory at any size.
//
// For i < dim_r, with the K static offsets d_k:
//
//   y[i] = sum over k of dia_val[k * dim_r + i] * x[i + d_k]
//
// and an x index outside [0, n_x) reads as zero (the padding of the plain
// torch op, ops/torch_ops.py::ehyb_dia).  The terms are added in order of k,
// each product rounded on its own, as the plain version adds them.
//
// What the TPU needed and this leaves behind: pack_dia's (nb, K*Brows, 128)
// blocking, the lane roll and the sublane select that build each shifted x
// window in registers.  Here dia_val stays (K, dim_r) row-major, so the
// threads of a warp read consecutive rows of one diagonal: every load of the
// value stream is coalesced.
//
// Design.  A block of 512 threads owns a run of 2048 rows (4 per thread, 4
// independent sums).  When the run's x span [r0 + d_min, r0 + 2048 + d_max)
// fits in shared memory it is staged there once (fem3d_68's 99 diagonals
// span 28,162 rows: ~121 KB of dynamic shared memory), and each x element
// then comes from device memory once per block instead of K times.  A span
// too wide to stage is read through __ldg instead (STAGED = false).  The
// offsets are a small device array that each block copies to shared memory.
//
// Bound on the H100: bytes.  Each call reads dia_val once and x and writes y:
// (K * dim_r + 2 * dim_r) * 4 B, ~381 MB at fem3d_68 (~114 us at 3.35 TB/s);
// the staged x re-reads come from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPerThread = 4;
constexpr int kRows = kThreads * kPerThread;

template <bool STAGED>
__global__ void __launch_bounds__(kThreads) dia_kernel(
    const float* __restrict__ val, const int* __restrict__ offsets, int n_diag,
    long long dim_r, int d_min, int span, const float* __restrict__ x,
    long long n_x, float* __restrict__ y) {
  extern __shared__ int smem[];
  int* s_off = smem;
  // x staging area after the offsets (offsets padded to 4 ints)
  float* xs = reinterpret_cast<float*>(smem + ((n_diag + 3) & ~3));
  const long long r0 = (long long)blockIdx.x * kRows;
  const int t = threadIdx.x;
  for (int k = t; k < n_diag; k += kThreads) s_off[k] = offsets[k];
  if (STAGED) {
    const long long g0 = r0 + d_min;  // x index held by xs[0]
    for (int j = t; j < span; j += kThreads) {
      const long long g = g0 + j;
      xs[j] = (g >= 0 && g < n_x) ? __ldg(x + g) : 0.0f;
    }
  }
  __syncthreads();
  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;
  for (int k = 0; k < n_diag; ++k) {
    const int d = s_off[k];
    const float* vk = val + (size_t)k * dim_r;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int r = t + j * kThreads;  // row within the run
      const long long i = r0 + r;
      if (i < dim_r) {
        float xv;
        if (STAGED) {
          xv = xs[r + d - d_min];
        } else {
          const long long g = i + d;
          xv = (g >= 0 && g < n_x) ? __ldg(x + g) : 0.0f;
        }
        acc[j] = __fadd_rn(acc[j], __fmul_rn(__ldg(vk + i), xv));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = r0 + t + j * kThreads;
    if (i < dim_r) y[i] = acc[j];
  }
}

template <bool STAGED>
int launch(const float* val, const int* offsets, int n_diag, long long dim_r,
           int d_min, int span, const float* x, long long n_x, float* y,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dia_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = (dim_r + kRows - 1) / kRows;
  dia_kernel<STAGED><<<(unsigned)blocks, kThreads, smem, stream>>>(
      val, offsets, n_diag, dim_r, d_min, span, x, n_x, y);
  return 0;
}

}  // namespace

// Rows each block owns (the wrapper sizes the staged span with it).
extern "C" int ehyb_dia_block_rows() { return kRows; }

// Launches the DIA body on `stream` (a cudaStream_t) and returns
// cudaGetLastError(); 0 means the launch was accepted.  `offsets` is a
// device array of n_diag int32 offsets with minimum d_min and maximum d_max;
// `staged` selects the shared-memory x span (the wrapper checks that it
// fits).
extern "C" int ehyb_dia(const float* val, const int* offsets, int n_diag,
                        long long dim_r, int d_min, int d_max,
                        const float* x, long long n_x, float* y, int staged,
                        void* stream) {
  if (dim_r <= 0 || n_diag <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t off_bytes = (size_t)((n_diag + 3) & ~3) * sizeof(int);
  int rc;
  if (staged) {
    const int span = d_max - d_min + kRows;
    rc = launch<true>(val, offsets, n_diag, dim_r, d_min, span, x, n_x, y,
                      off_bytes + (size_t)span * sizeof(float), st);
  } else {
    rc = launch<false>(val, offsets, n_diag, dim_r, d_min, 0, x, n_x, y,
                       off_bytes, st);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
