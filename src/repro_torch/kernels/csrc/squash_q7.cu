// Integer squash (paper Eq. 8 with the Alg. 4 Newton isqrt) over the rows
// of an int8 [R, D] tensor, D <= 16, into int8 [R, D].
//
// Replaces the Pallas TPU kernel src/repro/kernels/squash.py,
// squash_q7_pallas (body _squash_kernel, isqrt _isqrt), and is bit-exact
// with repro_torch.quant.int8_ops.squash_q7.
//
// Bound on the H100: the function moves 2*R*D bytes and does ~32 guarded
// Newton steps (two integer divisions each) per row, which run on the
// CUDA cores.  At the primary capsules' shape ([64*1024, 4]) the bytes
// take ~0.16 us at 3.35 TB/s, so the integer divisions of the isqrt
// loop bound it in practice.  Design: one thread per row, the whole row
// in registers; no shared memory and no inter-thread communication.
// Making it fast (several rows per thread, a shorter exact isqrt) is
// later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "q7.cuh"

namespace {

__global__ void squash_q7_kernel(const int8_t* __restrict__ s,
                                 int8_t* __restrict__ out, int R, int D,
                                 int in_frac, int out_frac) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const int8_t* src = s + static_cast<size_t>(row) * D;
  int32_t x[q7::kMaxDim];
  int32_t v[q7::kMaxDim];
#pragma unroll
  for (int d = 0; d < q7::kMaxDim; ++d) x[d] = d < D ? src[d] : 0;
  q7::squash_row(x, D, in_frac, out_frac, v);
  int8_t* dst = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int d = 0; d < q7::kMaxDim; ++d)
    if (d < D) dst[d] = static_cast<int8_t>(v[d]);
}

// Check entry for the device isqrt alone (tests it exhaustively over the
// range a squash can reach, [0, 16 * 128^2]); not on any serving path.
__global__ void isqrt_newton_kernel(const int32_t* __restrict__ n,
                                    int32_t* __restrict__ out, int N) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < N) out[k] = q7::isqrt_newton(n[k]);
}

}  // namespace

extern "C" int isqrt_newton_launch(const void* n, void* out, int N,
                                   void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  isqrt_newton_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(n), static_cast<int32_t*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

// C entry point (loaded with ctypes).  Returns cudaGetLastError() after
// the launch; 0 means the launch was accepted.
extern "C" int squash_q7_launch(const void* s, void* out, int R, int D,
                                int in_frac, int out_frac, void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const int blocks = (R + kThreads - 1) / kThreads;
  squash_q7_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<int8_t*>(out), R, D,
      in_frac, out_frac);
  return static_cast<int>(cudaGetLastError());
}
