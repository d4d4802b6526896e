// Float squash (Sabour et al. 2017, Eq. 1) over the rows of a float32
// [R, D] tensor: v = sq / (1 + sq) * s * rsqrt(sq + 1e-7), sq = sum(s^2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/squash.py,
// squash_float_pallas (body _squash_float_kernel), and agrees with
// repro_torch.core.routing.squash within float32 rounding: `rsqrtf` and
// torch's `rsqrt` may round differently, and the row sum runs in order.
//
// Bound on the H100: the function reads and writes 4*R*D bytes each and
// does about 4 float32 operations per element (67 TFLOP/s outside the
// tensor cores), so bytes bound it.  Design: one thread per row, a loop
// over any D, the row read twice from device memory (its second read is
// served by L1/L2); neighbouring threads touch neighbouring rows, so
// loads are coalesced only when D is small.  A warp per row for wide D
// is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void squash_float_kernel(const float* __restrict__ s,
                                    float* __restrict__ out, int64_t R,
                                    int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= R) return;
  const float* src = s + row * D;
  float sq = 0.0f;
  // a product and a sum, each rounded, as torch's `s * s` then `sum`
  for (int d = 0; d < D; ++d) sq = __fadd_rn(sq, __fmul_rn(src[d], src[d]));
  const float scale = sq / (1.0f + sq);
  const float inv = rsqrtf(sq + 1e-7f);
  float* dst = out + row * D;
  for (int d = 0; d < D; ++d) dst[d] = scale * src[d] * inv;
}

}  // namespace

// C entry point (loaded with ctypes).  Returns cudaGetLastError() after
// the launch; 0 means the launch was accepted.
extern "C" int squash_float_launch(const void* s, void* out, long long R,
                                   int D, void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const long long blocks = (R + kThreads - 1) / kThreads;
  squash_float_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<float*>(out), R, D);
  return static_cast<int>(cudaGetLastError());
}
