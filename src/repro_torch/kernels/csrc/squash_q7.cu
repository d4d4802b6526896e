// Integer squash (paper Eq. 8) over the rows of an int8 [R, D] tensor,
// D <= 32, into int8 [R, D].
//
// Replaces the Pallas TPU kernel src/repro/kernels/squash.py,
// squash_q7_pallas (body _squash_kernel, isqrt _isqrt), and is bit-exact
// with repro_torch.quant.int8_ops.squash_q7.
//
// Bound on the H100: the function moves 2*R*D bytes, ~0.16 us at
// 3.35 TB/s at the primary capsules' shape ([64*1024, 4]), and does D
// multiply-adds, one isqrt and one integer division per row on the CUDA
// cores; the bytes bound it.  Design: the exact one-step isqrt of q7.cuh
// (a float32 root and a +-1 correction) in place of the reference's 32
// guarded Newton steps, so a row costs one integer division (the
// squash ratio) instead of 65.  Each thread squashes four rows: for
// D = 4 it reads and writes them as one 16-byte word where the pointers
// are 16-byte aligned (one 32-bit word a row otherwise); other D take
// the rows byte by byte, four rows a thread at a grid stride.
#include <cuda_runtime.h>

#include <cstdint>

#include "q7.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ uint32_t squash_word(uint32_t w, int in_frac,
                                                int out_frac) {
  int32_t x[4];
  int32_t v[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) x[d] = static_cast<int8_t>(w >> (8 * d));
  q7::squash_row<4>(x, 4, in_frac, out_frac, v);
  uint32_t out = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d)
    out |= (static_cast<uint32_t>(v[d]) & 0xffu) << (8 * d);
  return out;
}

// D = 4, both pointers 4-byte aligned: thread t owns rows [4t, 4t + 4).
__global__ void __launch_bounds__(kThreads)
    squash_q7_d4_kernel(const uint32_t* __restrict__ s,
                        uint32_t* __restrict__ out, int R, bool vec16,
                        int in_frac, int out_frac) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) * kRowsPerThread;
  if (row >= R) return;
  if (vec16 && row + kRowsPerThread <= R) {
    uint4 w = reinterpret_cast<const uint4*>(s)[row / kRowsPerThread];
    w.x = squash_word(w.x, in_frac, out_frac);
    w.y = squash_word(w.y, in_frac, out_frac);
    w.z = squash_word(w.z, in_frac, out_frac);
    w.w = squash_word(w.w, in_frac, out_frac);
    reinterpret_cast<uint4*>(out)[row / kRowsPerThread] = w;
    return;
  }
  for (int k = row; k < R && k < row + kRowsPerThread; ++k)
    out[k] = squash_word(s[k], in_frac, out_frac);
}

// Any D <= 32 (q7::kMaxDim): four rows a thread, a grid's width apart.
__global__ void __launch_bounds__(kThreads)
    squash_q7_kernel(const int8_t* __restrict__ s, int8_t* __restrict__ out,
                     int R, int D, int in_frac, int out_frac) {
  const int stride = gridDim.x * kThreads;
  for (int row = blockIdx.x * kThreads + threadIdx.x; row < R;
       row += stride) {
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
}

// Check entry for the device isqrt alone (held against
// int8_ops.isqrt_newton on every non-negative int32); not on any
// serving path.
__global__ void isqrt_kernel(const int32_t* __restrict__ n,
                             int32_t* __restrict__ out, int N) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < N) out[k] = q7::isqrt(n[k]);
}

bool is_aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

}  // namespace

extern "C" int isqrt_launch(const void* n, void* out, int N, void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kBlock = 256;
  isqrt_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(n), static_cast<int32_t*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

// C entry point (loaded with ctypes); D is 1..kMaxDim.  Returns
// cudaGetLastError() after the launch; 0 means the launch was accepted.
extern "C" int squash_q7_launch(const void* s, void* out, int R, int D,
                                int in_frac, int out_frac, void* stream) {
  if (D < 1 || D > q7::kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return static_cast<int>(cudaSuccess);
  const int threads = (R + kRowsPerThread - 1) / kRowsPerThread;
  const int blocks = (threads + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 4 && is_aligned(s, 4) && is_aligned(out, 4)) {
    squash_q7_d4_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(s), static_cast<uint32_t*>(out), R,
        is_aligned(s, 16) && is_aligned(out, 16), in_frac, out_frac);
  } else {
    squash_q7_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const int8_t*>(s), static_cast<int8_t*>(out), R, D,
        in_frac, out_frac);
  }
  return static_cast<int>(cudaGetLastError());
}
