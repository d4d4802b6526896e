// int8 x int8 -> int32 GEMM with the q7 scalar-shift epilogue (paper's
// mat_mult_q7 family): C = sat8(round_shift(A @ B, shift)), A [M, K],
// B [K, N] row-major int8, optionally batched ([..., M, K] x [..., K, N]
// with one launch, the batch on gridDim.z).
//
// Replaces the Pallas TPU kernel src/repro/kernels/q7_matmul.py,
// q7_matmul_pallas (body _q7_matmul_kernel), and is bit-exact with
// repro_torch.quant.int8_ops.matmul_q7 (the epilogue is q7::rshift_sat8:
// nearest adds the half-LSB, a negative shift shifts left, shifts outside
// [0, 31] follow XLA's rules).
//
// Bound on the H100: 2*M*K*N int8 operations at 1,979 TOP/s against
// M*K + K*N + M*N bytes at 3.35 TB/s; square products from about 256^3
// up are bound by operations, thin ones (small M or N) by bytes.  Two
// main loops, chosen per call by kernels/q7_matmul.py::gemm_plan from
// the shape and the operands' alignment alone: i8_gemm_sm90.cuh (wgmma
// fed by a TMA ring, B transposed first by i8_transpose_launch; stream-K
// for M <= 64, split K for other thin products) wherever TMA can
// describe A (K % 16 == 0, A 16-byte aligned), and i8_gemm.cuh (mma.sync
// m16n8k32) for the rest.
#include <cuda_runtime.h>

#include <cstdint>

#include "i8_gemm.cuh"
#include "i8_gemm_sm90.cuh"
#include "q7.cuh"

namespace {

struct ScalarShift {
  using Out = int8_t;
  int shift;
  bool nearest;
  __device__ __forceinline__ void stage(int32_t*, int64_t, int, int) const {}
  __device__ __forceinline__ int32_t apply(int32_t acc, int,
                                           const int32_t*) const {
    return q7::rshift_sat8(acc, shift, nearest);
  }
};

}  // namespace

// C entry point (loaded with ctypes): `batch` products of [M, K] x [K, N]
// packed back to back.  Returns cudaGetLastError() after the launch; 0
// means the launch was accepted.
extern "C" int q7_matmul_launch(const void* a, const void* b, void* c,
                                int batch, int M, int N, int K, int shift,
                                int nearest, void* stream) {
  return i8gemm::launch(a, b, c, batch, M, N, K,
                        ScalarShift{shift, nearest != 0}, stream);
}

// The wgmma route, one launch each: Bt [batch, N, K] = B transposed;
// the product over A [batch, M, K] and Bt on tiles 128 x bn, into C
// (split == 1) or into the int32 partials work [batch, split, M, N];
// C from those partials; and the stream-K product on `ctas` blocks, work
// holding its arrival counts and partial tiles.  Each returns
// cudaGetLastError() after its launch.
extern "C" int i8_transpose_launch(const void* b, void* bt, int batch, int K,
                                   int N, void* stream) {
  return i8sm90::launch_transpose(b, bt, batch, K, N, stream);
}

extern "C" int q7_matmul_wgmma_launch(const void* a, const void* bt, void* c,
                                      void* work, int batch, int M, int N,
                                      int K, int bn, int split, int shift,
                                      int nearest, void* stream) {
  return i8sm90::launch_product(a, bt, c, work, batch, M, N, K, bn, split,
                                ScalarShift{shift, nearest != 0}, stream);
}

extern "C" int q7_matmul_reduce_launch(const void* work, void* c, int batch,
                                       int M, int N, int split, int shift,
                                       int nearest, void* stream) {
  return i8sm90::launch_reduce(work, c, batch, M, N, split,
                               ScalarShift{shift, nearest != 0}, stream);
}

extern "C" int q7_matmul_streamk_launch(const void* a, const void* bt,
                                        void* c, void* work, int batch,
                                        int M, int N, int K, int ctas,
                                        int shift, int nearest,
                                        void* stream) {
  return i8sm90::launch_streamk(a, bt, c, work, batch, M, N, K, ctas,
                                ScalarShift{shift, nearest != 0}, stream);
}
