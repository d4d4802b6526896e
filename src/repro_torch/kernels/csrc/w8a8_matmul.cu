// W8A8 GEMM with a per-output-column power-of-two shift: C [M, N] int8 =
// sat8(shift_col(A @ W)), A [M, K] and W [K, N] row-major int8,
// col_shift [N] int32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/w8a8_matmul.py,
// w8a8_matmul_pallas (body _w8a8_kernel), and is bit-exact with
// repro_torch.kernels.ref.w8a8_matmul_ref.  For a column's shift sh:
// nearest adds shl(1, sh - 1) when sh > 0; then sar(acc, sh) for sh >= 0
// or shl(acc, -sh) for sh < 0; then sat8 (q7.cuh's XLA shift rules).
//
// Bound on the H100: 2*M*K*N int8 operations at 1,979 TOP/s against
// M*K + K*N + M*N + 4*N bytes at 3.35 TB/s, as q7_matmul.cu, on the
// same two main loops, chosen the same way: i8_gemm_sm90.cuh (wgmma, TMA
// ring, stream-K or split K; W transposed by q7_matmul.cu's
// i8_transpose_launch) where TMA can describe A, i8_gemm.cuh (mma.sync)
// elsewhere.  Each block that runs the epilogue loads the shifts of its
// output columns into shared memory once a tile.
#include <cuda_runtime.h>

#include <cstdint>

#include "i8_gemm.cuh"
#include "i8_gemm_sm90.cuh"
#include "q7.cuh"

namespace {

struct ColumnShift {
  using Out = int8_t;
  const int32_t* col_shift;
  bool nearest;
  __device__ __forceinline__ void stage(int32_t* tile, int64_t, int n0,
                                        int N) const {
    for (int j = threadIdx.x; j < i8gemm::kBN; j += blockDim.x)
      tile[j] = n0 + j < N ? col_shift[n0 + j] : 0;
    __syncthreads();
  }
  __device__ __forceinline__ int32_t apply(int32_t acc, int col,
                                           const int32_t* tile) const {
    const int32_t sh = tile[col];
    if (nearest && sh > 0) acc = q7::wadd(acc, q7::shl(1, sh - 1));
    acc = sh >= 0 ? q7::sar(acc, sh) : q7::shl(acc, -sh);
    return q7::sat8(acc);
  }
};

}  // namespace

// C entry point (loaded with ctypes).  Returns cudaGetLastError() after
// the launch; 0 means the launch was accepted.
extern "C" int w8a8_matmul_launch(const void* a, const void* w,
                                  const void* col_shift, void* c, int M,
                                  int N, int K, int nearest, void* stream) {
  return i8gemm::launch(
      a, w, c, 1, M, N, K,
      ColumnShift{static_cast<const int32_t*>(col_shift), nearest != 0},
      stream);
}

// The wgmma route: the product over A [batch, M, K] and Wt [batch, N, K]
// (W transposed by i8_transpose_launch) on tiles 128 x bn, into C (split
// == 1) or into the int32 partials work [batch, split, M, N]; C from
// those partials; and the stream-K product on `ctas` blocks.  The
// arguments follow q7_matmul.cu's entries, the epilogue's last.  Each
// returns cudaGetLastError() after its launch.
extern "C" int w8a8_matmul_wgmma_launch(const void* a, const void* wt,
                                        void* c, void* work, int batch,
                                        int M, int N, int K, int bn,
                                        int split, const void* col_shift,
                                        int nearest, void* stream) {
  return i8sm90::launch_product(
      a, wt, c, work, batch, M, N, K, bn, split,
      ColumnShift{static_cast<const int32_t*>(col_shift), nearest != 0},
      stream);
}

extern "C" int w8a8_matmul_reduce_launch(const void* work, void* c,
                                         int batch, int M, int N, int split,
                                         const void* col_shift, int nearest,
                                         void* stream) {
  return i8sm90::launch_reduce(
      work, c, batch, M, N, split,
      ColumnShift{static_cast<const int32_t*>(col_shift), nearest != 0},
      stream);
}

extern "C" int w8a8_matmul_streamk_launch(const void* a, const void* wt,
                                          void* c, void* work, int batch,
                                          int M, int N, int K, int ctas,
                                          const void* col_shift, int nearest,
                                          void* stream) {
  return i8sm90::launch_streamk(
      a, wt, c, work, batch, M, N, K, ctas,
      ColumnShift{static_cast<const int32_t*>(col_shift), nearest != 0},
      stream);
}
