// W8A8 dense product with a power-of-two dequantizing epilogue: Y [M, N]
// = out(float(A @ W) * 2^-(xe + n[col])), A [M, K] row-major int8, W
// stored K-major as Wt [N, K] int8 (the port's W8A8 leaf, laid out once
// at quantization), xe the activation's exponent (one int32 in device
// memory), n [N] int32 the weight's per-column exponents, out bfloat16
// (round to nearest even) or float32.  The batched face takes `batch`
// such products packed back to back, A [batch, M, K], Wt [batch, N, K],
// n [batch, N] (each entry its own exponents, one xe for all) -> Y
// [batch, M, N]: the MoE's expert products, one expert a batch entry.
//
// No TPU kernel: the reference computes these with XLA's int8
// dot_general and einsum and an elementwise dequantization,
// src/repro/quant/lm_quant.py:76 (q_dense) and :86 (q_einsum).  It is
// bit-exact with repro_torch.kernels.w8a8_dense.w8a8_dense_plain: the
// int32 accumulator (wrapping, as XLA's dot) becomes float32 by
// __int2float_rn, is multiplied by 2^-(xe + n), built exactly from its
// exponent bits (xe and n lie in [-24, 24], so the scale is a normal
// float32 and the product is exact), and is rounded once, by
// __float2bfloat16_rn.
//
// Bound on the H100: 2*batch*M*K*N int8 operations at 1,979 TOP/s
// against batch*(M*K + K*N + 2*M*N + 4*N) bytes (bfloat16 out) at 3.35
// TB/s; a decode step (M = the batch, 8, or an expert's 4 slots) is
// bound by the bytes of W, a prefill (M = 512) by operations for the
// wide products.  It runs on the same two main loops as q7_matmul.cu and
// w8a8_matmul.cu, chosen the same way by kernels/q7_matmul.py::gemm_plan,
// reading Wt as it is stored (no transpose launch): i8_gemm_sm90.cuh
// where TMA can describe A and Wt (wgmma; for M <= 64, the decode
// products, the stream-K schedule: 64-row tiles, a deep ring of W and
// one persistent block per SM, each an equal share of W's bytes; above,
// 128-row tiles and split K), and i8_gemm.cuh (mma.sync, its K-major B
// copied straight into shared memory) elsewhere.  Each block stages xe + n
// of its batch entry's output columns in shared memory once a tile, as
// w8a8_matmul.cu's ColumnShift stages its shifts; split K runs the same
// functor in the reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "i8_gemm.cuh"
#include "i8_gemm_sm90.cuh"

namespace {

__device__ __forceinline__ float to_out(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

template <class T>
struct Dequant {
  using Out = T;
  const int32_t* xe;           // the activation's exponent, one int32
  const int32_t* n;            // [batch, N] the weight columns' exponents
  __device__ __forceinline__ void stage(int32_t* tile, int64_t z, int n0,
                                        int N) const {
    const int32_t e = *xe;
    const int32_t* nz = n + z * N;
    for (int j = threadIdx.x; j < i8gemm::kBN; j += blockDim.x)
      tile[j] = n0 + j < N ? e + nz[n0 + j] : 0;
    __syncthreads();
  }
  __device__ __forceinline__ T apply(int32_t acc, int col,
                                     const int32_t* tile) const {
    // 2^-(xe + n): the exponent field of a float32 holds 127 - (xe + n)
    const float scale = __int_as_float((127 - tile[col]) << 23);
    return to_out(__fmul_rn(__int2float_rn(acc), scale), T{});
  }
};

template <class T>
Dequant<T> dequant(const void* xe, const void* n) {
  return Dequant<T>{static_cast<const int32_t*>(xe),
                    static_cast<const int32_t*>(n)};
}

}  // namespace

// C entry points (loaded with ctypes); `out_bf16` picks the output type
// (1: bfloat16, 0: float32), and `batch` products run on the grid's z.
// Each returns cudaGetLastError() after its launch; 0 means the launch
// was accepted.
extern "C" int w8a8_dense_launch(const void* a, const void* wt,
                                 const void* xe, const void* n, void* c,
                                 int batch, int M, int N, int K,
                                 int out_bf16, void* stream) {
  if (out_bf16)
    return i8gemm::launch<Dequant<__nv_bfloat16>, true>(
        a, wt, c, batch, M, N, K, dequant<__nv_bfloat16>(xe, n), stream);
  return i8gemm::launch<Dequant<float>, true>(
      a, wt, c, batch, M, N, K, dequant<float>(xe, n), stream);
}

// The wgmma route over A [batch, M, K] and Wt [batch, N, K]: the product
// on tiles 128 x bn, into C (split == 1) or into the int32 partials work
// [batch, split, M, N]; C from those partials; and the stream-K product
// on `ctas` blocks, work holding its arrival counts and partial tiles.
// The arguments follow w8a8_matmul.cu's entries, the epilogue's last (xe,
// n [batch, N], out_bf16).
extern "C" int w8a8_dense_wgmma_launch(const void* a, const void* wt, void* c,
                                       void* work, int batch, int M, int N,
                                       int K, int bn, int split,
                                       const void* xe, const void* n,
                                       int out_bf16, void* stream) {
  if (out_bf16)
    return i8sm90::launch_product(a, wt, c, work, batch, M, N, K, bn, split,
                                  dequant<__nv_bfloat16>(xe, n), stream);
  return i8sm90::launch_product(a, wt, c, work, batch, M, N, K, bn, split,
                                dequant<float>(xe, n), stream);
}

extern "C" int w8a8_dense_reduce_launch(const void* work, void* c, int batch,
                                        int M, int N, int split,
                                        const void* xe, const void* n,
                                        int out_bf16, void* stream) {
  if (out_bf16)
    return i8sm90::launch_reduce(work, c, batch, M, N, split,
                                 dequant<__nv_bfloat16>(xe, n), stream);
  return i8sm90::launch_reduce(work, c, batch, M, N, split,
                               dequant<float>(xe, n), stream);
}

extern "C" int w8a8_dense_streamk_launch(const void* a, const void* wt,
                                         void* c, void* work, int batch,
                                         int M, int N, int K, int ctas,
                                         const void* xe, const void* n,
                                         int out_bf16, void* stream) {
  if (out_bf16)
    return i8sm90::launch_streamk(a, wt, c, work, batch, M, N, K, ctas,
                                  dequant<__nv_bfloat16>(xe, n), stream);
  return i8sm90::launch_streamk(a, wt, c, work, batch, M, N, K, ctas,
                                dequant<float>(xe, n), stream);
}
