// Tiled int8 x int8 -> int32 GEMM main loop, shared by q7_matmul.cu,
// w8a8_matmul.cu and w8a8_dense.cu and templated on the epilogue that
// turns each int32 accumulator into an output element of the epilogue's
// type `Epi::Out` (int8 for the shift epilogues, bfloat16 or float32 for
// w8a8_dense's dequantization).
//
// A is row-major [M, K], B row-major [K, N] or, with the template flag
// kBKMajor, stored K-major as Bt [N, K] (w8a8_dense's weights), C
// row-major [M, N] Epi::Out, with an optional batch on gridDim.z (one
// product per z, operands packed back to back).  Each block computes one
// kBM x kBN output tile; the K loop runs inside the block.
//
// This loop keeps the shapes TMA cannot describe (K % 16 != 0, an
// operand not 16-byte aligned): kernels/q7_matmul.py::gemm_plan sends
// every other shape to i8_gemm_sm90.cuh's wgmma loop.
//
// Design:
//   * 256 threads = 8 warps as 2 (rows) x 4 (cols); each warp owns a
//     64 x 32 sub-tile, 4 x 4 tensor-core tiles of m16n8k32, whose int32
//     accumulators live in registers (64 per thread).  The launch bounds
//     cap a thread at 128 registers so that two blocks share an SM
//     whatever the epilogue needs.
//   * The inner product is `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8
//     .s32` WITHOUT `.satfinite`: XLA's int32 dot wraps on overflow, and
//     so does this sum (integer adds are exact modulo 2^32, so the order
//     of the K sum cannot change the result).
//   * Per K step of kBK = 64, the A tile [kBM][kBK] and the B tile as
//     [kBN][kBK], so that each thread's fragment is 4 consecutive k
//     bytes, are staged in shared memory (a row-major B transposed on its
//     way in, a K-major one copied 16 bytes at a time).  Rows are padded
//     to kLd = 80 bytes (20 words): the 8 rows x 4 words a fragment load
//     touches fall in 32 distinct banks.
//   * The block masks ragged edges itself: out-of-range A/B bytes are
//     staged as zeros (exact in integer arithmetic) and out-of-range
//     outputs are not written, so any M, K, N >= 1 works.  Global loads
//     are 16 bytes wide where the row length and the base pointer allow
//     it, byte-wise otherwise.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "q7.cuh"

namespace i8gemm {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kLd = kBK + 16;          // padded smem row, bytes
constexpr int kThreads = 256;
constexpr int kWarpM = 64;             // rows of one warp's sub-tile
constexpr int kWarpN = 32;             // cols of one warp's sub-tile
constexpr int kMi = kWarpM / 16;       // m16 tiles per warp
constexpr int kNi = kWarpN / 8;        // n8 tiles per warp

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of row `row` (length `len`, row stride `ld`) starting at
// column `col`, zero outside [0, rows) x [0, len).
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ p,
                                        int64_t row, int rows, int64_t col,
                                        int64_t len, int64_t ld, bool vec) {
  if (row < rows && vec && col + 16 <= len)
    return __ldg(reinterpret_cast<const uint4*>(p + row * ld + col));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row < rows) {
    const int8_t* src = p + row * ld;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col + j < len)
        w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[col + j]))
                    << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Epilogue contract: `Epi::Out` is the output element type;
// `stage(tile, z, n0, N)` runs once per block before the K loop (all
// threads; `tile` is kBN int32 of shared memory for the per-column data
// of columns [n0, n0 + kBN) of batch entry z),
// `apply(acc, col, tile)` maps one accumulator of output column n0 + col
// to its output value (converted to Epi::Out by the store).

template <class Epi, bool kBKMajor>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                typename Epi::Out* __restrict__ C, int M, int N, int K,
                bool vec_a, bool vec_b, Epi epi) {
  __shared__ __align__(16) int8_t As[kBM * kLd];
  __shared__ __align__(16) int8_t Bs[kBN * kLd];   // [n][k]
  __shared__ int32_t epi_tile[kBN];

  const int64_t z = blockIdx.z;
  A += z * static_cast<int64_t>(M) * K;
  B += z * static_cast<int64_t>(K) * N;
  C += z * static_cast<int64_t>(M) * N;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;       // mma groupID, thread-in-group
  const int wm = (warp / 4) * kWarpM, wn = (warp % 4) * kWarpN;

  epi.stage(epi_tile, z, n0, N);

  int32_t acc[kMi][kNi][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: kBM rows x kBK bytes = 512 chunks of 16 bytes, 2 a thread
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads;
      const int r = chunk / (kBK / 16), kk = (chunk % (kBK / 16)) * 16;
      const uint4 v = load16(A, m0 + r, M, k0 + kk, K, K, vec_a);
      *reinterpret_cast<uint4*>(&As[r * kLd + kk]) = v;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads;
      if constexpr (kBKMajor) {
        // B tile: kBN rows of Bt x kBK bytes, copied as they are
        const int r = chunk / (kBK / 16), kk = (chunk % (kBK / 16)) * 16;
        const uint4 v = load16(B, n0 + r, N, k0 + kk, K, K, vec_b);
        *reinterpret_cast<uint4*>(&Bs[r * kLd + kk]) = v;
      } else {
        // B tile: kBK rows x kBN bytes, stored transposed
        const int kr = chunk / (kBN / 16), nn = (chunk % (kBN / 16)) * 16;
        const uint4 v = load16(B, k0 + kr, K, n0 + nn, N, N, vec_b);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          Bs[(nn + j) * kLd + kr] =
              static_cast<int8_t>((w[j / 4] >> (8 * (j % 4))) & 0xffu);
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[kMi][4];
      uint32_t bf[kNi][2];
#pragma unroll
      for (int i = 0; i < kMi; ++i) {
        const int8_t* p = &As[(wm + i * 16 + g) * kLd + ks + t * 4];
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const int8_t* p = &Bs[(wn + j * 8 + g) * kLd + ks + t * 4];
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNi; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // accumulator r of tile (i, j): row g (+8 for r >= 2), col 2t + (r & 1)
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = wn + j * 8 + 2 * t + (r & 1);
        if (row < M && n0 + col < N)
          C[static_cast<int64_t>(row) * N + n0 + col] =
              static_cast<typename Epi::Out>(
                  epi.apply(acc[i][j][r], col, epi_tile));
      }
}

// Launch one product per batch entry (gridDim.z), B row-major [K, N] or
// with kBKMajor K-major [N, K]; returns cudaGetLastError() after the
// launch.
template <class Epi, bool kBKMajor = false>
int launch(const void* a, const void* b, void* c, int batch, int M, int N,
           int K, Epi epi, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_a = K % 16 == 0 && aligned(a);
  const bool vec_b = (kBKMajor ? K : N) % 16 == 0 && aligned(b);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  gemm_kernel<Epi, kBKMajor>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<typename Epi::Out*>(c), M, N, K, vec_a, vec_b, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8gemm
