// Hopper int8 x int8 -> int32 GEMM main loops: wgmma fed by a TMA ring,
// on two schedules.  Shared by q7_matmul.cu, w8a8_matmul.cu and
// w8a8_dense.cu and templated on the same epilogue functors as
// i8_gemm.cuh, the mma.sync loop that keeps the shapes TMA cannot
// describe; the functor's `Out` is the output element type (int8, or
// bfloat16/float32 for w8a8_dense).
//
// Replaces, with i8_gemm.cuh, the main loop of two Pallas TPU kernels:
// src/repro/kernels/q7_matmul.py, q7_matmul_pallas (body
// _q7_matmul_kernel), and src/repro/kernels/w8a8_matmul.py,
// w8a8_matmul_pallas (body _w8a8_kernel).
//
// Bound on the H100: 2*M*K*N int8 operations at 1,979 TOP/s against
// M*K + K*N + M*N bytes at 3.35 TB/s.  Large square products are bound
// by operations (4096^3: 0.0694 ms), which only wgmma reaches; thin ones
// (small M, long K or wide N: an LM's decode step) by the bytes of B,
// which only every SM streaming at once can move.
//
// Design:
//   * Operands.  wgmma takes .s8 operands K-major only (its transpose
//     flags are for 16-bit types), so A [batch, M, K] is read as it is
//     and B as Bt [batch, N, K]: w8a8_dense's weights are stored so, and
//     q7_matmul's and w8a8_matmul's B [batch, K, N] first goes through
//     transpose_kernel into a scratch the wrapper allocates.
//   * Copies.  TMA keeps a ring of stages of (A tile rows x kBK, B tile
//     BN x kBK) in flight with 3-D loads (batch, rows, K) in the 128-byte
//     swizzle, each kBK = 128 bytes of K wide; "full" mbarriers count the
//     bytes in, "empty" mbarriers count the consumer warps out.  TMA
//     fills rows and K beyond the operands with zeros, which is exact in
//     integer arithmetic, so M below wgmma's 64 rows and a ragged last K
//     block need no masking.
//   * Products.  wgmma.mma_async m64n128k32 .s32.s8.s8 (BN / 128 of them
//     per 32 bytes of K and 64 rows) with int32 accumulators in
//     registers, WITHOUT .satfinite: XLA's int32 dot wraps on overflow,
//     and so does this sum.  One wgmma group stays in flight while the
//     stage of the one before is handed back.
//   * Tiles (M > 64; wgmma_gemm_kernel): a block per kBM = 128-row tile
//     and, when the output has fewer tiles than the card has SMs and K is
//     long, per K part (`split` > 1, each a contiguous run of K blocks).
//     A producer warpgroup's one thread issues the copies; two consumer
//     warpgroups each own 64 rows.  The parts write int32 partial sums
//     into a workspace [batch, split, M, N], and splitk_reduce_kernel
//     adds them and runs the epilogue once per output.
//   * Stream-K (M <= 64; wgmma_streamk_kernel): the product is bound by
//     the bytes of B, so no shared memory goes to padding rows of A and
//     no SM idles in a tail wave.  Tiles are kSkBM = 64 rows (one wgmma)
//     x 128, and one warpgroup both issues the copies (thread 0) and
//     multiplies: a stage is 24 KB, so kSkStages = 8 of them keep 128 KB
//     of B in flight per SM.  A persistent grid of `ctas` blocks (one
//     per SM) cuts the tiles x K blocks iterations into equal contiguous
//     shares; a block walks its share tile by tile, K block by K block,
//     the ring running on across tile boundaries.  A tile whose K blocks
//     all lie in one share is stored by its block; the blocks of a tile
//     cut between shares each add their int32 partial sums into the
//     tile's sum tile in the workspace (reductions, no return) and count
//     themselves in on its arrival count (both zeroed by the launch), and
//     the last to arrive reads the sum back and stores the tile.  No block
//     waits for another.
//   * Sums.  The partials of both schedules are added as uint32, i.e.
//     modulo 2^32, like the wrapping accumulators: integer addition
//     modulo 2^32 is associative and commutative, so neither the cut of
//     K nor the order of the partials can change a bit of the result.
//   * Epilogue.  The functor maps each accumulator to its output in
//     registers; rows and columns beyond the output are not stored.
#pragma once

#include <cuda.h>            // CUtensorMap and the driver's enums (types only)
#include <cuda_runtime.h>

#include <cstdint>

namespace i8sm90 {

constexpr int kBM = 128;               // rows of an output tile
constexpr int kBK = 128;               // K bytes per stage: one swizzle row
constexpr int kWgRows = 64;            // rows of one wgmma
constexpr int kConsumers = kBM / kWgRows;           // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);    // + the producer's

// stages of the ring for an output tile BN wide: 6 x 32 KB or 4 x 48 KB
template <int BN>
__host__ __device__ constexpr int stages() { return BN == 128 ? 6 : 4; }
template <int BN>
__host__ __device__ constexpr int stage_bytes() { return (kBM + BN) * kBK; }
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return stages<BN>() * stage_bytes<BN>() + 1024;   // + alignment slack
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
// A wait is a few copies long; one that outlasts 2^26 tries (far beyond
// a second) is a fault of the ring, and traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// box (kBK bytes of K, rows, 1) at (k, row, z) of a 3-D tensor map into
// shared memory, counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row,
                                         int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row),
      "r"(z)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for this layout.  The tile starts 1024-byte
// aligned, so 32 bytes further along K is 2 more in the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// two neighbouring output elements in one aligned store (p's element
// index even, N even, C aligned to 2 * sizeof(T))
template <class T>
struct alignas(2 * sizeof(T)) Pair {
  T lo, hi;
};

template <class T>
__device__ __forceinline__ void store_pair(T* p, T lo, T hi) {
  *reinterpret_cast<Pair<T>*>(p) = Pair<T>{lo, hi};
}

__device__ __forceinline__ void store_pair(int8_t* p, int8_t lo, int8_t hi) {
  *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(
      static_cast<uint8_t>(lo) |
      (static_cast<uint16_t>(static_cast<uint8_t>(hi)) << 8));
}

// keeps the compiler from moving accumulator registers across an
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64x128] += A[64x32] . B[128x32]^T, int32 accumulators, wrapping
__device__ __forceinline__ void wgmma_m64n128k32(int32_t (&d)[64],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// One warp's share of a 64 x 128 tile of stream-K sums, epilogue applied,
// into C [batch, M, N]: sum 4j + r sits at row row0 (+8 for r >= 2) and
// column 8j + 2 (lane % 4) + (r & 1) of the tile that starts at column
// n0.  Rows and columns beyond the output are not stored.
template <class Epi>
__device__ __forceinline__ void store_block(
    const int32_t (&acc)[64], typename Epi::Out* __restrict__ C, int64_t z,
    int M, int N, int row0, int n0, int lane, const Epi& epi,
    const int32_t* epi_tile) {
  using Out = typename Epi::Out;
  const bool pairs = N % 2 == 0;   // two outputs in one aligned store
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      const int col = 8 * j + 2 * (lane % 4);   // in the tile
      const int n = n0 + col;
      if (row >= M || n >= N) continue;
      Out* p = C + (z * M + row) * static_cast<int64_t>(N) + n;
      const Out c0 = static_cast<Out>(
          epi.apply(acc[4 * j + 2 * half], col, epi_tile));
      if (n + 1 < N) {
        const Out c1 = static_cast<Out>(
            epi.apply(acc[4 * j + 2 * half + 1], col + 1, epi_tile));
        if (pairs) {
          store_pair(p, c0, c1);
          continue;
        }
        p[1] = c1;
      }
      p[0] = c0;
    }
}

// Bt[z, n, k] = B[z, k, n] for B [batch, K, N] at any alignment, one
// TK x TN tile (TK * TN = 4096 bytes) a block: read a 4-byte word a load
// where B's rows allow it (`vec`: N % 4 == 0, B 4-byte aligned), a byte
// a load elsewhere; Bt's rows are stored a word at a time, so K % 4 == 0
// (the wgmma route has K % 16 == 0) and Bt is 4-byte aligned.  Grid (K
// tiles, N tiles, batch); a narrow N takes a tall tile (TN = 8 for N <= 8)
// so that a block still moves 4 KB.
template <int TK, int TN>
__global__ void __launch_bounds__(256)
    transpose_kernel(const int8_t* __restrict__ B, int8_t* __restrict__ Bt,
                     int K, int N, bool vec) {
  static_assert(TK * TN == 4096, "a tile is 16 bytes a thread");
  __shared__ __align__(4) int8_t tile[TN][TK + 4];   // [n][k], padded
  const int64_t z = blockIdx.z;
  const int k0 = blockIdx.x * TK, n0 = blockIdx.y * TN;
  B += z * K * static_cast<int64_t>(N);
  Bt += z * K * static_cast<int64_t>(N);
  if (vec) {
#pragma unroll
    for (int i = 0; i < TK * TN / 4 / 256; ++i) {
      const int idx = i * 256 + threadIdx.x;
      const int r = idx / (TN / 4), c = 4 * (idx % (TN / 4));
      uint32_t w = 0;
      if (k0 + r < K && n0 + c < N)
        w = *reinterpret_cast<const uint32_t*>(
            &B[static_cast<int64_t>(k0 + r) * N + n0 + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tile[c + j][r] = static_cast<int8_t>((w >> (8 * j)) & 0xffu);
    }
  } else {
#pragma unroll
    for (int i = 0; i < TK * TN / 256; ++i) {
      const int idx = i * 256 + threadIdx.x;
      const int r = idx / TN, c = idx % TN;   // a warp: whole rows of TN
      tile[c][r] = k0 + r < K && n0 + c < N
                       ? B[static_cast<int64_t>(k0 + r) * N + n0 + c]
                       : int8_t{0};
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TK * TN / 4 / 256; ++i) {
    const int idx = i * 256 + threadIdx.x;
    const int c = idx / (TK / 4), w = idx % (TK / 4);
    if (n0 + c < N && k0 + 4 * w < K)
      *reinterpret_cast<uint32_t*>(
          &Bt[static_cast<int64_t>(n0 + c) * K + k0 + 4 * w]) =
          *reinterpret_cast<const uint32_t*>(&tile[c][4 * w]);
  }
}

// One (kBM x BN) output tile, or with split > 1 one K part of it, per
// block; grid (N tiles, M tiles, batch * split).  `work` is null for
// split == 1 (the epilogue writes C) and the [batch, split, M, N] int32
// partials otherwise.
template <int BN, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      typename Epi::Out* __restrict__ C,
                      int32_t* __restrict__ work,
                      int M, int N, int K, int split, Epi epi) {
  constexpr int kNB = BN / 128;                 // m64n128 wgmmas per k32
  constexpr int kStages = stages<BN>();
  constexpr uint32_t kStage = stage_bytes<BN>();
  using Out = typename Epi::Out;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ int32_t epi_tile[BN];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int z = blockIdx.z / split, part = blockIdx.z % split;
  const int kblocks = (K + kBK - 1) / kBK;
  const int kb0 = static_cast<int>(static_cast<int64_t>(part) * kblocks /
                                   split);
  const int kb1 = static_cast<int>(static_cast<int64_t>(part + 1) *
                                   kblocks / split);
  // stage s: A tile at ring + s * kStage, B tile kBM * kBK further; the
  // 128-byte swizzle wants each tile 1024-byte aligned
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  if (split == 1)
#pragma unroll
    for (int h = 0; h < kNB; ++h)
      epi.stage(epi_tile + 128 * h, z, n0 + 128 * h, N);   // all threads
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumers * 4);   // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so that the compiler sees it is
  // uniform: wgmma issued on a path it takes for divergent is
  // serialised (ptxas C7518)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // producer: one thread issues every copy
    if (threadIdx.x == kConsumers * 128) {
      for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        mbar_wait(smem_u32(&empty_bar[s]), phase ^ 1);
        const uint32_t full = smem_u32(&full_bar[s]);
        mbar_expect_tx(full, kStage);
        tma_load(ring + s * kStage, &tma_a, full, kb * kBK, m0, z);
        tma_load(ring + s * kStage + kBM * kBK, &tma_b, full, kb * kBK, n0,
                 z);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64);
    // rows beyond M are zeros from TMA and are multiplied all the same
    // (a branch around the wgmmas makes ptxas serialise them, C7515)
    int32_t acc[kNB][64];
#pragma unroll
    for (int h = 0; h < kNB; ++h)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[h][r] = 0;
    const int lane = threadIdx.x % 32;
    for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
      const int s = i % kStages;
      mbar_wait(smem_u32(&full_bar[s]), (i / kStages) & 1);
      const uint32_t a = ring + s * kStage + wg * kWgRows * kBK;
      const uint32_t b = ring + s * kStage + kBM * kBK;
#pragma unroll
      for (int h = 0; h < kNB; ++h) fence_acc(acc[h]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
        for (int h = 0; h < kNB; ++h)
          wgmma_m64n128k32(acc[h], sw128_desc(a + 32 * kk),
                           sw128_desc(b + h * 128 * kBK + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the group before this one is done: its stage goes back
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int h = 0; h < kNB; ++h) fence_acc(acc[h]);
      if (i > 0 && lane == 0)
        mbar_arrive(smem_u32(&empty_bar[(i - 1) % kStages]));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < kNB; ++h) fence_acc(acc[h]);

    // accumulator 4j + r of acc[h]: row 16 warp + lane/4 (+8 for r >= 2),
    // column 128 h + 8 j + 2 (lane % 4) + (r & 1)
    const int warp = (threadIdx.x % 128) / 32;
    const int row0 = m0 + kWgRows * wg + 16 * warp + lane / 4;
    const bool pairs = N % 2 == 0;   // two outputs in one aligned store
#pragma unroll
    for (int h = 0; h < kNB; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half;
          const int col = 128 * h + 8 * j + 2 * (lane % 4);   // in the tile
          const int n = n0 + col;
          if (row >= M || n >= N) continue;
          const int32_t v0 = acc[h][4 * j + 2 * half];
          const int32_t v1 = acc[h][4 * j + 2 * half + 1];
          if (work != nullptr) {
            int32_t* p = work + ((static_cast<int64_t>(z) * split + part) *
                                     M + row) * N + n;
            p[0] = v0;
            if (n + 1 < N) p[1] = v1;
            continue;
          }
          Out* p = C + (static_cast<int64_t>(z) * M + row) * N + n;
          const Out c0 = static_cast<Out>(epi.apply(v0, col, epi_tile));
          if (n + 1 < N) {
            const Out c1 = static_cast<Out>(epi.apply(v1, col + 1, epi_tile));
            if (pairs) {
              store_pair(p, c0, c1);
              continue;
            }
            p[1] = c1;
          }
          p[0] = c0;
        }
  }
}

// C[z] = epilogue(sum over p of work[z, p]), the sum modulo 2^32.  A
// block of 8 warps covers 32 columns (a lane each) of 8 / group rows:
// the `group` warps of a row take every group-th partial, four loads in
// flight each, and the first of them adds the group's sums and runs the
// epilogue.  Grid (N / 32 strips, M / (8 / group) rows, batch); the host
// picks group from split (1 for a few partials, 8 for a hundred).
template <class Epi>
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const int32_t* __restrict__ work,
                         typename Epi::Out* __restrict__ C, int M, int N,
                         int split, int group, Epi epi) {
  __shared__ int32_t epi_tile[128];
  __shared__ uint32_t sums[8][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * 32 / 128 * 128;  // the epilogue's 128 columns
  const int n = blockIdx.x * 32 + lane;
  const int row = blockIdx.y * (8 / group) + warp / group;
  const int g = warp % group;
  const int64_t z = blockIdx.z;
  const int64_t plane = static_cast<int64_t>(M) * N;
  epi.stage(epi_tile, z, t0, N);                // all threads
  uint32_t s[4] = {0u, 0u, 0u, 0u};
  if (row < M && n < N) {
    const int32_t* p = work + z * split * plane +
                       static_cast<int64_t>(row) * N + n;
    for (int q = g; q < split; q += 4 * group)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q + u * group < split)
          s[u] += static_cast<uint32_t>(p[(q + u * group) * plane]);
  }
  sums[warp][lane] = s[0] + s[1] + s[2] + s[3];
  __syncthreads();
  if (g != 0 || row >= M || n >= N) return;
  uint32_t sum = 0;
  for (int i = 0; i < group; ++i) sum += sums[warp + i][lane];
  C[z * plane + static_cast<int64_t>(row) * N + n] =
      static_cast<typename Epi::Out>(
          epi.apply(static_cast<int32_t>(sum), n - t0, epi_tile));
}

// ---------------------------------------------------------------------------
// stream-K, for M <= 64
// ---------------------------------------------------------------------------
constexpr int kSkBM = kWgRows;         // rows of a stream-K tile
constexpr int kSkBN = 128;             // columns of a stream-K tile
constexpr int kSkStages = 8;           // 8 x 24 KB
constexpr int kSkThreads = 128;        // one warpgroup
constexpr int kSkStage = (kSkBM + kSkBN) * kBK;
constexpr int kSkSmem = kSkStages * kSkStage + 1024;   // + alignment slack

// first iteration of block c's share of `iters` over `ctas` blocks
__device__ __forceinline__ int64_t sk_begin(int c, int64_t iters,
                                            int ctas) {
  return c * iters / ctas;
}

// the block whose share holds iteration i: the last c with sk_begin <= i
__device__ __forceinline__ int sk_owner(int64_t i, int64_t iters, int ctas) {
  return static_cast<int>(((i + 1) * ctas - 1) / iters);
}

// TMA loads of K block kb of tile t into stage s of the ring, counted in
// bytes on its full barrier
__device__ __forceinline__ void sk_load(const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        uint32_t ring, uint64_t* full_bar,
                                        int s, int t, int kb, int m_tiles,
                                        int n_tiles) {
  const int z = t / (m_tiles * n_tiles), mn = t % (m_tiles * n_tiles);
  const uint32_t full = smem_u32(&full_bar[s]);
  mbar_expect_tx(full, kSkStage);
  tma_load(ring + s * kSkStage, map_a, full, kb * kBK, mn / n_tiles * kSkBM,
           z);
  tma_load(ring + s * kSkStage + kSkBM * kBK, map_b, full, kb * kBK,
           mn % n_tiles * kSkBN, z);
}

// Block `blockIdx.x` of `gridDim.x` walks iterations [sk_begin(c),
// sk_begin(c + 1)) of the tiles x kblocks iterations, iteration i being K
// block i % kblocks of tile i / kblocks, tile t = (z * m_tiles + mt) *
// n_tiles + nt.  A tile cut between blocks is indexed by its first owner
// (each block is the first owner of at most one cut tile: the one its
// share ends inside, or begins at and ends inside): `work` holds an
// arrival count a block (int32 [ctas]) and then a sum tile a block
// ([ctas][rows][128], rows = min(M, 64)), all zero at launch.  Each owner
// adds its partial sums into the tile's sum with reductions (red.add,
// modulo 2^32: exact in any order), then arrives; the last to arrive
// reads the whole sum back and stores the tile.
template <class Epi>
__global__ void __launch_bounds__(kSkThreads, 1)
    wgmma_streamk_kernel(const __grid_constant__ CUtensorMap tma_a,
                         const __grid_constant__ CUtensorMap tma_b,
                         typename Epi::Out* __restrict__ C,
                         int32_t* __restrict__ work, int batch, int M, int N,
                         int K, Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kSkStages];
  __shared__ int32_t epi_tile[kSkBN];

  const int kblocks = (K + kBK - 1) / kBK;
  const int m_tiles = (M + kSkBM - 1) / kSkBM;
  const int n_tiles = (N + kSkBN - 1) / kSkBN;
  const int64_t iters = static_cast<int64_t>(batch) * m_tiles * n_tiles *
                        kblocks;
  const int ctas = gridDim.x, cta = blockIdx.x;
  const int64_t begin = sk_begin(cta, iters, ctas);
  const int count = static_cast<int>(sk_begin(cta + 1, iters, ctas) - begin);
  const int rows = min(M, kSkBM);           // of a sum tile
  int32_t* counts = work;
  int32_t* sums = work + ctas;
  // stage s: A tile at ring + s * kSkStage, B tile kSkBM * kBK further,
  // each 1024-byte aligned for the 128-byte swizzle
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // the consumers' (tile, K block), and the producer's, kSkStages - 1 ahead
  int t = static_cast<int>(begin / kblocks);
  int kb = static_cast<int>(begin % kblocks);
  int lt = t, lkb = kb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSkStages; ++s) mbar_init(smem_u32(&full_bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int li = 0; li < kSkStages && li < count; ++li) {
      sk_load(&tma_a, &tma_b, ring, full_bar, li, lt, lkb, m_tiles, n_tiles);
      if (++lkb == kblocks) lkb = 0, ++lt;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_in_tile = 16 * warp + lane / 4;   // (+8 for r >= 2)
  int32_t acc[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0;
  for (int li = 0; li < count; ++li) {
    const int s = li % kSkStages;
    mbar_wait(smem_u32(&full_bar[s]), (li / kSkStages) & 1);
    const uint32_t a = ring + s * kSkStage;
    const uint32_t b = a + kSkBM * kBK;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_m64n128k32(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the group before this one is done in every warp once all are past
    // the barrier: its stage takes the load of iteration li - 1 +
    // kSkStages (a barrier, not an mbarrier thread 0 spins on: a wait
    // loop on a divergent path serialises the wgmmas, ptxas C7518)
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    __syncthreads();
    if (threadIdx.x == 0 && li > 0 && li - 1 + kSkStages < count) {
      sk_load(&tma_a, &tma_b, ring, full_bar, (li - 1) % kSkStages, lt, lkb,
              m_tiles, n_tiles);
      if (++lkb == kblocks) lkb = 0, ++lt;
    }

    const bool tile_end = kb == kblocks - 1;
    const int tile = t;
    if (++kb == kblocks) kb = 0, ++t;
    if (!tile_end && li != count - 1) continue;
    // the share leaves the tile here: its sums leave the accumulators,
    // then the tile is stored, or its partial sums added to the tile's sum
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    int32_t out[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      out[r] = acc[r];
      acc[r] = 0;
    }
    const int64_t t0 = static_cast<int64_t>(tile) * kblocks;
    const int z = tile / (m_tiles * n_tiles);
    const int mn = tile % (m_tiles * n_tiles);
    const int m0 = mn / n_tiles * kSkBM, n0 = mn % n_tiles * kSkBN;
    int last_in = 1;          // a block stores the tiles it holds whole
    if (t0 < begin || !tile_end) {
      // a tile cut between shares: add to its sum tile, arrive; the last
      // block in stores the sum
      const int first = sk_owner(t0, iters, ctas);
      const int owners = sk_owner(t0 + kblocks - 1, iters, ctas) - first + 1;
      int32_t* sum = sums + static_cast<int64_t>(first) * rows * kSkBN;
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const int row = row_in_tile + 8 * ((r >> 1) & 1);
        const int col = 8 * (r / 4) + 2 * (lane % 4) + (r & 1);
        if (m0 + row < M && n0 + col < N)
          atomicAdd(reinterpret_cast<uint32_t*>(sum + row * kSkBN + col),
                    static_cast<uint32_t>(out[r]));
      }
      __syncthreads();        // every thread's additions, then one fence
      last_in = 0;
      if (threadIdx.x == 0) {
        __threadfence();
        last_in = atomicAdd(&counts[first], 1) == owners - 1;
      }
      last_in = __syncthreads_or(last_in);
      __threadfence();
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const int row = row_in_tile + 8 * ((r >> 1) & 1);
        const int col = 8 * (r / 4) + 2 * (lane % 4) + (r & 1);
        if (last_in && m0 + row < M && n0 + col < N)
          out[r] = __ldcg(sum + row * kSkBN + col);
      }
    }
    __syncthreads();          // the last tile's epilogue is done with epi_tile
    epi.stage(epi_tile, z, n0, N);                // all threads
    // a block that is not the last in stores nothing: its rows start at M
    // (predicated, not branched around: a branch back to the wgmmas on a
    // path ptxas cannot prove uniform serialises them, C7518)
    store_block(out, C, z, M, N, last_in ? m0 + row_in_tile : M, n0, lane,
                epi, epi_tile);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// that the library need not link libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 3-D map of an int8 [depth, rows, K] tensor, boxes of kBK x box_rows x 1
// in the 128-byte swizzle, zeros outside the tensor
inline bool make_map(CUtensorMap* map, const void* base, int depth, int rows,
                     int K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K),
                                 static_cast<cuuint64_t>(K) * rows};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TK, int TN>
int launch_transpose_tile(const void* b, void* bt, int batch, int K, int N,
                          cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  const dim3 grid((K + TK - 1) / TK, (N + TN - 1) / TN, batch);
  transpose_kernel<TK, TN><<<grid, 256, 0, stream>>>(
      static_cast<const int8_t*>(b), static_cast<int8_t*>(bt), K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

// Bt [batch, N, K] = B [batch, K, N] transposed; returns
// cudaGetLastError() after the launch.
inline int launch_transpose(const void* b, void* bt, int batch, int K, int N,
                            void* stream) {
  if (batch <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (N <= 8) return launch_transpose_tile<512, 8>(b, bt, batch, K, N, s);
  if (N <= 16) return launch_transpose_tile<256, 16>(b, bt, batch, K, N, s);
  if (N <= 32) return launch_transpose_tile<128, 32>(b, bt, batch, K, N, s);
  return launch_transpose_tile<64, 64>(b, bt, batch, K, N, s);
}

template <int BN, class Epi>
int launch_product_bn(const void* a, const void* bt, void* c, void* work,
                      int batch, int M, int N, int K, int split, Epi epi,
                      cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, batch, M, K, kBM) ||
      !make_map(&map_b, bt, batch, N, K, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_gemm_kernel<BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<BN>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM, batch * split);
  wgmma_gemm_kernel<BN, Epi><<<grid, kThreads, smem_bytes<BN>(), stream>>>(
      map_a, map_b, static_cast<typename Epi::Out*>(c),
      static_cast<int32_t*>(work), M, N, K, split, epi);
  return static_cast<int>(cudaGetLastError());
}

// The product over A [batch, M, K] and Bt [batch, N, K] (both 16-byte
// aligned, K % 16 == 0) on tiles kBM x bn (bn 128 or 256): C when split
// == 1, else the int32 partials in work [batch, split, M, N].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// it does not take.
template <class Epi>
int launch_product(const void* a, const void* bt, void* c, void* work,
                   int batch, int M, int N, int K, int bn, int split, Epi epi,
                   void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      split < 1 || (split > 1) != (work != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bn == 128)
    return launch_product_bn<128>(a, bt, c, work, batch, M, N, K, split, epi,
                                  s);
  if (bn == 256)
    return launch_product_bn<256>(a, bt, c, work, batch, M, N, K, split, epi,
                                  s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The stream-K product over A [batch, M, K] and Bt [batch, N, K] (both
// 16-byte aligned, K % 16 == 0) on `ctas` persistent blocks, into C; work
// holds ctas * (1 + min(M, 64) * 128) int32, zeroed here on the stream.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for what it does not take.
template <class Epi>
int launch_streamk(const void* a, const void* bt, void* c, void* work,
                   int batch, int M, int N, int K, int ctas, Epi epi,
                   void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      ctas < 1 || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t iters = static_cast<int64_t>(batch) *
                        ((M + kSkBM - 1) / kSkBM) *
                        ((N + kSkBN - 1) / kSkBN) * ((K + kBK - 1) / kBK);
  if (ctas > iters || iters > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, batch, M, K, kSkBM) ||
      !make_map(&map_b, bt, batch, N, K, kSkBN))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_streamk_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSkSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t ints = static_cast<size_t>(ctas) *
                      (1 + static_cast<size_t>(M < kSkBM ? M : kSkBM) *
                               kSkBN);
  const cudaError_t zero = cudaMemsetAsync(work, 0, ints * sizeof(int32_t),
                                           s);
  if (zero != cudaSuccess) return static_cast<int>(zero);
  wgmma_streamk_kernel<Epi><<<ctas, kSkThreads, kSkSmem, s>>>(
      map_a, map_b, static_cast<typename Epi::Out*>(c),
      static_cast<int32_t*>(work), batch, M, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

// C = epilogue(sum of the split partials in work); returns
// cudaGetLastError() after the launch.
template <class Epi>
int launch_reduce(const void* work, void* c, int batch, int M, int N,
                  int split, Epi epi, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int group = 1;                 // warps a row: each walks ~4 or more partials
  while (group < 8 && 4 * group < split) group *= 2;
  const dim3 grid((N + 31) / 32, (M + 8 / group - 1) / (8 / group), batch);
  splitk_reduce_kernel<Epi><<<grid, 256, 0, static_cast<cudaStream_t>(
                                                stream)>>>(
      static_cast<const int32_t*>(work), static_cast<typename Epi::Out*>(c),
      M, N, split, group, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8sm90
