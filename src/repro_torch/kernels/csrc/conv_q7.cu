// Int8 NHWC convolution, VALID padding, with the bias, requantisation,
// saturation and an optional relu in its epilogue: one implicit GEMM
//
//   out[m, n] = relu?(sat8(shift(sum_k patch[m, k] * w[k, n] + bias'[n])))
//
// over M = B*OH*OW output pixels, N = Cout and K = KH*KW*Cin, where
// patch[m, :] is output pixel m's receptive field in (kh, kw, ci) order
// and w is the HWIO weight tensor read as it lies, [K, Cout] row-major.
//
// Replaces no TPU kernel: the reference computes these convs with XLA's
// int32 conv (src/repro/quant/int8_ops.py, conv2d_q7 and
// conv2d_q7_per_channel), not with Pallas.  It was added because the
// port's plain version (float64 im2col with one F.unfold launch an image,
// a float64 product and a dozen elementwise casts, shifts and clamps)
// held ~90% of the CapsNet serving path's device time and most of its
// host time inside a wave.
//
// Bit-exact with repro_torch.quant.int8_ops.conv2d_q7 and
// conv2d_q7_per_channel: the products are summed in int32 with wrap
// (mma.sync without .satfinite; integer adds are exact modulo 2^32, so
// the order of the K sum cannot change the result), the bias is shifted
// into the accumulator and added with wrap, then q7::rshift_sat8 (the
// half-LSB for nearest, the arithmetic shift, saturation), then the
// relu.  Shift amounts outside [0, 31] follow q7.cuh (left gives 0,
// right the sign fill), which is what torch's << and >> and its
// wrapping scalar add give both faces; the wrapper clamps every shift
// to [-64, 64], which changes none of these results, and the entry
// refuses a shift that does not fit its int8 tables.
//
// Bound on the H100: at the paper's shapes a conv moves 0.3-3 MB (input
// read once, output written once) and does 0.1-3.3 G int8 operations a
// B=256 wave, so both bounds are 0.1-2 us; what costs is the gather of
// the overlapping patch rows (each input byte is read KH*KW/stride^2
// times, from L1/L2) and, at small M, too few blocks.
//
// Design:
//   * a block of 4 warps owns BM output pixels x BN output channels
//     (BN = 16, 32 or 64 covers Cout up to 64 in one column of blocks);
//     the wrapper (kernels/conv.py, conv_plan) picks BM, the largest of
//     128/64/32/16 that still gives every SM a block, from M;
//   * the weights' [K_pad, BN] slab (K padded with zeros to a multiple of
//     32, which is exact) is staged once in shared memory, transposed to
//     [n][k] so that each thread's mma B fragment is 4 consecutive k
//     bytes; with the rest of the block's shared memory it lies in
//     dynamic shared memory (MNIST's primary capsules: 64 x 816 bytes);
//   * im2col in shared memory: the block gathers its pixels' patch rows,
//     kBK = 128 k at a time, through two tables built once per block (the
//     offset of each k inside a receptive field, the first byte of each
//     pixel's field, -1 for padding), 16 bytes a load where Cin % 16 == 0,
//     4 where Cin % 4 == 0, one byte otherwise; nothing goes through
//     device memory;
//   * products: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, int32
//     accumulators in registers;
//   * epilogue: each column's shifted bias and output shift from shared
//     memory, the int8 tile written back through shared memory and stored
//     16 bytes a thread where Cout % 16 == 0.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "q7.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 128;             // k of the patch rows staged at a time
constexpr int kLdA = kBK + 16;       // padded shared row, bytes: the 8 rows x
                                     // 4 words of a fragment load fall in
                                     // 32 distinct banks
constexpr int kMaxCout = 1024;
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;      // cards whose opt-in is remembered

struct ConvArgs {
  const int8_t* x;                   // [B, H, W, Cin]
  const int8_t* w;                   // [KH, KW, Cin, Cout] = [K, Cout]
  const int8_t* bias;                // [Cout], or null
  int8_t* out;                       // [B, OH, OW, Cout] = [M, Cout]
  int H, W, Cin, KW, Cout, stride, OH, OW, M, K, K_pad;
  int vec;                           // bytes a gather load: 16, 4 or 1
  int out_vec;                       // 1: 16-byte stores of the tile
  int nearest, relu;
  int8_t out_shift[kMaxCout];        // per channel
  int8_t bias_shift[kMaxCout];
};

__host__ __device__ constexpr int warps_m(int bm) {
  return bm / 16 < kWarps ? bm / 16 : kWarps;
}

__host__ __device__ inline size_t smem_bytes(int bm, int bn, int k_pad) {
  return static_cast<size_t>(bn) * (k_pad + 16) +
         static_cast<size_t>(bm) * kLdA +
         4 * static_cast<size_t>(k_pad + bm + 2 * bn);
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 patch bytes of the pixel whose field starts at x + base, at the k
// whose offsets koff[0..16) give (-1: padding, read as 0).
__device__ __forceinline__ uint4 gather16(const ConvArgs& a, int base,
                                          const int32_t* koff) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (base < 0) return make_uint4(0u, 0u, 0u, 0u);
  if (a.vec == 16) {
    const int off = koff[0];
    if (off >= 0)
      return __ldg(reinterpret_cast<const uint4*>(a.x + base + off));
  } else if (a.vec == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int off = koff[4 * j];
      if (off >= 0)
        w[j] = __ldg(reinterpret_cast<const uint32_t*>(a.x + base + off));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int off = koff[j];
      if (off >= 0)
        w[j / 4] |= static_cast<uint32_t>(
                        static_cast<uint8_t>(__ldg(a.x + base + off)))
                    << (8 * (j % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_q7_kernel(const __grid_constant__ ConvArgs a) {
  constexpr int WM = warps_m(BM);            // warps along the pixels
  constexpr int WN = kWarps / WM;            // warps along the channels
  constexpr int MI = BM / WM / 16;           // m16 tiles a warp
  constexpr int NI = BN / WN / 8;            // n8 tiles a warp
  static_assert(MI >= 1 && NI >= 1, "tile too small for four warps");

  extern __shared__ __align__(16) int8_t smem[];
  const int ldb = a.K_pad + 16;
  int8_t* Bs = smem;                                         // [BN][ldb]
  int8_t* As = Bs + BN * ldb;                                // [BM][kLdA]
  int32_t* koff = reinterpret_cast<int32_t*>(As + BM * kLdA);  // [K_pad]
  int32_t* rowbase = koff + a.K_pad;                         // [BM]
  int32_t* ebias = rowbase + BM;                             // [BN]
  int32_t* eshift = ebias + BN;                              // [BN]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // k = (kh * KW + kw) * Cin + ci lies kh * W * Cin + kw * Cin + ci bytes
  // into a pixel's receptive field
  const int kwc = a.KW * a.Cin;
  const int wc = a.W * a.Cin;
  for (int k = tid; k < a.K_pad; k += kThreads)
    koff[k] = k < a.K ? (k / kwc) * wc + k % kwc : -1;
  for (int r = tid; r < BM; r += kThreads) {
    const int m = m0 + r;
    int base = -1;
    if (m < a.M) {
      const int P = a.OH * a.OW;
      const int b = m / P, p = m % P;
      const int oh = p / a.OW, ow = p % a.OW;
      base = ((b * a.H + oh * a.stride) * a.W + ow * a.stride) * a.Cin;
    }
    rowbase[r] = base;
  }
  for (int c = tid; c < BN; c += kThreads) {
    const int n = n0 + c;
    int32_t bt = 0, sh = 0;
    if (n < a.Cout) {
      if (a.bias != nullptr) {
        const int32_t b = a.bias[n];
        const int bs = a.bias_shift[n];
        bt = bs >= 0 ? q7::shl(b, bs) : q7::sar(b, -bs);
      }
      sh = a.out_shift[n];
    }
    ebias[c] = bt;
    eshift[c] = sh;
  }
  // the weight slab, transposed: word (c, k/4) holds w[k..k+4, n0 + c]
  const int words = BN * (a.K_pad / 4);
  for (int u = tid; u < words; u += kThreads) {
    const int c = u % BN, k = (u / BN) * 4;
    const int n = n0 + c;
    uint32_t word = 0u;
    if (n < a.Cout) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < a.K)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(
                      __ldg(a.w + static_cast<int64_t>(k + j) * a.Cout + n)))
                  << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(Bs + c * ldb + k) = word;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;      // mma groupID, thread-in-group
  const int wr = (warp / WN) * (MI * 16), wcol = (warp % WN) * (NI * 8);

  int32_t acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < a.K_pad; k0 += kBK) {
    const int width = min(kBK, a.K_pad - k0);  // a multiple of 32
    const int per_row = width / 16;
    for (int u = tid; u < BM * per_row; u += kThreads) {
      const int r = u / per_row, c16 = (u % per_row) * 16;
      *reinterpret_cast<uint4*>(As + r * kLdA + c16) =
          gather16(a, rowbase[r], koff + k0 + c16);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      if (ks < width) {
        uint32_t af[MI][4];
        uint32_t bf[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int8_t* p = As + (wr + i * 16 + g) * kLdA + ks + t * 4;
          af[i][0] = *reinterpret_cast<const uint32_t*>(p);
          af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLdA);
          af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLdA + 16);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int8_t* p = Bs + (wcol + j * 8 + g) * ldb + k0 + ks + t * 4;
          bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j]);
      }
    }
    __syncthreads();
  }

  // accumulator r of tile (i, j): row g (+8 for r >= 2), col 2t + (r & 1);
  // the int8 tile [BM][BN] goes through the patch buffer
  int8_t* Os = As;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wr + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = wcol + j * 8 + 2 * t + (r & 1);
        int32_t v = q7::rshift_sat8(q7::wadd(acc[i][j][r], ebias[col]),
                                    eshift[col], a.nearest != 0);
        if (a.relu && v < 0) v = 0;
        Os[row * BN + col] = static_cast<int8_t>(v);
      }
  __syncthreads();

  const int rows = min(BM, a.M - m0);
  int8_t* dst = a.out + static_cast<int64_t>(m0) * a.Cout + n0;
  if (a.out_vec) {
    constexpr int kPerRow = BN / 16;
    for (int u = tid; u < rows * kPerRow; u += kThreads) {
      const int r = u / kPerRow, c = (u % kPerRow) * 16;
      if (n0 + c < a.Cout)
        *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(r) * a.Cout +
                                  c) =
            *reinterpret_cast<const uint4*>(Os + r * BN + c);
    }
  } else {
    for (int u = tid; u < rows * BN; u += kThreads) {
      const int r = u / BN, c = u % BN;
      if (n0 + c < a.Cout)
        dst[static_cast<int64_t>(r) * a.Cout + c] = Os[r * BN + c];
    }
  }
}

template <int BM, int BN>
int launch_tile(const ConvArgs& a, int device, cudaStream_t st) {
  // the opt-in above 48 KB holds for one device's context: it raises the
  // cap to kMaxSmem once a device (every call past kMaxDevices), and the
  // same value from racing threads does no harm
  static std::atomic<bool> opted_in[kMaxDevices];
  const size_t smem = smem_bytes(BM, BN, a.K_pad);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool known = device < kMaxDevices;
  if (smem > 48 * 1024 &&
      !(known && opted_in[device].load(std::memory_order_relaxed))) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_q7_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (known) opted_in[device].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((a.M + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  conv_q7_kernel<BM, BN><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool is_aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

bool fits_int8(int s) { return s >= -128 && s <= 127; }

int launch(const ConvArgs& a, int bm, int bn, int device, cudaStream_t st) {
#define CONV_Q7_TILE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return launch_tile<BM_, BN_>(a, device, st);
  CONV_Q7_TILE(128, 16)
  CONV_Q7_TILE(128, 32)
  CONV_Q7_TILE(128, 64)
  CONV_Q7_TILE(64, 16)
  CONV_Q7_TILE(64, 32)
  CONV_Q7_TILE(64, 64)
  CONV_Q7_TILE(32, 16)
  CONV_Q7_TILE(32, 32)
  CONV_Q7_TILE(32, 64)
  CONV_Q7_TILE(16, 32)
  CONV_Q7_TILE(16, 64)
#undef CONV_Q7_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point (loaded with ctypes).  x [B, H, W, Cin], w [KH, KW, Cin,
// Cout], bias [Cout] (or null), out [B, OH, OW, Cout], all int8 and
// contiguous on card `device`; args = [B, H, W, Cin, KH, KW, Cout,
// stride, nearest, relu, bm, bn, n_out, n_bias, then n_out output shifts
// and n_bias bias shifts] (n 1: one for every channel, or Cout), packed
// once a geometry by kernels/conv.py::_launch_args, whose conv_plan picks
// (bm, bn) among the tiles below; this entry only checks them.  It
// returns cudaErrorInvalidValue, launching nothing, for a geometry, a
// shift table, a tile or a shared-memory size it does not take.  The
// launch runs with `device` current and puts the caller's current device
// back.  Returns cudaGetLastError() after the launch; 0 means the launch
// was accepted.
extern "C" int conv_q7_launch(const void* x, const void* w, const void* bias,
                              void* out, const int* args, int device,
                              void* stream) {
  const int B = args[0], H = args[1], W = args[2], Cin = args[3];
  const int KH = args[4], KW = args[5], Cout = args[6], stride = args[7];
  const int bm = args[10], bn = args[11], n_out = args[12], n_bias = args[13];
  const int* out_shifts = args + 14;
  const int* bias_shifts = out_shifts + n_out;
  if (B < 0 || Cin < 1 || KH < 1 || KW < 1 || stride < 1 || H < KH ||
      W < KW || Cout < 1 || Cout > kMaxCout || device < 0 ||
      (n_out != 1 && n_out != Cout) || (n_bias != 1 && n_bias != Cout))
    return static_cast<int>(cudaErrorInvalidValue);
  // every index is an int: each tensor holds fewer than 2^31 elements
  const int64_t OH = (H - KH) / stride + 1, OW = (W - KW) / stride + 1;
  if (int64_t{B} * H * W * Cin >= (int64_t{1} << 31) ||
      int64_t{B} * OH * OW * Cout >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.bias = static_cast<const int8_t*>(bias);
  a.out = static_cast<int8_t*>(out);
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.KW = KW;
  a.Cout = Cout;
  a.stride = stride;
  a.OH = static_cast<int>(OH);
  a.OW = static_cast<int>(OW);
  a.M = B * a.OH * a.OW;
  a.K = KH * KW * Cin;
  a.K_pad = (a.K + 31) / 32 * 32;
  a.vec = Cin % 16 == 0 && is_aligned(x, 16)  ? 16
          : Cin % 4 == 0 && is_aligned(x, 4) ? 4
                                              : 1;
  a.out_vec = Cout % 16 == 0 && is_aligned(out, 16);
  a.nearest = args[8];
  a.relu = args[9];
  for (int n = 0; n < Cout; ++n) {
    const int os = out_shifts[n_out == 1 ? 0 : n];
    const int bs = bias_shifts[n_bias == 1 ? 0 : n];
    if (!fits_int8(os) || !fits_int8(bs))
      return static_cast<int>(cudaErrorInvalidValue);
    a.out_shift[n] = static_cast<int8_t>(os);
    a.bias_shift[n] = static_cast<int8_t>(bs);
  }
  if (a.M == 0) return static_cast<int>(cudaSuccess);
  int prev = device;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = launch(a, bm, bn, device, static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
