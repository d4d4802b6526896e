// Float squash (Sabour et al. 2017, Eq. 1) over the rows of an [R, D]
// float32, bfloat16 or float16 tensor: v = sq / (1 + sq) * s *
// rsqrt(sq + 1e-7), sq = sum(s^2), computed in float32 and stored in the
// input's dtype, in one launch for every dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/squash.py,
// squash_float_pallas (body _squash_float_kernel), and agrees with
// repro_torch.core.routing.squash within float32 rounding: `rsqrtf` and
// torch's `rsqrt` may round differently, and a row's sum of squares is
// added in another order where lanes share a row.
//
// Bound on the H100: the function reads and writes R*D*sizeof(dtype)
// bytes each, 2*R*D*sizeof(dtype) at 3.35 TB/s, against about 4 float32
// operations an element (67 TFLOP/s outside the tensor cores), so bytes
// bound it.  Design: every element is read once and written once; a
// row lives in registers between its sum and its scale.  Three paths,
// picked by kernels/squash.py::squash_float_plan before the launch from
// the shape, the dtype and the alignment of the rows:
//   packed  rows of 16, 8, 4 or 2 bytes, contiguous, 16-byte aligned:
//           a thread loads one 16-byte word holding 1 to 8 whole rows
//           (D = 4 float32 is one float4 a row, D = 4 bfloat16 two rows
//           a word) and squashes them in registers;
//   lanes   rows whose bytes are a multiple of 16, each row 16-byte
//           aligned: a group of 2 to 32 lanes shares a row, one to four
//           16-byte words a lane, and sums sq with __shfl_xor_sync;
//   element any other row (a misaligned view such as s[:, 1:], D = 6
//           float32): the same lane groups with element loads.
// All paths walk the rows with a grid-stride loop, on a grid that covers
// them in one pass: measured on the H100, a grid capped at 8 blocks an SM
// took 7-10 % longer at [16777216, 4] and [1048576, 16] and gained
// nothing at [65536, 4], and four words a thread gained nothing either.
// squash_float_floor_launch is an empty kernel: its device time is the
// floor under which no launch of this function can go.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGrid = 0x7fffffffLL;   // gridDim.x's limit
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// v = scale * s * inv, in the plain version's order of operations
__device__ __forceinline__ float squash_scale(float sq) {
  return sq / (1.0f + sq);
}

// One 16-byte word of V = 16 / sizeof(T) elements holding RPV whole rows
// of D = V / RPV elements each.
template <typename T, int RPV>
__device__ __forceinline__ uint4 squash_word(uint4 w) {
  constexpr int V = 16 / sizeof(T);
  constexpr int D = V / RPV;
  T e[V];
  memcpy(e, &w, 16);
#pragma unroll
  for (int r = 0; r < RPV; ++r) {
    float x[D];
    float sq = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = to_f(e[r * D + d]);
      sq += x[d] * x[d];
    }
    const float scale = squash_scale(sq);
    const float inv = rsqrtf(sq + kEps);
#pragma unroll
    for (int d = 0; d < D; ++d) e[r * D + d] = from_f<T>(scale * x[d] * inv);
  }
  memcpy(&w, e, 16);
  return w;
}

// One row of D elements loaded element by element (the packed path's
// leftover rows, fewer than a word holds).
template <typename T, int D>
__device__ void squash_row_elements(const T* src, T* dst) {
  float x[D];
  float sq = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = to_f(src[d]);
    sq += x[d] * x[d];
  }
  const float scale = squash_scale(sq);
  const float inv = rsqrtf(sq + kEps);
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = from_f<T>(scale * x[d] * inv);
}

// packed: nvec 16-byte words of RPV rows each, then `tail` rows (fewer
// than RPV) squashed by the first threads of block 0.
template <typename T, int RPV>
__global__ void __launch_bounds__(kThreads)
    squash_float_packed(const uint4* __restrict__ s, uint4* __restrict__ out,
                        long long nvec, int tail) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < nvec; i += step)
    out[i] = squash_word<T, RPV>(s[i]);
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    constexpr int D = 16 / sizeof(T) / RPV;
    const long long row = nvec * RPV + threadIdx.x;
    squash_row_elements<T, D>(reinterpret_cast<const T*>(s) + row * D,
                              reinterpret_cast<T*>(out) + row * D);
  }
}

// lanes / element: a group of G lanes (a power of two, at most 32)
// shares a row; lane l holds chunks l, l + G, ... (at most NC of them),
// a chunk being a 16-byte word (VEC) or one element.  Rows start `rs`
// elements apart in s and D apart in out.  The loop bound is the same for
// every lane of a warp, so the whole warp takes part in each shuffle.
template <typename T, bool VEC, int NC>
__global__ void __launch_bounds__(kThreads)
    squash_float_lanes(const T* __restrict__ s, T* __restrict__ out,
                       long long R, int D, long long rs, int G) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const int lane = threadIdx.x & (G - 1);
  const int groups = kThreads / G;
  const int nchunks = D / V;
  const long long step = static_cast<long long>(gridDim.x) * groups;
  // the first row of this thread's warp, so the loop bound is uniform
  const long long warp0 = static_cast<long long>(blockIdx.x) * groups +
                          (threadIdx.x & ~31) / G;
  const int in_warp = (threadIdx.x & 31) / G;
  for (long long r0 = warp0; r0 < R; r0 += step) {
    const long long row = r0 + in_warp;
    const bool live = row < R;
    float x[NC][V];
    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = lane + c * G;
#pragma unroll
      for (int v = 0; v < V; ++v) x[c][v] = 0.0f;
      if (!live || j >= nchunks) continue;
      if constexpr (VEC) {
        const uint4 w = reinterpret_cast<const uint4*>(s + row * rs)[j];
        T e[V];
        memcpy(e, &w, 16);
#pragma unroll
        for (int v = 0; v < V; ++v) x[c][v] = to_f(e[v]);
      } else {
        x[c][0] = to_f(s[row * rs + j]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) sq += x[c][v] * x[c][v];
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (!live) continue;
    const float scale = squash_scale(sq);
    const float inv = rsqrtf(sq + kEps);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = lane + c * G;
      if (j >= nchunks) continue;
      if constexpr (VEC) {
        T e[V];
#pragma unroll
        for (int v = 0; v < V; ++v) e[v] = from_f<T>(scale * x[c][v] * inv);
        uint4 w;
        memcpy(&w, e, 16);
        reinterpret_cast<uint4*>(out + row * D)[j] = w;
      } else {
        out[row * D + j] = from_f<T>(scale * x[c][0] * inv);
      }
    }
  }
}

__global__ void squash_float_floor_kernel() {}

// Blocks to launch for `work` units of `per_block` each: one pass over
// the work, within gridDim.x's limit (the loops stride over the rest).
unsigned grid_for(long long work, long long per_block) {
  const long long need = (work + per_block - 1) / per_block;
  return static_cast<unsigned>(need < 1 ? 1 : need < kMaxGrid ? need
                                                              : kMaxGrid);
}

template <typename T, int RPV>
void launch_packed_rpv(const uint4* s, uint4* out, long long nvec, int tail,
                       cudaStream_t st) {
  squash_float_packed<T, RPV><<<grid_for(nvec, kThreads), kThreads, 0, st>>>(
      s, out, nvec, tail);
}

template <typename T>
int launch_packed(const void* s, void* out, long long R, int D,
                  cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (D > V || V % D != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rpv = V / D;
  const long long nvec = R / rpv;
  const int tail = static_cast<int>(R % rpv);
  const auto* src = static_cast<const uint4*>(s);
  auto* dst = static_cast<uint4*>(out);
  switch (rpv) {
    case 1:
      launch_packed_rpv<T, 1>(src, dst, nvec, tail, st);
      break;
    case 2:
      launch_packed_rpv<T, 2>(src, dst, nvec, tail, st);
      break;
    case 4:
      launch_packed_rpv<T, 4>(src, dst, nvec, tail, st);
      break;
    case 8:
      if constexpr (V >= 8) {
        launch_packed_rpv<T, 8>(src, dst, nvec, tail, st);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC, int NC>
void launch_lanes_nc(const void* s, void* out, long long R, int D,
                     long long rs, int G, cudaStream_t st) {
  const unsigned grid = grid_for(R, kThreads / G);
  squash_float_lanes<T, VEC, NC><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(s), static_cast<T*>(out), R, D, rs, G);
}

template <typename T>
int launch_lanes(const void* s, void* out, long long R, int D, long long rs,
                 bool vec, int G, int nc, cudaStream_t st) {
  if (G < 1 || G > 32 || (G & (G - 1)) != 0 ||
      (vec && D % (16 / static_cast<int>(sizeof(T))) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    if (nc == 1) {
      launch_lanes_nc<T, true, 1>(s, out, R, D, rs, G, st);
    } else if (nc == 4) {
      launch_lanes_nc<T, true, 4>(s, out, R, D, rs, G, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (nc == 1) {
    launch_lanes_nc<T, false, 1>(s, out, R, D, rs, G, st);
  } else if (nc == 4) {
    launch_lanes_nc<T, false, 4>(s, out, R, D, rs, G, st);
  } else if (nc == 32) {
    launch_lanes_nc<T, false, 32>(s, out, R, D, rs, G, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* s, void* out, long long R, int D, long long rs,
           int path, int G, int nc, cudaStream_t st) {
  switch (path) {
    case 0:
      return launch_packed<T>(s, out, R, D, st);
    case 1:
      return launch_lanes<T>(s, out, R, D, rs, true, G, nc, st);
    case 2:
      return launch_lanes<T>(s, out, R, D, rs, false, G, nc, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point (loaded with ctypes).  s: R rows of D elements, row r at
// element r * rs; out: [R, D] contiguous.  dtype 0 float32, 1 bfloat16,
// 2 float16; path 0 packed, 1 lanes, 2 element, with G lanes a row and
// nc chunks a lane (kernels/squash.py::squash_float_plan).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a plan
// the kernels do not take); 0 means the launch was accepted.
extern "C" int squash_float_launch(const void* s, void* out, long long R,
                                   int D, long long rs, int dtype, int path,
                                   int G, int nc, void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(s, out, R, D, rs, path, G, nc, st);
    case 1:
      return launch<__nv_bfloat16>(s, out, R, D, rs, path, G, nc, st);
    case 2:
      return launch<__half>(s, out, R, D, rs, path, G, nc, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int squash_float_floor_launch(void* stream) {
  squash_float_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
