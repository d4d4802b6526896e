// Fused int8 dynamic routing (paper Alg. 5, all r iterations in one
// launch): u_hat int8 [B, J, I, O] -> v int8 [B, J, O] in Q0.7.
//
// Replaces the Pallas TPU kernel src/repro/kernels/routing.py,
// routing_q7_pallas (body _routing_kernel, helpers _softmax_q7_cols,
// _squash_rows, _isqrt, _rshift_sat8), and is bit-exact with
// repro_torch.kernels.routing.routing_q7_plain.  Each iteration runs the
// shift softmax over J, s = sum_i c * u_hat, rshift_sat8, the integer
// squash into Q0.7 (q7::squash_row, the squash kernel's device function),
// the agreement sum_o u_hat * v, rshift_sat8 and a saturating q7 add into
// the logits.
//
// Bound on the H100: the function reads B*J*I*O bytes and writes B*J*O,
// about 3.9 MB for MNIST at B = 64 (~1.2 us at 3.35 TB/s); its ~2*r*J*I*O
// integer multiply-adds per sample run on the CUDA cores.  Design: one
// CTA per sample holds that sample's u_hat (61,440 B for MNIST), the
// logits b and the couplings c ([J, I] int8 each) in dynamic shared
// memory, so u_hat is read from device memory once for all r iterations
// (the TPU kernel kept it in VMEM for the same reason).  That is above
// 48 KB, so the launch raises the kernel's dynamic shared memory limit.
// The sums over I and O are int32 sums in uint32 arithmetic: their order
// cannot change the result.  More CTAs per sample, cp.async/TMA staging
// and fusing the u_hat product are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "q7.cuh"

namespace {

constexpr int kMaxIters = 8;
constexpr int kThreads = 256;

struct RoutingArgs {
  int num_iters;
  int logit_frac;
  int nearest;
  int caps_out_shifts[kMaxIters];
  int caps_out_fracs[kMaxIters];
  int agree_shifts[kMaxIters];
};

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory layout: u [J*I*O] | b [J*I] | c [J*I] | s/v int32 [J*O].
// Mirrors repro_torch.kernels.routing.routing_smem_bytes.
__host__ __device__ __forceinline__ size_t smem_bytes(int J, int I, int O) {
  const size_t ji = static_cast<size_t>(J) * I;
  return align16(ji * O) + 2 * align16(ji) +
         align16(static_cast<size_t>(J) * O * sizeof(int32_t));
}

// 2^(20 + max(floor((x - m) / 2^logit_frac), -20)), as int8_ops.softmax_q7.
__device__ __forceinline__ int32_t pow2_prob(int32_t x, int32_t m,
                                             int logit_frac) {
  int32_t e = q7::sar(x - m, logit_frac);
  e = e < q7::kExpFloor ? q7::kExpFloor : e;
  return q7::shl(1, 20 + e);
}

__global__ void __launch_bounds__(kThreads)
    routing_q7_kernel(const int8_t* __restrict__ u_hat,
                      int8_t* __restrict__ v_out, int J, int I, int O,
                      RoutingArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ji = J * I;
  const size_t jio = static_cast<size_t>(ji) * O;
  int8_t* u = reinterpret_cast<int8_t*>(smem);
  int8_t* b = reinterpret_cast<int8_t*>(smem + align16(jio));
  int8_t* c = b + align16(ji);
  int32_t* sv = reinterpret_cast<int32_t*>(c + align16(ji));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool nearest = args.nearest != 0;

  // Stage this sample's u_hat, 16 bytes a thread where aligned.
  const int8_t* src = u_hat + static_cast<size_t>(blockIdx.x) * jio;
  size_t head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const size_t n16 = jio / 16;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(u);
    for (size_t k = tid; k < n16; k += blockDim.x) d4[k] = s4[k];
    head = n16 * 16;
  }
  for (size_t k = head + tid; k < jio; k += blockDim.x) u[k] = src[k];
  for (int k = tid; k < ji; k += blockDim.x) b[k] = 0;
  __syncthreads();

  for (int r = 0; r < args.num_iters; ++r) {
    // 1. couplings: shift softmax over j for every input capsule i.
    for (int i = tid; i < I; i += blockDim.x) {
      int32_t m = b[i];
      for (int j = 1; j < J; ++j) m = max(m, static_cast<int32_t>(b[j * I + i]));
      int32_t tot = 0;
      for (int j = 0; j < J; ++j)
        tot = q7::wadd(tot, pow2_prob(b[j * I + i], m, args.logit_frac));
      tot = tot < 1 ? 1 : tot;
      for (int j = 0; j < J; ++j) {
        const int32_t p = pow2_prob(b[j * I + i], m, args.logit_frac);
        c[j * I + i] = static_cast<int8_t>(
            q7::clamp_i(q7::floordiv(q7::shl(p, 7), tot), 0, q7::kInt8Max));
      }
    }
    __syncthreads();

    // 2. s[j, :] = sum_i c[j, i] * u[j, i, :]; one warp per capsule j.
    for (int j = warp; j < J; j += nwarps) {
      int32_t acc[q7::kMaxDim];
#pragma unroll
      for (int o = 0; o < q7::kMaxDim; ++o) acc[o] = 0;
      for (int i = lane; i < I; i += 32) {
        const int32_t cji = c[j * I + i];
        const int8_t* ur = u + (static_cast<size_t>(j) * I + i) * O;
#pragma unroll
        for (int o = 0; o < q7::kMaxDim; ++o)
          if (o < O) acc[o] = q7::wadd(acc[o], q7::wmul(cji, ur[o]));
      }
#pragma unroll
      for (int o = 0; o < q7::kMaxDim; ++o) {
        if (o < O) {
          for (int off = 16; off > 0; off >>= 1)
            acc[o] = q7::wadd(acc[o],
                              __shfl_down_sync(0xffffffffu, acc[o], off));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int o = 0; o < q7::kMaxDim; ++o)
          if (o < O) sv[j * O + o] = acc[o];
      }
    }
    __syncthreads();

    // 3. requantize s and squash each output capsule into Q0.7.
    for (int j = tid; j < J; j += blockDim.x) {
      int32_t s[q7::kMaxDim];
      int32_t v[q7::kMaxDim];
#pragma unroll
      for (int o = 0; o < q7::kMaxDim; ++o)
        s[o] = o < O ? q7::rshift_sat8(sv[j * O + o],
                                       args.caps_out_shifts[r], nearest)
                     : 0;
      q7::squash_row(s, O, args.caps_out_fracs[r], 7, v);
#pragma unroll
      for (int o = 0; o < q7::kMaxDim; ++o)
        if (o < O) sv[j * O + o] = v[o];
    }
    __syncthreads();
    if (r == args.num_iters - 1) break;

    // 4. agreement, requantized, saturating-added into the logits.
    for (int k = tid; k < ji; k += blockDim.x) {
      const int j = k / I;
      const int8_t* ur = u + static_cast<size_t>(k) * O;
      int32_t a = 0;
#pragma unroll
      for (int o = 0; o < q7::kMaxDim; ++o)
        if (o < O) a = q7::wadd(a, q7::wmul(ur[o], sv[j * O + o]));
      a = q7::rshift_sat8(a, args.agree_shifts[r], nearest);
      b[k] = static_cast<int8_t>(q7::sat8(b[k] + a));
    }
    __syncthreads();
  }

  int8_t* dst = v_out + static_cast<size_t>(blockIdx.x) * J * O;
  for (int k = tid; k < J * O; k += blockDim.x)
    dst[k] = static_cast<int8_t>(sv[k]);
}

}  // namespace

// C entry point (loaded with ctypes).  The shift tables are host arrays:
// num_iters entries each (agree_shifts: num_iters - 1), num_iters <= 8.
// Returns cudaGetLastError() after the launch (or the error of raising
// the shared memory limit); 0 means the launch was accepted.
extern "C" int routing_q7_launch(const void* u_hat, void* v, int B, int J,
                                 int I, int O, int num_iters,
                                 const int* caps_out_shifts,
                                 const int* caps_out_fracs,
                                 const int* agree_shifts, int logit_frac,
                                 int nearest, void* stream) {
  if (num_iters < 1 || num_iters > kMaxIters || O > q7::kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  RoutingArgs args = {};
  args.num_iters = num_iters;
  args.logit_frac = logit_frac;
  args.nearest = nearest;
  for (int r = 0; r < num_iters; ++r) {
    args.caps_out_shifts[r] = caps_out_shifts[r];
    args.caps_out_fracs[r] = caps_out_fracs[r];
    if (r < num_iters - 1) args.agree_shifts[r] = agree_shifts[r];
  }
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = smem_bytes(J, I, O);
  cudaError_t err = cudaFuncSetAttribute(
      routing_q7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  routing_q7_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(u_hat), static_cast<int8_t*>(v), J, I, O,
      args);
  return static_cast<int>(cudaGetLastError());
}
