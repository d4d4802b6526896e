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
// about 3.9 MB for MNIST at B = 64 (1.175 us at 3.35 TB/s); its
// (2r - 1)*J*I*O integer multiply-adds a sample (39.3 M operations at
// B = 64, r = 3) take 1.174 us at the CUDA cores' int32 rate (33.5 T
// operations/s): the bytes bound it, by a hair.
//
// Design: one thread-block cluster of cs CTAs per sample (cs <= 8, the
// portable size; the wrapper picks up to 4, at most one CTA per SM, which
// measured fastest).  CTA k of a cluster holds the input capsules
// [k*I/cs, (k+1)*I/cs) of its sample: its u_hat slice [J, I_k, O], staged
// once with cp.async (16-byte chunks where the slice allows) while the
// first softmax runs, and its logits b and couplings c [J, I_k].  The
// served (J, O) get their own instance, with the loops over j and o
// unrolled at compile time.  Where a slice of u_hat would not fit in
// shared memory even at 8 CTAs (a very large I), the general instance
// reads it from global memory, through L2, on every pass instead of
// staging it (kStaged = false); only b, c, the partials and v stay in
// shared memory.
//
//   * softmax and agreement are local to the column i, so one thread owns
//     each column: it adds the agreement of the last v into b[:, i] and
//     runs the softmax over j at once, with one integer division a column:
//     p = 2^(20 + e), e in [-20, 0], so (p << 7) // tot equals
//     (2^27 // tot) >> -e by nested floor division;
//   * the partial s [J, O] int32 of the slice is summed over (j, part of
//     I_k) units spread evenly over the warps, each reduced with one
//     __reduce_add_sync per o and added into shared memory;
//   * after a cluster barrier every CTA sums the cs partials through
//     distributed shared memory and squashes the J rows itself, so v
//     needs no second exchange.  Sums are int32 in uint32 arithmetic:
//     their order cannot change the result.  The partials alternate
//     between two buffers by iteration parity: a CTA clears or refills a
//     buffer only after the next cluster barrier, which every peer passes
//     only once it has read that buffer, and a last barrier keeps every
//     CTA's shared memory alive until its peers have read it.
//
// Fusing the u_hat product into the staging is later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "q7.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxIters = 16;

// The shift tables, passed by pointer to the C entry (routing.py
// RoutingArgs mirrors it).  At namespace scope: a type of the unnamed
// namespace would give routing_q7_launch internal linkage.
struct RoutingArgs {
  int num_iters;
  int logit_frac;
  int nearest;
  int caps_out_shifts[kMaxIters];
  int caps_out_fracs[kMaxIters];
  int agree_shifts[kMaxIters];
};

namespace {

constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// First input capsule of slice k of cs over [0, I); slices are never
// empty when cs <= I.  Mirrors routing.py slice_bounds.
__host__ __device__ __forceinline__ int slice_begin(int k, int I, int cs) {
  return static_cast<int>(static_cast<int64_t>(k) * I / cs);
}

// Shared memory of one CTA, sized for the largest slice I_k = ceil(I/cs):
// u [J][align16(I_k*O)] (staged only) | b [J*I_k] | c [J*I_k] | 2 partials
// s [J*O] int32 | v [J*O] int32.  Mirrors routing.py routing_smem_bytes.
struct Layout {
  size_t u_row, b, c, part, part_stride, v, total;
};

__host__ __device__ __forceinline__ Layout layout(int J, int I, int O,
                                                  int cs, bool staged) {
  const size_t ik = (static_cast<size_t>(I) + cs - 1) / cs;
  const size_t jo4 = align16(static_cast<size_t>(J) * O * sizeof(int32_t));
  Layout L;
  L.u_row = staged ? align16(ik * O) : 0;
  L.b = J * L.u_row;
  L.c = L.b + align16(J * ik);
  L.part = L.c + align16(J * ik);
  L.part_stride = jo4 / sizeof(int32_t);
  L.v = L.part + 2 * jo4;
  L.total = L.v + jo4;
  return L;
}

// Exponent of 2^(20 + max(floor((x - m) / 2^logit_frac), -20)), as
// int8_ops.softmax_q7; in [-20, 0] since x <= m.
__device__ __forceinline__ int32_t pow2_exp(int32_t x, int32_t m,
                                            int logit_frac) {
  const int32_t e = q7::sar(x - m, logit_frac);
  return e < q7::kExpFloor ? q7::kExpFloor : e;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy rows j of u_hat[sample, j, i0:i0+ik, :] into u_s rows of u_row
// bytes: `vec` bytes a cp.async (16 or 4) where every row's source is
// that aligned, the rest byte by byte.
__device__ __forceinline__ void stage_slice(const int8_t* src0,
                                            size_t src_row, int8_t* u_s,
                                            size_t u_row, int J, int len,
                                            int vec) {
  const int nv = vec > 1 ? len / vec : 0;
  for (int k = threadIdx.x; k < J * nv; k += kThreads) {
    const int j = k / nv;
    const int w = k - j * nv;
    const int8_t* s = src0 + j * src_row + static_cast<size_t>(w) * vec;
    int8_t* d = u_s + j * u_row + static_cast<size_t>(w) * vec;
    if (vec == 16)
      cp_async16(d, s);
    else
      cp_async4(d, s);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int head = nv * vec;
  const int tail = len - head;
  for (int k = threadIdx.x; k < J * tail; k += kThreads) {
    const int j = k / tail;
    const int w = head + (k - j * tail);
    u_s[j * u_row + w] = src0[j * src_row + w];
  }
}

// Step 1 for one column i: the agreement of the last v added into
// b[:, i] (r > 0), then the softmax over j into c[:, i] with one division.
// kJ > 0 keeps the column's logits in registers; kJ = 0 takes J at run
// time and re-reads them from shared memory.
template <int kJ, int kO>
__device__ __forceinline__ void column_step(
    int i, int r, int J, int O, int ik, const int8_t* __restrict__ u,
    size_t u_row, int8_t* __restrict__ b, int8_t* __restrict__ c,
    const int32_t* __restrict__ v, int agree_shift, int logit_frac,
    bool nearest) {
  constexpr int kSlots = kO > 0 ? kO : q7::kMaxDim;
  constexpr int kRegs = kJ > 0 ? kJ : 1;
  int32_t bv[kRegs];
  int32_t m = q7::kInt8Min;
#pragma unroll
  for (int j = 0; j < (kJ > 0 ? kJ : J); ++j) {
    int32_t bj = 0;
    if (r > 0) {
      const int8_t* ur = u + j * u_row + static_cast<size_t>(i) * O;
      int32_t a = 0;
#pragma unroll
      for (int o = 0; o < kSlots; ++o)
        if (o < O) a = q7::wadd(a, q7::wmul(ur[o], v[j * O + o]));
      a = q7::rshift_sat8(a, agree_shift, nearest);
      bj = q7::sat8(b[j * ik + i] + a);
    }
    b[j * ik + i] = static_cast<int8_t>(bj);
    if (kJ > 0) bv[j] = bj;
    m = max(m, bj);
  }
  int32_t tot = 0;
#pragma unroll
  for (int j = 0; j < (kJ > 0 ? kJ : J); ++j) {
    const int32_t bj = kJ > 0 ? bv[j] : b[j * ik + i];
    tot = q7::wadd(tot, q7::shl(1, 20 + pow2_exp(bj, m, logit_frac)));
  }
  const int32_t q = (int32_t{1} << 27) / (tot < 1 ? 1 : tot);
#pragma unroll
  for (int j = 0; j < (kJ > 0 ? kJ : J); ++j) {
    const int32_t bj = kJ > 0 ? bv[j] : b[j * ik + i];
    const int32_t e = pow2_exp(bj, m, logit_frac);
    c[j * ik + i] = static_cast<int8_t>(min(q >> -e, q7::kInt8Max));
  }
}

// kJ, kO > 0 fix J and O at compile time (the served geometries), so the
// loops over j and o unroll with no predicated slots; 0 takes them at run
// time (O <= kMaxDim).  kStaged copies the CTA's u_hat slice into shared
// memory; otherwise it is read where it lies.
template <int kJ, int kO, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    routing_q7_kernel(const int8_t* __restrict__ u_hat,
                      int8_t* __restrict__ v_out, int J_arg, int I, int O_arg,
                      int vec, const __grid_constant__ RoutingArgs args) {
  constexpr int kSlots = kO > 0 ? kO : q7::kMaxDim;
  const int J = kJ > 0 ? kJ : J_arg;
  const int O = kO > 0 ? kO : O_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int sample = blockIdx.x / cs;
  const int i0 = slice_begin(rank, I, cs);
  const int ik = slice_begin(rank + 1, I, cs) - i0;
  const Layout L = layout(J, I, O, cs, kStaged);
  int8_t* b = reinterpret_cast<int8_t*>(smem + L.b);
  int8_t* c = reinterpret_cast<int8_t*>(smem + L.c);
  int32_t* part = reinterpret_cast<int32_t*>(smem + L.part);
  int32_t* v = reinterpret_cast<int32_t*>(smem + L.v);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int JO = J * O;
  const bool nearest = args.nearest != 0;

  // u_hat slice in flight while the first softmax runs (b = 0 needs no
  // u_hat); the first partial buffer starts at 0.  u points at row j = 0
  // of the slice, u_row bytes a row, in shared or global memory.
  const size_t src_row = static_cast<size_t>(I) * O;
  const int8_t* src = u_hat + (static_cast<size_t>(sample) * J * I + i0) * O;
  const int8_t* u = src;
  size_t u_row = src_row;
  if (kStaged) {
    int8_t* u_s = reinterpret_cast<int8_t*>(smem);
    stage_slice(src, src_row, u_s, L.u_row, J, ik * O, vec);
    u = u_s;
    u_row = L.u_row;
  }
  for (int k = tid; k < JO; k += kThreads) part[k] = 0;

  // (j, part of I_k) units of the partial sum, a multiple of kWarps
  int g = J, h = kWarps;
  while (h != 0) {
    const int t = g % h;
    g = h;
    h = t;
  }
  const int parts = kWarps / g;

  for (int r = 0; r < args.num_iters; ++r) {
    // 1. per column i: agreement into b[:, i], softmax into c[:, i]
    const int agree_shift = r > 0 ? args.agree_shifts[r - 1] : 0;
    for (int i = tid; i < ik; i += kThreads)
      column_step<kJ, kO>(i, r, J, O, ik, u, u_row, b, c, v, agree_shift,
                          args.logit_frac, nearest);
    if (kStaged && r == 0) cp_async_wait_all();
    __syncthreads();

    // 2. partial s[j, :] += sum over this slice of c[j, i] * u[j, i, :]
    int32_t* mine = part + (r & 1) * L.part_stride;
    for (int unit = warp; unit < J * parts; unit += kWarps) {
      const int j = unit / parts;
      const int p = unit - j * parts;
      const int lo = p * ik / parts;
      const int hi = (p + 1) * ik / parts;
      int32_t acc[kSlots];
#pragma unroll
      for (int o = 0; o < kSlots; ++o) acc[o] = 0;
      for (int i = lo + lane; i < hi; i += 32) {
        const int32_t cji = c[j * ik + i];
        const int8_t* ur = u + j * u_row + static_cast<size_t>(i) * O;
#pragma unroll
        for (int o = 0; o < kSlots; ++o)
          if (o < O) acc[o] = q7::wadd(acc[o], q7::wmul(cji, ur[o]));
      }
#pragma unroll
      for (int o = 0; o < kSlots; ++o) {
        if (o < O) {
          const unsigned t = __reduce_add_sync(
              0xffffffffu, static_cast<unsigned>(acc[o]));
          if (lane == o)
            atomicAdd(reinterpret_cast<unsigned*>(mine + j * O + o), t);
        }
      }
    }
    cluster.sync();

    // 3. every CTA sums the cs partials and squashes the J rows; the
    //    other buffer is cleared for the next iteration.
    const bool last = r == args.num_iters - 1;
    const size_t off = (r & 1) * L.part_stride;
    for (int j = tid; j < J; j += kThreads) {
      int32_t s[kSlots];
      int32_t vj[kSlots];
#pragma unroll
      for (int o = 0; o < kSlots; ++o) s[o] = 0;
      for (int k = 0; k < cs; ++k) {
        const int32_t* peer = cluster.map_shared_rank(part, k) + off;
#pragma unroll
        for (int o = 0; o < kSlots; ++o)
          if (o < O) s[o] = q7::wadd(s[o], peer[j * O + o]);
      }
#pragma unroll
      for (int o = 0; o < kSlots; ++o)
        if (o < O)
          s[o] = q7::rshift_sat8(s[o], args.caps_out_shifts[r], nearest);
      q7::squash_row<kSlots>(s, O, args.caps_out_fracs[r], 7, vj);
#pragma unroll
      for (int o = 0; o < kSlots; ++o) {
        if (o < O) {
          v[j * O + o] = vj[o];
          if (last && rank == 0)
            v_out[static_cast<size_t>(sample) * JO + j * O + o] =
                static_cast<int8_t>(vj[o]);
        }
      }
    }
    if (last) break;
    int32_t* next = part + ((r + 1) & 1) * L.part_stride;
    for (int k = tid; k < JO; k += kThreads) next[k] = 0;
    __syncthreads();
  }
  // no CTA leaves while a peer may still read its partials
  cluster.sync();
}

// Launch one instance: raise its dynamic shared memory limit once per
// device, then a cs-CTA cluster per sample.
template <int kJ, int kO, bool kStaged = true>
cudaError_t launch(const cudaLaunchConfig_t& cfg, const void* u_hat,
                   void* v, int J, int I, int O, int vec,
                   const RoutingArgs& args) {
  static bool smem_raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_raised[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(routing_q7_kernel<kJ, kO, kStaged>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err != cudaSuccess) return err;
    smem_raised[dev] = true;
  }
  return cudaLaunchKernelEx(&cfg, routing_q7_kernel<kJ, kO, kStaged>,
                            static_cast<const int8_t*>(u_hat),
                            static_cast<int8_t*>(v), J, I, O, vec, args);
}

}  // namespace

// C entry point (loaded with ctypes).  `args` holds the shift tables
// (num_iters entries each, agree_shifts num_iters - 1; num_iters <=
// kMaxIters); O is 1..kMaxDim; cs is the cluster size, 1..8 and at most
// I; staged != 0 copies each CTA's u_hat slice into shared memory (the
// wrapper decides, from routing_smem_bytes).  The kernel's dynamic shared
// memory limit is raised once per device.  Returns the error of that, of
// the launch or cudaGetLastError() after it; 0 means the launch was
// accepted.
extern "C" int routing_q7_launch(const void* u_hat, void* v, int B, int J,
                                 int I, int O, int cs, int staged,
                                 const RoutingArgs* args, void* stream) {
  if (args->num_iters < 1 || args->num_iters > kMaxIters || O < 1 ||
      O > q7::kMaxDim || J < 1 || cs < 1 || cs > kMaxCluster || cs > I)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  // cp.async width: every row's slice start must be that aligned
  const uintptr_t base = reinterpret_cast<uintptr_t>(u_hat);
  const size_t row = static_cast<size_t>(I) * O;
  int vec = 16;
  for (int k = 0; k < cs && vec > 1 && staged; ++k) {
    const size_t start = static_cast<size_t>(slice_begin(k, I, cs)) * O;
    while (vec > 1 && ((base | row | start) & (vec - 1)) != 0)
      vec = vec == 16 ? 4 : 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = layout(J, I, O, cs, staged != 0).total;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the served geometries (MNIST, smallNORB, CIFAR-10, EDGE_TINY) get
  // their own instance; any other (J, O), or an unstaged slice, the
  // general one
  cudaError_t err;
  if (!staged)
    err = launch<0, 0, false>(cfg, u_hat, v, J, I, O, vec, *args);
  else if (J == 10 && O == 6)
    err = launch<10, 6>(cfg, u_hat, v, J, I, O, vec, *args);
  else if (J == 5 && O == 6)
    err = launch<5, 6>(cfg, u_hat, v, J, I, O, vec, *args);
  else if (J == 10 && O == 5)
    err = launch<10, 5>(cfg, u_hat, v, J, I, O, vec, *args);
  else if (J == 4 && O == 4)
    err = launch<4, 4>(cfg, u_hat, v, J, I, O, vec, *args);
  else
    err = launch<0, 0>(cfg, u_hat, v, J, I, O, vec, *args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
