// Integer helpers shared by the q7 kernels (squash_q7.cu, routing_q7.cu).
// Both kernels squash through q7::squash_row, so they share one isqrt.
//
// Each helper reproduces the semantics of the torch / XLA integer oracle
// (repro_torch.quant.int8_ops) on int32, including the cases C++ leaves
// undefined or defines differently:
//
//   * shift amounts outside [0, 31] (negative ones read as huge unsigned
//     values, as XLA and torch read them): a left shift gives 0, an
//     arithmetic right shift gives the sign fill;
//   * int32 overflow in adds and multiplies wraps (done in uint32);
//   * `//` is a floor division.  In these kernels every numerator is
//     >= 0 and every divisor >= 1 on int8 inputs, where floor and C's
//     truncation agree; floordiv still corrects a negative numerator so
//     a wrapped intermediate cannot diverge from the oracle.
#pragma once

#include <cstdint>

namespace q7 {

constexpr int kInt8Min = -128;
constexpr int kInt8Max = 127;
constexpr int kSquashGuardBits = 10;   // int8_ops.SQUASH_GUARD_BITS
constexpr int kExpFloor = -20;         // int8_ops.EXP_FLOOR
constexpr int kMaxDim = 16;            // capsule dims the kernels take

__host__ __device__ __forceinline__ int32_t shl(int32_t a, int32_t s) {
  return static_cast<uint32_t>(s) >= 32u
             ? 0
             : static_cast<int32_t>(static_cast<uint32_t>(a) << s);
}

__host__ __device__ __forceinline__ int32_t sar(int32_t a, int32_t s) {
  return static_cast<uint32_t>(s) >= 32u ? (a < 0 ? -1 : 0) : (a >> s);
}

__host__ __device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__host__ __device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// floor(n / d) for d >= 1.
__host__ __device__ __forceinline__ int32_t floordiv(int32_t n, int32_t d) {
  int32_t q = n / d;
  return (n % d != 0 && n < 0) ? q - 1 : q;
}

__host__ __device__ __forceinline__ int32_t clamp_i(int32_t x, int32_t lo,
                                                    int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__host__ __device__ __forceinline__ int32_t sat8(int32_t x) {
  return clamp_i(x, kInt8Min, kInt8Max);
}

// int8_ops.rshift_sat8: positive shifts round (nearest adds the half-LSB)
// and shift right, negative shifts shift left, then saturate.
__host__ __device__ __forceinline__ int32_t rshift_sat8(int32_t acc,
                                                        int32_t shift,
                                                        bool nearest) {
  if (shift > 0) {
    if (nearest) acc = wadd(acc, shl(1, shift - 1));
    acc = sar(acc, shift);
  } else if (shift < 0) {
    acc = shl(acc, -shift);
  }
  return sat8(acc);
}

// floor(sqrt(n)) for n >= 2, n for n <= 1: equal to int8_ops.isqrt_newton
// (Alg. 4, 32 guarded Newton steps from n / 2) on every int32, without its
// 64 integer divisions.  The float32 root of n (n rounded to float32,
// then a correctly rounded sqrt) is within 0.01 of sqrt(n) for n < 2^31,
// so its truncation is floor(sqrt(n)) or one off where sqrt(n) lies that
// close to an integer; one step down and one step up, with the squares
// in 64 bits, make it exact.  On the squash's domain, [0, 16 * 128^2],
// the truncation alone is already exact.
__device__ __forceinline__ int32_t isqrt(int32_t n) {
  if (n <= 1) return n;
  int32_t r = static_cast<int32_t>(__fsqrt_rn(__int2float_rn(n)));
  if (static_cast<int64_t>(r) * r > n) {
    --r;
  } else if (static_cast<int64_t>(r + 1) * (r + 1) <= n) {
    ++r;
  }
  return r;
}

// int8_ops.squash_q7 on one capsule s[0..D) (int8 values held in int32),
// D <= kSlots <= kMaxDim; writes the int8 results into v as int32.  A
// caller that knows D at compile time passes it as kSlots, so the loops
// unroll to D slots.
template <int kSlots = kMaxDim>
__device__ __forceinline__ void squash_row(const int32_t* s, int D,
                                           int in_frac, int out_frac,
                                           int32_t* v) {
  int32_t Q = 0;
#pragma unroll
  for (int d = 0; d < kSlots; ++d)
    if (d < D) Q = wadd(Q, wmul(s[d], s[d]));
  const int32_t S = isqrt(Q);
  const int shift = out_frac - in_frac + kSquashGuardBits;
  const int32_t num = shift >= 0 ? shl(S, shift) : sar(S, -shift);
  int32_t den = wadd(shl(1, in_frac), sar(Q, in_frac));
  den = den < 1 ? 1 : den;
  const int32_t ratio = floordiv(num, den);
#pragma unroll
  for (int d = 0; d < kSlots; ++d)
    if (d < D) v[d] = sat8(sar(wmul(ratio, s[d]), kSquashGuardBits));
}

}  // namespace q7
