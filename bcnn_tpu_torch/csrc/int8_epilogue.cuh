// The epilogue that the int8 convolutions K4 (conv_int8.cu) and K5
// (grouped_int8.cu) run on each int32 sum, and its requantize:
//   y = fp32(acc) * d[o]                          (d = fp32(sx) * w_scale)
//   y = ((y - mean[o]) * inv[o]) * scale[o] + bias[o]   BN as it stands
//     | y * scale[o] + bias[o]                          BN folded
//     | y + bias[o]                                     no BN
//   y = LRELU (y > 0 ? y : 0.1 y) | RELU | NONE
//   q = int8(clip(rint(y / s_out), -127, 127))
// Every step rounds as the plain version's separate torch ops do
// (bcnn_tpu_torch/ops/conv_int8.py:int8_epilogue_ref): __fmul_rn and
// friends, IEEE division, never a contracted FMA.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bcnn_int8 {

enum { kBnNone = 0, kBnFolded = 1, kBnUnfolded = 2 };
enum { kActNone = 0, kActRelu = 1, kActLrelu = 2 };

// one output channel's vectors
struct Chan {
  float d, scale, bias, mean, inv;
};

__device__ __forceinline__ float epilogue(int acc, const Chan& v, int bn,
                                          int act) {
  float y = __fmul_rn(__int2float_rn(acc), v.d);
  if (bn == kBnUnfolded) {
    y = __fmul_rn(__fsub_rn(y, v.mean), v.inv);
    y = __fadd_rn(__fmul_rn(y, v.scale), v.bias);
  } else if (bn == kBnFolded) {
    y = __fadd_rn(__fmul_rn(y, v.scale), v.bias);
  } else {
    y = __fadd_rn(y, v.bias);
  }
  if (act == kActLrelu) {
    y = y > 0.f ? y : __fmul_rn(0.1f, y);
  } else if (act == kActRelu) {
    y = y < 0.f ? 0.f : y;
  }
  return y;
}

// int8(clip(rint(fl(y / s)), -127, 127)), the plain version's true
// division and round
__device__ __forceinline__ int8_t requant(float y, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
  return (int8_t)(int)q;
}

// requant(y, s) in the low byte of the result, by one multiply with
// inv_s = fl(1 / s) (0 turns the shortcut off, and then it divides). With
// 1 / s normal, t = fl(y * inv_s) lies within 1.5 * 2^-23 |t| (+ 2^-48)
// of fl(y / s), under 2^-22 |t|. t is clamped to [-127, 127] first, which
// commutes with rint at integer bounds (a NaN clamps to -127 as requant's
// does; a t clamped from beyond 127 and the true quotient both give 127),
// so 2^-22 |t| < 2^-15: where t's distance to the nearest half-integer,
// 0.5 - |t - rint(t)|, exceeds 2^-15, both round to the same integer. t +
// 1.5 * 2^23 rounds t to the nearest integer, ties to even as rintf, and
// holds it in its low byte. Within 2^-15 of a half-integer h (ties
// included) it finds where Q = fl(y / s) lies against h without
// dividing: h has at most 9 significant bits and an even last bit, so Q >
// h exactly when y / s > h + (the next float above h - h) / 2, and Q < h
// exactly when y / s < h - (h - the float below) / 2, else Q = h, which
// rounds to the even neighbour; both midpoints times s are exact in
// double, and the sign of a double fma y - m * s decides. No call, no
// slow path (requant_exact; requant_bits divides only where the shortcut
// is off). bcnn_tpu_torch/ops/grouped_int8.py:requant_bits_ref is its
// numpy twin, tested at the ties.
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

// requant_bits' shortcut alone: the code of t = clamp(y * inv_s, kLo,
// 127) in the low byte; sets `bad` where t lies within 2^-15 of a
// half-integer, whose code it may miss. kLo = 0 stands for a RELU before
// it (y < 0 gives t = 0, code 0).
template <int kLo = -127>
__device__ __forceinline__ int requant_fast(float y, float inv_s, bool& bad) {
  const float t = fminf(fmaxf(__fmul_rn(y, inv_s), (float)kLo), 127.f);
  const float nm = __fadd_rn(t, kRound);
  const float e = __fsub_rn(t, __fsub_rn(nm, kRound));
  bad |= !(fabsf(e) < 0.5f - 0x1p-15f);
  return __float_as_int(nm);
}

// requant_bits with the shortcut on (inv_s = fl(1 / s) normal): no
// division, no call.
__device__ __forceinline__ int requant_exact(float y, float s, float inv_s) {
  bool bad = false;
  const int fast = requant_fast(y, inv_s, bad);
  if (!bad) return fast;
  const float t = fminf(fmaxf(__fmul_rn(y, inv_s), -127.f), 127.f);
  const float h = __fadd_rn(floorf(t), 0.5f);
  const double hd = h;
  const double up = hd + 0.5 * ((double)nextafterf(h, INFINITY) - hd);
  const double dn = hd - 0.5 * (hd - (double)nextafterf(h, -INFINITY));
  float q = __fsub_rn(h, 0.5f);
  if (__fma_rn(-up, (double)s, (double)y) > 0.0 ||
      (!(__fma_rn(-dn, (double)s, (double)y) < 0.0) && ((int)q & 1)))
    q = __fadd_rn(h, 0.5f);
  return __float_as_int(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), kRound));
}

__device__ __forceinline__ int requant_bits(float y, float s, float inv_s) {
  return inv_s > 0.f ? requant_exact(y, s, inv_s) : (int)requant(y, s);
}

}  // namespace bcnn_int8
