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

}  // namespace bcnn_int8
