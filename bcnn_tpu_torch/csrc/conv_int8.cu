// K4: int8 convolution with its fused epilogue, for Hopper (sm_90a).
//
// Replaces what the JAX package computes through XLA for a quantized conv
// (there is no Pallas kernel for it): bcnn_tpu/ops/quant.py:302
// `conv2d_int8`, then `_apply_conv_epilogue` and `_maybe_emit_int8` of
// bcnn_tpu/compile.py:438-468. PyTorch has no int8 convolution on CUDA, so
// the port needs its own. From x int8 (N, C, H, W), w int8 (O, C, k, k)
// and fp32 per-channel vectors it computes
//   acc[n,o,p,q] = sum_{c,r,s} x[n,c,p*S+r-P,q*S+s-P] * w[o,c,r,s]  (int32)
//   y = fp32(acc) * d[o]                          (d = fp32(sx) * w_scale)
//   y = ((y - mean[o]) * inv[o]) * scale[o] + bias[o]   BN as it stands
//     | y * scale[o] + bias[o]                          BN folded
//     | y + bias[o]                                     no BN
//   y = LRELU (y > 0 ? y : 0.1 y) | RELU | NONE
//   out = int8(clip(rint(y / s_out), -127, 127)) or fp32 y,  NCHW.
// Every step rounds as the plain version's separate torch ops do
// (__fmul_rn and friends, IEEE division, never a contracted FMA), and d
// and inv come from the wrapper, so the kernel is bit-equal to
// bcnn_tpu_torch/ops/conv_int8.py:conv_int8_fused_ref.
//
// What bounds it: an implicit GEMM of M = N*OH*OW rows, O columns and
// K = C*k*k deep. At YOLOv3-tiny 416, batch 8, the wide early layers
// (K = 27..288, O = 16..64) move far more bytes than they multiply
// (bound by the 3.35 TB/s of device memory), the deep 13x13 and 26x26
// ones (K up to 4,608, O up to 1,024) the other way (1,979 TOPS of dense
// int8). This first version is simple and right: a block computes a
// 128 x 64 tile of the output, 8 warps of 32 x 32, with
// mma.sync.m16n8k32 s8 x s8 -> s32 from shared memory, K in steps of 32:
// - The x tile is gathered im2col on the fly, a thread one output pixel
//   and 16 of the 32 k values (c, r, s stepped, not divided), zero where
//   the window leaves the image, where k >= K (the first conv's K = 27)
//   or the row is past M (the ragged 13x13 tiles): byte loads, neighbouring
//   threads on neighbouring pixels.
// - The w tile is 8 bytes a thread, one load where K is a multiple of 8.
// - Two shared buffers: the global loads of step t+1 are in flight while
//   the tensor cores work on step t; one barrier a step.
// - Rows of 48 bytes in shared memory keep the fragment reads free of
//   bank conflicts.
// - Columns past O (the heads' 255) are computed on zero weights and not
//   stored.
// Left for later: wgmma and TMA, a channels-last int8 layout that makes
// the gather 16-byte loads, and staging the output tile for coalesced
// stores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileM = 128;   // output pixels a block
constexpr int kTileN = 64;    // output channels a block
constexpr int kTileK = 32;    // reduction depth a step: one m16n8k32
constexpr int kRow = 48;      // shared-memory row: 32 bytes + 16 padding
constexpr int kThreads = 256; // 8 warps: 4 along M x 2 along N

enum { kBnNone = 0, kBnFolded = 1, kBnUnfolded = 2 };
enum { kActNone = 0, kActRelu = 1, kActLrelu = 2 };

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* d;
  const float* scale;
  const float* bias;
  const float* mean;
  const float* inv;
  void* out;
  int c, h, w_in, o, k, stride, pad, oh, ow;
  int kdim;  // C * k * k
  int m;     // N * OH * OW
  int bn, act, out_int8, w_vec;
  float s_out;
};

__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
    conv_int8_kernel(const Conv p) {
  __shared__ __align__(16) int8_t sa[2][kTileM * kRow];
  __shared__ __align__(16) int8_t sb[2][kTileN * kRow];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTileM;
  const int o0 = blockIdx.y * kTileN;
  const int ohw = p.oh * p.ow;
  const int kk2 = p.k * p.k;
  const int steps = (p.kdim + kTileK - 1) / kTileK;

  // x loader: output pixel a_row of the tile, k values a_half*16 + 0..15
  const int a_row = tid % kTileM;
  const int a_half = tid / kTileM;
  const int am = m0 + a_row;
  const bool a_ok = am < p.m;
  long long a_base = 0;
  int ih0 = 0, iw0 = 0;
  if (a_ok) {
    const int img = am / ohw;
    const int pq = am - img * ohw;
    const int oy = pq / p.ow;
    a_base = (long long)img * p.c * p.h * p.w_in;
    ih0 = oy * p.stride - p.pad;
    iw0 = (pq - oy * p.ow) * p.stride - p.pad;
  }
  // w loader: output channel b_row of the tile, k values b_q*8 + 0..7
  const int b_row = tid / 4;
  const int b_q = tid % 4;
  const bool b_ok = o0 + b_row < p.o;
  const int8_t* wrow = p.w + (long long)(b_ok ? o0 + b_row : 0) * p.kdim;

  uint32_t ra[4];
  uint2 rb;

  auto load = [&](int step) {
    int kk = step * kTileK + a_half * 16;
    int ci = kk / kk2;
    int rem = kk - ci * kk2;
    int r = rem / p.k;
    int s = rem - r * p.k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ih = ih0 + r, iw = iw0 + s;
        if (a_ok && kk < p.kdim && (unsigned)ih < (unsigned)p.h &&
            (unsigned)iw < (unsigned)p.w_in) {
          const uint8_t v = (uint8_t)p.x[a_base +
                                         ((long long)ci * p.h + ih) * p.w_in +
                                         iw];
          word |= (uint32_t)v << (8 * j);
        }
        ++kk;
        if (++s == p.k) {
          s = 0;
          if (++r == p.k) {
            r = 0;
            ++ci;
          }
        }
      }
      ra[i] = word;
    }
    const int kb = step * kTileK + b_q * 8;
    rb = make_uint2(0u, 0u);
    if (b_ok && kb < p.kdim) {
      if (p.w_vec) {
        rb = *reinterpret_cast<const uint2*>(wrow + kb);
      } else {
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kb + j < p.kdim) {
            const uint32_t v = (uint8_t)wrow[kb + j];
            if (j < 4)
              lo |= v << (8 * j);
            else
              hi |= v << (8 * (j - 4));
          }
        }
        rb = make_uint2(lo, hi);
      }
    }
  };
  auto store = [&](int buf) {
    *reinterpret_cast<uint4*>(&sa[buf][a_row * kRow + a_half * 16]) =
        make_uint4(ra[0], ra[1], ra[2], ra[3]);
    *reinterpret_cast<uint2*>(&sb[buf][b_row * kRow + b_q * 8]) = rb;
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* pa = &sa[buf][(wm * 32 + mi * 16 + g) * kRow + t * 4];
      a[mi][0] = *reinterpret_cast<const uint32_t*>(pa);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * kRow);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * kRow + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* pb = &sb[buf][(wn * 32 + ni * 8 + g) * kRow + t * 4];
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
    }
    if (step + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: acc[mi][ni][e] is row g (+8 for e >= 2), column 2t + (e & 1)
  // of the 16 x 8 product (mi, ni) of this warp
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mi * 16 + g + 8 * half;
      if (m >= p.m) continue;
      const int img = m / ohw;
      const long long base = (long long)img * p.o * ohw + (m - img * ohw);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = o0 + wn * 32 + ni * 8 + t * 2 + j;
          if (o >= p.o) continue;
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + j]),
                              p.d[o]);
          if (p.bn == kBnUnfolded) {
            y = __fmul_rn(__fsub_rn(y, p.mean[o]), p.inv[o]);
            y = __fadd_rn(__fmul_rn(y, p.scale[o]), p.bias[o]);
          } else if (p.bn == kBnFolded) {
            y = __fadd_rn(__fmul_rn(y, p.scale[o]), p.bias[o]);
          } else {
            y = __fadd_rn(y, p.bias[o]);
          }
          if (p.act == kActLrelu) {
            y = y > 0.f ? y : __fmul_rn(0.1f, y);
          } else if (p.act == kActRelu) {
            y = y < 0.f ? 0.f : y;
          }
          const long long idx = base + (long long)o * ohw;
          if (p.out_int8) {
            float q = rintf(__fdiv_rn(y, p.s_out));
            q = fminf(fmaxf(q, -127.f), 127.f);
            static_cast<int8_t*>(p.out)[idx] = (int8_t)(int)q;
          } else {
            static_cast<float*>(p.out)[idx] = y;
          }
        }
      }
    }
  }
}

}  // namespace

// x int8 (n, c, h, w), w int8 (o, c, k, k), out int8 or fp32
// (n, o, oh, ow), all contiguous; d and bias fp32 (o); scale (o) for
// bn >= 1, mean and inv (o) for bn == 2, else may be null. Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int bcnn_conv_int8(const void* x, const void* w, const void* d,
                              const void* scale, const void* bias,
                              const void* mean, const void* inv, void* out,
                              int n, int c, int h, int wd, int o, int k,
                              int stride, int pad, int bn, int act,
                              int out_int8, float s_out, void* stream) {
  if (n < 0 || c < 1 || h < 0 || wd < 0 || o < 1 || k < 1 || stride < 1 ||
      pad < 0 || bn < kBnNone || bn > kBnUnfolded || act < kActNone ||
      act > kActLrelu || (out_int8 && !(s_out > 0.f)))
    return (int)cudaErrorInvalidValue;
  if (!x || !w || !d || !bias || !out || (bn >= kBnFolded && !scale) ||
      (bn == kBnUnfolded && (!mean || !inv)))
    return (int)cudaErrorInvalidValue;
  const long long span_h = (long long)h + 2LL * pad - k;
  const long long span_w = (long long)wd + 2LL * pad - k;
  if (span_h < 0 || span_w < 0 || n == 0) return (int)cudaSuccess;
  const long long oh = span_h / stride + 1, ow = span_w / stride + 1;
  const long long m = (long long)n * oh * ow;
  const long long kdim = (long long)c * k * k;
  if (m > 0x7fffffffLL - kTileM || kdim > 0x7fffffffLL - kTileK ||
      (long long)h * wd > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long tiles_n = (o + kTileN - 1) / kTileN;
  if (tiles_n > 65535) return (int)cudaErrorInvalidValue;
  Conv p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.d = static_cast<const float*>(d);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.mean = static_cast<const float*>(mean);
  p.inv = static_cast<const float*>(inv);
  p.out = out;
  p.c = c;
  p.h = h;
  p.w_in = wd;
  p.o = o;
  p.k = k;
  p.stride = stride;
  p.pad = pad;
  p.oh = (int)oh;
  p.ow = (int)ow;
  p.kdim = (int)kdim;
  p.m = (int)m;
  p.bn = bn;
  p.act = act;
  p.out_int8 = out_int8 ? 1 : 0;
  p.w_vec = (kdim % 8 == 0) && ((reinterpret_cast<uintptr_t>(w) & 7) == 0);
  p.s_out = s_out;
  const dim3 grid((unsigned)((m + kTileM - 1) / kTileM), (unsigned)tiles_n);
  conv_int8_kernel<<<grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
