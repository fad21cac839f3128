// K5: int8 grouped and depthwise convolution with its fused epilogue, for
// Hopper (sm_90a).
//
// Replaces what the JAX package computes through XLA for a quantized
// depthwise layer or a quantized CONV2D with num_groups > 1 (there is no
// Pallas kernel for it): bcnn_tpu/ops/quant.py:302 `conv2d_int8` with
// feature_group_count > 1, then the bias or BN, the activation and the
// requantize of bcnn_tpu/compile.py:470-496 and :438-468. PyTorch has no
// int8 convolution on CUDA. From x int8 (N, C, H, W) held channels-last
// (NHWC in memory), w int8 (O, C/G, k, k) held (k, k, C/G, O) in memory
// (ops/grouped_int8.py:grouped_weight) and fp32 per-channel vectors it
// computes, with cg = C/G and og = O/G,
//   acc[n,o,p,q] = sum_{r,s,j} x[n, p*S+r-P, q*S+s-P, (o/og)*cg + j]
//                              * w[r, s, j, o]                    (int32)
// then the epilogue of int8_epilogue.cuh (dequant, BN or bias, NONE, RELU
// or LRELU) and, with s_out, the requantize: int8 channels-last, else fp32
// NCHW. The int32 sum is exact, every epilogue step rounds as the plain
// version's separate torch ops do, so the kernel is bit-equal to
// bcnn_tpu_torch/ops/grouped_int8.py:grouped_int8_fused_ref.
//
// A simple kernel: a thread computes 4 consecutive output channels (a
// quad) of one output pixel at a time, and walks `pix` pixels `rows`
// apart. A block is `quads` x `rows` threads: consecutive threads on
// consecutive quads of one pixel, so that a warp's loads and stores of a
// pixel's channels are contiguous. The block's weights (k * k * cg rows
// of 4 * quads bytes) are staged in shared memory once, where they fit in
// 48 KB (else each thread reads them from global memory). Depthwise with
// C % 4 == 0 (cg = og = 1: output channel o reads input channel o) loads
// a char4 of x and of w at each tap; other shapes load bytes. Stores are
// char4 where O % 4 == 0. The plan (quads, rows, pix, staged) comes from
// ops/grouped_int8.py:plan_grouped_int8 and is checked here.
// Left for later: a tiled, register-blocked design (several pixels a
// thread sharing each loaded x row), and the tensor cores for grouped
// convs with deep groups.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_epilogue.cuh"

namespace {

using namespace bcnn_int8;  // Chan, epilogue, requant, the codes

constexpr int kThreads = 256;          // threads a block, at most
constexpr int kMaxQuads = 64;          // quads a block, at most
constexpr int kSmemStaged = 48 * 1024;  // staged weights, bytes, at most

struct Grouped {
  const int8_t* x;
  const int8_t* w;
  const float* d;
  const float* scale;
  const float* bias;
  const float* mean;
  const float* inv;
  void* out;
  int c, h, w_in, o, k, stride, pad, oh, ow;
  int cg, og;  // input and output channels a group
  int taps;    // k * k * cg: the rows of w
  int m;       // N * OH * OW
  int bn, act, out_int8;
  float s_out;
  int quads, rows, pix, staged;  // the plan
  int o_vec;                     // char4 stores
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads) grouped_int8_kernel(Grouped p) {
  extern __shared__ __align__(16) int8_t sw[];
  const int span = 4 * p.quads;  // output channels a block
  const int tq = threadIdx.x % p.quads;
  const int tp = threadIdx.x / p.quads;
  const int o_blk = blockIdx.y * span;
  if (p.staged) {
    // row (tap * cg + j) of the block's columns [o_blk, o_blk + span)
    const int total = p.taps * span;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / span;
      const int o = o_blk + i - row * span;
      sw[i] = o < p.o ? p.w[(long long)row * p.o + o] : (int8_t)0;
    }
    __syncthreads();
  }
  const int oq = o_blk + 4 * tq;  // the thread's first output channel
  if (oq >= p.o) return;
  Chan v[4];
  int cb[4];  // first input channel of each output channel's group
  bool ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int oc = oq + e;
    ok[e] = oc < p.o;
    v[e] = ok[e] ? Chan{p.d[oc], p.bn >= kBnFolded ? p.scale[oc] : 0.f,
                        p.bias[oc], p.bn == kBnUnfolded ? p.mean[oc] : 0.f,
                        p.bn == kBnUnfolded ? p.inv[oc] : 0.f}
                 : Chan{0.f, 0.f, 0.f, 0.f, 0.f};
    cb[e] = ok[e] ? (oc / p.og) * p.cg : 0;
  }
  const int plane = p.oh * p.ow;
  const long long m0 = (long long)blockIdx.x * p.rows * p.pix + tp;
  for (int it = 0; it < p.pix; ++it) {
    const long long mm = m0 + (long long)it * p.rows;
    if (mm >= p.m) break;
    const int m = (int)mm;
    const int ni = m / plane;
    const int rem = m - ni * plane;
    const int oy = rem / p.ow;
    const int ox = rem - oy * p.ow;
    const int iy0 = oy * p.stride - p.pad;
    const int ix0 = ox * p.stride - p.pad;
    int acc[4] = {0, 0, 0, 0};
    for (int r = 0; r < p.k; ++r) {
      const int iy = iy0 + r;
      if (iy < 0 || iy >= p.h) continue;
      for (int s = 0; s < p.k; ++s) {
        const int ix = ix0 + s;
        if (ix < 0 || ix >= p.w_in) continue;
        const int8_t* xp =
            p.x + (((long long)ni * p.h + iy) * p.w_in + ix) * p.c;
        const int tap = r * p.k + s;
        if (kVec) {
          const char4 xv = *reinterpret_cast<const char4*>(xp + oq);
          const char4 wv =
              p.staged
                  ? *reinterpret_cast<const char4*>(sw + tap * span + 4 * tq)
                  : *reinterpret_cast<const char4*>(
                        p.w + (long long)tap * p.o + oq);
          acc[0] += (int)xv.x * (int)wv.x;
          acc[1] += (int)xv.y * (int)wv.y;
          acc[2] += (int)xv.z * (int)wv.z;
          acc[3] += (int)xv.w * (int)wv.w;
        } else {
          for (int j = 0; j < p.cg; ++j) {
            const int row = tap * p.cg + j;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (!ok[e]) continue;
              const int wv = p.staged
                                 ? sw[row * span + 4 * tq + e]
                                 : p.w[(long long)row * p.o + oq + e];
              acc[e] += (int)xp[cb[e] + j] * wv;
            }
          }
        }
      }
    }
    if (p.out_int8) {
      int8_t q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[e] = ok[e] ? requant(epilogue(acc[e], v[e], p.bn, p.act), p.s_out)
                     : (int8_t)0;
      int8_t* op = static_cast<int8_t*>(p.out) + (long long)m * p.o + oq;
      if (p.o_vec) {
        *reinterpret_cast<char4*>(op) = make_char4(q[0], q[1], q[2], q[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ok[e]) op[e] = q[e];
      }
    } else {
      float* op = static_cast<float*>(p.out);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (ok[e])
          op[((long long)ni * p.o + oq + e) * plane + rem] =
              epilogue(acc[e], v[e], p.bn, p.act);
    }
  }
}

}  // namespace

// Launches K5 on `stream`. x, w, d, bias and out are device pointers;
// scale with bn >= 1 and mean, inv with bn == 2, else may be null. The
// plan (ops/grouped_int8.py:plan_grouped_int8): `quads` (a power of two
// up to 64) quads of output channels and `rows` pixels a block, `pix`
// pixels a thread, the weights staged in shared memory when `staged`.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments or
// a plan it does not take.
extern "C" int bcnn_grouped_int8(const void* x, const void* w, const void* d,
                                 const void* scale, const void* bias,
                                 const void* mean, const void* inv, void* out,
                                 int n, int c, int h, int wd, int o, int k,
                                 int stride, int pad, int groups, int bn,
                                 int act, int out_int8, float s_out,
                                 int quads, int rows, int pix, int staged,
                                 void* stream) {
  if (n < 0 || c < 1 || h < 0 || wd < 0 || o < 1 || k < 1 || stride < 1 ||
      pad < 0 || groups < 1 || c % groups || o % groups || bn < kBnNone ||
      bn > kBnUnfolded || act < kActNone || act > kActLrelu ||
      (out_int8 && !(s_out > 0.f)))
    return (int)cudaErrorInvalidValue;
  if (!x || !w || !d || !bias || !out || (bn >= kBnFolded && !scale) ||
      (bn == kBnUnfolded && (!mean || !inv)))
    return (int)cudaErrorInvalidValue;
  if (quads < 1 || quads > kMaxQuads || (quads & (quads - 1)) || rows < 1 ||
      quads * rows > kThreads || pix < 1)
    return (int)cudaErrorInvalidValue;
  const long long span_h = (long long)h + 2LL * pad - k;
  const long long span_w = (long long)wd + 2LL * pad - k;
  if (span_h < 0 || span_w < 0 || n == 0) return (int)cudaSuccess;
  const long long oh = span_h / stride + 1, ow = span_w / stride + 1;
  const long long m = (long long)n * oh * ow;
  const int cg = c / groups;
  const long long taps = (long long)k * k * cg;
  if (m > 0x7fffffffLL || oh * ow > 0x7fffffffLL ||
      taps * 4 * quads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long smem = staged ? taps * 4 * quads : 0;
  if (smem > kSmemStaged) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)rows * pix;
  const long long tiles_m = (m + per_block - 1) / per_block;
  const long long tiles_q = ((o + 3) / 4 + quads - 1) / quads;
  if (tiles_m > 0x7fffffffLL || tiles_q > 65535)
    return (int)cudaErrorInvalidValue;
  const auto al4 = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 3) == 0;
  };
  Grouped p{};
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
  p.cg = cg;
  p.og = o / groups;
  p.taps = (int)taps;
  p.m = (int)m;
  p.bn = bn;
  p.act = act;
  p.out_int8 = out_int8 ? 1 : 0;
  p.s_out = s_out;
  p.quads = quads;
  p.rows = rows;
  p.pix = pix;
  p.staged = staged ? 1 : 0;
  p.o_vec = out_int8 && o % 4 == 0 && al4(out);
  const bool vec = cg == 1 && p.og == 1 && c % 4 == 0 && al4(x) && al4(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)tiles_m, (unsigned)tiles_q);
  const unsigned threads = (unsigned)(quads * rows);
  if (vec)
    grouped_int8_kernel<true><<<grid, threads, (size_t)smem, st>>>(p);
  else
    grouped_int8_kernel<false><<<grid, threads, (size_t)smem, st>>>(p);
  return (int)cudaGetLastError();
}
