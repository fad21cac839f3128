// K5: int8 grouped and depthwise convolution with its fused epilogue, for
// Hopper (sm_90a).
//
// Replaces what the JAX package computes through XLA for a quantized
// depthwise layer or a quantized CONV2D with num_groups > 1 (there is no
// Pallas kernel for it): bcnn_tpu/ops/quant.py:302 `conv2d_int8` with
// feature_group_count > 1, then the bias or BN, the activation and the
// requantize of bcnn_tpu/compile.py:470-496 and :438-468. PyTorch has no
// int8 convolution on CUDA. From x int8 (N, C, H, W) held channels-last
// (NHWC in memory), w int8 (O, C/G, k, k) held (k, k, O, C/G) in memory
// (ops/grouped_int8.py:grouped_weight: a group's input channels are
// contiguous for each tap and output channel; for depthwise, C/G = 1,
// the same memory as (k, k, 1, O)) and fp32 per-channel vectors it
// computes, with cg = C/G and og = O/G,
//   acc[n,o,p,q] = sum_{r,s,j} x[n, p*S+r-P, q*S+s-P, (o/og)*cg + j]
//                              * w[r, s, o, j]                    (int32)
// then the epilogue of int8_epilogue.cuh (dequant, BN or bias, NONE, RELU
// or LRELU) and, with s_out, the requantize: int8 channels-last, else fp32
// NCHW. The int32 sum is exact, every epilogue step rounds as the plain
// version's separate torch ops do, and the requantize's shortcut
// (requant_bits) gives requant's code, so the kernel is bit-equal to
// bcnn_tpu_torch/ops/grouped_int8.py:grouped_int8_fused_ref.
//
// What bounds it. MobileNet-v1's nine depthwise shapes move 319.5 MB of
// int8 a batch-64 forward: 95.4 us at 3.35 TB/s. They are 1.11 G
// multiply-adds (MACs); at 64 integer multiply-adds a clock per SM (132
// SMs, about 1.98 GHz: 16.7 T/s) one instruction a MAC alone would take
// about 66 us, and the epilogue (dequant, bias, activation, requantize)
// runs once per 9 MACs. So the integer issue rate binds nearly as tightly
// as the bytes, and the design counts instructions per MAC.
//
// The grid walks (image, output row, strip) directly: block (lanes,
// strips, rows), grid (N * strip tiles, row bands, lane tiles); one
// division a thread, none a pixel; offsets are 32-bit (the launcher
// refuses a tensor of 2^31 bytes or more). A thread computes a strip of
// adjacent output pixels along one row for the channels of its lane.
// ops/grouped_int8.py:plan_grouped_int8 names the branch and the block
// (fit to a sweep on the card, tools/k5_compare.py --sweep); the
// launcher checks both. The branches:
//
// kDw: depthwise (cg = og = 1), k = 3, stride 1 or 2, C % 16 == 0, the
//   requantize's shortcut on. A lane is 16 consecutive channels, so each
//   x column and each output pixel is one 16-byte access and a warp's
//   accesses are contiguous in NHWC. A strip is 2 pixels (4 cost twice
//   the registers and ran slower). Option (c) of the design: __dp4a over
//   the 3 taps of one kernel row of one channel. The block stages its
//   lanes' weights once in shared memory, as words [w0, w1, w2, 0] and [0,
//   w0, w1, w2] per channel, kernel row and quad of channels (dw_weights:
//   8 byte_perms a quad). Per kernel row a thread loads its strip's
//   stride + 3 x columns once (row 0's before the stage, so the loads
//   overlap it) and per quad transposes 4 columns x 4 channels in
//   registers (8 byte_perms) into a word of 4 consecutive columns per
//   channel; one __dp4a of that word with [w0, w1, w2, 0] is one output's
//   row sum, and with [0, w0, w1, w2] the next output's (stride 1). Every
//   loaded x column serves each tap and output of the strip that reads
//   it. Measured (SASS of the int8 path, tools/k5_compare.py --ptxas):
//   the sums take 0.94 instructions a MAC (__dp4a, byte_perm, shared
//   loads) at stride 1 and 1.15 at stride 2, where PR 12's kernel took
//   about 3 (two byte unpacks and an IMAD); the whole int8 path about 3.8
//   a MAC, most of it the epilogue. The epilogue and the activation
//   are compiled per BN mode and activation (9 kernels a stride), its
//   vectors are 16-byte loads once a thread. No shared-memory stage of x:
//   the halo columns come from L1 (neighbouring strips of a warp) and the
//   halo rows from L1 or L2 (the blocks run through the rows in order and
//   a layer's x is at most 25.7 MB), so each input byte comes from device
//   memory about once without one.
// kG16 / kG4: grouped with cg % 16 == 0 (or cg % 4 == 0) and og % 4 ==
//   0. A lane is 4 output channels of one group; per tap and 16 (or 4) of
//   the group's input channels a thread loads its strip's x columns and
//   the 4 channels' weights (contiguous in the (k, k, O, C/G) layout) and
//   runs 4 x strip __dp4a per word: 4 MACs an instruction, each x load
//   shared by 4 output channels and each w load by the strip's pixels.
//   __dp4a and not the tensor cores: the sums stay in the lane's registers
//   with no shared-memory stage or fragment layout, and the grouped shapes
//   the port runs are small (797 M MACs on the (8, 256, 26, 26) 4-group
//   shape, about 12 us of __dp4a at 64 a clock per SM).
// kBytes: everything else (C % 16 != 0, k != 3, channel multipliers,
//   stride > 2, misaligned tensors, the shortcut off): a lane is 4 output
//   channels, byte loads, int multiply-adds; bit-equal, not fast.
//
// Requantize (int8_epilogue.cuh): t = y * (1 / s), rounded by adding 1.5
// * 2^23, the code the low byte of the sum; within 2^-15 of a
// half-integer (rare) an exact decision without a division.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "int8_epilogue.cuh"

namespace {

using namespace bcnn_int8;  // Chan, epilogue and the requantizes

constexpr int kThreads = 256;  // threads a block, at most
enum { kDw = 0, kG16 = 1, kG4 = 2, kBytes = 3 };

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
  int bn, act, out_int8;
  float s_out, inv_s;  // inv_s: 1 / s_out, or 0 (no shortcut)
  int s;               // pixels a strip (kBytes reads it; the others' S)
  int lanes;           // lanes in all
  int strip_tiles;     // blocks along a row's strips
};

__device__ __forceinline__ unsigned word(const int4& v, int q) {
  return (unsigned)(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w);
}

// 4 words of 4 bytes (a.b = byte b of word a) transposed:
// e[i] = [a.i, b.i, c.i, d.i]
__device__ __forceinline__ void transpose4(unsigned a, unsigned b, unsigned c,
                                           unsigned d, unsigned e[4]) {
  const unsigned t0 = __byte_perm(a, b, 0x6240);  // a0 b0 a2 b2
  const unsigned t1 = __byte_perm(a, b, 0x7351);  // a1 b1 a3 b3
  const unsigned t2 = __byte_perm(c, d, 0x6240);
  const unsigned t3 = __byte_perm(c, d, 0x7351);
  e[0] = __byte_perm(t0, t2, 0x5410);
  e[1] = __byte_perm(t1, t3, 0x5410);
  e[2] = __byte_perm(t0, t2, 0x7632);
  e[3] = __byte_perm(t1, t3, 0x7632);
}

// output channels o..o+3's vectors, 16-byte loads (kDw: every address
// a multiple of 16); kBn fixed
template <int kBn>
__device__ __forceinline__ void chan4(const Grouped& p, int o, Chan v[4]) {
  const auto ld4 = [&](const float* a) {
    return __ldg(reinterpret_cast<const float4*>(a + o));
  };
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 d = ld4(p.d), b = ld4(p.bias);
  const float4 sc = kBn >= kBnFolded ? ld4(p.scale) : z;
  const float4 m = kBn == kBnUnfolded ? ld4(p.mean) : z;
  const float4 iv = kBn == kBnUnfolded ? ld4(p.inv) : z;
  v[0] = Chan{d.x, sc.x, b.x, m.x, iv.x};
  v[1] = Chan{d.y, sc.y, b.y, m.y, iv.y};
  v[2] = Chan{d.z, sc.z, b.z, m.z, iv.z};
  v[3] = Chan{d.w, sc.w, b.w, m.w, iv.w};
}

// output channel o's vectors (bn: p.bn, or the same fixed at compile time)
__device__ __forceinline__ Chan chan(const Grouped& p, int o, int bn) {
  return Chan{__ldg(p.d + o), bn >= kBnFolded ? __ldg(p.scale + o) : 0.f,
              __ldg(p.bias + o), bn == kBnUnfolded ? __ldg(p.mean + o) : 0.f,
              bn == kBnUnfolded ? __ldg(p.inv + o) : 0.f};
}

// the low bytes of 4 codes as one word
__device__ __forceinline__ unsigned pack4(int q0, int q1, int q2, int q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                     0x5410);
}

// The epilogue of 4 output channels o0.. of pixel m (= (n * oh + oy) * ow
// + ox) from their sums: an int8 word at m * O + o0 (aligned: O % 4 == 0),
// or 4 fp32 values into NCHW.
__device__ __forceinline__ void store4(const Grouped& p, const Chan v[4],
                                       const int acc[4], int n, int oy,
                                       int ox, int o0) {
  if (p.out_int8) {
    int q[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q[e] = requant_bits(epilogue(acc[e], v[e], p.bn, p.act), p.s_out,
                          p.inv_s);
    const int m = (n * p.oh + oy) * p.ow + ox;
    *reinterpret_cast<unsigned*>(static_cast<int8_t*>(p.out) + m * p.o +
                                 o0) = pack4(q[0], q[1], q[2], q[3]);
  } else {
    float* op = static_cast<float*>(p.out);
    const int plane = p.oh * p.ow;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[(n * p.o + o0 + e) * plane + oy * p.ow + ox] =
          epilogue(acc[e], v[e], p.bn, p.act);
  }
}

// kDw's weights, made once a block by dw_weights: for each of the
// block's lanes, kernel row r and quad q, the 4 channels' taps as [w0,
// w1, w2, 0] (A) and [0, w0, w1, w2] (B), one 16-byte word each; word
// ((r * 4 + q) * 2 + ab) * lanes + lane, so that a warp's lanes read
// consecutive words.
constexpr int kDwLanes = 64;  // lanes a kDw block, at most
constexpr int kDwWords = 3 * 4 * 2;  // 16-byte words a lane

__device__ __forceinline__ void dw_weights(const Grouped& p, uint4* sab) {
  const int lanes = blockDim.x;
  const int tid = threadIdx.x + lanes * (threadIdx.y + blockDim.y *
                                         threadIdx.z);
  const int nthreads = lanes * blockDim.y * blockDim.z;
  for (int t = tid; t < 3 * lanes; t += nthreads) {
    const int r = t / lanes, l = t - r * lanes;
    const int lane = blockIdx.z * lanes + l;
    if (lane >= p.lanes) continue;
    int4 wt[3];  // taps (r, 0..2) of the 16 channels: (3, 3, 1, C) memory
#pragma unroll
    for (int s = 0; s < 3; ++s)
      wt[s] = __ldg(reinterpret_cast<const int4*>(p.w + (r * 3 + s) * p.c +
                                                  16 * lane));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned a[4];  // channel e's taps [w0, w1, w2, 0]
      transpose4(word(wt[0], q), word(wt[1], q), word(wt[2], q), 0u, a);
      sab[((r * 4 + q) * 2) * lanes + l] = make_uint4(a[0], a[1], a[2], a[3]);
      sab[((r * 4 + q) * 2 + 1) * lanes + l] =
          make_uint4(a[0] << 8, a[1] << 8, a[2] << 8, a[3] << 8);
    }
  }
}

constexpr int kDwS = 2;  // kDw's pixels a strip

// kernel row r's x columns of kDw's strip (stride + 3 of them, zeros
// outside the image): the row's base is one 32-bit offset, then ix * C a
// column.
template <int kStride>
__device__ __forceinline__ void dw_columns(const Grouped& p, int n, int oy,
                                           int ox0, int lane, int r,
                                           int4 (&xc)[kStride + 3]) {
  const int iy = oy * kStride - p.pad + r;
  const bool row_ok = iy >= 0 && iy < p.h;
  const int8_t* xrow = p.x + (n * p.h + iy) * p.w_in * p.c + 16 * lane;
  const int ix0 = ox0 * kStride - p.pad;
  if (row_ok && ix0 >= 0 && ix0 + kStride + 3 <= p.w_in) {
    // a strip inside the row: no column checks
    const int8_t* xp = xrow + ix0 * p.c;
#pragma unroll
    for (int cc = 0; cc < kStride + 3; ++cc)
      xc[cc] = __ldg(reinterpret_cast<const int4*>(xp + cc * p.c));
    return;
  }
#pragma unroll
  for (int cc = 0; cc < kStride + 3; ++cc) {
    const int ix = ix0 + cc;
    xc[cc] = row_ok && ix >= 0 && ix < p.w_in
                 ? __ldg(reinterpret_cast<const int4*>(xrow + ix * p.c))
                 : make_int4(0, 0, 0, 0);
  }
}

// kDw: a strip of kDwS = 2 outputs at (n, oy, ox0..), the 16 channels of
// `lane` (l within the block), the block's weights in sab, kernel row 0's
// x columns in x0 (loaded before the block's weights were ready); kBn and
// kAct fixed, so the epilogue has no branch.
template <int kStride, int kBn, int kAct>
__device__ __forceinline__ void dw_strip(const Grouped& p, const uint4* sab,
                                         int n, int oy, int ox0, int lane,
                                         int l,
                                         const int4 (&x0)[kStride + 3]) {
  constexpr int S = kDwS;
  constexpr int kCols = kStride + 3;  // x columns the strip reads
  const int lanes = blockDim.x;
  const int c16 = 16 * lane;
  int acc[S][16];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[j][i] = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    int4 xc[kCols];
    if (r == 0) {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) xc[cc] = x0[cc];
    } else {
      dw_columns<kStride>(p, n, oy, ox0, lane, r, xc);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 a4 = sab[((r * 4 + q) * 2) * lanes + l];
      const unsigned a[4] = {a4.x, a4.y, a4.z, a4.w};
      // column cc of the strip as a word of channels 4q..4q+3 (a column
      // past the strip meets a zero tap)
      const auto col = [&](int cc) {
        return cc < kCols ? word(xc[cc], q) : 0u;
      };
      unsigned t0[4];
      transpose4(col(0), col(1), col(2), col(3), t0);
      if constexpr (kStride == 1) {
        const uint4 b4 = sab[((r * 4 + q) * 2 + 1) * lanes + l];
        const unsigned b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][4 * q + e] = __dp4a((int)t0[e], (int)a[e], acc[0][4 * q + e]);
          acc[1][4 * q + e] = __dp4a((int)t0[e], (int)b[e], acc[1][4 * q + e]);
        }
      } else {
        unsigned t2[4];
        transpose4(col(2), col(3), col(4), col(5), t2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][4 * q + e] = __dp4a((int)t0[e], (int)a[e], acc[0][4 * q + e]);
          acc[1][4 * q + e] = __dp4a((int)t2[e], (int)a[e], acc[1][4 * q + e]);
        }
      }
    }
  }
  const int left = p.ow - ox0;  // outputs of the strip inside the row
  if (p.out_int8) {  // int8 channels-last: the shortcut's codes
    constexpr int kPre = kAct == kActRelu ? kActNone : kAct;
    bool bad = false;
    unsigned res[S][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Chan v[4];
      chan4<kBn>(p, c16 + 4 * q, v);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        int cq[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = epilogue(acc[j][4 * q + e], v[e], kBn, kPre);
          cq[e] = kAct == kActRelu ? requant_fast<0>(y, p.inv_s, bad)
                                   : requant_fast(y, p.inv_s, bad);
        }
        res[j][q] = pack4(cq[0], cq[1], cq[2], cq[3]);
      }
    }
    if (bad) {
      // a code near a half-integer (rare): the strip's codes again with
      // requant_bits' exact decision
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        Chan v[4];
        chan4<kBn>(p, c16 + 4 * q, v);
#pragma unroll
        for (int j = 0; j < S; ++j) {
          int cq[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cq[e] = requant_exact(
                epilogue(acc[j][4 * q + e], v[e], kBn, kAct), p.s_out,
                p.inv_s);
          res[j][q] = pack4(cq[0], cq[1], cq[2], cq[3]);
        }
      }
    }
    int8_t* orow = static_cast<int8_t*>(p.out) +
                   ((n * p.oh + oy) * p.ow + ox0) * p.o + c16;
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (j < left)
        *reinterpret_cast<int4*>(orow + j * p.o) =
            make_int4((int)res[j][0], (int)res[j][1], (int)res[j][2],
                      (int)res[j][3]);
  } else {
    // fp32 NCHW: channel o's plane, row oy, columns ox0..
    float* orow = static_cast<float*>(p.out) + (n * p.o + c16) * p.oh * p.ow +
                  oy * p.ow + ox0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Chan v[4];
      chan4<kBn>(p, c16 + 4 * q, v);
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (j < left)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            orow[(4 * q + e) * p.oh * p.ow + j] =
                epilogue(acc[j][4 * q + e], v[e], kBn, kAct);
    }
  }
}

// kG16 / kG4: a strip of S outputs, the 4 output channels of `lane` (one
// group), the group's input channels VB at a time.
template <int S, int VB>
__device__ __forceinline__ void grouped_strip(const Grouped& p, int n, int oy,
                                              int ox0, int lane) {
  using Vec = typename std::conditional<VB == 16, int4, int>::type;
  constexpr int kWords = VB / 4;
  const int o0 = 4 * lane;
  const int cb = (o0 / p.og) * p.cg;  // the group's first input channel
  int acc[S][4];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  const auto wd = [](const Vec& v, int u) {
    if constexpr (VB == 16) {
      return (int)word(v, u);
    } else {
      return v;
    }
  };
  for (int r = 0; r < p.k; ++r) {
    const int iy = oy * p.stride - p.pad + r;
    if (iy < 0 || iy >= p.h) continue;
    const int8_t* xrow = p.x + (n * p.h + iy) * p.w_in * p.c + cb;
    for (int s = 0; s < p.k; ++s) {
      const int ix0 = ox0 * p.stride - p.pad + s;
      const int8_t* wp = p.w + ((r * p.k + s) * p.o + o0) * p.cg;
      for (int j0 = 0; j0 < p.cg; j0 += VB) {
        Vec xv[S], wv[4];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int ix = ix0 + j * p.stride;
          xv[j] = ix >= 0 && ix < p.w_in
                      ? __ldg(reinterpret_cast<const Vec*>(xrow + ix * p.c +
                                                           j0))
                      : Vec{};
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[e] = __ldg(reinterpret_cast<const Vec*>(wp + e * p.cg + j0));
#pragma unroll
        for (int u = 0; u < kWords; ++u)
#pragma unroll
          for (int j = 0; j < S; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[j][e] = __dp4a(wd(xv[j], u), wd(wv[e], u), acc[j][e]);
      }
    }
  }
  Chan v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = chan(p, o0 + e, p.bn);
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (ox0 + j < p.ow) store4(p, v, acc[j], n, oy, ox0 + j, o0);
}

// kBytes: a strip of p.s outputs, output channels 4 lane.. (masked to O),
// byte loads.
__device__ __forceinline__ void bytes_strip(const Grouped& p, int n, int oy,
                                            int ox0, int lane) {
  const int o0 = 4 * lane;
  bool ok[4];
  int cb[4];  // first input channel of each output channel's group
  Chan v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ok[e] = o0 + e < p.o;
    cb[e] = ok[e] ? ((o0 + e) / p.og) * p.cg : 0;
    v[e] = ok[e] ? chan(p, o0 + e, p.bn) : Chan{0.f, 0.f, 0.f, 0.f, 0.f};
  }
  const int plane = p.oh * p.ow;
  for (int j = 0; j < p.s && ox0 + j < p.ow; ++j) {
    const int ox = ox0 + j;
    int acc[4] = {0, 0, 0, 0};
    for (int r = 0; r < p.k; ++r) {
      const int iy = oy * p.stride - p.pad + r;
      if (iy < 0 || iy >= p.h) continue;
      for (int s = 0; s < p.k; ++s) {
        const int ix = ox * p.stride - p.pad + s;
        if (ix < 0 || ix >= p.w_in) continue;
        const int8_t* xp = p.x + ((n * p.h + iy) * p.w_in + ix) * p.c;
        const int8_t* wp = p.w + (r * p.k + s) * p.o * p.cg;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!ok[e]) continue;
          for (int jj = 0; jj < p.cg; ++jj)
            acc[e] += (int)xp[cb[e] + jj] * (int)wp[(o0 + e) * p.cg + jj];
        }
      }
    }
    const int m = (n * p.oh + oy) * p.ow + ox;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!ok[e]) continue;
      const float y = epilogue(acc[e], v[e], p.bn, p.act);
      if (p.out_int8)
        static_cast<int8_t*>(p.out)[m * p.o + o0 + e] =
            (int8_t)requant_bits(y, p.s_out, p.inv_s);
      else
        static_cast<float*>(p.out)[(n * p.o + o0 + e) * plane +
                                   oy * p.ow + ox] = y;
    }
  }
}

// kBn and kAct: kDw's epilogue, fixed (the other branches read p.bn and
// p.act)
template <int kBranch, int S, int kStride, int kBn, int kAct>
__global__ void __launch_bounds__(kThreads) grouped_int8_kernel(Grouped p) {
  const int n = blockIdx.x / p.strip_tiles;
  const int strip =
      (blockIdx.x - n * p.strip_tiles) * blockDim.y + threadIdx.y;
  const int oy = blockIdx.y * blockDim.z + threadIdx.z;
  const int lane = blockIdx.z * blockDim.x + threadIdx.x;
  const int ox0 = strip * p.s;
  if constexpr (kBranch == kDw) {
    // kernel row 0's loads go out before the block's weights are staged
    // (all three rows' would cost occupancy: 104 registers, not 80)
    extern __shared__ uint4 sab[];  // kDwWords a lane
    const bool ok = ox0 < p.ow && oy < p.oh && lane < p.lanes;
    int4 x0[kStride + 3];
    dw_columns<kStride>(p, n, ok ? oy : -p.h, ox0, lane, 0, x0);
    dw_weights(p, sab);
    __syncthreads();
    if (!ok) return;
    dw_strip<kStride, kBn, kAct>(p, sab, n, oy, ox0, lane, threadIdx.x, x0);
    return;
  }
  if (ox0 >= p.ow || oy >= p.oh || lane >= p.lanes) return;
  if constexpr (kBranch == kG16)
    grouped_strip<S, 16>(p, n, oy, ox0, lane);
  else if constexpr (kBranch == kG4)
    grouped_strip<S, 4>(p, n, oy, ox0, lane);
  else
    bytes_strip(p, n, oy, ox0, lane);
}

template <int kStride, int kBn>
void launch_dw_act(int act, dim3 grid, dim3 block, cudaStream_t st,
                   const Grouped& p) {
  const size_t smem = sizeof(uint4) * kDwWords * block.x;
  if (act == kActRelu)
    grouped_int8_kernel<kDw, kDwS, kStride, kBn, kActRelu>
        <<<grid, block, smem, st>>>(p);
  else if (act == kActLrelu)
    grouped_int8_kernel<kDw, kDwS, kStride, kBn, kActLrelu>
        <<<grid, block, smem, st>>>(p);
  else
    grouped_int8_kernel<kDw, kDwS, kStride, kBn, kActNone>
        <<<grid, block, smem, st>>>(p);
}

template <int kStride>
void launch_dw(int bn, int act, dim3 grid, dim3 block, cudaStream_t st,
               const Grouped& p) {
  if (bn == kBnUnfolded)
    launch_dw_act<kStride, kBnUnfolded>(act, grid, block, st, p);
  else if (bn == kBnFolded)
    launch_dw_act<kStride, kBnFolded>(act, grid, block, st, p);
  else
    launch_dw_act<kStride, kBnNone>(act, grid, block, st, p);
}

// the largest power of two up to 16 that divides every address
int alignment(const void* const* ptrs, int count) {
  uintptr_t bits = 16;
  for (int i = 0; i < count; ++i)
    if (ptrs[i]) bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return (int)(bits & (~bits + 1));
}

}  // namespace

// K5's branch for a shape (the rules of ops/grouped_int8.py:k5_branch):
// kDw, kG16, kG4 or kBytes; `shortcut`: fp32 out, or 1 / s_out normal
// (kDw's requantize never divides).
extern "C" int bcnn_grouped_int8_branch(int c, int o, int k, int stride,
                                        int groups, int align,
                                        int shortcut) {
  const int cg = c / groups, og = o / groups;
  if (cg == 1 && og == 1 && c % 16 == 0 && k == 3 &&
      (stride == 1 || stride == 2) && align >= 16 && shortcut)
    return kDw;
  if (og % 4 == 0 && cg % 16 == 0 && align >= 16) return kG16;
  if (og % 4 == 0 && cg % 4 == 0 && align >= 4) return kG4;
  return kBytes;
}

// Launches K5 on `stream`. x, w, d, bias and out are device pointers;
// scale with bn >= 1 and mean, inv with bn == 2, else may be null. The
// plan (ops/grouped_int8.py:plan_grouped_int8): `branch` (it must be the
// one bcnn_grouped_int8_branch gives for these shapes and addresses), `s`
// pixels a strip (2 or 4; kBytes also 1), a block of `lanes` x `strips` x
// `rows` threads (at most 256). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments or a plan it does not take.
extern "C" int bcnn_grouped_int8(const void* x, const void* w, const void* d,
                                 const void* scale, const void* bias,
                                 const void* mean, const void* inv, void* out,
                                 int n, int c, int h, int wd, int o, int k,
                                 int stride, int pad, int groups, int bn,
                                 int act, int out_int8, float s_out,
                                 int branch, int s, int lanes, int strips,
                                 int rows, void* stream) {
  if (n < 0 || c < 1 || h < 0 || wd < 0 || o < 1 || k < 1 || stride < 1 ||
      pad < 0 || groups < 1 || c % groups || o % groups || bn < kBnNone ||
      bn > kBnUnfolded || act < kActNone || act > kActLrelu ||
      (out_int8 && !(s_out > 0.f)))
    return (int)cudaErrorInvalidValue;
  if (!x || !w || !d || !bias || !out || (bn >= kBnFolded && !scale) ||
      (bn == kBnUnfolded && (!mean || !inv)))
    return (int)cudaErrorInvalidValue;
  const long long span_h = (long long)h + 2LL * pad - k;
  const long long span_w = (long long)wd + 2LL * pad - k;
  if (span_h < 0 || span_w < 0 || n == 0) return (int)cudaSuccess;
  const long long oh = span_h / stride + 1, ow = span_w / stride + 1;
  const int cg = c / groups;
  // every offset 32-bit
  if ((long long)n * h * wd * c > 0x7fffffffLL ||
      (long long)n * oh * ow * o > 0x7fffffffLL ||
      (long long)k * k * o * cg > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {x, w, d, scale, bias, mean, inv, out};
  // the requantize's shortcut needs 1 / s normal (int8_epilogue.cuh)
  const float inv_s = out_int8 ? 1.0f / s_out : 0.f;
  const bool shortcut = std::isnormal(inv_s);
  if (branch != bcnn_grouped_int8_branch(c, o, k, stride, groups,
                                         alignment(ptrs, 8),
                                         !out_int8 || shortcut))
    return (int)cudaErrorInvalidValue;
  const bool s_ok = branch == kDw    ? s == 2
                   : branch == kBytes ? s == 1 || s == 2 || s == 4
                                      : s == 2 || s == 4;
  if (!s_ok || lanes < 1 || strips < 1 || rows < 1 ||
      (long long)lanes * strips * rows > kThreads ||
      (branch == kDw && lanes > kDwLanes))
    return (int)cudaErrorInvalidValue;
  const long long lanes_all = branch == kDw ? c / 16 : (o + 3) / 4;
  const long long strip_tiles = ((ow + s - 1) / s + strips - 1) / strips;
  const long long row_tiles = (oh + rows - 1) / rows;
  const long long lane_tiles = (lanes_all + lanes - 1) / lanes;
  if (n * strip_tiles > 0x7fffffffLL || row_tiles > 65535 ||
      lane_tiles > 65535)
    return (int)cudaErrorInvalidValue;
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
  p.bn = bn;
  p.act = act;
  p.out_int8 = out_int8 ? 1 : 0;
  p.s_out = s_out;
  p.inv_s = shortcut ? inv_s : 0.f;
  p.s = s;
  p.lanes = (int)lanes_all;
  p.strip_tiles = (int)strip_tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(n * strip_tiles), (unsigned)row_tiles,
                  (unsigned)lane_tiles);
  const dim3 block((unsigned)lanes, (unsigned)strips, (unsigned)rows);
  const bool s4 = s == 4;
  if (branch == kDw && stride == 1)
    launch_dw<1>(bn, act, grid, block, st, p);
  else if (branch == kDw)
    launch_dw<2>(bn, act, grid, block, st, p);
  else if (branch == kG16)
    s4 ? grouped_int8_kernel<kG16, 4, 1, -1, -1><<<grid, block, 0, st>>>(p)
       : grouped_int8_kernel<kG16, 2, 1, -1, -1><<<grid, block, 0, st>>>(p);
  else if (branch == kG4)
    s4 ? grouped_int8_kernel<kG4, 4, 1, -1, -1><<<grid, block, 0, st>>>(p)
       : grouped_int8_kernel<kG4, 2, 1, -1, -1><<<grid, block, 0, st>>>(p);
  else
    grouped_int8_kernel<kBytes, 1, 1, -1, -1><<<grid, block, 0, st>>>(p);
  return (int)cudaGetLastError();
}
