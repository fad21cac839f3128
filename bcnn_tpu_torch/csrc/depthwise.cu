// K3: depthwise k x k convolution + bias + activation in one pass, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bcnn_tpu/ops/dw_pallas.py:depthwise_fused
// (dw_pallas.py:139, the pallas_call at :166). For x (N, C, H, W) fp32,
// w (C, 1, k, k) and b (C,) it writes y (N, C, OH, OW),
//   y[n,c,i,j] = act(b[c] + sum_{r,q} w[c,0,r,q] * x[n,c, i*s-p+r, j*s-p+q])
// with zeros outside the image, OH = (H + 2p - k)/s + 1 (OW alike), for
// any k >= 1, stride s >= 1 and pad p >= 0; act is NONE, RELU, LRELU
// (slope 0.1) or CLAMP [0, 1]. The plain PyTorch version is
// bcnn_tpu_torch/ops/depthwise.py:depthwise_fused_ref: the grouped conv,
// then + b, then the activation, three passes over the output.
//
// What bounds it: bytes. A 3x3 output is 9 multiply-adds (18 flops) for
// one 4-byte read (at stride 1) and one 4-byte write: about 2 flops a
// byte, a tenth of the card's fp32 ridge. So the target is one read of x
// and one write of y. Design: a block of 256 threads computes a tile of
// output rows and columns of g (n, c) planes: it stages the tile's input
// with its halo (zeros where the window leaves the image) and the planes'
// weights and biases in shared memory, with neighbouring threads on
// neighbouring columns, so every global read and write is coalesced and
// each input is read from device memory about once (the halo rows shared
// by two tiles come from L2). The staging uses cp.async, so a thread
// starts all its loads before any arrives: with plain loads, each stored
// to shared memory before the next was started, only some 6 KB per SM were
// in flight and the kernel ran at under 1 TB/s. Then each thread computes
// outputs of one row from shared memory, neighbouring threads on
// neighbouring x, and applies bias and activation before its single
// store. Tiles aim at 2048 outputs: a band of rows of a large plane, a
// multiple of the block's rows of threads so that each does the same
// work (112 x 112 takes 16 rows), or several whole small planes per
// block (7 x 7 planes go 41 to a block), so no width leaves most threads
// idle. Only the strided outputs are computed. k = 3 is compiled with its
// taps unrolled; other k run the same code with the loop bounds at run
// time.
//
// Left behind from the TPU kernel: whole-image VMEM blocks, the pad made
// in registers, stride 2 computed at stride 1 and subsampled, the 8-image
// groups, and the C % 128 gate with its VMEM budget: any C goes here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetOutputs = 2048;         // outputs per block
constexpr long long kSmemBytes = 48 * 1024;  // no opt-in needed below this

enum Act { kNone = 0, kRelu = 1, kLrelu = 2, kClamp = 3 };

struct Tile {
  int planes, chans;       // n * c, c
  int h, w, oh, ow;
  int k, stride, pad, act;
  int g, th, tw;           // planes, output rows and columns per block
  int rows_in, cols_in;    // (th - 1) * s + k, (tw - 1) * s + k
  int tiles_h, tiles_w;
};

// 4-byte asynchronous copy from device to shared memory (sm_80+); with
// `valid` false it reads nothing and writes 0. The issuing thread does not
// wait for it, so all of a block's staging loads are in flight together.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kLrelu: return v > 0.f ? v : 0.1f * v;
    case kClamp: return fminf(fmaxf(v, 0.f), 1.f);
    default: return v;
  }
}

// grid: one block per (group of g planes, row tile, column tile), column
// tile fastest; block (bx, by) with bx * by = kThreads, x along columns.
// Shared memory: g input tiles of rows_in x cols_in, g * k * k weights,
// g biases.
template <int K>
__global__ void __launch_bounds__(kThreads)
depthwise_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y, Tile t) {
  extern __shared__ float smem[];
  const int k = K > 0 ? K : t.k;
  const int kk = k * k;
  int blk = blockIdx.x;
  const int tw_i = blk % t.tiles_w;
  blk /= t.tiles_w;
  const int th_i = blk % t.tiles_h;
  const int plane0 = (blk / t.tiles_h) * t.g;
  const int g_n = min(t.g, t.planes - plane0);
  float* tile = smem;
  float* wts = tile + t.g * t.rows_in * t.cols_in;
  float* bias = wts + t.g * kk;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < g_n * kk; e += kThreads) {
    const int gi = e / kk;
    wts[e] = w[(long long)((plane0 + gi) % t.chans) * kk + (e - gi * kk)];
  }
  for (int e = tid; e < g_n; e += kThreads)
    bias[e] = b[(plane0 + e) % t.chans];

  // stage the input tiles, zeros outside the image
  const int iy0 = th_i * t.th * t.stride - t.pad;
  const int ix0 = tw_i * t.tw * t.stride - t.pad;
  for (int rr = threadIdx.y; rr < g_n * t.rows_in; rr += blockDim.y) {
    const int gi = rr / t.rows_in;
    const int iy = iy0 + (rr - gi * t.rows_in);
    const bool row_ok = iy >= 0 && iy < t.h;
    const float* src =
        x + ((long long)(plane0 + gi) * t.h + (row_ok ? iy : 0)) * t.w;
    float* dst = tile + rr * t.cols_in;
    for (int q = threadIdx.x; q < t.cols_in; q += blockDim.x) {
      const int ix = ix0 + q;
      const bool ok = row_ok && ix >= 0 && ix < t.w;
      cp_async4(dst + q, ok ? src + ix : src, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int oy0 = th_i * t.th;
  const int ox0 = tw_i * t.tw;
  const int th_n = min(t.th, t.oh - oy0);
  const int tw_n = min(t.tw, t.ow - ox0);
  for (int rr = threadIdx.y; rr < g_n * th_n; rr += blockDim.y) {
    const int gi = rr / th_n;
    const int oy = rr - gi * th_n;
    const float* trow = tile + (gi * t.rows_in + oy * t.stride) * t.cols_in;
    const float* wg = wts + gi * kk;
    const float bg = bias[gi];
    float* out =
        y + ((long long)(plane0 + gi) * t.oh + oy0 + oy) * t.ow + ox0;
    for (int ox = threadIdx.x; ox < tw_n; ox += blockDim.x) {
      const float* tp = trow + ox * t.stride;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < k; ++r) {
#pragma unroll
        for (int q = 0; q < k; ++q)
          acc = fmaf(tp[r * t.cols_in + q], wg[r * k + q], acc);
      }
      out[ox] = activate(acc + bg, t.act);
    }
  }
}

long long smem_bytes(const Tile& t, long long th, long long tw, long long g) {
  const long long rows = (th - 1) * t.stride + t.k;
  const long long cols = (tw - 1) * t.stride + t.k;
  return 4 * g * (rows * cols + (long long)t.k * t.k + 1);
}

}  // namespace

// x (n, c, h, w), w (c, 1, k, k), b (c,) and y (n, c, oh, ow): fp32,
// contiguous, on the device; y allocated by the caller. act: 0 NONE,
// 1 RELU, 2 LRELU, 3 CLAMP. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take (a k x k window too large for shared memory among them).
extern "C" int bcnn_depthwise(const void* x, const void* w, const void* b,
                              void* y, int n, int c, int h, int wd, int k,
                              int stride, int pad, int act, void* stream) {
  if (n < 0 || c < 0 || h < 0 || wd < 0 || k < 1 || stride < 1 || pad < 0 ||
      act < kNone || act > kClamp)
    return (int)cudaErrorInvalidValue;
  const long long span_h = (long long)h + 2LL * pad - k;
  const long long span_w = (long long)wd + 2LL * pad - k;
  const long long planes = (long long)n * c;
  if (span_h < 0 || span_w < 0 || planes == 0) return (int)cudaSuccess;
  if (planes > 0x7fffffffLL || (long long)h * wd > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Tile t{};
  t.planes = (int)planes;
  t.chans = c;
  t.h = h;
  t.w = wd;
  t.oh = (int)(span_h / stride + 1);
  t.ow = (int)(span_w / stride + 1);
  t.k = k;
  t.stride = stride;
  t.pad = pad;
  t.act = act;

  // tile: up to 128 output columns, rows to make kTargetOutputs, and
  // whole small planes grouped; halved until shared memory holds it
  long long tw = t.ow < 128 ? t.ow : 128;
  long long th = kTargetOutputs / tw;
  th = th < 1 ? 1 : (th > t.oh ? t.oh : th);
  long long g = 1;
  if (th == t.oh && tw == t.ow) {
    g = kTargetOutputs / ((long long)t.oh * t.ow);
    g = g < 1 ? 1 : (g > planes ? planes : g);
  }
  while (smem_bytes(t, th, tw, g) > kSmemBytes) {
    if (g > 1)
      g = (g + 1) / 2;
    else if (th > 1)
      th = (th + 1) / 2;
    else if (tw > 1)
      tw = (tw + 1) / 2;
    else
      return (int)cudaErrorInvalidValue;
  }
  // even out the column tiles without adding any; threads: bx columns
  // (a power of two up to a warp) by kThreads / bx rows
  t.tiles_w = (int)((t.ow + tw - 1) / tw);
  t.tw = (t.ow + t.tiles_w - 1) / t.tiles_w;
  int bx = 1;
  while (bx < 32 && bx < t.tw) bx *= 2;
  const int by = kThreads / bx;
  if (th > by && th < t.oh) {
    // a band of a large plane: a multiple of the thread rows
    th = th / by * by;
    t.tiles_h = (int)((t.oh + th - 1) / th);
    t.th = (int)th;
  } else {
    t.tiles_h = (int)((t.oh + th - 1) / th);
    t.th = (t.oh + t.tiles_h - 1) / t.tiles_h;
  }
  t.g = (int)g;
  t.rows_in = (t.th - 1) * stride + k;
  t.cols_in = (t.tw - 1) * stride + k;
  const long long blocks =
      (planes + g - 1) / g * (long long)t.tiles_h * t.tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  const dim3 block(bx, by);
  const size_t smem = (size_t)smem_bytes(t, t.th, t.tw, t.g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  const unsigned grid = (unsigned)blocks;
  if (k == 3)
    depthwise_kernel<3><<<grid, block, smem, s>>>(xf, wf, bf, yf, t);
  else
    depthwise_kernel<0><<<grid, block, smem, s>>>(xf, wf, bf, yf, t);
  return (int)cudaGetLastError();
}
