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
// bcnn_tpu_torch/ops/depthwise.py:depthwise_fused_ref.
//
// What bounds it: bytes. A 3x3 output is 9 multiply-adds (18 flops) for
// one 4-byte read (at stride 1) and one 4-byte write: about 2 flops a
// byte, a tenth of the card's fp32 ridge. So the target is one read of x
// and one write of y at the card's memory rate, with the loads in flight
// all the time. The design:
// - A tile is g whole (n, c) planes, or a band of output rows of one
//   plane. In NCHW its input is ONE contiguous range of x: g planes, or
//   the band's input rows with their halo. A block stages that range as
//   it lies in memory, with 16-byte cp.async.cg copies from the 16-byte
//   boundary below its start (4-byte copies only where a 16-byte chunk
//   would leave x). Nothing is padded in shared memory: the window's
//   zeros are predicates on the row and the column in the compute, each
//   a predicated load that reads nothing outside. (A 1-D bulk copy,
//   cp.async.bulk on an mbarrier, measured no faster on the H100.)
// - Blocks are persistent: a grid of about (SMs x resident blocks) walks
//   the tiles, with a ring of `stages` staged tiles, so the copies of the
//   next tiles are in flight while this one is computed and stored.
// - A thread computes a column of R outputs (R = 7 at k 3, stride 1 or
//   2; MobileNet's planes are multiples of 7 high). It slides the window
//   down the input rows in registers, k shared-memory loads per input row,
//   about 3.9 loads an output at stride 1 instead of 9. Neighbouring
//   threads take neighbouring columns, so loads and stores are coalesced
//   and free of bank conflicts at stride 1. (Two columns a thread share
//   loads across the pair but meet 2-way bank conflicts: slower.)
// - Each output sums its taps row by row with fmaf from 0, then adds the
//   bias, as the plain version does.
// The tile plan (tile kind, g, band height, ring depth, stage size, grid)
// is chosen in Python (ops/depthwise.py:plan_tiles), and checked here.
//
// Left behind from the TPU kernel: whole-image VMEM blocks, the pad made
// in registers, stride 2 computed at stride 1 and subsampled, the 8-image
// groups, and the C % 128 gate with its VMEM budget: any C goes here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;
constexpr long long kMaxSmemBlock = 232448;  // 227 KB, sm_90
constexpr int kRows = 7;                     // outputs per thread, k 3

enum Act { kNone = 0, kRelu = 1, kLrelu = 2, kClamp = 3 };

struct Plan {
  long long planes;       // n * c
  int chans, h, w, oh, ow;
  int k, stride, pad, act;
  int g, th, tiles_h;     // planes, output rows per tile; bands per plane
  int tiles, strips;      // tiles in all; strips of R rows per band
  int stages, stage_floats;
};

// The tile t: planes p0 .. p0+g_n-1, output rows oy0 .. oy0+th_n-1, input
// rows lo .. hi-1 of each plane staged, from x[start] for len floats.
struct Span {
  long long p0, start;
  int g_n, oy0, th_n, lo, hi, len;
};

__device__ __forceinline__ Span span_of(const Plan& p, int t) {
  Span s;
  const int band = t % p.tiles_h;
  s.p0 = (long long)(t / p.tiles_h) * p.g;
  s.g_n = (int)min((long long)p.g, p.planes - s.p0);
  s.oy0 = band * p.th;
  s.th_n = min(p.th, p.oh - s.oy0);
  if (p.tiles_h == 1) {
    s.lo = 0;
    s.hi = p.h;
  } else {
    s.lo = min(max(s.oy0 * p.stride - p.pad, 0), p.h);
    s.hi = min(max((s.oy0 + s.th_n - 1) * p.stride - p.pad + p.k, s.lo), p.h);
  }
  s.start = (s.p0 * p.h + s.lo) * p.w;
  s.len = ((s.g_n - 1) * p.h + s.hi - s.lo) * p.w;
  return s;
}

// floats between the 16-byte boundary at or below x + start and x + start
__device__ __forceinline__ int head_of(const float* x, long long start) {
  return (int)((reinterpret_cast<uintptr_t>(x + start) & 15) >> 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// 4-byte copy; with `valid` false it reads nothing and writes 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n - 1 groups of this thread are pending (n = stages)
__device__ __forceinline__ void cp_async_wait_ring(int n) {
  switch (n) {
    case 2: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Start the copies of tile t into buf: buf[head + e] = x[start + e].
__device__ __forceinline__ void stage_tile(const Plan& p, const float* x,
                                          int t, float* buf) {
  const Span s = span_of(p, t);
  const int head = head_of(x, s.start);
  const float* src0 = x + s.start - head;  // 16-byte aligned
  const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
  const uintptr_t x_hi = x_lo + 4ull * (unsigned long long)p.planes * p.h * p.w;
  const int chunks = (head + s.len + 3) >> 2;
  for (int j = threadIdx.x; j < chunks; j += kThreads) {
    const float* src = src0 + 4 * j;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    if (a >= x_lo && a + 16 <= x_hi) {
      cp_async16(buf + 4 * j, src);
    } else {  // a chunk at an end of x
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = a + 4 * e >= x_lo && a + 4 * e < x_hi;
        cp_async4(buf + 4 * j + e, ok ? src + e : x, ok);
      }
    }
  }
}

// the activation of R outputs, with one branch on act for all of them
template <int R>
__device__ __forceinline__ void activate(float (&v)[R], int act) {
  switch (act) {
    case kRelu:
#pragma unroll
      for (int t = 0; t < R; ++t) v[t] = fmaxf(v[t], 0.f);
      break;
    case kLrelu:
#pragma unroll
      for (int t = 0; t < R; ++t) v[t] = v[t] > 0.f ? v[t] : 0.1f * v[t];
      break;
    case kClamp:
#pragma unroll
      for (int t = 0; t < R; ++t) v[t] = fminf(fmaxf(v[t], 0.f), 1.f);
      break;
    default: break;
  }
}

// A thread walks a tile's items (plane gi, strip, column ox), numbered
// column fastest: thread i takes items i, i + kThreads, ... It keeps its
// place as counters and steps them by kThreads written as (gi, strip,
// ox), and the channel by gi's step mod C, so the loops divide by
// nothing.
struct Steps {
  int ox, strip, gi, chan;
};

// The outputs of one item: rows oyb .. oyb+R-1 of column ox of plane
// (p0 + gi), channel c. K, S > 0: k and stride known at compile time;
// K == 0: read them from the plan (then R == 1).
template <int K, int S, int R>
__device__ __forceinline__ void compute_item(
    const Plan& p, const Span& s, const float* buf, int head,
    const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ y, int gi, int strip, int ox, int c) {
  const int k = K > 0 ? K : p.k;
  const int st = S > 0 ? S : p.stride;
  const int oyb = s.oy0 + strip * R;
  const int iy0 = oyb * st - p.pad;
  const int ix0 = ox * st - p.pad;
  // index in buf of input (iy0, ix0) of this plane
  int off = head + (gi * p.h + iy0 - s.lo) * p.w + ix0;
  float acc[R];
#pragma unroll
  for (int t = 0; t < R; ++t) acc[t] = 0.f;
  if constexpr (K > 0) {
    float wr[K * K];
#pragma unroll
    for (int i = 0; i < K * K; ++i) wr[i] = __ldg(w + c * K * K + i);
    bool col_ok[K];
#pragma unroll
    for (int q = 0; q < K; ++q)
      col_ok[q] = (unsigned)(ix0 + q) < (unsigned)p.w;
    // input rows iy0 .. iy0 + (R-1)*S + K - 1, each read once
#pragma unroll
    for (int ri = 0; ri < (R - 1) * S + K; ++ri, off += p.w) {
      const int iy = iy0 + ri;
      const bool row_ok = iy >= s.lo && iy < s.hi;
      float v[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {  // a predicated load: none outside
        v[q] = 0.f;
        if (row_ok && col_ok[q]) v[q] = buf[off + q];
      }
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int r = ri - t * S;  // this row is tap row r of output t
        if (r >= 0 && r < K) {
#pragma unroll
          for (int q = 0; q < K; ++q)
            acc[t] = fmaf(v[q], wr[r * K + q], acc[t]);
        }
      }
    }
  } else {
    const float* wc = w + (long long)c * k * k;
    for (int r = 0; r < k; ++r, off += p.w) {
      const int iy = iy0 + r;
      const bool row_ok = iy >= s.lo && iy < s.hi;
      for (int q = 0; q < k; ++q) {
        float v = 0.f;
        if (row_ok && (unsigned)(ix0 + q) < (unsigned)p.w) v = buf[off + q];
        acc[0] = fmaf(v, __ldg(wc + r * k + q), acc[0]);
      }
    }
  }
  const float bc = __ldg(b + c);
#pragma unroll
  for (int t = 0; t < R; ++t) acc[t] += bc;
  activate(acc, p.act);
  float* out = y + ((s.p0 + gi) * p.oh + oyb) * p.ow + ox;
  const int rows = min(R, s.oy0 + s.th_n - oyb);
#pragma unroll
  for (int t = 0; t < R; ++t)
    if (t < rows) out[t * p.ow] = acc[t];
}

// grid: persistent blocks; block i takes tiles i, i + gridDim.x, ...
// Shared memory: a ring of `stages` buffers of stage_floats.
template <int K, int S, int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
depthwise_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y,
                 Plan p, Steps d) {
  extern __shared__ __align__(16) float smem[];
  const int ring = p.stages;
  const int per_plane = p.strips * p.ow;
  const int gi0 = threadIdx.x / per_plane;
  const int strip0 = threadIdx.x % per_plane / p.ow;
  const int ox0 = threadIdx.x % p.ow;
  int t = blockIdx.x;
  for (int i = 0; i < ring - 1; ++i) {
    const int tn = t + i * (int)gridDim.x;
    if (tn < p.tiles) stage_tile(p, x, tn, smem + i * p.stage_floats);
    cp_async_commit();
  }
  for (int i = 0; t < p.tiles; ++i, t += gridDim.x) {
    const int tn = t + (ring - 1) * (int)gridDim.x;
    if (tn < p.tiles)
      stage_tile(p, x, tn, smem + ((i + ring - 1) % ring) * p.stage_floats);
    cp_async_commit();
    cp_async_wait_ring(ring);
    __syncthreads();

    const Span s = span_of(p, t);
    const float* buf = smem + (i % ring) * p.stage_floats;
    const int head = head_of(x, s.start);
    int gi = gi0, strip = strip0, ox = ox0;
    int c = (int)((s.p0 + gi) % p.chans);
    while (gi < s.g_n) {
      compute_item<K, S, R>(p, s, buf, head, w, b, y, gi, strip, ox, c);
      ox += d.ox;
      strip += d.strip;
      gi += d.gi;
      c += d.chan;
      if (ox >= p.ow) {
        ox -= p.ow;
        ++strip;
      }
      if (strip >= p.strips) {
        strip -= p.strips;
        ++gi;
        ++c;
      }
      if (c >= p.chans) c -= p.chans;
    }
    __syncthreads();  // the next iteration stages into this buffer
  }
}


template <int K, int S, int R>
int launch(const float* x, const float* w, const float* b, float* y,
           const Plan& p, int grid, cudaStream_t stream) {
  const auto kern = depthwise_kernel<K, S, R>;
  const long long smem = 4LL * p.stages * p.stage_floats;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Steps d;
  d.ox = kThreads % p.ow;
  d.strip = kThreads / p.ow % p.strips;
  d.gi = kThreads / (p.strips * p.ow);
  d.chan = d.gi % p.chans;
  kern<<<grid, kThreads, (size_t)smem, stream>>>(x, w, b, y, p, d);
  return (int)cudaGetLastError();
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// x (n, c, h, w), w (c, 1, k, k), b (c,) and y (n, c, oh, ow): fp32,
// contiguous, on the device; y allocated by the caller. act: 0 NONE,
// 1 RELU, 2 LRELU, 3 CLAMP. The tile plan (g .. grid) comes from
// ops/depthwise.py:plan_tiles: g planes or a band of th output rows per
// tile, tiles_h bands a plane, `tiles` in all, `rows` outputs a thread
// (7 at k 3 and stride 1 or 2, else 1) in `strips` strips a band, a ring
// of `stages` buffers of stage_floats floats, `grid` persistent blocks.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments or a plan it does not take.
extern "C" int bcnn_depthwise(const void* x, const void* w, const void* b,
                              void* y, int n, int c, int h, int wd, int k,
                              int stride, int pad, int act, int g, int th,
                              int tiles_h, int tiles, int rows, int strips,
                              int stages, int stage_floats, int grid,
                              void* stream) {
  if (n < 0 || c < 0 || h < 0 || wd < 0 || k < 1 || stride < 1 || pad < 0 ||
      act < kNone || act > kClamp)
    return (int)cudaErrorInvalidValue;
  const long long span_h = (long long)h + 2LL * pad - k;
  const long long span_w = (long long)wd + 2LL * pad - k;
  const long long planes = (long long)n * c;
  if (span_h < 0 || span_w < 0 || planes == 0) return (int)cudaSuccess;
  if ((long long)h * wd > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Plan p{};
  p.planes = planes;
  p.chans = c;
  p.h = h;
  p.w = wd;
  p.oh = (int)(span_h / stride + 1);
  p.ow = (int)(span_w / stride + 1);
  p.k = k;
  p.stride = stride;
  p.pad = pad;
  p.act = act;
  p.g = g;
  p.th = th;
  p.tiles_h = tiles_h;
  p.tiles = tiles;
  p.strips = strips;
  p.stages = stages;
  p.stage_floats = stage_floats;

  // the plan must cover every output once and fit its buffers
  const bool fast = rows == kRows && k == 3 && (stride == 1 || stride == 2);
  if (!(fast || rows == 1) || g < 1 || th < 1 || th > p.oh ||
      tiles_h != cdiv(p.oh, th) || (g > 1 && tiles_h != 1) ||
      tiles != cdiv(planes, g) * tiles_h || strips != cdiv(th, rows) ||
      (long long)strips * p.ow > 0x7fffffffLL || stages < 2 || stages > 4 ||
      stage_floats % 4 != 0 || grid < 1 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  const long long band_rows = (long long)(th - 1) * stride + k;
  const long long max_len = tiles_h == 1
      ? (long long)g * h * wd
      : (band_rows < h ? band_rows : h) * wd;
  if (stage_floats < (max_len + 3 + 3) / 4 * 4 ||
      4LL * stages * stage_floats > kMaxSmemBlock)
    return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (rows == 1) return launch<0, 0, 1>(xf, wf, bf, yf, p, grid, s);
  if (stride == 1) return launch<3, 1, kRows>(xf, wf, bf, yf, p, grid, s);
  return launch<3, 2, kRows>(xf, wf, bf, yf, p, grid, s);
}
