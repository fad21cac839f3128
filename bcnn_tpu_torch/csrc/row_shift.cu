// K2: the two-tap fractional shift of one shear of the three-shear
// rotation, along rows (row mode) or down columns (column mode), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bcnn_tpu/ops/shear_pallas.py:
// row_shift_pallas (shear_pallas.py:101, the pallas_call at :132) together
// with the fill padding of bcnn_tpu/data/device_augment.py:_row_shift
// around it. Row mode: for rows img (N, R, win, C) fp32, whose columns
// cover absolute x in [in_x0, in_x0 + win) with `fill` outside, and
// per-row shifts d (N, R), it writes out (N, R, out_w, C):
//   out[n,r,j,c] = sum_{k=0..2*kmax} hat(d[n,r] - (k - kmax))
//                                    * IMG[n, r, out_x0 + j + k - kmax, c]
// with hat(t) = max(0, 1 - |t|). Column mode computes the same shift
// along axis 1 of img (N, win, R, C) with one shift a column, d (N, R),
// into out (N, out_w, R, C): the row mode of img.transpose(1, 2) without
// either transposing copy (the JAX package transposes because Mosaic
// wants x on the lanes). The plain PyTorch versions are
// bcnn_tpu_torch/ops/row_shift.py:row_shift_ref and col_shift_ref, the
// sweep over all 2*kmax+1 shifts.
//
// What bounds it: bytes. Each output reads two inputs and writes one, with
// three flops; at the training path's shapes (batch 32 at 416 px) a launch
// moves about 140 MB, 41-42 us at the card's 3.35 TB/s.
//
// Arithmetic (both modes): at most two hat weights are nonzero, at
// k0 = floor(d) + kmax and k0 + 1, and each is used only if it lies in
// [0, 2*kmax], as the sweep has it. The weights are computed as the sweep
// computes them (the integer k - kmax first, then d minus it) and the two
// products are added with __fmul_rn/__fadd_rn, so the kernel rounds
// exactly as the sweep does (its other taps add exact zeros): bit-equal.
//
// Row mode design. d is constant along a row, so with C = chans the whole
// output row is a two-tap stencil over ONE contiguous range of the row:
// output float e (= j*C + c) is w0*IN[s+e] + w1*IN[s+C+e], where IN is the
// row as win*C floats, `fill` outside [0, win*C), and
// s = (out_x0 - kmax - in_x0 + k0)*C. A tile is a row (or a piece of
// kPiece outputs of a longer one). Its source range is staged into shared
// memory by 16-byte cp.async copies from the 16-byte boundary at or below
// its start (input rows are 1,254 or 1,314 floats at 416 px, so every
// other row starts off a boundary); 4-byte copies only where a chunk
// would leave img. The fill is a predicate on the row index, never a
// read. Each thread writes 4 outputs as one aligned float4 (scalar head
// and tail where the output row is off a 16-byte boundary), reading the
// two 4-float tap windows as aligned float4s from shared memory (no bank
// conflicts) and selecting with the row's fixed offset. A block takes one
// tile: with 16 blocks resident on an SM, 16 rows' copies are in flight
// while others compute, and the hardware hands out the 13,376 rows of a
// launch as blocks finish. (Persistent blocks walking the tiles through a
// ring of 2 or 3 stages measured 8-16% slower on the H100: a launch's
// tiles split unevenly over the resident blocks.) Nothing divides by C in
// a loop.
//
// Column mode design. The input row of output i's lower tap in column x
// is i + b(x), with b constant down a column, so a thread walks kSeg
// outputs down a column and carries the lower tap of output i as the upper
// tap of output i+1: each input float is read once (once more at a
// segment's start). A thread takes W neighbouring floats of an image row
// (W = 2, one float2 load and store a row, where the rows allow it: an
// even R*C and 8-byte aligned tensors, as at 416 px; else W = 1), and a
// warp 32*W neighbouring floats, so its loads and stores are coalesced:
// b changes by at most 1 every ~11 columns (|sin 5 deg| < 1/11), so a
// warp load touches at most two input rows, and a thread whose two floats
// straddle such a step loads them one by one. The thread's loads are all
// issued before its first store, to keep bytes in flight. (Measured on the
// H100 at the path's shape: wider stores and shorter segments helped, 60
// to 53 us; bypassing L1 did not.)

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kRowThreads = 128;
constexpr int kPiece = 4096;  // outputs of a row a tile at most; 4 | kPiece
constexpr long long kMaxSmemBlock = 232448;  // 227 KB, sm_90
constexpr int kColThreads = 128;
constexpr int kSeg = 4;  // outputs a thread walks down a column

// What one shift d selects: taps k0 and k0+1, their use and weights.
struct Shift {
  int k0;
  bool v0, v1;
  float w0, w1;
};

__device__ __forceinline__ Shift shift_of(float d, int kmax) {
  Shift s;
  s.k0 = (int)floorf(d) + kmax;
  s.v0 = s.k0 >= 0 && s.k0 <= 2 * kmax;
  s.v1 = s.k0 + 1 >= 0 && s.k0 + 1 <= 2 * kmax;
  s.w0 = fmaxf(0.f, 1.f - fabsf(d - (float)(s.k0 - kmax)));
  s.w1 = fmaxf(0.f, 1.f - fabsf(d - (float)(s.k0 + 1 - kmax)));
  return s;
}

// w0*a + w1*b, rounded as the sweep rounds it
__device__ __forceinline__ float combine(const Shift& s, float a, float b) {
  float acc = 0.f;
  if (s.v0) acc = __fmul_rn(s.w0, a);
  if (s.v1) acc = __fadd_rn(acc, __fmul_rn(s.w1, b));
  return acc;
}

// --------------------------------------------------------------------- //
// Row mode
// --------------------------------------------------------------------- //

struct RowArgs {
  const float* img;
  const float* d;
  float* out;
  long long img_floats;  // img's extent
  int win_c, out_c;      // floats of an input row, of an output row
  int chans, kmax;
  int col0;              // out_x0 - kmax - in_x0: column of tap 0, output 0
  int piece, pieces;     // outputs a tile; tiles a row
  int stage_floats;      // a tile's stage, a multiple of 4
  float fill;
};

// Tile t: outputs e0 .. e0+len-1 of row `row`; the row's floats lo .. hi-1
// are staged; s is the row float of output e0's lower tap.
struct Tile {
  long long row;
  int e0, len, s, lo, hi;
  Shift sh;
};

__device__ __forceinline__ Tile tile_of(const RowArgs& a, int t) {
  Tile T;
  const int row = t / a.pieces;
  T.row = row;
  T.e0 = (t - row * a.pieces) * a.piece;
  T.len = min(a.piece, a.out_c - T.e0);
  T.sh = shift_of(__ldg(a.d + row), a.kmax);
  T.s = (a.col0 + T.sh.k0) * a.chans + T.e0;
  // the floats the taps read, [s, s + len + C), inside the row
  T.lo = max(T.s, 0);
  T.hi = max(min(T.s + T.len + a.chans, a.win_c), T.lo);
  return T;
}

// floats between the 16-byte boundary at or below p and p
__device__ __forceinline__ int head_of(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copies of tile T into buf: buf[head + i - lo] = row float i
// for i in [lo, hi), head = the source's offset from a 16-byte boundary.
__device__ __forceinline__ void stage_tile(const RowArgs& a, const Tile& T,
                                          float* buf) {
  if (T.hi <= T.lo) return;
  const float* src = a.img + T.row * a.win_c + T.lo;
  const int head = head_of(src);
  const float* src0 = src - head;  // 16-byte aligned
  const uintptr_t x_lo = reinterpret_cast<uintptr_t>(a.img);
  const uintptr_t x_hi = x_lo + 4ull * (unsigned long long)a.img_floats;
  const int chunks = (head + T.hi - T.lo + 3) >> 2;
  for (int j = threadIdx.x; j < chunks; j += kRowThreads) {
    const float* p = src0 + 4 * j;
    const uintptr_t q = reinterpret_cast<uintptr_t>(p);
    if (q >= x_lo && q + 16 <= x_hi) {
      cp_async16(buf + 4 * j, p);
    } else {  // a chunk at an end of img
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = q + 4 * e >= x_lo && q + 4 * e < x_hi;
        cp_async4(buf + 4 * j + e, ok ? p + e : a.img, ok);
      }
    }
  }
}

// buf floats m .. m+3 (m may be negative or past the stage: those floats
// lie outside [lo, hi) and the caller replaces them by the fill), from
// the two aligned chunks that hold them
__device__ __forceinline__ float4 window4(const float4* buf4, int m,
                                          int qmax) {
  const int q = m >> 2;  // floor
  const float4 x = buf4[min(max(q, 0), qmax)];
  const float4 y = buf4[min(max(q + 1, 0), qmax)];
  switch (m & 3) {
    case 0: return x;
    case 1: return make_float4(x.y, x.z, x.w, y.x);
    case 2: return make_float4(x.z, x.w, y.x, y.y);
    default: return make_float4(x.w, y.x, y.y, y.z);
  }
}

// row float i: v if i lies in the row, else the fill (a select, no read)
__device__ __forceinline__ float in_row(float v, int i, int win_c,
                                        float fill) {
  return (unsigned)i < (unsigned)win_c ? v : fill;
}

__device__ __forceinline__ void compute_tile(const RowArgs& a, const Tile& T,
                                             const float* buf) {
  const int C = a.chans;
  // buf index of output e0's lower tap: output e reads buf[mb+e], [mb+e+C]
  const int mb = head_of(a.img + T.row * a.win_c + T.lo) - T.lo + T.s;
  float* dst = a.out + T.row * a.out_c + T.e0;
  // outputs before dst's first 16-byte boundary, then float4s, then a tail
  const int oh = min((4 - head_of(dst)) & 3, T.len);
  const int nvec = (T.len - oh) >> 2;
  const int tail0 = oh + 4 * nvec;
  const int scalars = oh + T.len - tail0;
  const int last = a.stage_floats - 1;
  if ((int)threadIdx.x < scalars) {
    const int e = (int)threadIdx.x < oh ? threadIdx.x
                                        : tail0 + threadIdx.x - oh;
    const int i = T.s + e;
    const float v0 = buf[min(max(mb + e, 0), last)];
    const float v1 = buf[min(max(mb + e + C, 0), last)];
    dst[e] = combine(T.sh, in_row(v0, i, a.win_c, a.fill),
                     in_row(v1, i + C, a.win_c, a.fill));
  }
  const float4* buf4 = reinterpret_cast<const float4*>(buf);
  const int qmax = a.stage_floats / 4 - 1;
  for (int v = threadIdx.x; v < nvec; v += kRowThreads) {
    const int e = oh + 4 * v;
    const int i = T.s + e;
    const float4 p = window4(buf4, mb + e, qmax);
    const float4 q = window4(buf4, mb + e + C, qmax);
    const int w = a.win_c;
    const float f = a.fill;
    float4 r;
    r.x = combine(T.sh, in_row(p.x, i, w, f), in_row(q.x, i + C, w, f));
    r.y = combine(T.sh, in_row(p.y, i + 1, w, f),
                  in_row(q.y, i + 1 + C, w, f));
    r.z = combine(T.sh, in_row(p.z, i + 2, w, f),
                  in_row(q.z, i + 2 + C, w, f));
    r.w = combine(T.sh, in_row(p.w, i + 3, w, f),
                  in_row(q.w, i + 3 + C, w, f));
    *reinterpret_cast<float4*>(dst + e) = r;
  }
}

// grid: one block a tile. Shared memory: the tile's stage_floats.
__global__ void __launch_bounds__(kRowThreads)
row_shift_kernel(RowArgs a) {
  extern __shared__ __align__(16) float buf[];
  const Tile T = tile_of(a, blockIdx.x);
  stage_tile(a, T, buf);
  cp_async_wait_all();
  __syncthreads();
  compute_tile(a, T, buf);
}

// --------------------------------------------------------------------- //
// Column mode
// --------------------------------------------------------------------- //

struct ColArgs {
  const float* img;
  const float* d;
  float* out;
  int win, cols, chans, rc;  // input rows; columns, channels, cols*chans
  int total;                 // n * rc: the (image, column, channel) floats
  int kmax, col0, out_w;     // col0 = out_x0 - kmax - in_x0
  float fill;
};

// W neighbouring floats as one load or store
template <int W>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* v) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

// grid: x = chunk of kColThreads threads over the (image, W floats of an
// image row) pairs, y = segment of kSeg outputs down the columns
template <int W>
__global__ void __launch_bounds__(kColThreads)
col_shift_kernel(ColArgs a) {
  const int g = blockIdx.x * kColThreads + threadIdx.x;
  const int per_image = a.rc / W;
  if (g >= a.total / W) return;
  const int n = g / per_image;
  const int x = W * (g - n * per_image);  // column * chans + channel
  const int i0 = blockIdx.y * kSeg;
  const int count = min(kSeg, a.out_w - i0);
  Shift sh[W];
  int j0[W];  // input row of output i0's lower tap, float by float
  bool same = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    sh[w] = shift_of(
        __ldg(a.d + (long long)n * a.cols + (x + w) / a.chans), a.kmax);
    j0[w] = a.col0 + sh[w].k0 + i0;
    same = same && j0[w] == j0[0];
  }
  const float* src = a.img + (long long)n * a.win * a.rc + x;
  float v[kSeg + 1][W];
#pragma unroll
  for (int t = 0; t <= kSeg; ++t) {
#pragma unroll
    for (int w = 0; w < W; ++w) v[t][w] = a.fill;
    if (t > count) continue;
    if (same) {
      if ((unsigned)(j0[0] + t) < (unsigned)a.win)
        Vec<W>::load(src + (long long)(j0[0] + t) * a.rc, v[t]);
    } else {  // the floats straddle a step of b: one by one
#pragma unroll
      for (int w = 0; w < W; ++w)
        if ((unsigned)(j0[w] + t) < (unsigned)a.win)
          v[t][w] = __ldg(src + w + (long long)(j0[w] + t) * a.rc);
    }
  }
  float* dst = a.out + ((long long)n * a.out_w + i0) * a.rc + x;
#pragma unroll
  for (int t = 0; t < kSeg; ++t) {
    if (t >= count) break;
    float r[W];
#pragma unroll
    for (int w = 0; w < W; ++w) r[w] = combine(sh[w], v[t][w], v[t + 1][w]);
    Vec<W>::store(dst + (long long)t * a.rc, r);
  }
}

bool fits_int(long long v) { return v >= INT_MIN && v <= INT_MAX; }

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// the row index math of both modes stays in 32 bits: tap columns
// col0 + k0 for k0 in [-1, 2*kmax + 1], times chans, plus a row
bool index_fits(long long col0, int kmax, int chans, long long row_floats) {
  const long long far = (col0 < 0 ? -col0 : col0) + 2LL * kmax + 2;
  return fits_int(far * chans + row_floats) && fits_int(col0);
}

}  // namespace

// Row mode. img (n, rows, win, chans), d (n, rows) and out (n, rows,
// out_w, chans): fp32, contiguous, on the device; out allocated by the
// caller. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int bcnn_row_shift(const void* img, const void* d, void* out,
                              int n, int rows, int win, int chans, int kmax,
                              int out_x0, int out_w, int in_x0, float fill,
                              void* stream) {
  if (n < 0 || rows < 0 || win < 0 || chans < 0 || kmax < 0 || out_w < 0)
    return (int)cudaErrorInvalidValue;
  const long long out_c = (long long)out_w * chans;
  const long long nrows = (long long)n * rows;
  if (out_c == 0 || nrows == 0) return (int)cudaSuccess;
  const long long win_c = (long long)win * chans;
  const long long col0 = (long long)out_x0 - kmax - in_x0;
  if (!fits_int(win_c) || !fits_int(out_c) ||
      !index_fits(col0, kmax, chans, out_c + win_c))
    return (int)cudaErrorInvalidValue;
  RowArgs a;
  a.img = static_cast<const float*>(img);
  a.d = static_cast<const float*>(d);
  a.out = static_cast<float*>(out);
  a.img_floats = nrows * win_c;
  a.win_c = (int)win_c;
  a.out_c = (int)out_c;
  a.chans = chans;
  a.kmax = kmax;
  a.col0 = (int)col0;
  a.piece = (int)(out_c < kPiece ? out_c : kPiece);
  a.pieces = (int)cdiv(out_c, a.piece);
  const long long tiles = nrows * a.pieces;
  // the stage holds the range [s, s + piece + C) from the boundary below
  const long long stage = 4 * cdiv(a.piece + (long long)chans + 3, 4);
  const long long smem = 4 * stage;
  if (!fits_int(tiles) || smem > kMaxSmemBlock)
    return (int)cudaErrorInvalidValue;
  a.stage_floats = (int)stage;
  a.fill = fill;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_shift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  row_shift_kernel<<<(unsigned)tiles, kRowThreads, (size_t)smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Column mode. img (n, win, cols, chans), d (n, cols) and out (n, out_w,
// cols, chans): fp32, contiguous, on the device; out allocated by the
// caller. out[:, i, x] is the row mode's out[:, x, i] of
// img.transpose(1, 2). Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int bcnn_col_shift(const void* img, const void* d, void* out,
                              int n, int win, int cols, int chans, int kmax,
                              int out_x0, int out_w, int in_x0, float fill,
                              void* stream) {
  if (n < 0 || win < 0 || cols < 0 || chans < 0 || kmax < 0 || out_w < 0)
    return (int)cudaErrorInvalidValue;
  const long long rc = (long long)cols * chans;
  const long long total = (long long)n * rc;
  if (total == 0 || out_w == 0) return (int)cudaSuccess;
  const long long col0 = (long long)out_x0 - kmax - in_x0;
  const long long segs = cdiv(out_w, kSeg);
  if (!fits_int(total) || !index_fits(col0, kmax, 1, (long long)out_w + win) ||
      segs > 65535)
    return (int)cudaErrorInvalidValue;
  ColArgs a;
  a.img = static_cast<const float*>(img);
  a.d = static_cast<const float*>(d);
  a.out = static_cast<float*>(out);
  a.win = win;
  a.cols = cols;
  a.chans = chans;
  a.rc = (int)rc;
  a.total = (int)total;
  a.kmax = kmax;
  a.col0 = (int)col0;
  a.out_w = out_w;
  a.fill = fill;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float2 loads and stores where every image row starts 8-byte aligned
  const bool pairs = rc % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(img) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (pairs) {
    const dim3 grid((unsigned)cdiv(total / 2, kColThreads), (unsigned)segs);
    col_shift_kernel<2><<<grid, kColThreads, 0, s>>>(a);
  } else {
    const dim3 grid((unsigned)cdiv(total, kColThreads), (unsigned)segs);
    col_shift_kernel<1><<<grid, kColThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
