// K4: int8 convolution with its fused epilogue, for Hopper (sm_90a).
//
// Replaces what the JAX package computes through XLA for a quantized conv
// (there is no Pallas kernel for it): bcnn_tpu/ops/quant.py:302
// `conv2d_int8`, then `_apply_conv_epilogue` and `_maybe_emit_int8` of
// bcnn_tpu/compile.py:438-468. PyTorch has no int8 convolution on CUDA, so
// the port needs its own. From x int8 (N, C, H, W) held channels-last
// (NHWC in memory), w int8 (O, C, k, k) held channels-last ((O, k, k, C)
// in memory) and fp32 per-channel vectors it computes
//   acc[n,o,p,q] = sum_{r,s,c} x[n,p*S+r-P,q*S+s-P,c] * w[o,r,s,c]  (int32)
//   y = fp32(acc) * d[o]                          (d = fp32(sx) * w_scale)
//   y = ((y - mean[o]) * inv[o]) * scale[o] + bias[o]   BN as it stands
//     | y * scale[o] + bias[o]                          BN folded
//     | y + bias[o]                                     no BN
//   y = LRELU (y > 0 ? y : 0.1 y) | RELU | NONE
//   out = int8(clip(rint(y / s_out), -127, 127)) channels-last (NHWC),
//       | fp32 y, NCHW (the linear heads, read as NCHW downstream).
// The int32 sum is exact in any order, so the (r, s, c) order of k and
// the split of k between blocks change no bit; every epilogue step rounds
// as the plain version's separate torch ops do (__fmul_rn and friends,
// IEEE division, never a contracted FMA), and d and inv come from the
// wrapper, so the kernel is bit-equal to
// bcnn_tpu_torch/ops/conv_int8.py:conv_int8_fused_ref.
//
// What bounds it: an implicit GEMM of M = N*OH*OW rows, O columns and
// K = k*k*C deep. At YOLOv3-tiny 416, batch 8, the wide early layers
// (K = 27..288, O = 16..64) and the 1x1 layers move more bytes than they
// multiply (3.35 TB/s of device memory; lid1 writes 22 MB of int8), the
// deep 13x13 and 26x26 3x3 layers (K up to 4,608) the other way (1,979
// TOPS of dense int8). What the design does about each:
// - Loads of 16 bytes. With x NHWC and C a multiple of 16, a stage of 64
//   k values is 64 channels of one (r, s) tap, or several taps when C <
//   64: each output pixel's stage is four 16-byte chunks, copied by
//   cp.async.cg straight to shared memory, zero-filled (src-size 0)
//   outside the image, past K and past M. The w tile is four 16-byte
//   chunks of an (r, s, c) row. The k position of a thread's chunk is
//   stepped by 64 a stage, never divided.
// - A ring of kStages = 4 stages of 64 k values (cp.async.commit_group /
//   wait_group): three stages in flight while the tensor cores work on
//   the fourth, two m16n8k32 steps and one barrier a stage (stages of
//   32 k values left the deep layers waiting on their loads, at 5-8% of
//   the int8 rate on an H100).
// - Fragments by ldmatrix.x4 for mma.sync.m16n8k32 s8 x s8 -> s32. Stage
//   rows are 64 bytes, their four 16-byte chunks permuted by row
//   (chunk ^ ((row >> 1) & 3)), so the 8 rows an ldmatrix phase reads,
//   and the 2 rows x 4 chunks 8 cp.async threads write, hit all 32 banks
//   once.
// - Tiles and split-K per shape, from the Python plan
//   (ops/conv_int8.py:plan_conv_int8, checked here): 128 x 64, 64 x 64,
//   128 x 32 or 128 x 16 output tiles, and K split between blocks where
//   the tiles alone would leave SMs idle (the 13 x 13 layers). A split
//   block writes its int32 partial tile to a workspace, coalesced, then
//   counts itself in at its tile's counter; the last block of a tile adds
//   the other partials (int32: any order is exact) and runs the epilogue,
//   so the epilogue runs once per output.
// - Stores staged through shared memory: the epilogue writes the block's
//   int8 tile there, then 16-byte stores of 16 channels of one pixel go
//   to NHWC memory (a pixel's channels are contiguous); fp32 tiles are
//   staged transposed and written down NCHW columns, consecutive threads
//   on consecutive pixels.
// - The epilogue's per-channel vectors (d, BN, bias) are staged in
//   shared memory once a block, not read from device memory once an
//   output.
// - C not a multiple of 16 (ragged shapes): a byte gather from NHWC into
//   the same stage layout, its address stepped along k (a tap's C bytes,
//   then the next tap's, are contiguous), and the w rows (K bytes, not
//   16-byte aligned) likewise. C = 3 with a 3 x 3 window (lid1, any RGB
//   net's first conv: K = 27, one stage) has its own loader: a thread
//   a pixel, its 27 bytes at offsets fixed when compiled (lid1 91 us
//   against 136 us through the byte gather on an H100,
//   tools/k4_compare.py --variant). lid1's time is in that gather, the
//   epilogue's arithmetic and its 22 MB of stores.
// Left for later: wgmma (the only way to the full int8 rate) on the deep
// layers, and TMA's im2col mode for the x tile.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_epilogue.cuh"

namespace {

using namespace bcnn_int8;  // Chan, requant, the BN and activation codes

constexpr int kTileK = 32;   // reduction depth of one m16n8k32
constexpr int kStageK = 64;  // k values a stage: two m16n8k32 steps
constexpr int kChunks = kStageK / 16;  // 16-byte chunks of a stage row
constexpr int kStages = 4;   // stages in a block's ring

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* d;
  const float* scale;
  const float* bias;
  const float* mean;
  const float* inv;
  void* out;
  int* ws;        // split-K partial tiles, (tiles, splits, BM * BN) int32
  int* counters;  // split-K: blocks of each tile done, zero at launch
  int c, h, w_in, o, k, stride, pad, oh, ow;
  int kdim;   // k * k * C
  int m;      // N * OH * OW
  int steps;  // stages of kStageK k values in all
  int split_steps, splits;
  int bn, act, out_int8, vec, o_vec, rgb3;
  float s_out;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// byte offset of 16-byte chunk `chunk` (0..3) of row `row` in a stage tile
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kStageK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The (r, s, ci) of reduction index kk in (r, s, c) order.
struct KPos {
  int r, s, ci;
};

__device__ __forceinline__ KPos kpos(int kk, int c, int k) {
  const int tap = kk / c;
  const int r = tap / k;
  return KPos{r, tap - r * k, kk - tap * c};
}

// the epilogue's per-channel vectors of a block's BN columns, staged in
// shared memory once a block
enum { kVecD = 0, kVecScale, kVecBias, kVecMean, kVecInv, kVecs };

// one output channel's vectors (Chan), read from the staged ones once a
// thread and column
template <int BN>
__device__ __forceinline__ Chan chan(const float (&v)[kVecs][BN], int col) {
  return Chan{v[kVecD][col], v[kVecScale][col], v[kVecBias][col],
              v[kVecMean][col], v[kVecInv][col]};
}

// the epilogue of one accumulator (int8_epilogue.cuh)
__device__ __forceinline__ float epilogue(const Conv& p, int acc,
                                          const Chan& v) {
  return bcnn_int8::epilogue(acc, v, p.bn, p.act);
}

// Shared memory a block of this shape takes: the ring, or the staged
// output tile that reuses it (fp32 transposed, a channel's BM pixels a
// row; int8, a pixel's BN channels a row of an odd number of 16-byte
// units, so that a warp's 2-byte writes hit 32 banks).
template <int BM, int BN>
struct Smem {
  static constexpr int kStF = BM + 4;
  static constexpr int kStI = BN + ((BN / 16) % 2 ? 32 : 16);
  static constexpr int kStage = (BM + BN) * kStageK;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kOutF = BN * kStF * 4, kOutI = BM * kStI;
  static constexpr int kOut = kOutF > kOutI ? kOutF : kOutI;
  static constexpr int kBytes = kRing > kOut ? kRing : kOut;
};

// A block computes a BM x BN output tile with WM x WN warps, each a
// (BM / WM) x (BN / WN) tile of m16n8k32 products, over the stages
// [blockIdx.z * split_steps, ...) of K.
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
    conv_int8_kernel(const Conv p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int MI = TM / 16, NI = TN / 8;
  static_assert(TM % 16 == 0 && TN % 16 == 0, "warp tile");
  static_assert(kThreads % kChunks == 0 &&
                    (kChunks * BM) % kThreads == 0, "x chunks a thread");
  constexpr int kRowsA = kChunks * BM / kThreads;  // x rows a thread loads
  constexpr int kRowStep = kThreads / kChunks;
  using S = Smem<BM, BN>;
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ float s_vec[kVecs][BN];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int t_begin = blockIdx.z * p.split_steps;
  const int t_count = min(p.steps - t_begin, p.split_steps);
  const int ohw = p.oh * p.ow;
  // read before the epilogue: the main loop's barriers order them
  for (int q = tid; q < BN; q += kThreads) {
    const int o = o0 + q;
    const bool ok = o < p.o;
    s_vec[kVecD][q] = ok ? p.d[o] : 0.f;
    s_vec[kVecBias][q] = ok ? p.bias[o] : 0.f;
    s_vec[kVecScale][q] = ok && p.bn >= kBnFolded ? p.scale[o] : 0.f;
    s_vec[kVecMean][q] = ok && p.bn == kBnUnfolded ? p.mean[o] : 0.f;
    s_vec[kVecInv][q] = ok && p.bn == kBnUnfolded ? p.inv[o] : 0.f;
  }

  // x loader of 16-byte copies: rows tid / kChunks + i * kRowStep of the
  // tile, chunk tid % kChunks (a pixel's 64 bytes by 4 neighbouring
  // threads)
  const int chunk = tid % kChunks;
  long long a_base[kRowsA];
  int a_ih[kRowsA], a_iw[kRowsA];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const int am = m0 + tid / kChunks + i * kRowStep;
    a_ih[i] = -(1 << 30);  // rows past M: outside the image
    a_iw[i] = 0;
    a_base[i] = 0;
    if (am < p.m) {
      const int img = am / ohw;
      const int pq = am - img * ohw;
      const int oy = pq / p.ow;
      a_ih[i] = oy * p.stride - p.pad;
      a_iw[i] = (pq - oy * p.ow) * p.stride - p.pad;
      a_base[i] = (((long long)img * p.h + a_ih[i]) * p.w_in + a_iw[i]) *
                  (long long)p.c;
    }
  }
  // k position of this thread's x chunk at the next stage issued (vec)
  KPos kp = kpos(t_begin * kStageK + 16 * chunk, p.c, p.k);

  auto issue = [&](int t, int slot) {
    int8_t* sa = smem + slot * S::kStage;
    int8_t* sb = sa + BM * kStageK;
    if (p.vec) {
      const bool k_ok = kp.r < p.k;
      const long long koff =
          ((long long)kp.r * p.w_in + kp.s) * p.c + kp.ci;
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) {
        const int row = tid / kChunks + i * kRowStep;
        const bool ok = k_ok && (unsigned)(a_ih[i] + kp.r) < (unsigned)p.h &&
                        (unsigned)(a_iw[i] + kp.s) < (unsigned)p.w_in;
        cp_async16(smem_u32(sa + swz(row, chunk)),
                   ok ? p.x + a_base[i] + koff : p.x, ok);
      }
      kp.ci += kStageK;
      while (kp.ci >= p.c) {
        kp.ci -= p.c;
        if (++kp.s == p.k) {
          kp.s = 0;
          ++kp.r;
        }
      }
      for (int q = tid; q < kChunks * BN; q += kThreads) {
        const int o = o0 + q / kChunks;
        const int kk = t * kStageK + 16 * (q % kChunks);
        const bool ok = o < p.o && kk < p.kdim;
        cp_async16(smem_u32(sb + swz(q / kChunks, q % kChunks)),
                   ok ? p.w + (long long)o * p.kdim + kk : p.w, ok);
      }
      return;
    }
    if (p.rgb3) {
      // C = 3, k = 3 (an RGB net's first conv; K = 27, one stage): a
      // thread gathers a pixel's whole patch, three runs of 9 bytes, at
      // offsets known when compiled, one bounds test a tap
      for (int row = tid; row < BM; row += kThreads) {
        const int am = m0 + row;
        uint32_t word[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        if (am < p.m) {
          const int img = am / ohw;
          const int pq = am - img * ohw;
          const int oy = pq / p.ow;
          const int ih0 = oy * p.stride - p.pad;
          const int iw0 = (pq - oy * p.ow) * p.stride - p.pad;
          const int8_t* px =
              p.x + (((long long)img * p.h + ih0) * p.w_in + iw0) * 3;
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const bool rok = (unsigned)(ih0 + r) < (unsigned)p.h;
            const int8_t* rp = px + (long long)r * p.w_in * 3;
#pragma unroll
            for (int sx = 0; sx < 3; ++sx) {
              if (!rok || (unsigned)(iw0 + sx) >= (unsigned)p.w_in) continue;
#pragma unroll
              for (int ci = 0; ci < 3; ++ci) {
                const int kk = (r * 3 + sx) * 3 + ci;
                word[kk >> 2] |= (uint32_t)(uint8_t)rp[sx * 3 + ci]
                                 << (8 * (kk & 3));
              }
            }
          }
        }
        *reinterpret_cast<uint4*>(sa + swz(row, 0)) =
            make_uint4(word[0], word[1], word[2], word[3]);
        *reinterpret_cast<uint4*>(sa + swz(row, 1)) =
            make_uint4(word[4], word[5], word[6], word[7]);
        *reinterpret_cast<uint4*>(sa + swz(row, 2)) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(sa + swz(row, 3)) = make_uint4(0, 0, 0, 0);
      }
    } else {
      // byte gather: a thread one row (tid % BM), chunks tid / BM + i *
      // (kThreads / BM), so that chunks past K cost every thread alike;
      // 16 k values a chunk, the address stepped by one byte along k and
      // by (W - k) * C more where r steps
      const int row = tid % BM;
      const int am = m0 + row;
      int ih0 = -(1 << 30), iw0 = 0;  // rows past M: outside the image
      long long base = 0;
      if (am < p.m) {
        const int img = am / ohw;
        const int pq = am - img * ohw;
        const int oy = pq / p.ow;
        ih0 = oy * p.stride - p.pad;
        iw0 = (pq - oy * p.ow) * p.stride - p.pad;
        base = (((long long)img * p.h + ih0) * p.w_in + iw0) *
               (long long)p.c;
      }
      for (int cq = tid / BM; cq < kChunks; cq += kThreads / BM) {
        const int k0 = t * kStageK + 16 * cq;
        uint32_t word[4] = {0u, 0u, 0u, 0u};
        if (k0 < p.kdim) {
          KPos g = kpos(k0, p.c, p.k);
          long long off = base + ((long long)g.r * p.w_in + g.s) * p.c + g.ci;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (k0 + j < p.kdim && (unsigned)(ih0 + g.r) < (unsigned)p.h &&
                (unsigned)(iw0 + g.s) < (unsigned)p.w_in)
              word[j >> 2] |= (uint32_t)(uint8_t)p.x[off] << (8 * (j & 3));
            ++off;
            if (++g.ci == p.c) {
              g.ci = 0;
              if (++g.s == p.k) {
                g.s = 0;
                ++g.r;
                off += (long long)(p.w_in - p.k) * p.c;
              }
            }
          }
        }
        *reinterpret_cast<uint4*>(sa + swz(row, cq)) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
    for (int q = tid; q < kChunks * BN; q += kThreads) {
      const int o = o0 + q / kChunks;
      const int kk = t * kStageK + 16 * (q % kChunks);
      uint32_t word[4] = {0u, 0u, 0u, 0u};
      if (o < p.o) {
        const int8_t* wrow = p.w + (long long)o * p.kdim;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (kk + j < p.kdim)
            word[j >> 2] |= (uint32_t)(uint8_t)wrow[kk + j] << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(sb + swz(q / kChunks, q % kChunks)) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < t_count) issue(t_begin + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < t_count; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = i + kStages - 1;
    if (nx < t_count) issue(t_begin + nx, nx % kStages);
    cp_async_commit();
    const uint32_t sa = smem_u32(smem + (i % kStages) * S::kStage);
    const uint32_t sb = sa + BM * kStageK;
#pragma unroll
    for (int ks = 0; ks < kStageK / kTileK; ++ks) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], sa + swz(wm * TM + mi * 16 + (lane & 15),
                                     2 * ks + (lane >> 4)));
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + swz(wn * TN + nj * 16 + ((lane >> 4) << 3) +
                                    (lane & 7),
                                2 * ks + ((lane >> 3) & 1)));
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the staging tile reuses it

  if (p.splits > 1) {
    // partial tiles, (tile, split, mi * NI + ni, thread) int4
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int4* part = reinterpret_cast<int4*>(p.ws) +
                 (long long)tile * p.splits * (MI * NI * kThreads);
    int4* mine = part + (long long)blockIdx.z * (MI * NI * kThreads);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mine[(mi * NI + ni) * kThreads + tid] =
            make_int4(acc[mi][ni][0], acc[mi][ni][1], acc[mi][ni][2],
                      acc[mi][ni][3]);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int z = 0; z < p.splits; ++z) {
      if (z == (int)blockIdx.z) continue;
      const int4* other = part + (long long)z * (MI * NI * kThreads);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int4 v = __ldcg(other + (mi * NI + ni) * kThreads + tid);
          acc[mi][ni][0] += v.x;
          acc[mi][ni][1] += v.y;
          acc[mi][ni][2] += v.z;
          acc[mi][ni][3] += v.w;
        }
    }
  }

  // epilogue: acc[mi][ni][e] is row g (+8 for e >= 2), column 2t + (e & 1)
  // of the 16 x 8 product (mi, ni) of this warp
  const int g = lane >> 2, t4 = lane & 3;
  if (p.out_int8) {
    int8_t* st = smem;  // [BM][S::kStI]
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * TN + ni * 8 + 2 * t4 + j;
        const Chan v = chan(s_vec, col);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = wm * TM + mi * 16 + g + 8 * half;
            st[row * S::kStI + col] =
                requant(epilogue(p, acc[mi][ni][2 * half + j], v), p.s_out);
          }
      }
    __syncthreads();
    int8_t* out = static_cast<int8_t*>(p.out);
    for (int q = tid; q < BM * (BN / 16); q += kThreads) {
      const int row = q / (BN / 16), oc = o0 + 16 * (q % (BN / 16));
      const int m = m0 + row;
      if (m >= p.m) continue;
      const int8_t* src = st + row * S::kStI + (oc - o0);
      int8_t* dst = out + (long long)m * p.o + oc;
      if (p.o_vec && oc + 16 <= p.o) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < 16 && oc + j < p.o; ++j) dst[j] = src[j];
      }
    }
  } else {
    float* st = reinterpret_cast<float*>(smem);  // [BN][S::kStF]
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * TN + ni * 8 + 2 * t4 + j;
        const Chan v = chan(s_vec, col);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            st[col * S::kStF + wm * TM + mi * 16 + g + 8 * half] =
                epilogue(p, acc[mi][ni][2 * half + j], v);
      }
    __syncthreads();
    float* out = static_cast<float*>(p.out);
    for (int q = tid; q < BM * BN; q += kThreads) {
      const int col = q / BM, row = q % BM;
      const int o = o0 + col, m = m0 + row;
      if (o >= p.o || m >= p.m) continue;
      const int img = m / ohw;
      out[((long long)img * p.o + o) * ohw + (m - img * ohw)] =
          st[col * S::kStF + row];
    }
  }
}

// the tile shapes the plan may pick: (BM, BN, warps along M, along N)
struct Cfg {
  int bm, bn, threads, smem;
  void (*fn)(const Conv);
};

#define BCNN_K4_CFG(BM, BN, WM, WN)                    \
  {                                                    \
    BM, BN, WM * WN * 32, Smem<BM, BN>::kBytes,        \
        conv_int8_kernel<BM, BN, WM, WN>               \
  }
const Cfg kCfgs[] = {
    BCNN_K4_CFG(128, 64, 4, 2),
    BCNN_K4_CFG(64, 64, 2, 2),
    BCNN_K4_CFG(128, 32, 4, 1),
    BCNN_K4_CFG(128, 16, 4, 1),
};
#undef BCNN_K4_CFG

}  // namespace

// x int8 (n, c, h, w) channels-last, w int8 (o, c, k, k) channels-last
// ((o, k, k, c) in memory), out int8 (n, o, oh, ow) channels-last or fp32
// NCHW; d and bias fp32 (o); scale (o) for bn >= 1, mean and inv (o) for
// bn == 2, else may be null. The plan (ops/conv_int8.py:plan_conv_int8):
// tile shape `cfg`, K split into `splits` runs of `split_steps` stages
// of 64 k values; with splits > 1, ws holds (tiles, splits, bm * bn) int32 and
// counters one int32 a tile, zeroed here on `stream`. Launches on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// or a plan it does not take.
extern "C" int bcnn_conv_int8(const void* x, const void* w, const void* d,
                              const void* scale, const void* bias,
                              const void* mean, const void* inv, void* out,
                              int n, int c, int h, int wd, int o, int k,
                              int stride, int pad, int bn, int act,
                              int out_int8, float s_out, int cfg, int splits,
                              int split_steps, void* ws, void* counters,
                              void* stream) {
  if (n < 0 || c < 1 || h < 0 || wd < 0 || o < 1 || k < 1 || stride < 1 ||
      pad < 0 || bn < kBnNone || bn > kBnUnfolded || act < kActNone ||
      act > kActLrelu || (out_int8 && !(s_out > 0.f)))
    return (int)cudaErrorInvalidValue;
  if (!x || !w || !d || !bias || !out || (bn >= kBnFolded && !scale) ||
      (bn == kBnUnfolded && (!mean || !inv)))
    return (int)cudaErrorInvalidValue;
  if (cfg < 0 || cfg >= (int)(sizeof(kCfgs) / sizeof(kCfgs[0])) ||
      splits < 1 || split_steps < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const long long span_h = (long long)h + 2LL * pad - k;
  const long long span_w = (long long)wd + 2LL * pad - k;
  if (span_h < 0 || span_w < 0 || n == 0) return (int)cudaSuccess;
  const Cfg& f = kCfgs[cfg];
  const long long oh = span_h / stride + 1, ow = span_w / stride + 1;
  const long long m = (long long)n * oh * ow;
  const long long kdim = (long long)c * k * k;
  if (m > 0x7fffffffLL - f.bm || kdim > 0x7fffffffLL - kStageK ||
      (long long)h * wd > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long steps = (kdim + kStageK - 1) / kStageK;
  // every step in exactly one split, no split empty
  if ((long long)(splits - 1) * split_steps >= steps ||
      (long long)splits * split_steps < steps)
    return (int)cudaErrorInvalidValue;
  const long long tiles_m = (m + f.bm - 1) / f.bm;
  const long long tiles_n = (o + f.bn - 1) / f.bn;
  if (tiles_n > 65535 || tiles_m > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // the split workspace's int4 index stays in range (an unsplit launch
  // has none: its outputs may pass 2^31, as at batch 1024)
  if (splits > 1 &&
      tiles_m * tiles_n > 0x7fffffffLL / ((long long)splits * f.bm * f.bn))
    return (int)cudaErrorInvalidValue;
  const auto al16 = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  if (splits > 1 && (!ws || !counters || !al16(ws)))
    return (int)cudaErrorInvalidValue;
  Conv p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.d = static_cast<const float*>(d);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.mean = static_cast<const float*>(mean);
  p.inv = static_cast<const float*>(inv);
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
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
  p.steps = (int)steps;
  p.split_steps = split_steps;
  p.splits = splits;
  p.bn = bn;
  p.act = act;
  p.out_int8 = out_int8 ? 1 : 0;
  p.vec = c % 16 == 0 && al16(x) && al16(w);
  p.o_vec = o % 16 == 0 && al16(out);
  p.rgb3 = c == 3 && k == 3;
  p.s_out = s_out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    const cudaError_t rc = cudaMemsetAsync(
        counters, 0, (size_t)(tiles_m * tiles_n) * sizeof(int), st);
    if (rc != cudaSuccess) return (int)rc;
  }
  // dynamic and static shared memory together may pass the 48 KB a
  // block takes without opting in
  const cudaError_t arc = cudaFuncSetAttribute(
      f.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  if (arc != cudaSuccess) return (int)arc;
  const dim3 grid((unsigned)tiles_m, (unsigned)tiles_n, (unsigned)splits);
  f.fn<<<grid, f.threads, f.smem, st>>>(p);
  return (int)cudaGetLastError();
}
