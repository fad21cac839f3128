// K1: YOLO head decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bcnn_tpu/ops/yolo_pallas.py:decode_fused
// (yolo_pallas.py:57, `_kernel`, the pallas_call at :74). From the raw
// head x (N, A*(5+K), H, W) fp32, channel c = a*(5+K) + e, it writes, for
// candidate m = (row*W + col)*A + a:
//   boxes[n, m] = ((col + s(tx))/W, (row + s(ty))/H,
//                  e^tw * aw / net_w, e^th * ah / net_h)
//   obj[n, m]   = s(to)
//   probs[n, m, k] = s(to) * s(tc_k)
// with s the logistic function. The plain PyTorch version is
// bcnn_tpu_torch/ops/yolo_decode.py:decode_grid_ref.
//
// What bounds it: bytes in principle (each candidate reads 5+K floats and
// writes 5+K, a few exp/div each: at batch 8 and 80 classes the two heads
// of YOLOv3-tiny at 416 px move 2.8 and 11 MB, 0.8 and 3.3 us at 3.35
// TB/s), but at these sizes the time is latency: the launch (about 2 us
// on the card), one round trip to memory and the stores. So the design
// keeps the dependent steps few and every access coalesced:
// - A block takes one image and a chunk of L locations (a power of 2)
//   across all A anchors: grid N * ceil(HW / L). L is 16, or 8 where 16
//   would give fewer than two blocks an SM (the 13x13 head at batch 8:
//   176 blocks), and smaller only where the stage would not fit 48 KB.
// - It stages x[n, :, loc0:loc0+L] into shared memory, a row of L (+1,
//   against bank conflicts) floats a channel, read along the location
//   (coalesced), all of a thread's loads issued before the first use; it
//   turns each value into its sigmoid or exp, or its finished box
//   coordinate, as it stores it: each computed once.
// - In (location, anchor) order the block's outputs are three contiguous
//   ranges: L*A boxes (one float4 each), L*A objectness values and
//   L*A*K probabilities, the last written as aligned float4s (scalar head
//   and tail), 4 neighbouring outputs a thread, so the stores coalesce.
// - Where A*(5+K)*(L+1) floats would not fit even at L = 1, the classes
//   go through the stage kc at a time (a loop, one pass at the path's
//   shapes), their probabilities written as scalars.
// expf and 1/(1+expf(-v)) without fast-math keep the kernel within rtol
// 1e-5, atol 1e-6 of the plain version.
//
// Left behind from the TPU kernel: its NHWC input in lane-dense tiles;
// here x stays NCHW, and the turn to (location, anchor) order happens in
// shared memory.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxAnchors = 16;
constexpr int kThreads = 256;
constexpr int kBatch = 16;              // loads a thread issues together
constexpr int kSmemFloats = 12 * 1024;  // 48 KB: no opt-in needed

// anchor sizes of the head's mask, passed by value in the kernel's
// parameters: the kernel allocates nothing and reads no extra buffer
struct Anchors {
  float w[kMaxAnchors];
  float h[kMaxAnchors];
};

struct Decode {
  const float* x;
  float4* boxes;
  float* obj;
  float* probs;
  int num, classes, grid_h, grid_w, hw;
  int lg, chunks;  // L = 2^lg locations a block; blocks an image
  int kc;          // classes staged at once
  float net_w, net_h;
};

__device__ __forceinline__ float logistic(float v) {
  return 1.f / (1.f + expf(-v));
}

// floor(v / d) for 0 <= v < 2^22, with inv = 1/d rounded: the rounding
// error, under (v + 0.5) * 2^-23 / d, is less than the 0.5 / d between
// (v + 0.5) / d and the nearest integer
__device__ __forceinline__ int div_small(int v, float inv) {
  return (int)(((float)v + 0.5f) * inv);
}

// floats between the 16-byte boundary at or below p and p
__device__ __forceinline__ int head_of(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// Where the block's staged rows live: box rows a*5 + e (e < 5), then
// class rows A*5 + a*kn + kk for classes k0 + kk of the current chunk;
// row r, location l at sm[r * P + l].
struct Block {
  int n, loc0, lb, L, P;
  long long m0;  // the block's first candidate (n*hw + loc0)*A
};

// Stage rows [first, last) at the thread's location l: rows
// r0, r0 + step, ... Each value is read, then stored as what the outputs
// use: box coordinates finished, objectness and classes as sigmoids.
__device__ __forceinline__ void stage(const Decode& p, const Block& b,
                                      const Anchors& anchors, float* sm,
                                      int first, int last, int k0, int kn) {
  const int A = p.num, E = 5 + p.classes;
  const int l = threadIdx.x & (b.L - 1);
  const int step = kThreads >> p.lg;
  const bool live = l < b.lb;
  const int loc = b.loc0 + l;
  const float* xl = p.x + (long long)b.n * A * E * p.hw + loc;
  const float inv_kn = kn > 0 ? 1.f / (float)kn : 0.f;
  for (int base = first + (threadIdx.x >> p.lg); base < last;
       base += kBatch * step) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = base + u * step;
      v[u] = 0.f;
      if (live && row < last) {
        int ch;
        if (row < A * 5) {
          const int a = row / 5;
          ch = a * E + row - a * 5;
        } else {
          const int r = row - A * 5;
          const int a = div_small(r, inv_kn);
          ch = a * E + 5 + k0 + r - a * kn;
        }
        v[u] = __ldg(xl + (long long)ch * p.hw);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = base + u * step;
      if (row >= last) break;
      float out = 0.f;
      if (row >= A * 5) {
        out = logistic(v[u]);
      } else {
        const int a = row / 5, e = row - a * 5;
        if (e == 0) {
          const int gy = loc / p.grid_w;
          out = ((float)(loc - gy * p.grid_w) + logistic(v[u])) /
                (float)p.grid_w;
        } else if (e == 1) {
          out = ((float)(loc / p.grid_w) + logistic(v[u])) / (float)p.grid_h;
        } else if (e == 4) {
          out = logistic(v[u]);
        } else {
          // select the anchor with constant indices: indexing the
          // parameter struct with `a` would copy it to local memory
          float aw = 0.f, ah = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxAnchors; ++i) {
            if (i == a) {
              aw = anchors.w[i];
              ah = anchors.h[i];
            }
          }
          out = e == 2 ? expf(v[u]) * aw / p.net_w
                       : expf(v[u]) * ah / p.net_h;
        }
      }
      sm[row * b.P + l] = out;
    }
  }
}

// probability of candidate cq (= location*A + anchor) of the block and
// class kk of the staged chunk
__device__ __forceinline__ float prob(const Decode& p, const Block& b,
                                      const float* sm, int cq, int kk,
                                      int kn, float inv_a) {
  const int l = div_small(cq, inv_a);
  const int a = cq - l * p.num;
  return sm[(a * 5 + 4) * b.P + l] *
         sm[(p.num * 5 + a * kn + kk) * b.P + l];
}

__device__ __forceinline__ void write_probs(const Decode& p, const Block& b,
                                            const float* sm, int k0, int kn) {
  const int K = p.classes;
  const int cand = b.lb * p.num;
  const float inv_a = 1.f / (float)p.num;
  const int tid = threadIdx.x;
  if (kn < K) {  // a chunk of the classes: runs of kn floats K apart
    const float inv_kn = 1.f / (float)kn;
    for (int q = tid; q < cand * kn; q += kThreads) {
      const int cq = div_small(q, inv_kn);
      const int kk = q - cq * kn;
      p.probs[(b.m0 + cq) * K + k0 + kk] = prob(p, b, sm, cq, kk, kn, inv_a);
    }
    return;
  }
  // all classes: the block's probabilities are one contiguous range
  float* dst = p.probs + b.m0 * K;
  const int len = cand * K;
  const float inv_k = 1.f / (float)K;
  const int oh = min((4 - head_of(dst)) & 3, len);
  const int nvec = (len - oh) >> 2;
  const int tail0 = oh + 4 * nvec;
  if (tid < oh + len - tail0) {
    const int e = tid < oh ? tid : tail0 + tid - oh;
    const int cq = div_small(e, inv_k);
    dst[e] = prob(p, b, sm, cq, e - cq * K, K, inv_a);
  }
  for (int v = tid; v < nvec; v += kThreads) {
    const int e = oh + 4 * v;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cq = div_small(e + j, inv_k);
      r[j] = prob(p, b, sm, cq, e + j - cq * K, K, inv_a);
    }
    *reinterpret_cast<float4*>(dst + e) = make_float4(r[0], r[1], r[2], r[3]);
  }
}

// grid: one block per (image, chunk of L locations)
__global__ void __launch_bounds__(kThreads)
yolo_decode_kernel(Decode p, Anchors anchors) {
  extern __shared__ float sm[];
  Block b;
  b.n = blockIdx.x / p.chunks;
  b.L = 1 << p.lg;
  b.P = b.L + 1;
  b.loc0 = (blockIdx.x - b.n * p.chunks) * b.L;
  b.lb = min(b.L, p.hw - b.loc0);
  b.m0 = ((long long)b.n * p.hw + b.loc0) * p.num;
  const int A = p.num;
  int kn = min(p.kc, p.classes);
  stage(p, b, anchors, sm, 0, A * (5 + kn), 0, kn);
  __syncthreads();
  const float inv_a = 1.f / (float)A;
  for (int q = threadIdx.x; q < b.lb * A; q += kThreads) {
    const int l = div_small(q, inv_a);
    const float* s = sm + (q - l * A) * 5 * b.P + l;
    p.boxes[b.m0 + q] = make_float4(s[0], s[b.P], s[2 * b.P], s[3 * b.P]);
    p.obj[b.m0 + q] = s[4 * b.P];
  }
  if (kn > 0) write_probs(p, b, sm, 0, kn);
  for (int k0 = kn; k0 < p.classes; k0 += kn) {
    kn = min(p.kc, p.classes - k0);
    __syncthreads();  // every read of the last chunk is done
    stage(p, b, anchors, sm, A * 5, A * (5 + kn), k0, kn);
    __syncthreads();
    write_probs(p, b, sm, k0, kn);
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// x: (n, num*(5+classes), grid_h, grid_w) fp32, contiguous, on the device.
// boxes (n, grid_h*grid_w*num, 4), obj (n, grid_h*grid_w*num) and
// probs (n, grid_h*grid_w*num, classes) are fp32 outputs the caller
// allocated. anchors_wh is a HOST array (aw0, ah0, aw1, ah1, ...) of
// 2*num floats. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int bcnn_yolo_decode(const void* x, void* boxes, void* obj,
                                void* probs, const void* anchors_wh, int n,
                                int num, int classes, int grid_h, int grid_w,
                                float net_w, float net_h, void* stream) {
  if (num < 1 || num > kMaxAnchors || classes < 0 || n < 0 || grid_h < 0 ||
      grid_w < 0)
    return (int)cudaErrorInvalidValue;
  const long long hw = (long long)grid_h * grid_w;
  if (n == 0 || hw == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)num * (5 + classes);  // channels
  int lg = n * cdiv(hw, 16) >= 2LL * sms ? 4 : 3;
  while (lg > 0 && rows * ((1 << lg) + 1) > kSmemFloats) --lg;
  const int P = (1 << lg) + 1;
  long long kc = classes;
  if (rows * P > kSmemFloats) kc = kSmemFloats / (num * P) - 5;
  const long long chunks = cdiv(hw, 1 << lg);
  if (hw > INT_MAX || rows > INT_MAX || n * chunks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Decode p;
  p.x = static_cast<const float*>(x);
  p.boxes = static_cast<float4*>(boxes);
  p.obj = static_cast<float*>(obj);
  p.probs = static_cast<float*>(probs);
  p.num = num;
  p.classes = classes;
  p.grid_h = grid_h;
  p.grid_w = grid_w;
  p.hw = (int)hw;
  p.lg = lg;
  p.chunks = (int)chunks;
  p.kc = (int)kc;
  p.net_w = net_w;
  p.net_h = net_h;
  Anchors anchors = {};
  const float* awh = static_cast<const float*>(anchors_wh);
  for (int a = 0; a < num; ++a) {
    anchors.w[a] = awh[2 * a];
    anchors.h[a] = awh[2 * a + 1];
  }
  const size_t smem = 4ull * num * (5 + kc) * P;
  yolo_decode_kernel<<<(unsigned)(n * chunks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p, anchors);
  return (int)cudaGetLastError();
}

extern "C" const char* bcnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
