// K1: YOLO head decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bcnn_tpu/ops/yolo_pallas.py:decode_fused
// (`_kernel`, the pallas_call at yolo_pallas.py:74). From the raw head
// x (N, A*(5+K), H, W) fp32, channel c = a*(5+K) + e, it writes, for
// candidate m = (row*W + col)*A + a:
//   boxes[n, m] = ((col + s(tx))/W, (row + s(ty))/H,
//                  e^tw * aw / net_w, e^th * ah / net_h)
//   obj[n, m]   = s(to)
//   probs[n, m, k] = s(to) * s(tc_k)
// with s the logistic function. The plain PyTorch version is
// bcnn_tpu_torch/ops/yolo_decode.py:decode_grid_ref.
//
// What bounds it: bytes. Each candidate reads 5+K floats and writes 5+K,
// with a few exp/div each; at batch 8 and 80 classes the two heads of
// YOLOv3-tiny at 416 px move about 14 MB, far below the card's compute.
// Design: one thread per (n, anchor, location), with the location index
// fastest, so the 32 threads of a warp read 32 neighbouring floats of one
// channel plane (coalesced) for each of the 5+K channels. Each thread then
// writes its own box (one 16-byte store), objectness and K-float class row;
// those rows are A*K floats apart across neighbouring threads, so the class
// writes are not coalesced. A shared-memory transpose that makes them so is
// later work. expf and 1/(1+expf(-v)) without fast-math keep the kernel
// within rtol 1e-5, atol 1e-6 of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxAnchors = 16;
constexpr int kThreads = 128;

// anchor sizes of the head's mask, passed by value in the kernel's
// parameters: the kernel allocates nothing and reads no extra buffer
struct Anchors {
  float w[kMaxAnchors];
  float h[kMaxAnchors];
};

__device__ __forceinline__ float logistic(float v) {
  return 1.f / (1.f + expf(-v));
}

__global__ void __launch_bounds__(kThreads)
yolo_decode_kernel(const float* __restrict__ x, float4* __restrict__ boxes,
                   float* __restrict__ obj, float* __restrict__ probs,
                   Anchors anchors, int num, int classes, int grid_h,
                   int grid_w, float net_w, float net_h, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int hw = grid_h * grid_w;
  const int loc = (int)(t % hw);
  const long long na = t / hw;  // n*num + a
  const int a = (int)(na % num);
  const long long n = na / num;
  const int e = 5 + classes;
  const int row = loc / grid_w;
  const int col = loc - row * grid_w;

  // channel plane (a*e + ch) of image n: ((n*num + a)*e + ch)*hw + loc
  const float* xa = x + na * e * hw + loc;
  const long long m = (n * hw + loc) * num + a;

  const float bx = ((float)col + logistic(xa[0])) / (float)grid_w;
  const float by = ((float)row + logistic(xa[hw])) / (float)grid_h;
  // select the anchor with constant indices: indexing the parameter
  // struct with `a` would copy it to local memory
  float aw = 0.f, ah = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxAnchors; ++i) {
    if (i == a) {
      aw = anchors.w[i];
      ah = anchors.h[i];
    }
  }
  const float bw = expf(xa[2 * hw]) * aw / net_w;
  const float bh = expf(xa[3 * hw]) * ah / net_h;
  const float o = logistic(xa[4 * hw]);
  boxes[m] = make_float4(bx, by, bw, bh);
  obj[m] = o;
  float* p = probs + m * classes;
  const float* xc = xa + 5 * hw;
  for (int k = 0; k < classes; ++k) p[k] = o * logistic(xc[(long long)k * hw]);
}

}  // namespace

// x: (n, num*(5+classes), grid_h, grid_w) fp32, contiguous, on the device.
// boxes (n, grid_h*grid_w*num, 4), obj (n, grid_h*grid_w*num) and
// probs (n, grid_h*grid_w*num, classes) are fp32 outputs the caller
// allocated. anchors_wh is a HOST array (aw0, ah0, aw1, ah1, ...) of
// 2*num floats. Launches on `stream` and returns cudaGetLastError().
extern "C" int bcnn_yolo_decode(const void* x, void* boxes, void* obj,
                                void* probs, const void* anchors_wh, int n,
                                int num, int classes, int grid_h, int grid_w,
                                float net_w, float net_h, void* stream) {
  if (num < 1 || num > kMaxAnchors || classes < 0 || n < 0 || grid_h < 0 ||
      grid_w < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * num * grid_h * grid_w;
  if (total == 0) return (int)cudaSuccess;
  Anchors anchors = {};
  const float* awh = static_cast<const float*>(anchors_wh);
  for (int a = 0; a < num; ++a) {
    anchors.w[a] = awh[2 * a];
    anchors.h[a] = awh[2 * a + 1];
  }
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  yolo_decode_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float4*>(boxes),
      static_cast<float*>(obj), static_cast<float*>(probs), anchors, num,
      classes, grid_h, grid_w, net_w, net_h, total);
  return (int)cudaGetLastError();
}

extern "C" const char* bcnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
