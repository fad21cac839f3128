// K6: a conv's batch norm and activation in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: bcnn_tpu leaves BN and the activation to XLA,
// which fuses them into the conv's output. In eager PyTorch they were
// about 15 launches a conv (ops/norm.py:batch_norm: four per-channel
// casts, the eps add, rsqrt and its casts, subtract, two multiplies, add;
// ops/activations.py: LRELU's compare, multiply and where), four of them
// full passes over the activation. K6 reads the conv's output once and
// writes the result once. Its plain version is
// bcnn_tpu_torch/ops/bn_act.py:bn_act_ref, those same torch ops.
//
// What it computes, on x (N, C, H, W) contiguous NCHW or channels-last
// (NHWC in memory), bf16 or fp32, with the per-channel vectors fp32 (C,),
// the plain version's values bit for bit, y in x's layout:
//   unfolded: m, v, s, b = T(run_mean), T(run_var), T(scales), T(biases)
//             inv = T(rsqrtf(T(v + eps)))
//             y = T(T(T(T(x - m) * inv) * s) + b)
//   folded:   y = T(T(x * s) + b)
// T rounds to x's dtype (__float2bfloat16_rn, as c10::BFloat16 rounds on
// sm_80 and later; nothing for fp32), in torch's order: (x - m) * inv *
// s + b is not re-associated into x * a + c, which would round otherwise.
// In fp32 each step is one op (__fsub_rn, __fmul_rn, __fadd_rn: never
// contracted into an FMA). In bf16 each step is one bf16x2 op on a pair
// (add/sub/mul.rn.bf16x2: one rounding of the exact result, never fused),
// which is the plain version's fp32 op and rounding to bf16: a product
// of two bf16 values is exact in fp32 (16 significant bits) wherever it
// can round to a nonzero bf16, and a sum is exact in fp32 unless the
// operands are 2^15 or more apart in size, when both ways give the
// larger.
// The constants are formed in fp32 as above. eps is the plain version's
// 1e-6 in x's dtype; rsqrtf is the function torch's CUDA rsqrt calls for
// a float. Activations: NONE; RELU as torch's clamp_min (a NaN kept, else
// fmaxf(y, 0), in fp32); LRELU as torch.where(y > 0, y, T(slope * y)),
// slope 0.1 in x's dtype; MISH as torch's CUDA mish (F.mish), y taken to
// fp32 and T(y * tanhf(log1pf(expf(y)))), the same three functions in the
// same order, rounded once; SWISH as torch's CUDA silu (F.silu), y taken
// to fp32 and T(y / (1 + expf(-y))), one IEEE add and divide, rounded
// once.
//
// What bounds it: bytes, one read and one write of each value (YOLOv3 at
// 416, batch 64, bf16: its 72 BN convs move 9.80 GB, 2.93 ms at 3.35
// TB/s). MISH adds three accurate transcendentals a value and SWISH one
// and a divide (no fast-math: torch's bits), which may put their launches
// nearer the card's fp32 issue rate than its memory. So the design moves
// each byte once, in 16-byte accesses, and
// keeps the instructions a byte few enough to stay under the memory:
// - x is walked flat as 16-byte vectors (8 bf16 or 4 fp32 values),
//   neighbouring threads on neighbouring vectors, kUnroll vectors a
//   thread in flight (every load issued before the first use); one wave
//   of resident blocks of 256 threads at most, each a run of the vectors
//   equal to within one, so that no block starts after the others end;
// - bf16 is computed two values an instruction (bf16x2), with no
//   conversion to fp32 and back between the steps;
// - a vector's channel is (i / HW) % C, from multiply-high dividers (as
//   PyTorch's IntDivider). Its four constants are derived in registers
//   from L1-cached loads of the fp32 vectors: one rsqrtf a vector, no
//   shared table, no barrier, any C. Where HW is not a multiple of the
//   vector (169 and 676 are not of 8), a vector may hold the end of one
//   plane and the start of the next: every vector of such a launch then
//   picks each value's constants from its channel's and the next's by
//   byte permutes (the next's loaded only where the vector straddles);
//   planes shorter than a vector are walked value by value;
// - the elements before x's first 16-byte boundary and after its last
//   whole vector go one a thread; where x and y are not equally aligned,
//   every element does.
// The channels-last form (bn_act_kernel_nhwc) has the same arithmetic;
// a value's channel is its innermost index, i % C:
// - where C is a multiple of the vector (8 bf16 or 4 fp32 values; every
//   BN conv of YOLOv3 and YOLOv4) and x and y lie on 16-byte boundaries,
//   each vector holds consecutive channels of one pixel, so no vector
//   straddles. Each block first forms the C channels' constants once, in
//   x's dtype, into a shared table (one array a constant), then a vector
//   takes its channels' constants as one 16-byte shared load each: in
//   bf16 the words of channel pairs, as the bf16x2 steps take them. The
//   walk of the vectors and the grid are the NCHW form's;
// - otherwise (C = 3, a misaligned x, a table past 48 KB) every value
//   goes one a thread, its channel by the divider, its constants derived
//   from the vectors as the NCHW form's scalars derive them.
// The launcher cuts the batch into runs of whole images of fewer than
// 2^31 values, so that every index is 32-bit; in either layout an image
// is one contiguous run of C * H * W values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // vectors a thread loads before it computes
constexpr int kTableKb = 48;     // the channels-last form's largest table

// bcnn_tpu_torch/types.py:Activation
constexpr int kNone = 0;
constexpr int kRelu = 2;
constexpr int kLrelu = 5;
constexpr int kMish = 10;
constexpr int kSwish = 11;

// torch's CUDA mish on a float: x * tanh(log1p(exp(x))), in that order
__device__ __forceinline__ float mish(float x) {
  return __fmul_rn(x, tanhf(log1pf(expf(x))));
}

// torch's CUDA silu on a float: x / (1 + exp(-x))
__device__ __forceinline__ float swish(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 (PyTorch's IntDivider)
struct Divider {
  unsigned m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

Divider make_divider(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1u << s) < d) ++s;
  const uint64_t one = 1;
  return {(unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

struct Params {
  const void* x;
  void* y;
  const float* mean;
  const float* var;
  const float* scale;
  const float* bias;
  unsigned n;     // values in this launch: whole images
  unsigned head;  // values before the first 16-byte vector
  unsigned nvec;  // whole 16-byte vectors after them
  unsigned hw, c;
  bool straddles;  // some vector holds values of two planes
  // NCHW: by_c divides planes by c. Channels-last: by_c divides values
  // by c, or with nvec vectors by c / V
  Divider by_hw, by_c;
  float eps, slope;  // in x's dtype
};

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;
  __device__ static float round(float v) { return v; }
  __device__ static float get(float v) { return v; }
  __device__ static float put(float v) { return v; }
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
  // value 2k is the low half of word k
  __device__ static void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  // every value is already a bf16 one (each step ends in round), so its
  // high 16 bits are the value
  __device__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (__float_as_uint(f[2 * k]) >> 16) |
             (__float_as_uint(f[2 * k + 1]) & 0xffff0000u);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

struct Consts {
  float m, inv, s, b;
};

template <typename T, bool kFolded>
__device__ __forceinline__ Consts consts(const Params& p, unsigned ch) {
  using Tr = Traits<T>;
  Consts k;
  k.s = Tr::round(__ldg(p.scale + ch));
  k.b = Tr::round(__ldg(p.bias + ch));
  k.m = k.inv = 0.f;
  if (!kFolded) {
    k.m = Tr::round(__ldg(p.mean + ch));
    const float v = Tr::round(__fadd_rn(Tr::round(__ldg(p.var + ch)), p.eps));
    k.inv = Tr::round(rsqrtf(v));
  }
  return k;
}

template <typename T, bool kFolded, int kAct>
__device__ __forceinline__ float apply(float x, const Consts& k,
                                       float slope) {
  using Tr = Traits<T>;
  float t;
  if (kFolded) {
    t = Tr::round(__fadd_rn(Tr::round(__fmul_rn(x, k.s)), k.b));
  } else {
    t = Tr::round(__fsub_rn(x, k.m));
    t = Tr::round(__fmul_rn(t, k.inv));
    t = Tr::round(__fmul_rn(t, k.s));
    t = Tr::round(__fadd_rn(t, k.b));
  }
  if (kAct == kRelu) t = t != t ? t : fmaxf(t, 0.f);  // a NaN kept
  if (kAct == kLrelu) t = t > 0.f ? t : Tr::round(__fmul_rn(slope, t));
  if (kAct == kMish) t = Tr::round(mish(t));
  if (kAct == kSwish) t = Tr::round(swish(t));
  return t;
}

// bf16 pairs, one word each, in one IEEE op with one rounding (sm_90;
// the .rn keeps ptxas from fusing a multiply and an add into an FMA)
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_sub(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a bf16 value held exactly in a float, as a pair of it
__device__ __forceinline__ unsigned twice(float v) {
  const unsigned h = __float_as_uint(v) >> 16;
  return h | (h << 16);
}

// the step of apply() on a pair of bf16 values; each op's one rounding
// of the exact result is the plain version's fp32 op and bf16 rounding
// (the note at the top)
template <bool kFolded, int kAct>
__device__ __forceinline__ unsigned apply2(unsigned t, unsigned m,
                                           unsigned inv, unsigned s,
                                           unsigned b, unsigned slope) {
  if (kFolded) {
    t = bf2_add(bf2_mul(t, s), b);
  } else {
    t = bf2_sub(t, m);
    t = bf2_mul(t, inv);
    t = bf2_mul(t, s);
    t = bf2_add(t, b);
  }
  float lo = __uint_as_float(t << 16), hi = __uint_as_float(t & 0xffff0000u);
  if (kAct == kRelu) {  // in fp32, exact: a NaN kept, else fmaxf
    lo = lo != lo ? lo : fmaxf(lo, 0.f);
    hi = hi != hi ? hi : fmaxf(hi, 0.f);
    t = (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
  }
  if (kAct == kLrelu) {
    const unsigned q = bf2_mul(slope, t);
    t = ((lo > 0.f ? t : q) & 0xffffu) | ((hi > 0.f ? t : q) & 0xffff0000u);
  }
  if (kAct == kMish || kAct == kSwish) {
    // in fp32, each half rounded to bf16 once
    using Tr = Traits<__nv_bfloat16>;
    lo = Tr::round(kAct == kMish ? mish(lo) : swish(lo));
    hi = Tr::round(kAct == kMish ? mish(hi) : swish(hi));
    t = (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
  }
  return t;
}

// the values f of a vector whose first value is value i of the launch,
// in place, one at a time in fp32: planes of fewer values than a vector
template <typename T, bool kFolded, int kAct>
__device__ void walk(const Params& p, unsigned i, float* f) {
  constexpr int V = Traits<T>::kVec;
  const unsigned plane = p.by_hw.div(i);
  unsigned r = i - plane * p.hw;
  unsigned ch = plane - p.by_c.div(plane) * p.c;
  Consts k = consts<T, kFolded>(p, ch);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (r == p.hw) {  // the next plane, the next channel
      r = 0;
      ch = ch + 1 == p.c ? 0 : ch + 1;
      k = consts<T, kFolded>(p, ch);
    }
    f[j] = apply<T, kFolded, kAct>(f[j], k, p.slope);
    ++r;
  }
}

// the vector whose first value is value i of the launch, in place.
// Where the launch has vectors that straddle two planes (p.straddles, the
// same for every thread), each picks, value by value, the constants of
// the channel the value lies in
template <typename T, bool kFolded, int kAct>
__device__ __forceinline__ void epilogue(const Params& p, unsigned i,
                                         uint4& raw) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  if (p.hw < V) {
    float f[V];
    Tr::unpack(raw, f);
    walk<T, kFolded, kAct>(p, i, f);
    raw = Tr::pack(f);
    return;
  }
  const unsigned plane = p.by_hw.div(i);
  const unsigned r = i - plane * p.hw;
  const unsigned ch = plane - p.by_c.div(plane) * p.c;
  const Consts k0 = consts<T, kFolded>(p, ch);
  Consts k1 = k0;
  unsigned split = V;  // the values in channel ch
  if (p.straddles && r + V > p.hw) {
    split = p.hw - r;
    k1 = consts<T, kFolded>(p, ch + 1 == p.c ? 0 : ch + 1);
  }
  if constexpr (sizeof(T) == 2) {
    unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    const unsigned m0 = twice(k0.m), i0 = twice(k0.inv), s0 = twice(k0.s),
                   b0 = twice(k0.b), slope = twice(p.slope);
    if (!p.straddles) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = apply2<kFolded, kAct>(w[q], m0, i0, s0, b0, slope);
    } else {
      const unsigned m1 = twice(k1.m), i1 = twice(k1.inv),
                     s1 = twice(k1.s), b1 = twice(k1.b);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // each half from channel ch's word (bytes 0-3) or the next's (4-7)
        const unsigned sel = (2 * q < split ? 0x10u : 0x54u) |
                             (2 * q + 1 < split ? 0x3200u : 0x7600u);
        w[q] = apply2<kFolded, kAct>(
            w[q], __byte_perm(m0, m1, sel), __byte_perm(i0, i1, sel),
            __byte_perm(s0, s1, sel), __byte_perm(b0, b1, sel), slope);
      }
    }
    raw = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float f[V];
    Tr::unpack(raw, f);
#pragma unroll
    for (int j = 0; j < V; ++j)
      f[j] = apply<T, kFolded, kAct>(f[j], j < split ? k0 : k1, p.slope);
    raw = Tr::pack(f);
  }
}

template <typename T, bool kFolded, int kAct>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(Params p) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const uint4* xv = reinterpret_cast<const uint4*>(x + p.head);
  uint4* yv = reinterpret_cast<uint4*>(y + p.head);
  // the block's share of the vectors: an equal run each
  const unsigned lo = (unsigned)((unsigned long long)p.nvec * blockIdx.x /
                                 gridDim.x);
  const unsigned hi = (unsigned)((unsigned long long)p.nvec *
                                 (blockIdx.x + 1) / gridDim.x);
  for (unsigned v0 = lo + threadIdx.x; v0 < hi; v0 += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kThreads;
      if (v < hi) raw[u] = __ldcs(xv + v);  // read once: evict first
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kThreads;
      if (v < hi) {
        epilogue<T, kFolded, kAct>(p, p.head + v * V, raw[u]);
        yv[v] = raw[u];
      }
    }
  }
  // the scalars: [0, head) and [head + nvec * V, n)
  const unsigned body_end = p.head + p.nvec * V;
  const unsigned scalars = p.head + (p.n - body_end);
  for (unsigned j = blockIdx.x * kThreads + threadIdx.x; j < scalars;
       j += gridDim.x * kThreads) {
    const unsigned e = j < p.head ? j : body_end + (j - p.head);
    const unsigned plane = p.by_hw.div(e);
    const unsigned ch = plane - p.by_c.div(plane) * p.c;
    y[e] = Tr::put(apply<T, kFolded, kAct>(
        Tr::get(x[e]), consts<T, kFolded>(p, ch), p.slope));
  }
}

// a channels-last vector of V channels' values, in place, with those
// channels' constants m, inv, s, b as 16 bytes of x's dtype each (in
// bf16, word q holds channels 2q and 2q + 1, as the vector's word q)
template <typename T, bool kFolded, int kAct>
__device__ __forceinline__ void epilogue_nhwc(uint4& raw, const uint4& m,
                                              const uint4& inv,
                                              const uint4& s,
                                              const uint4& b, float slope) {
  using Tr = Traits<T>;
  const unsigned wm[4] = {m.x, m.y, m.z, m.w},
                 wi[4] = {inv.x, inv.y, inv.z, inv.w},
                 ws[4] = {s.x, s.y, s.z, s.w}, wb[4] = {b.x, b.y, b.z, b.w};
  if constexpr (sizeof(T) == 2) {
    unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    const unsigned sl = twice(slope);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = apply2<kFolded, kAct>(w[q], wm[q], wi[q], ws[q], wb[q], sl);
    raw = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float f[4];
    Tr::unpack(raw, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Consts k = {__uint_as_float(wm[j]), __uint_as_float(wi[j]),
                        __uint_as_float(ws[j]), __uint_as_float(wb[j])};
      f[j] = apply<T, kFolded, kAct>(f[j], k, slope);
    }
    raw = Tr::pack(f);
  }
}

// the channels-last form (the note at the top). With vectors (p.nvec >
// 0, the launch's values all in them), a shared table of the c channels'
// constants in x's dtype: s, b, then m, inv where unfolded, c values
// each; the vector v of the launch holds channels [V j, V j + V), j = v %
// (c / V). Without, one value a thread.
template <typename T, bool kFolded, int kAct>
__global__ void __launch_bounds__(kThreads) bn_act_kernel_nhwc(Params p) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  if (p.nvec == 0) {
    for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < p.n;
         e += gridDim.x * kThreads) {
      const unsigned ch = e - p.by_c.div(e) * p.c;
      y[e] = Tr::put(apply<T, kFolded, kAct>(
          Tr::get(x[e]), consts<T, kFolded>(p, ch), p.slope));
    }
    return;
  }
  extern __shared__ uint4 table[];
  T* tab = reinterpret_cast<T*>(table);
  for (unsigned ch = threadIdx.x; ch < p.c; ch += kThreads) {
    const Consts k = consts<T, kFolded>(p, ch);
    tab[ch] = Tr::put(k.s);
    tab[p.c + ch] = Tr::put(k.b);
    if (!kFolded) {
      tab[2 * p.c + ch] = Tr::put(k.m);
      tab[3 * p.c + ch] = Tr::put(k.inv);
    }
  }
  __syncthreads();
  const unsigned cv = p.c / V;  // vectors a pixel
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const unsigned lo = (unsigned)((unsigned long long)p.nvec * blockIdx.x /
                                 gridDim.x);
  const unsigned hi = (unsigned)((unsigned long long)p.nvec *
                                 (blockIdx.x + 1) / gridDim.x);
  for (unsigned v0 = lo + threadIdx.x; v0 < hi; v0 += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kThreads;
      if (v < hi) raw[u] = __ldcs(xv + v);  // read once: evict first
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kThreads;
      if (v < hi) {
        const unsigned j = v - p.by_c.div(v) * cv;
        uint4 m = make_uint4(0, 0, 0, 0), inv = m;
        if (!kFolded) {
          m = table[2 * cv + j];
          inv = table[3 * cv + j];
        }
        epilogue_nhwc<T, kFolded, kAct>(raw[u], m, inv, table[j],
                                        table[cv + j], p.slope);
        yv[v] = raw[u];
      }
    }
  }
}

// blocks of the kernel (NCHW or channels-last) resident on an SM with
// `smem` bytes of shared memory each, asked once a size in KB (rounded
// up, so never more blocks than fit)
template <typename T, bool kFolded, int kAct, bool kNhwc>
int resident(unsigned smem) {
  static int blocks[kTableKb + 1] = {};
  const unsigned kb = (smem + 1023) / 1024;
  int& b = blocks[kb];
  if (b == 0) {
    const void* k = kNhwc ? (const void*)bn_act_kernel_nhwc<T, kFolded, kAct>
                          : (const void*)bn_act_kernel<T, kFolded, kAct>;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, kThreads,
                                                      kb * 1024) !=
            cudaSuccess ||
        b < 1)
      b = 1;
  }
  return b;
}

// one full wave of resident blocks at most, none without work
template <typename T, bool kFolded, int kAct, bool kNhwc>
void launch_act(const Params& p, unsigned work, unsigned smem, int sms,
                cudaStream_t s) {
  unsigned blocks = (work + kThreads - 1) / kThreads;
  const unsigned most =
      (unsigned)(sms * resident<T, kFolded, kAct, kNhwc>(smem));
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  if (kNhwc)
    bn_act_kernel_nhwc<T, kFolded, kAct><<<blocks, kThreads, smem, s>>>(p);
  else
    bn_act_kernel<T, kFolded, kAct><<<blocks, kThreads, 0, s>>>(p);
}

template <typename T, bool kFolded, bool kNhwc>
void launch(const Params& p, int act, unsigned work, unsigned smem, int sms,
            cudaStream_t s) {
  if (act == kRelu)
    launch_act<T, kFolded, kRelu, kNhwc>(p, work, smem, sms, s);
  else if (act == kLrelu)
    launch_act<T, kFolded, kLrelu, kNhwc>(p, work, smem, sms, s);
  else if (act == kMish)
    launch_act<T, kFolded, kMish, kNhwc>(p, work, smem, sms, s);
  else if (act == kSwish)
    launch_act<T, kFolded, kSwish, kNhwc>(p, work, smem, sms, s);
  else
    launch_act<T, kFolded, kNone, kNhwc>(p, work, smem, sms, s);
}

template <typename T>
void launch_form(const Params& p, int folded, int act, int nhwc,
                 unsigned work, unsigned smem, int sms, cudaStream_t s) {
  if (folded && nhwc)
    launch<T, true, true>(p, act, work, smem, sms, s);
  else if (folded)
    launch<T, true, false>(p, act, work, smem, sms, s);
  else if (nhwc)
    launch<T, false, true>(p, act, work, smem, sms, s);
  else
    launch<T, false, false>(p, act, work, smem, sms, s);
}

}  // namespace

// x and y: (n, c, h*w = hw) contiguous (nhwc == 0) or (n, hw, c)
// contiguous (nhwc != 0, channels-last), bf16 (bf16 != 0) or fp32, on
// the device, y allocated by the caller in x's layout; mean, var, scale,
// bias: fp32 (c,) on the device (mean and var unread when folded). eps
// and slope: 1e-6 and 0.1 in x's dtype. act: 0 (NONE), 2 (RELU), 5
// (LRELU), 10 (MISH) or 11 (SWISH). Launches on `stream` (once for each
// run of whole images of fewer than 2^31 values) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int bcnn_bn_act(const void* x, void* y, const void* mean,
                           const void* var, const void* scale,
                           const void* bias, long long n, int c,
                           long long hw, int bf16, int folded, int act,
                           int nhwc, float eps, float slope, void* stream) {
  if (n < 0 || c < 1 || hw < 1 || (long long)c * hw > INT_MAX ||
      (act != kNone && act != kRelu && act != kLrelu && act != kMish &&
       act != kSwish))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long image = (long long)c * hw;
  const long long run = INT_MAX / image;  // whole images a launch
  const int esize = bf16 ? 2 : 4;
  const unsigned vec = 16 / esize;
  // the channels-last form's table: 2 or 4 constants a channel
  const long long table = (folded ? 2LL : 4LL) * c * esize;
  const bool vectors = c % vec == 0 && table <= kTableKb * 1024;
  Params p;
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.hw = (unsigned)hw;
  p.c = (unsigned)c;
  p.by_hw = make_divider(p.hw);
  p.eps = eps;
  p.slope = slope;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (long long i0 = 0; i0 < n; i0 += run) {
    const long long off = i0 * image * esize;
    p.x = static_cast<const char*>(x) + off;
    p.y = static_cast<char*>(y) + off;
    p.n = (unsigned)((n - i0 < run ? n - i0 : run) * image);
    const uintptr_t ax = reinterpret_cast<uintptr_t>(p.x) & 15;
    const uintptr_t ay = reinterpret_cast<uintptr_t>(p.y) & 15;
    unsigned work, smem = 0;
    if (nhwc) {  // vectors of whole channel groups, or one value a thread
      p.head = 0;
      p.nvec = vectors && ax == 0 && ay == 0 ? p.n / vec : 0;
      p.straddles = false;
      p.by_c = make_divider(p.nvec ? p.c / vec : p.c);
      work = p.nvec ? p.nvec : p.n;
      if (p.nvec) smem = (unsigned)table;
    } else {
      if (ax != ay) {  // no 16-byte access lines up for both
        p.head = p.n;
        p.nvec = 0;
      } else {
        p.head = (unsigned)(((16 - ax) & 15) / esize);
        if (p.head > p.n) p.head = p.n;
        p.nvec = (p.n - p.head) / vec;
      }
      p.straddles = p.hw % vec != 0 || p.head != 0;
      p.by_c = make_divider(p.c);
      const unsigned scalars = p.n - p.nvec * vec;
      work = p.nvec > scalars ? p.nvec : scalars;
    }
    if (bf16)
      launch_form<__nv_bfloat16>(p, folded, act, nhwc, work, smem, sms, s);
    else
      launch_form<float>(p, folded, act, nhwc, work, smem, sms, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
