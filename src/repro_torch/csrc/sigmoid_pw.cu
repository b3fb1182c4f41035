// sigmoid_pw: the piecewise-linear (PLAN) sigmoid, elementwise, and its
// backward.
//
// Replaces the TPU kernel src/repro/kernels/sigmoid_pw/kernel.py::
// sigmoid_pw_pallas (oracle src/repro/kernels/sigmoid_pw/ref.py):
//
//   y(|x|) = 1                      |x| >= 5
//          = 0.03125|x| + 0.84375   2.375 <= |x| < 5
//          = 0.125 |x| + 0.625      1     <= |x| < 2.375
//          = 0.25  |x| + 0.5        0     <= |x| < 1
//   y(-x)  = 1 - y(x)
//
// computed in fp32 with one cast to x's dtype. The backward is
// gx = g * slope(|x|) with slopes 1/32 / 1/8 / 1/4 at the same >= breaks,
// 1/4 at x = 0 and x = -0, and exactly +0 where |x| >= 5 (JAX's gradient of
// the oracle).
//
// Layout: x, y (and g, gx) contiguous, n elements, fp32 (code 0) or bf16
// (code 1), all of one type.
//
// Exactness: every slope is a power of two, so each product is exact and
// the one rounding is the add (written as mul then add, as the plain
// version does); 1 - y is exact for y in [1/2, 1]. The kernel is therefore
// bit-identical to the plain version, in bf16 after the one round-to-
// nearest-even cast. NaN propagates (no fminf/fmaxf clamp): |NaN| fails
// every >= test and 0.25 * NaN + 0.5 is NaN; +-inf map to 1 and 0.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (8 bytes in fp32); at the paper MLP's (100, 1022) fp32 activations
// that is 818 KB, 0.24 us at 3.35 TB/s, far under the launch latency, so on
// the MLP's path the kernel is launch-bound.
//
// What the design does about it: one grid-stride kernel, templated over the
// element type and the op (forward or backward), in which each thread moves
// 16-byte vectors (four floats or eight bf16 values in a uint4), so a large
// tensor streams at full width and a small one takes one short launch; a
// scalar loop handles the tail and a misaligned pointer. The paper MLP's
// deployed forward does not take this route under 8-bit signals: there the
// sigmoid and the signal's quantization are one launch, the signal route
// below.
//
// The signal route (sigmoid_pw_kernel_signal): the activation stage of the
// quantized MLP, y = sigmoid_pw(x) followed by the 8-bit signal between
// layers (core/qat.py::fake_quant_act(y, bits, signed=False)), for x (M, N)
// contiguous, one dynamic scale per row:
//
//   y   = sigmoid_pw(x)              in x's dtype (bf16: rounded first)
//   s   = max(rowmax(float(y)) / (2^bits - 1), 1e-12)
//   out = clip(round_half_even(float(y) / s), 0, 2^bits - 1) * s   -> x's dtype
//
// bit-identical to that chain as PyTorch runs it on the CPU (the plain
// version, ref.py::sigmoid_pw_signal): the division and the product are
// IEEE round-to-nearest (__fdiv_rn, __fmul_rn) and the round is rintf.
// The chain's straight-through round, x + (round(x) - x), is exactly
// round(x) here: 0 <= x <= 2^bits (x = y / s, y <= rowmax), so round(x) - x
// is exact and so is the sum, an integer. (PyTorch's CUDA division by a
// Python number multiplies by its reciprocal, so the chain run on the card
// can differ from this by an ulp of s; the route keeps the CPU's bits.)
// NaN propagates as torch's amax and maximum propagate it: one NaN in a row
// makes its max, its scale and every output of the row NaN, so no fmaxf
// (which drops a NaN) is used. The PLAN sigmoid maps every x to [0, 1], so
// a row with every x <= -5 has max 0, s = 1e-12 and all-zero outputs.
//
// What bounds it on the H100: bytes, 2 x M x N x sizeof(T) (x read once, the
// signal written once): at (100, 1022) fp32 818 KB, 0.244 us at 3.35 TB/s.
// At the MLP's shapes a launch costs more than that, so a launch, not
// bandwidth, sets its floor; what the route saves is the chain's dozen
// launches (the sigmoid, an amax, divisions, fills, max and min, round,
// the straight-through add, the product) and their round trips through
// device memory.
//
// Design: one group of G threads (a multiple of 32) a row, 256 / G rows a
// block, so a short row does not leave a block mostly idle. The group
// covers the row by 16-byte vectors (V elements) of the window of whole
// vectors that holds it (rows of N = 1022 fp32 start 8 bytes off a vector
// every other row); lanes outside the row are masked, and a vector that
// straddles a row's edge is stored element by element, so no block writes
// another row's outputs. Each thread keeps its VPT vectors' PLAN values in
// registers (N = 1022: one vector a thread); the row max is a warp shuffle
// and one step through an 8-float __shared__ array, then the quantize and
// store pass runs from the registers: x is read once and the signal written
// once. A row longer than 256 x 8 vectors (8192 fp32) streams instead
// (VPT = 0): x is read twice, the second time mostly from L2. A pointer off
// 16 bytes takes V = 1 (scalar, coalesced) accesses.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 32;

__device__ __forceinline__ float plan(float x) {
  const float a = fabsf(x);
  float y;
  if (a >= 5.f)
    y = 1.f;
  else if (a >= 2.375f)
    y = __fadd_rn(__fmul_rn(0.03125f, a), 0.84375f);
  else if (a >= 1.f)
    y = __fadd_rn(__fmul_rn(0.125f, a), 0.625f);
  else
    y = __fadd_rn(__fmul_rn(0.25f, a), 0.5f);
  return x < 0.f ? __fsub_rn(1.f, y) : y;
}

// g * slope(|x|); exactly +0 where |x| >= 5, as JAX's where-transposes give.
__device__ __forceinline__ float grad(float x, float g) {
  const float a = fabsf(x);
  if (a >= 5.f) return 0.f;
  return __fmul_rn(g, a >= 2.375f ? 0.03125f : a >= 1.f ? 0.125f : 0.25f);
}

// The two element-wise ops: the forward reads x, the backward x and g.
struct Plan {
  static constexpr bool kReadsG = false;
  __device__ float operator()(float x, float) const { return plan(x); }
};
struct Grad {
  static constexpr bool kReadsG = true;
  __device__ float operator()(float x, float g) const { return grad(x, g); }
};

// One 16-byte vector of T as fp32 lanes: four floats, or eight bf16 values
// (the low half of each 32-bit word first).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(uint4 w, float* f) {
    f[0] = __uint_as_float(w.x); f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z); f[3] = __uint_as_float(w.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(const float* f) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[1])) << 16);
  }
  __device__ static void load(uint4 w, float* f) {
    unpack(w.x, f); unpack(w.y, f + 2); unpack(w.z, f + 4); unpack(w.w, f + 6);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(pack(f), pack(f + 2), pack(f + 4), pack(f + 6));
  }
};

// out = op(x, g) over n elements: nvec 16-byte vectors over a grid-stride
// loop, then the scalar tail. g is unread (and may be null) for the forward.
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
sigmoid_pw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  T* __restrict__ out, long long n, long long nvec) {
  using V = Vec<T>;
  const Op op;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long v = i0; v < nvec; v += stride) {
    float a[V::N], b[V::N] = {};
    V::load(xv[v], a);
    if constexpr (Op::kReadsG) V::load(gv[v], b);
#pragma unroll
    for (int i = 0; i < V::N; ++i) a[i] = op(a[i], b[i]);
    ov[v] = V::store(a);
  }
  for (long long t = nvec * V::N + i0; t < n; t += stride) {
    float gt = 0.f;
    if constexpr (Op::kReadsG) gt = rt::to_f(g[t]);
    out[t] = rt::from_f<T>(op(rt::to_f(x[t]), gt));
  }
}

template <typename T, typename Op>
void launch_as(const void* x, const void* g, void* out, long long n,
               cudaStream_t st) {
  // 16-byte vectors when every pointer is 16-byte aligned, else none.
  const uintptr_t bits = (uintptr_t)x | (uintptr_t)(g ? g : x) | (uintptr_t)out;
  const long long nvec = (bits & 15) ? 0 : n / Vec<T>::N;
  long long blocks = (nvec + n - nvec * Vec<T>::N + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  sigmoid_pw_kernel<T, Op><<<(unsigned)(blocks < 1 ? 1 : blocks), THREADS, 0, st>>>(
      (const T*)x, (const T*)g, (T*)out, n, nvec);
}

// dtype: 0 fp32, 1 bf16. Returns the CUDA error code of the launch.
template <typename Op>
int launch(const void* x, const void* g, void* out, long long n, int dtype,
           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch_as<float, Op>(x, g, out, n, st);
  else if (dtype == 1)
    launch_as<__nv_bfloat16, Op>(x, g, out, n, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// --- the signal route --------------------------------------------------------

constexpr int SIG_WARPS = THREADS / 32;

// max that propagates NaN, as torch.amax and torch.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The value of y the chain quantizes: the PLAN sigmoid in x's dtype, as fp32.
template <typename T>
__device__ __forceinline__ float plan_as(float x) {
  return rt::round_to<T>(plan(x));
}

// V elements of T at vector j of a tensor of n elements, as fp32: one 16-byte
// load where the whole vector lies inside the tensor, else element by element
// (past the end reads as 0; those lanes are outside every row).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ x, long long j,
                                         long long n, float* f) {
  if constexpr (V > 1) {
    if ((j + 1) * V <= n) {
      Vec<T>::load(reinterpret_cast<const uint4*>(x)[j], f);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long e = j * V + k;
    f[k] = e < n ? rt::to_f(x[e]) : 0.f;
  }
}

// Store the lanes of vector j that lie in the row [rs, re): one 16-byte
// store where the whole vector does.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ out, long long j,
                                          long long rs, long long re,
                                          const float* f) {
  if constexpr (V > 1) {
    if (j * V >= rs && (j + 1) * V <= re) {
      reinterpret_cast<uint4*>(out)[j] = Vec<T>::store(f);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long e = j * V + k;
    if (e >= rs && e < re) out[e] = rt::from_f<T>(f[k]);
  }
}

// The signal of one element: clip(rint(y / s), 0, levels) * s, with the
// clip written as comparisons so that a NaN passes through.
__device__ __forceinline__ float quantize(float y, float s, float levels) {
  float q = rintf(__fdiv_rn(y, s));
  q = q < 0.f ? 0.f : q;
  q = q > levels ? levels : q;
  return __fmul_rn(q, s);
}

// Rows of N elements, G threads a row, VPT 16-byte vectors a thread held in
// registers (VPT = 0: a row of any length, streamed twice).
template <typename T, int V, int G, int VPT>
__global__ void __launch_bounds__(THREADS)
sigmoid_pw_kernel_signal(const T* __restrict__ x, T* __restrict__ out,
                         long long M, long long N, float levels) {
  static_assert(G % 32 == 0 && THREADS % G == 0, "a row is whole warps");
  __shared__ float red[SIG_WARPS];
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const long long row = (long long)blockIdx.x * (THREADS / G) + g;
  const bool live = row < M;
  const long long n = M * N, rs = row * N, re = rs + N;
  const long long vs = rs / V, ve = (re + V - 1) / V;   // the row's window
  float y[VPT > 0 ? VPT : 1][V];
  float mx = __int_as_float(0xff800000u);              // -inf
  if (live) {
    if constexpr (VPT > 0) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const long long j = vs + t + (long long)i * G;
        if (j >= ve) break;
        load_vec<T, V>(x, j, n, y[i]);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const long long e = j * V + k;
          y[i][k] = plan_as<T>(y[i][k]);
          if (e >= rs && e < re) mx = nan_max(mx, y[i][k]);
        }
      }
    } else {
      for (long long j = vs + t; j < ve; j += G) {
        float f[V];
        load_vec<T, V>(x, j, n, f);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const long long e = j * V + k;
          if (e >= rs && e < re) mx = nan_max(mx, plan_as<T>(f[k]));
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  constexpr int WPR = G / 32;                         // warps a row
  float amax = red[g * WPR];
#pragma unroll
  for (int w = 1; w < WPR; ++w) amax = nan_max(amax, red[g * WPR + w]);
  const float s = nan_max(__fdiv_rn(amax, levels), 1e-12f);
  if (!live) return;
  if constexpr (VPT > 0) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const long long j = vs + t + (long long)i * G;
      if (j >= ve) break;
#pragma unroll
      for (int k = 0; k < V; ++k) y[i][k] = quantize(y[i][k], s, levels);
      store_vec<T, V>(out, j, rs, re, y[i]);
    }
  } else {
    for (long long j = vs + t; j < ve; j += G) {
      float f[V];
      load_vec<T, V>(x, j, n, f);
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = quantize(plan_as<T>(f[k]), s, levels);
      store_vec<T, V>(out, j, rs, re, f);
    }
  }
}

template <typename T, int V, int G, int VPT>
void signal_as(const void* x, void* out, long long M, long long N,
               float levels, cudaStream_t st) {
  const long long rows = THREADS / G;
  sigmoid_pw_kernel_signal<T, V, G, VPT>
      <<<(unsigned)((M + rows - 1) / rows), THREADS, 0, st>>>(
          (const T*)x, (T*)out, M, N, levels);
}

// The plan: the fewest threads a row whose vectors cover the row's window,
// then more vectors a thread, then the streamed kernel. A row starts
// r N mod V elements into a vector, a multiple of gcd(N, V), so its window
// is at most ceil((N + V - gcd(N, V)) / V) vectors (N = 1022 fp32: 256).
// Mirrored by kernels/sigmoid_pw/kernel.py::signal_plan.
template <typename T, int V>
void signal_by_width(const void* x, void* out, long long M, long long N,
                     float levels, cudaStream_t st) {
  long long a = N, b = V;
  while (b) { const long long r = a % b; a = b; b = r; }   // gcd(N, V)
  const long long w = (N + V - a + V - 1) / V;
  if (w <= 32) signal_as<T, V, 32, 1>(x, out, M, N, levels, st);
  else if (w <= 64) signal_as<T, V, 64, 1>(x, out, M, N, levels, st);
  else if (w <= 128) signal_as<T, V, 128, 1>(x, out, M, N, levels, st);
  else if (w <= 256) signal_as<T, V, 256, 1>(x, out, M, N, levels, st);
  else if (w <= 512) signal_as<T, V, 256, 2>(x, out, M, N, levels, st);
  else if (w <= 1024) signal_as<T, V, 256, 4>(x, out, M, N, levels, st);
  else if (w <= 2048) signal_as<T, V, 256, 8>(x, out, M, N, levels, st);
  else signal_as<T, V, 256, 0>(x, out, M, N, levels, st);
}

template <typename T>
void signal_launch_as(const void* x, void* out, long long M, long long N,
                      float levels, cudaStream_t st) {
  if (((uintptr_t)x | (uintptr_t)out) & 15)
    signal_by_width<T, 1>(x, out, M, N, levels, st);
  else
    signal_by_width<T, Vec<T>::N>(x, out, M, N, levels, st);
}

}  // namespace

extern "C" int sigmoid_pw_launch(const void* x, void* y, long long n,
                                 int dtype, void* stream) {
  return launch<Plan>(x, nullptr, y, n, dtype, stream);
}

extern "C" int sigmoid_pw_bwd_launch(const void* x, const void* g, void* gx,
                                     long long n, int dtype, void* stream) {
  return launch<Grad>(x, g, gx, n, dtype, stream);
}

// x and out (M, N) contiguous of dtype (0 fp32, 1 bf16); levels = 2^bits - 1.
extern "C" int sigmoid_pw_signal_launch(const void* x, void* out, long long M,
                                        long long N, float levels, int dtype,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return 0;
  if (dtype == 0)
    signal_launch_as<float>(x, out, M, N, levels, st);
  else if (dtype == 1)
    signal_launch_as<__nv_bfloat16>(x, out, M, N, levels, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
