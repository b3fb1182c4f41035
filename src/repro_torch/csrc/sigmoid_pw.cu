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
// scalar loop handles the tail and a misaligned pointer. Fusing the
// activation into the qmatvec epilogue, which removes the launch and the
// round trip of the activations, is later work.
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

}  // namespace

extern "C" int sigmoid_pw_launch(const void* x, void* y, long long n,
                                 int dtype, void* stream) {
  return launch<Plan>(x, nullptr, y, n, dtype, stream);
}

extern "C" int sigmoid_pw_bwd_launch(const void* x, const void* g, void* gx,
                                     long long n, int dtype, void* stream) {
  return launch<Grad>(x, g, gx, n, dtype, stream);
}
