// Shared helpers of the port's CUDA kernels: element conversions, an exact
// int8 -> bf16x2 conversion, a warp-wide sum and the promotion of tensor-core
// sums. Element types are float
// (code 0), __nv_bfloat16 (code 1) and int8_t (code 2), as the Python
// wrappers pass them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as JAX's astype
}

// Round a float through T and back: the cast the reference makes where it
// converts fp32 probabilities to the compute dtype before a contraction.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Two signed int8 levels of u (already xor 0x80808080, so byte = level +
// 128) -> bf16x2, exactly: the byte goes into the mantissa of 2^23, one
// subtraction leaves the level as a float whose low 16 bits are zero, and
// its top half is the bf16. s0 / s1 select the bytes (0x744i for byte i).
__device__ __forceinline__ uint32_t bf16x2_of_levels(uint32_t u, uint32_t s0,
                                                     uint32_t s1) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, s0)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, s1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x on the tensor cores enters as bf16 (fp32 x as three bf16 planes), whose
// products are exact; but mma.sync's fp32 accumulator truncates at every
// add, so over a long K its error grows with the adds (fp32 x: 1.2e-5 to
// 4.5e-5 of the output at K = 6144 to 16384; bf16 x: up to 2.1e-5 at K =
// 16384, where an fp32 matmul is 4e-7 from float64). The
// kernels mma a short run of K into ``run`` and add the run into an fp32
// ``tot`` on the CUDA cores, which round: promote(tot, run) adds run into
// tot element by element and zeroes run. They do so where the output can
// show the truncation (``promotes``): for fp32 x, and for bf16 x with an
// fp32 output. A bf16 output rounds to 2^-9 of itself, 100x above it (at K
// = 16384 the kernels' and an fp32 matmul's bf16 outputs are as far from
// float64), and a run costs the bf16 prefill GEMM up to 25% of its time.
__device__ __forceinline__ void promote(float& tot, float& run) {
  tot += run;
  run = 0.f;
}
template <typename T, int N>
__device__ __forceinline__ void promote(T (&tot)[N], T (&run)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) promote(tot[i], run[i]);
}
template <typename TIn, typename TOut>
__host__ __device__ constexpr bool promotes() {
  return sizeof(TIn) == 4 || sizeof(TOut) == 4;
}

}  // namespace rt
