// attn_decode: one-token GQA attention against a (B, S, KV, D) KV cache.
//
// Replaces the TPU kernel
// src/repro/kernels/attn_decode/kernel.py::attn_decode_pallas (body _kernel).
//
// Layout: q (B, KV, G, D) in the compute dtype T (fp32 or bf16), already
// scaled by 1/sqrt(D). k, v (B, S, KV, D) in T, or int8 with per-token
// fp32 scales k_scale, v_scale (B, S). cache_len (B,) int32: row b sees the
// positions p < cache_len[b]. out (B, KV, G, D) in T.
//
// Numerics, as the reference: fp32 scores; for an int8 cache the scores are
// multiplied by k_scale after Q.K and the probabilities by v_scale before
// P.V; an online softmax keeps m, l and the accumulator in fp32; each
// probability is cast to the compute dtype (the cache dtype for a float
// cache, T for int8) before P.V; one cast of acc / l at the end. A row with
// cache_len 0 writes zeros.
//
// What bounds it on the H100: per token it reads the row's valid K and V
// once and does 4 * D flops per position and head group: about 1 flop per
// byte, so it is bound by the bytes of the cache it reads (28 KB per slot-
// token in bf16 for qwen2-1.5b, over all 28 layers).
//
// What the design does about it: one block per (b, kv head), one warp per
// query head of the group (G warps), lanes over D (D / 32 elements each,
// lane-interleaved so a warp reads a cache row in one coalesced pass). The
// loop over positions is bounded by this row's cache_len, so a short row
// reads only its own prefix and padded or stale positions are never read;
// the G warps of a block read the same K/V rows, which the L1 serves. The
// grid is B x KV blocks (16 at 8 slots): splitting S across blocks with a
// combine pass (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

template <typename T, typename TKV, int EPT>
__global__ void attn_decode_kernel(const T* __restrict__ q,
                                   const TKV* __restrict__ k,
                                   const TKV* __restrict__ v,
                                   const float* __restrict__ k_scale,
                                   const float* __restrict__ v_scale,
                                   const int32_t* __restrict__ cache_len,
                                   T* __restrict__ out, int S, int KV, int G) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int D = EPT * 32;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= G) return;

  const size_t qoff = (((size_t)b * KV + h) * G + g) * D;
  float qr[EPT], acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    qr[e] = rt::to_f(q[qoff + lane + 32 * e]);
    acc[e] = 0.f;
  }
  int len = cache_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  float m = NEG_INF, l = 0.f;
  for (int p = 0; p < len; ++p) {
    const size_t koff = (((size_t)b * S + p) * KV + h) * D;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) s = fmaf(qr[e], rt::to_f(k[koff + lane + 32 * e]), s);
    s = rt::warp_sum(s);
    if constexpr (QUANT) s *= k_scale[(size_t)b * S + p];
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float pr = expf(s - m_new);
    l = l * corr + pr;
    float pc;
    if constexpr (QUANT) pc = rt::round_to<T>(pr * v_scale[(size_t)b * S + p]);
    else pc = rt::round_to<TKV>(pr);
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      acc[e] = fmaf(pc, rt::to_f(v[koff + lane + 32 * e]), acc[e] * corr);
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < EPT; ++e) out[qoff + lane + 32 * e] = rt::from_f<T>(acc[e] * inv);
}

template <typename T, typename TKV>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* lens, void* out,
             int B, int S, int KV, int G, cudaStream_t st) {
  dim3 grid(B * KV), block(G * 32);
#define RT_CASE(E)                                                          \
  case E * 32:                                                              \
    attn_decode_kernel<T, TKV, E><<<grid, block, 0, st>>>(                  \
        (const T*)q, (const TKV*)k, (const TKV*)v, (const float*)ks,        \
        (const float*)vs, (const int32_t*)lens, (T*)out, S, KV, G);         \
    break;
  switch (D) {
    RT_CASE(1) RT_CASE(2) RT_CASE(4) RT_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_CASE
  return 0;
}

}  // namespace

// q_dtype: 0 fp32, 1 bf16; kv_dtype: the same code as q, or 2 for int8
// (then k_scale and v_scale are required). D must be 32, 64, 128 or 256 and
// G * 32 <= 1024. Returns the CUDA error code of the launch (0 on success).
extern "C" int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale,
                                  const void* cache_len, void* out, int B,
                                  int S, int KV, int G, int D, int q_dtype,
                                  int kv_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (q_dtype == 0 && kv_dtype == 0)
    rc = launch_d<float, float>(D, q, k, v, k_scale, v_scale, cache_len, out, B, S, KV, G, st);
  else if (q_dtype == 1 && kv_dtype == 1)
    rc = launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, k_scale, v_scale, cache_len, out, B, S, KV, G, st);
  else if (q_dtype == 0 && kv_dtype == 2)
    rc = launch_d<float, int8_t>(D, q, k, v, k_scale, v_scale, cache_len, out, B, S, KV, G, st);
  else if (q_dtype == 1 && kv_dtype == 2)
    rc = launch_d<__nv_bfloat16, int8_t>(D, q, k, v, k_scale, v_scale, cache_len, out, B, S, KV, G, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
