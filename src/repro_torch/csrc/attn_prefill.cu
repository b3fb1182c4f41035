// attn_prefill: blocked online-softmax attention with per-query [lo, hi)
// windows, for bucketed prefill admission, with fp32 queries. bf16 queries
// run on the tensor cores, in attn_prefill_tc.cu.
//
// Replaces the TPU kernel
// src/repro/kernels/attn_prefill/kernel.py::attn_prefill_pallas (body
// _kernel).
//
// Layout: q (B, T, KV, G, D) fp32, already scaled by 1/sqrt(D). k, v
// (B, S, KV, D) fp32, or int8 with per-token fp32 scales k_scale, v_scale
// (B, S). lo, hi (B, T) int32: query t of row b sees the key positions
// lo[b, t] <= p < hi[b, t] (prefill: lo = 0, hi = min(t + 1, len[b])); lo
// may be null, for all zeros. out (B, T, KV, G, D) fp32.
//
// Numerics, as the reference in fp32: fp32 scores; int8 k_scale after Q.K
// and v_scale on the probabilities before P.V; an online softmax with m, l
// and the accumulator in fp32; one division by l at the end. A query whose
// window is empty (hi <= lo) writes zeros, never NaN: it simply never
// visits a key, so no masked position can enter its sums (the reference's
// `alive` guard). The fp32 parity gates admit no TF32, so this kernel stays
// on the CUDA cores.
//
// What bounds it on the H100: a prefill of a T-token bucket does about
// 4 * T^2 / 2 * D flops per head for 2 * T * D * KV bytes of K and V per
// row, so for T >= 64 it is bound by fp32 operations.
//
// What the design does about it: one block per (b, tile of QT = 8 queries,
// kv head), one warp per query head of the group, each warp carrying its
// 8 query rows in registers; lane l holds elements l, l + 32, ... of a
// row (D / 32 rounded up; where D is not a multiple of 32 the lanes past D
// in the last group hold zeros and store nothing). The block walks the key
// positions [min lo, max hi) of its tile in chunks of KB, staging each chunk of K and
// V in shared memory once for all G x QT rows; each row then visits only
// the keys of the chunk inside its own [lo, hi), so the causal upper
// triangle and the padded tail of a row are neither read nor computed.
#include "common.cuh"

namespace {

constexpr int QT = 8;                 // queries per block

template <typename TKV, int D>
__global__ void attn_prefill_kernel(const float* __restrict__ q,
                                    const TKV* __restrict__ k,
                                    const TKV* __restrict__ v,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale,
                                    const int32_t* __restrict__ lo,
                                    const int32_t* __restrict__ hi,
                                    float* __restrict__ out, int Tq, int S,
                                    int KV, int G) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int EPT = (D + 31) / 32;  // elements of a row a lane
  constexpr int KB = 4096 / D;        // keys per staged chunk (32 KB of smem)
  // element e of this lane lies inside the row (always, for D % 32 == 0)
  auto in_row = [&](int e) {
    return D % 32 == 0 || (int)threadIdx.x % 32 + 32 * e < D;
  };
  __shared__ float ksm[KB][D];
  __shared__ float vsm[KB][D];
  __shared__ float kss[KB];
  __shared__ float vss[KB];

  const int nt = (Tq + QT - 1) / QT;
  const int h = blockIdx.x % KV;
  const int bt = blockIdx.x / KV;
  const int tile = bt % nt;
  const int b = bt / nt;
  const int t0 = tile * QT;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool live = g < G;

  int rlo[QT], rhi[QT];
  int kmin = S, kmax = 0;
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    const int t = t0 + r;
    if (t < Tq) {
      rlo[r] = lo ? max(lo[(size_t)b * Tq + t], 0) : 0;
      rhi[r] = min(hi[(size_t)b * Tq + t], S);
    } else {
      rlo[r] = 0;
      rhi[r] = 0;                     // padded query: empty window
    }
    if (rhi[r] > rlo[r]) {
      kmin = min(kmin, rlo[r]);
      kmax = max(kmax, rhi[r]);
    }
  }

  float qr[QT][EPT], acc[QT][EPT], m[QT], l[QT];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    const int t = t0 + r;
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = (live && t < Tq && in_row(e))
          ? q[((((size_t)b * Tq + t) * KV + h) * G + g) * D + lane + 32 * e]
          : 0.f;
    }
  }

  for (int c0 = kmin; c0 < kmax; c0 += KB) {
    const int cn = min(KB, kmax - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      const size_t off = (((size_t)b * S + c0 + j) * KV + h) * D + d;
      ksm[j][d] = rt::to_f(k[off]);
      vsm[j][d] = rt::to_f(v[off]);
    }
    if constexpr (QUANT) {
      for (int j = threadIdx.x; j < cn; j += blockDim.x) {
        kss[j] = k_scale[(size_t)b * S + c0 + j];
        vss[j] = v_scale[(size_t)b * S + c0 + j];
      }
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      const int ps = max(rlo[r], c0), pe = min(rhi[r], c0 + cn);
      for (int p = ps; p < pe; ++p) {
        const int j = p - c0;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e)
          if (in_row(e)) s = fmaf(qr[r][e], ksm[j][lane + 32 * e], s);
        s = rt::warp_sum(s);
        if constexpr (QUANT) s *= kss[j];
        const float m_new = fmaxf(m[r], s);
        const float corr = expf(m[r] - m_new);
        const float pr = expf(s - m_new);
        l[r] = l[r] * corr + pr;
        float pc = pr;
        if constexpr (QUANT) pc *= vss[j];
#pragma unroll
        for (int e = 0; e < EPT; ++e)
          if (in_row(e))
            acc[r][e] = fmaf(pc, vsm[j][lane + 32 * e], acc[r][e] * corr);
        m[r] = m_new;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    const int t = t0 + r;
    if (t >= Tq) break;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const size_t ooff = ((((size_t)b * Tq + t) * KV + h) * G + g) * D;
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (in_row(e)) out[ooff + lane + 32 * e] = acc[r][e] * inv;
  }
}

template <typename TKV>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* lo, const void* hi,
             void* out, int B, int Tq, int S, int KV, int G, cudaStream_t st) {
  dim3 grid(B * ((Tq + QT - 1) / QT) * KV), block(G * 32);
#define RT_CASE(DD)                                                         \
  case DD:                                                                  \
    attn_prefill_kernel<TKV, DD><<<grid, block, 0, st>>>(                   \
        (const float*)q, (const TKV*)k, (const TKV*)v, (const float*)ks,    \
        (const float*)vs, (const int32_t*)lo, (const int32_t*)hi,           \
        (float*)out, Tq, S, KV, G);                                         \
    break;
  switch (D) {
    RT_CASE(16) RT_CASE(32) RT_CASE(48) RT_CASE(64) RT_CASE(80) RT_CASE(96)
    RT_CASE(112) RT_CASE(128) RT_CASE(144) RT_CASE(160) RT_CASE(176)
    RT_CASE(192) RT_CASE(208) RT_CASE(224) RT_CASE(240) RT_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_CASE
  return 0;
}

}  // namespace

// q and out fp32; kv_dtype: 0 fp32, or 2 for int8 (then k_scale and
// v_scale are required). D must be a multiple of 16 from 16 to 256 and
// G * 32 <= 1024.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int attn_prefill_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lo, const void* hi, void* out,
                                   int B, int Tq, int S, int KV, int G, int D,
                                   int kv_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (kv_dtype == 0)
    rc = launch_d<float>(D, q, k, v, k_scale, v_scale, lo, hi, out, B, Tq, S, KV, G, st);
  else if (kv_dtype == 2)
    rc = launch_d<int8_t>(D, q, k, v, k_scale, v_scale, lo, hi, out, B, Tq, S, KV, G, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
