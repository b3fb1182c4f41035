// attn_decode: one-token GQA attention against a (B, S, KV, D) KV cache,
// split along S (flash-decoding) and merged by a second kernel.
//
// Replaces the TPU kernel
// src/repro/kernels/attn_decode/kernel.py::attn_decode_pallas (body _kernel).
//
// Layout: q (B, KV, G, D) in the compute dtype T (fp32 or bf16), scaled by
// 1/sqrt(D) in T as the kernel stages it. k, v (B, S, KV, D) in T, or int8 with per-token
// fp32 scales k_scale, v_scale (B, S). cache_len (B,) int32: row b sees the
// positions p < cache_len[b]. out (B, KV, G, D) in T. Scratch (fp32, the
// wrapper allocates it): pm, pl (B * KV, splits, G) and pacc
// (B * KV, splits, G, D), each split's running max, sum and unnormalised
// accumulator.
//
// Numerics, as the reference, per block of BK keys: fp32 scores; for an
// int8 cache the scores are multiplied by k_scale after Q.K and the
// probabilities by v_scale before P.V; an online softmax keeps m, l and the
// accumulator in fp32, rescaled once per key block; each probability is
// cast to the compute dtype (the cache dtype for a float cache, T for
// int8) before P.V. The merge takes out = sum_i acc_i e^(m_i - M) /
// sum_i l_i e^(m_i - M), M the largest m_i, over the splits in order (no
// atomics: the same bits every run), then one cast. A split that starts at
// or past its row's cache_len writes l = 0 and m = -inf and is skipped by
// the merge, which never evaluates e^(-inf - (-inf)); a row with
// cache_len 0 writes exact zeros.
//
// What bounds it on the H100: per token it reads the row's valid K and V
// once and does 4 * D flops per position and head group: about 1 flop per
// byte, so it is bound by the bytes of the cache it reads; at the engine's
// shapes (8 slots, S = 512, 1.8 MB) that is well under one launch, so what
// is left is latency.
//
// What the design does about it: a grid of splits x (b, kv head), the
// split length chosen by kernels/attn_decode/kernel.py::plan from S (never
// from cache_len, which would need the host to read it) so the grid fills
// the card (256 blocks at the engine's shape). A block of 8 warps stages
// BK = 32 keys of K and V at a time with cp.async, two buffers deep (int8
// stays raw in shared memory and is widened when read; rows are padded by
// 16 bytes so lanes over keys read without bank conflicts). A block serves
// HB neighbouring KV heads of one row (the plan's hb). With G >= 5 query
// heads a KV head (qwen2-1.5b's 6), HB = 1 and warp w owns the heads w,
// w + 8, ... of the group. With fewer, one KV head would leave 8 - G warps
// with nothing to score (7 of 8 at G = 1: stablelm-3b, musicgen-large,
// zamba2-1.2b), so HB = 8 / G, at most 4 (a power of two dividing KV,
// halved until two blocks fit an SM: 8 heads a block, one block an SM,
// measured no faster), and warp w < HB * G owns head w % G of KV head
// w / G. The HB heads of a key lie next to each other in the (B, S,
// KV, D) cache, so a staged row is one HB * D-wide contiguous read. Every
// head keeps its own m, l and accumulator per split in the same order, so
// a head's arithmetic does not depend on HB; at HB = 1 the launch is the
// one-head-group kernel it was. Splitting a block's keys across warps
// instead would need an in-block merge in another order (and
// split_softmax to follow it). Scoring: lane = key, 16-byte reads of
// its K row against q in shared memory (broadcast); then one warp max and
// one warp sum per key block and head, never one per key. P goes to the
// warp's own shared memory row, and P.V runs with lanes over D: each lane
// reads D / 32 contiguous values of a V row (where D is not a multiple of
// 32, pairs of values 64 apart, the lanes past D idle in the last group)
// and multiplies them by every head's p. D is any multiple of 16 up to 256.
#include "common.cuh"

namespace {

constexpr int BK = 32;         // keys per staged block (one per lane)
constexpr int WARPS = 8;
constexpr int HPW = 4;         // most heads per warp: G <= 32
constexpr int PAD = 16;        // bytes of padding after each staged row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N values of type E at p, widened to float: vector loads where N fills
// them (p is then aligned to the vector), else one at a time.
template <typename E, int N>
__device__ __forceinline__ void load_f(const E* p, float (&out)[N]) {
  if constexpr (sizeof(E) == 4 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      out[i] = f.x; out[i + 1] = f.y; out[i + 2] = f.z; out[i + 3] = f.w;
    }
  } else if constexpr (sizeof(E) == 2 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i));
      out[i] = f.x; out[i + 1] = f.y;
    }
  } else if constexpr (sizeof(E) == 1 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const char4 c = *reinterpret_cast<const char4*>(p + i);
      out[i] = c.x; out[i + 1] = c.y; out[i + 2] = c.z; out[i + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = rt::to_f(p[i]);
  }
}

// Bytes of dynamic shared memory: q (fp32) of the block's HB * G heads,
// each warp's P rows, then two buffers of K and V blocks (a staged row is
// the HB neighbouring KV heads' D values of one key, padded) and, for int8,
// their scales.
template <typename TKV, int D>
struct Smem {
  static __host__ __device__ int row(int HB) {
    return HB * D * (int)sizeof(TKV) + PAD;
  }
  static __host__ __device__ int kvbuf(int HB) {
    return 2 * BK * row(HB) + (sizeof(TKV) == 1 ? 2 * BK * 4 : 0);
  }
  static __host__ __device__ int q_bytes(int HB, int G) { return HB * G * D * 4; }
  static __host__ __device__ int p_bytes() { return WARPS * HPW * BK * 4; }
  static __host__ __device__ int total(int HB, int G) {
    return q_bytes(HB, G) + p_bytes() + 2 * kvbuf(HB);
  }
};

// P.V's lanes over D: lane l holds W contiguous values at W * l + 32 W e of
// each of NE groups e, where that start is below D.
template <int D>
struct PV {
  static constexpr int W = D % 32 == 0 ? D / 32 : 2;
  static constexpr int NE = (D + 32 * W - 1) / (32 * W);
  static __device__ __forceinline__ int at(int lane, int e) {
    return W * lane + 32 * W * e;
  }
  static __device__ __forceinline__ bool in(int lane, int e) {
    return D % (32 * W) == 0 || at(lane, e) < D;
  }
};

template <typename T, typename TKV, int D, bool MULTI>
__global__ void __launch_bounds__(WARPS * 32)
attn_decode_kernel_split(const T* __restrict__ q, const TKV* __restrict__ k,
                         const TKV* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int32_t* __restrict__ cache_len,
                         float* __restrict__ pm, float* __restrict__ pl,
                         float* __restrict__ pacc, float scale, int S,
                         int KV, int G, int HB, int split_len) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  using P = PV<D>;
  constexpr int EPT = P::NE * P::W;           // P.V: values of a row a lane
  constexpr int CH = 16 / sizeof(TKV);        // elements per 16-byte chunk
  constexpr int CPH = D / CH;                 // 16-byte chunks of one head
  using SM = Smem<TKV, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  // one KV head a block (!MULTI): the row, buffer and chunk counts are
  // compile-time constants, as in the one-head-group kernel
  const int hb = MULTI ? HB : 1;
  const int ROW = SM::row(hb), KVBUF = SM::kvbuf(hb);
  const int CPR = hb * CPH;                   // 16-byte chunks per row
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + SM::q_bytes(hb, G));
  unsigned char* kvbuf = smem + SM::q_bytes(hb, G) + SM::p_bytes();

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int groups = KV / hb;                 // blocks of hb KV heads a row
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y - b * groups) * hb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warp's heads: HB == 1 (!MULTI), heads warp, warp + 8, ... of KV
  // head h0; HB > 1 (G * HB <= 8), the one head warp % G of KV head
  // h0 + warp / G
  const int hl = MULTI ? warp / G : 0;        // the warp's KV head in block
  const bool busy = !MULTI || warp < hb * G;
  auto head = [&](int hh) { return MULTI ? warp % G : warp + WARPS * hh; };
  auto mine = [&](int hh) {
    return MULTI ? busy && hh == 0 : warp + WARPS * hh < G;
  };
  int len = cache_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int k0 = split * split_len;
  const int k1 = min(k0 + split_len, len);
  if (k0 >= k1) {                                      // empty split
    for (int i = tid; i < hb * G; i += WARPS * 32) {
      const int hi = i / G, g = i - hi * G;
      const size_t part = (size_t)(b * KV + h0 + hi) * nsplit + split;
      pm[part * G + g] = -INFINITY;
      pl[part * G + g] = 0.f;
    }
    return;
  }
  const int nblk = (k1 - k0 + BK - 1) / BK;
  const size_t head0 = ((size_t)b * S * KV + h0) * D;  // k/v of (b, 0, h0)
  const size_t key_stride = (size_t)KV * D;

  auto stage = [&](int j, int buf) {
    unsigned char* kt = kvbuf + buf * KVBUF;
    unsigned char* vt = kt + BK * ROW;
    const int kb = k0 + j * BK;
    for (int i = tid; i < BK * CPR; i += WARPS * 32) {
      const int r = i / CPR, c = i - r * CPR;
      const int key = kb + r;
      const bool ok = key < k1;
      const size_t off = head0 + (size_t)(ok ? key : k0) * key_stride + c * CH;
      cp_async16(smem_u32(kt + r * ROW + 16 * c), k + off, ok);
      cp_async16(smem_u32(vt + r * ROW + 16 * c), v + off, ok);
    }
    if constexpr (QUANT) {
      float* sc = reinterpret_cast<float*>(vt + BK * ROW);
      for (int i = tid; i < BK; i += WARPS * 32) {
        const int key = kb + i;
        const bool ok = key < k1;
        const size_t off = (size_t)b * S + (ok ? key : k0);
        cp_async4(smem_u32(sc + i), k_scale + off, ok);
        cp_async4(smem_u32(sc + BK + i), v_scale + off, ok);
      }
    }
  };

  stage(0, 0);
  cp_commit();
  // q of the HB groups, 16 bytes a thread at a time (G * D * sizeof(T) is
  // a multiple of 16), times the 1/sqrt(D) scale rounded to T (the product
  // in T, as the reference's scale_q), widened to fp32
  constexpr int QE = 16 / sizeof(T);
  const uint4* qrow = reinterpret_cast<const uint4*>(
      q + ((size_t)b * KV + h0) * G * D);
  for (int i = tid; i < hb * G * D / QE; i += WARPS * 32) {
    float f[QE];
    const uint4 raw = __ldg(qrow + i);
    load_f<T, QE>(reinterpret_cast<const T*>(&raw), f);
#pragma unroll
    for (int e = 0; e < QE; ++e) qs[i * QE + e] = rt::round_to<T>(f[e] * scale);
  }

  float acc[HPW][EPT], m_run[HPW], l_run[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[j][e] = 0.f;
  }
  float* pw = ps + warp * HPW * BK;            // this warp's P rows
  const float* qw = qs + hl * G * D;           // q of the warp's KV head

  for (int j = 0; j < nblk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nblk) {
      stage(j + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                           // block j (and q) landed
    const unsigned char* kt = kvbuf + buf * KVBUF;
    const unsigned char* vt = kt + BK * ROW;
    const float* sc = reinterpret_cast<const float*>(vt + BK * ROW);
    const int key = k0 + j * BK + lane;
    const bool valid = key < k1;

    if (busy) {
      // scores of this lane's key for the warp's heads
      float s[HPW], s2[HPW];                   // two chains: even, odd e
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) s[hh] = s2[hh] = 0.f;
      const TKV* krow =
          reinterpret_cast<const TKV*>(kt + lane * ROW) + hl * D;
#pragma unroll 4
      for (int c = 0; c < CPH; ++c) {
        float kf[CH];
        load_f<TKV, CH>(krow + c * CH, kf);
#pragma unroll
        for (int hh = 0; hh < HPW; ++hh) {
          if (mine(hh)) {
            const float* qg = qw + head(hh) * D + c * CH;
#pragma unroll
            for (int e = 0; e < CH; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + e);
              s[hh] = fmaf(qv.x, kf[e], s[hh]);
              s2[hh] = fmaf(qv.y, kf[e + 1], s2[hh]);
              s[hh] = fmaf(qv.z, kf[e + 2], s[hh]);
              s2[hh] = fmaf(qv.w, kf[e + 3], s2[hh]);
            }
          }
        }
      }
      const float kscale = QUANT ? sc[lane] : 1.f;
      const float vscale = QUANT ? sc[BK + lane] : 1.f;

      // one max and one sum per head over the block; p to the warp's rows
      float corr[HPW];
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        corr[hh] = 1.f;
        if (!mine(hh)) continue;
        const float sv = (s[hh] + s2[hh]) * kscale;
        float mx = valid ? sv : -INFINITY;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run[hh], mx);  // finite: key k0+j*BK valid
        corr[hh] = __expf(m_run[hh] - m_new);
        const float p = valid ? __expf(sv - m_new) : 0.f;
        l_run[hh] = l_run[hh] * corr[hh] + rt::warp_sum(p);
        m_run[hh] = m_new;
        float pc;
        if constexpr (QUANT) pc = rt::round_to<T>(p * vscale);
        else pc = rt::round_to<TKV>(p);
        pw[hh * BK + lane] = pc;
      }
      __syncwarp();

      // P.V: lanes over D
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[hh][e] *= corr[hh];
      const int nk = min(BK, k1 - (k0 + j * BK));
      for (int r = 0; r < nk; ++r) {
        float vf[EPT];
        const TKV* vrow =
            reinterpret_cast<const TKV*>(vt + r * ROW) + hl * D;
#pragma unroll
        for (int e = 0; e < P::NE; ++e) {
          float t[P::W];
          if (P::in(lane, e)) {
            load_f<TKV, P::W>(vrow + P::at(lane, e), t);
          } else {
#pragma unroll
            for (int w = 0; w < P::W; ++w) t[w] = 0.f;
          }
#pragma unroll
          for (int w = 0; w < P::W; ++w) vf[e * P::W + w] = t[w];
        }
#pragma unroll
        for (int hh = 0; hh < HPW; ++hh) {
          if (mine(hh)) {
            const float p = pw[hh * BK + r];
#pragma unroll
            for (int e = 0; e < EPT; ++e) acc[hh][e] = fmaf(p, vf[e], acc[hh][e]);
          }
        }
      }
    }
    __syncthreads();                           // buffer free for block j + 2
  }

  const size_t part = (size_t)(b * KV + h0 + hl) * nsplit + split;
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    if (!mine(hh)) continue;
    const int g = head(hh);
    if (lane == 0) {
      pm[part * G + g] = m_run[hh];
      pl[part * G + g] = l_run[hh];
    }
    float* dst = pacc + (part * G + g) * D;
#pragma unroll
    for (int e = 0; e < P::NE; ++e) {
      if (!P::in(lane, e)) continue;
#pragma unroll
      for (int w = 0; w < P::W; ++w)
        dst[P::at(lane, e) + w] = acc[hh][e * P::W + w];
    }
  }
}

// One block per (b, kv head, head g of the group), one thread per d (at
// least a warp: warp 0 computes the weights):
// out[g][d] merges the splits in order. Warp 0 turns the splits' m and l
// into weights w = e^(m - M) (0 for an empty split) and the denominator
// sum l w, in shared memory; then each thread sums acc w over the splits in
// order. acc of an empty split is never written: its load is discarded by
// a select, so no garbage enters the sum. Where lse is given, lane 0 also
// writes the row's log-sum-exp of its scores, M + log(sum l w) (-inf for a
// row with no visible key), for a merge across a sequence split over
// ranks (models/attention.py's decode on a sequence-sharded cache).
constexpr int MAX_SPLITS = 1024;

template <typename T, int D>
__global__ void __launch_bounds__(D < 32 ? 32 : D)
attn_decode_kernel_combine(const float* __restrict__ pm,
                           const float* __restrict__ pl,
                           const float* __restrict__ pacc,
                           T* __restrict__ out, float* __restrict__ lse,
                           int G, int nsplit) {
  __shared__ float wsp[MAX_SPLITS];
  __shared__ float den;
  const int bh = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const size_t base = (size_t)bh * nsplit;       // (bh, split) index base
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = -INFINITY;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const size_t pi = (base + sp) * G + g;
      if (pl[pi] > 0.f) M = fmaxf(M, pm[pi]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float dsum = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const size_t pi = (base + sp) * G + g;
      const float l = pl[pi];
      const float w = l > 0.f ? __expf(pm[pi] - M) : 0.f;
      wsp[sp] = w;
      dsum = fmaf(l, w, dsum);
    }
    dsum = rt::warp_sum(dsum);
    if (lane == 0) {
      den = dsum;
      if (lse) lse[(size_t)bh * G + g] = dsum > 0.f ? M + logf(dsum) : -INFINITY;
    }
  }
  __syncthreads();
  if (d >= D) return;
  float num = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < nsplit; ++sp) {
    const float v = pacc[((base + sp) * G + g) * D + d];
    const float w = wsp[sp];
    num = w > 0.f ? fmaf(v, w, num) : num;
  }
  out[((size_t)bh * G + g) * D + d] = rt::from_f<T>(den > 0.f ? num / den : 0.f);
}

template <typename T, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lens, void* out, float* pm, float* pl,
           float* pacc, float* lse, float scale, int B, int S, int KV,
           int G, int HB, int split_len, int nsplit, int smem,
           cudaStream_t st) {
  using SM = Smem<TKV, D>;
  if (G > WARPS * HPW || split_len <= 0 || split_len % BK ||
      (long long)nsplit * split_len < S || nsplit > MAX_SPLITS ||
      HB < 1 || KV % HB || (HB > 1 && HB * G > WARPS) ||
      smem < SM::total(HB, G))
    return (int)cudaErrorInvalidValue;
  const bool multi = HB > 1;
  auto kern = multi ? attn_decode_kernel_split<T, TKV, D, true>
                    : attn_decode_kernel_split<T, TKV, D, false>;
  static int smem_set[2] = {48 * 1024, 48 * 1024};   // per instantiation
  if (smem > smem_set[multi]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[multi] = smem;
  }
  kern<<<dim3(nsplit, B * KV / HB), WARPS * 32, smem, st>>>(
      (const T*)q, (const TKV*)k, (const TKV*)v, (const float*)ks,
      (const float*)vs, (const int32_t*)lens, pm, pl, pacc, scale, S, KV, G,
      HB, split_len);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_decode_kernel_combine<T, D>
      <<<dim3(B * KV, G), D < 32 ? 32 : D, 0, st>>>(pm, pl, pacc, (T*)out,
                                                    lse, G, nsplit);
  return 0;
}

template <typename T, typename TKV>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* lens, void* out,
             float* pm, float* pl, float* pacc, float* lse, float scale,
             int B, int S, int KV, int G, int HB, int split_len, int nsplit,
             int smem, cudaStream_t st) {
#define RT_CASE(DD)                                                         \
  case DD:                                                                  \
    return launch<T, TKV, DD>(q, k, v, ks, vs, lens, out, pm, pl, pacc,     \
                              lse, scale, B, S, KV, G, HB, split_len,       \
                              nsplit, smem, st);
  switch (D) {
    RT_CASE(16) RT_CASE(32) RT_CASE(48) RT_CASE(64) RT_CASE(80) RT_CASE(96)
    RT_CASE(112) RT_CASE(128) RT_CASE(144) RT_CASE(160) RT_CASE(176)
    RT_CASE(192) RT_CASE(208) RT_CASE(224) RT_CASE(240) RT_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_CASE
}

}  // namespace

// scale multiplies q in q's dtype (the wrapper passes 1/sqrt(D) rounded to
// it). q_dtype: 0 fp32, 1 bf16; kv_dtype: the same code as q, or 2 for int8
// (then k_scale and v_scale are required). D must be a multiple of 16 from
// 16 to 256 and G <= 32. hb (KV heads a block: 1, or a divisor of KV with
// hb * G <= 8), split_len (a multiple of 32) and nsplit (nsplit *
// split_len >= S) come from the wrapper's plan, with smem, the dynamic
// shared memory; pm, pl, pacc are its fp32 scratch; lse, (B, KV, G) fp32,
// may be null. Launches the split kernel and the merge on the stream.
// Returns the CUDA error code (0 on success).
extern "C" int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale,
                                  const void* cache_len, void* out, void* pm,
                                  void* pl, void* pacc, void* lse, float scale,
                                  int B, int S, int KV, int G, int D,
                                  int q_dtype, int kv_dtype, int hb,
                                  int split_len, int nsplit, int smem,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float *m = (float*)pm, *l = (float*)pl, *a = (float*)pacc,
        *ls = (float*)lse;
  int rc;
#define RT_ARGS D, q, k, v, k_scale, v_scale, cache_len, out, m, l, a, ls, \
                scale, B, S, KV, G, hb, split_len, nsplit, smem, st
  if (q_dtype == 0 && kv_dtype == 0)
    rc = launch_d<float, float>(RT_ARGS);
  else if (q_dtype == 1 && kv_dtype == 1)
    rc = launch_d<__nv_bfloat16, __nv_bfloat16>(RT_ARGS);
  else if (q_dtype == 0 && kv_dtype == 2)
    rc = launch_d<float, int8_t>(RT_ARGS);
  else if (q_dtype == 1 && kv_dtype == 2)
    rc = launch_d<__nv_bfloat16, int8_t>(RT_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef RT_ARGS
  if (rc) return rc;
  return (int)cudaGetLastError();
}
