// attn_prefill: blocked online-softmax attention with per-query [lo, hi)
// windows, for bucketed prefill admission and speculative verify, with
// fp32 queries. bf16 queries run on the tensor cores, in attn_prefill_tc.cu.
//
// Replaces the TPU kernel
// src/repro/kernels/attn_prefill/kernel.py::attn_prefill_pallas (body
// _kernel).
//
// Layout: q (B, T, KV, G, D) fp32, already scaled by 1/sqrt(D). k, v
// (B, S, KV, D) fp32, or int8 with per-token fp32 scales k_scale, v_scale
// (B, S). lo, hi (B, T) int32: query t of row b sees the key positions
// lo[b, t] <= p < hi[b, t] (prefill: lo = 0, hi = min(t + 1, len[b])); lo
// may be null, for all zeros. out (B, T, KV, G, D) fp32. lse, where not
// null, (B, T, KV, G) fp32: each query row's log-sum-exp m + log(l) of its
// visible scores, -inf for a row with none (a sequence-sharded cache's
// ranks merge by it); the store is a template parameter, so a launch
// without lse runs the kernel that has none. D is a multiple of 16 from 16
// to 256.
//
// Numerics, as the reference in fp32: fp32 scores; int8 k_scale after Q.K
// and v_scale on the probabilities before P.V; an online softmax with m, l
// and the accumulator in fp32, rescaled once per key block; one division
// by l at the end. A query whose window is empty (hi <= lo) writes zeros,
// never NaN: its probabilities are zero, so l stays 0. The fp32 parity
// gates admit no TF32, so this kernel stays on the CUDA cores.
//
// What bounds it on the H100: a prefill of a T-token bucket does about
// 4 * T^2 / 2 * D flops per head for 2 * T * D * KV bytes of K and V per
// row, so for T >= 64 it is bound by fp32 operations (67 TFLOP/s); the
// verify shape (T = 5 against a 512-entry cache) by the bytes of the cache
// and by latency.
//
// What the design does about it: a register-tiled flash attention. One
// block of 256 threads per (b, KV head, tile of 64 query rows), the rows
// of (b, h) flattened as r = t * G + g, so each staged key block serves
// all G heads of the group and every block is 64 rows whatever G is. The
// block walks the keys [min lo, max hi) of its rows in blocks of BK (64,
// or 32 where D is large: plan() sizes it to the shared memory) staged by
// cp.async into padded shared memory, two buffers deep, so block j + 1
// loads while block j is multiplied; an int8 block lands as bytes and is
// widened to fp32 once. The threads form a 16 x 16 grid: thread (ty, tx)
// computes the scores of rows ty + 16 i and keys tx + 16 j (i < 4,
// j < BK / 16) as
// outer products over float4 slices of D, masks each to its row's
// [lo, hi), takes each row's block max and sum with shuffles among the 16
// threads of the row, once per key block, and writes the probabilities to
// shared memory; then it accumulates O += P.V for its 4 rows and its
// columns 4 (tx + 16 c) .. + 3 of D, kept in registers across key blocks.
// Where B * KV * row tiles leave SMs idle (the verify shape: 16 blocks),
// plan() splits S across blocks: each split writes its m, l and
// unnormalised accumulator, and a second kernel merges the splits in
// order, as attn_decode merges its own.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;            // query rows a block
constexpr int THREADS = 256;        // a 16 x 16 grid
constexpr float NEG = -1e30f;       // running max before any key

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

// Shared memory of one block, in 4-byte words (the plan's arithmetic in
// kernels/attn_prefill/kernel.py::_simt_smem): Q (64 x D + 4), the K and V
// tiles (fp32, BK x D + 4; two buffers, or one for an int8 K/V, which lands
// as bytes in two raw buffers beside its scales), P (64 x BK + 4), and the
// rows' windows.
struct Smem {
  int ldq, q, tiles, kv, p, ldp, win, raw;
  __host__ __device__ Smem(int D, int BK, bool quant) {
    ldq = D + 4;
    ldp = BK + 4;
    q = 0;
    tiles = q + ROWS * ldq;
    kv = BK * ldq;                               // one K (or V) tile
    p = tiles + (quant ? 2 : 4) * kv;
    win = p + ROWS * ldp;
    raw = win + 2 * ROWS;                        // int8: 2 x (K, V, scales)
  }
  __host__ __device__ int raw_words(int D, int BK) const {
    return 2 * (2 * BK * D / 4 + 2 * BK);
  }
};

template <bool QUANT, int CG, int BK, bool LSE>
__global__ void __launch_bounds__(THREADS)
attn_prefill_kernel(const float* __restrict__ q, const void* __restrict__ kp,
                    const void* __restrict__ vp,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ lo,
                    const int32_t* __restrict__ hi, float* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int Tq, int S, int KV,
                    int G, int D, int split_len) {
  constexpr int JN = BK / 16;                     // key groups a thread
  extern __shared__ __align__(16) float sm[];
  const Smem L(D, BK, QUANT);
  float* qs = sm + L.q;
  float* ps = sm + L.p;
  int* rlo = reinterpret_cast<int*>(sm + L.win);
  int* rhi = rlo + ROWS;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = Tq * G;
  const int tiles = (rows + ROWS - 1) / ROWS;
  const int tile = tiles - 1 - (int)(blockIdx.x % tiles);   // longest first
  const int bh = blockIdx.x / tiles;              // b * KV + h
  const int b = bh / KV, h = bh - b * KV;
  const int split = blockIdx.y, splits = gridDim.y;
  const int r0 = tile * ROWS;
  const int d4 = D / 4;

  // Q rows r0 .. r0 + 63 (zero past T * G), and each row's window
  for (int i = tid; i < ROWS * d4; i += THREADS) {
    const int rr = i / d4, c = i - rr * d4, r = r0 + rr;
    const bool ok = r < rows;
    const int t = ok ? r / G : 0, g = ok ? r - t * G : 0;
    cp_async16(smem_u32(qs + rr * L.ldq + 4 * c),
               q + ((((size_t)b * Tq + t) * KV + h) * G + g) * D + 4 * c, ok);
  }
  cp_commit();
  if (tid < ROWS) {
    const int r = r0 + tid;
    int a = 0, e = 0;                             // past T: empty
    if (r < rows) {
      const int t = r / G;
      a = lo ? max(lo[(size_t)b * Tq + t], 0) : 0;
      e = min(hi[(size_t)b * Tq + t], S);
    }
    rlo[tid] = a;
    rhi[tid] = e;
  }
  __syncthreads();
  // the keys this block walks: its rows' [min lo, max hi), cut to its split
  int kmin = S, kmax = 0;
  for (int rr = 0; rr < ROWS; ++rr)
    if (rhi[rr] > rlo[rr]) {
      kmin = min(kmin, rlo[rr]);
      kmax = max(kmax, rhi[rr]);
    }
  kmin = max(kmin, split * split_len);
  kmax = min(kmax, (split + 1) * split_len);
  const int nblk = kmax > kmin ? (kmax - kmin + BK - 1) / BK : 0;

  // stage key block j (keys kmin + BK j ..) into buffer j & 1: fp32 into
  // its tiles, int8 as bytes and scales into its raw buffer
  auto stage = [&](int j) {
    const int kb = kmin + BK * j, buf = j & 1;
    if constexpr (QUANT) {
      signed char* raw = reinterpret_cast<signed char*>(sm + L.raw) +
                         (size_t)buf * (L.raw_words(D, BK) / 2) * 4;
      float* sc = reinterpret_cast<float*>(raw + 2 * BK * D);
      const int d16 = D / 16;
      for (int i = tid; i < 2 * BK * d16; i += THREADS) {
        const int which = i / (BK * d16), rest = i - which * BK * d16;
        const int kk = rest / d16, c = rest - kk * d16, p = kb + kk;
        const bool ok = p < kmax;
        const signed char* src = reinterpret_cast<const signed char*>(
            which ? vp : kp) + (((size_t)b * S + (ok ? p : 0)) * KV + h) * D + 16 * c;
        cp_async16(smem_u32(raw + (which * BK + kk) * D + 16 * c), src, ok);
      }
      for (int i = tid; i < 2 * BK; i += THREADS) {
        const int which = i / BK, kk = i - which * BK, p = kb + kk;
        const bool ok = p < kmax;
        cp_async4(smem_u32(sc + i),
                  (which ? v_scale : k_scale) + (size_t)b * S + (ok ? p : 0), ok);
      }
    } else {
      float* kt = sm + L.tiles + buf * 2 * L.kv;
      for (int i = tid; i < 2 * BK * d4; i += THREADS) {
        const int which = i / (BK * d4), rest = i - which * BK * d4;
        const int kk = rest / d4, c = rest - kk * d4, p = kb + kk;
        const bool ok = p < kmax;
        const float* src = reinterpret_cast<const float*>(which ? vp : kp) +
                           (((size_t)b * S + (ok ? p : 0)) * KV + h) * D + 4 * c;
        cp_async16(smem_u32(kt + which * L.kv + kk * L.ldq + 4 * c), src, ok);
      }
    }
    cp_commit();
  };

  float acc[4][CG][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  int wlo[4], whi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wlo[i] = rlo[ty + 16 * i];
    whi[i] = rhi[ty + 16 * i];
  }

  if (nblk > 0) stage(0);
#pragma unroll 1
  for (int j = 0; j < nblk; ++j) {
    const int kb = kmin + BK * j, buf = j & 1;
    if (j + 1 < nblk) {
      stage(j + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                              // block j (and Q) landed
    const float* kt;
    const float* ks = nullptr;
    const float* vsc = nullptr;
    if constexpr (QUANT) {
      const signed char* raw = reinterpret_cast<const signed char*>(sm + L.raw) +
                               (size_t)buf * (L.raw_words(D, BK) / 2) * 4;
      ks = reinterpret_cast<const float*>(raw + 2 * BK * D);
      vsc = ks + BK;
      float* t0 = sm + L.tiles;
      const int d16 = D / 16;
      for (int i = tid; i < 2 * BK * d16; i += THREADS) {
        const int which = i / (BK * d16), rest = i - which * BK * d16;
        const int kk = rest / d16, c = rest - kk * d16;
        const int4 v = *reinterpret_cast<const int4*>(raw + (which * BK + kk) * D + 16 * c);
        const int w[4] = {v.x, v.y, v.z, v.w};
        float* dst = t0 + which * L.kv + kk * L.ldq + 16 * c;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float4*>(dst + 4 * u) = make_float4(
              (float)(signed char)(w[u] & 0xff),
              (float)(signed char)((w[u] >> 8) & 0xff),
              (float)(signed char)((w[u] >> 16) & 0xff),
              (float)(signed char)(w[u] >> 24));
      }
      __syncthreads();
      kt = t0;
    } else {
      kt = sm + L.tiles + buf * 2 * L.kv;
    }
    const float* vt = kt + L.kv;

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d4; ++c) {
      float4 qa[4], kk[JN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * L.ldq + 4 * c);
#pragma unroll
      for (int jj = 0; jj < JN; ++jj)
        kk[jj] = *reinterpret_cast<const float4*>(kt + (tx + 16 * jj) * L.ldq + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) {
          s[i][jj] = fmaf(qa[i].x, kk[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qa[i].y, kk[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qa[i].z, kk[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qa[i].w, kk[jj].w, s[i][jj]);
        }
    }
    // mask to each row's window, then the block's row max and sum among
    // the 16 threads of a row (lanes differing in their low 4 bits)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float bmax = NEG;
      bool live[JN];
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) {
        const int p = kb + tx + 16 * jj;
        live[jj] = p >= wlo[i] && p < whi[i] && p < kmax;
        if constexpr (QUANT) s[i][jj] *= ks[tx + 16 * jj];
        if (live[jj]) bmax = fmaxf(bmax, s[i][jj]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      const float m_new = fmaxf(m[i], bmax);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) {
        const float pr = live[jj] ? expf(s[i][jj] - m_new) : 0.f;
        sum += pr;
        float pv = pr;
        if constexpr (QUANT) pv *= vsc[tx + 16 * jj];
        ps[(ty + 16 * i) * L.ldp + tx + 16 * jj] = pv;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();                              // P is written
    // O[rows][4 (tx + 16 c) ..] += P . V
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * L.ldp + kk);
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const int col = 4 * (tx + 16 * c);
        if (col >= D) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(vt + (kk + u) * L.ldq + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
            acc[i][c][0] = fmaf(pu, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pu, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pu, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pu, vv.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();                              // the buffers are free
  }
  cp_wait<0>();                                   // Q, where no block ran

  // one split: out = acc / l (zeros where l is 0); several: this split's
  // m, l and unnormalised acc for the merge
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    const int t = r / G, g = r - t * G;
    const size_t row = (((size_t)b * Tq + t) * KV + h) * G + g;
    float* dst;
    float scale = 1.f;
    if (splits == 1) {
      dst = out + row * D;
      scale = 1.f / fmaxf(l[i], 1e-30f);
      if constexpr (LSE)
        if (tx == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    } else {
      const size_t prow = ((size_t)split * (gridDim.x / tiles) + bh) * rows + r;
      dst = part_acc + prow * D;
      if (tx == 0) {
        part_ml[2 * prow] = m[i];
        part_ml[2 * prow + 1] = l[i];
      }
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = 4 * (tx + 16 * c);
      if (col >= D) continue;
      *reinterpret_cast<float4*>(dst + col) =
          make_float4(acc[i][c][0] * scale, acc[i][c][1] * scale,
                      acc[i][c][2] * scale, acc[i][c][3] * scale);
    }
  }
}

// The merge where S was split: for each query row, the splits' sums
// rescaled to their largest m over the splits that saw a key, in split
// order; a row no split saw writes zeros (and, with LSE, -inf).
template <bool LSE>
__global__ void __launch_bounds__(256)
attn_prefill_kernel_merge(const float* __restrict__ part_ml,
                          const float* __restrict__ part_acc,
                          float* __restrict__ out, float* __restrict__ lse,
                          int BH, int rows, int KV, int G, int Tq, int D,
                          int splits) {
  const size_t per = (size_t)BH * rows;           // rows of one split
  const size_t total = per * D;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t prow = i / D;
    const int d = (int)(i - prow * D);
    float big = NEG;
    for (int z = 0; z < splits; ++z) {
      const float* ml = part_ml + 2 * (z * per + prow);
      if (ml[1] > 0.f) big = fmaxf(big, ml[0]);
    }
    float num = 0.f, den = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float* ml = part_ml + 2 * (z * per + prow);
      if (!(ml[1] > 0.f)) continue;
      const float w = expf(ml[0] - big);
      num += part_acc[(z * per + prow) * D + d] * w;
      den += ml[1] * w;
    }
    // prow = bh * rows + r, r = t * G + g: out row ((b T + t) KV + h) G + g
    const int bh = (int)(prow / rows), r = (int)(prow - (size_t)bh * rows);
    const int b = bh / KV, h = bh - b * KV, t = r / G, g = r - t * G;
    const size_t orow = (((size_t)b * Tq + t) * KV + h) * G + g;
    out[orow * D + d] = den > 0.f ? num / den : 0.f;
    if constexpr (LSE)
      if (d == 0) lse[orow] = den > 0.f ? big + logf(den) : -INFINITY;
  }
}

template <bool QUANT, int CG, int BK, bool LSE>
int launch_cfg(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* lo, const void* hi, void* out,
               float* lse, float* pml, float* pacc, int B, int Tq, int S,
               int KV, int G,
               int D, int split_len, int splits, int smem, cudaStream_t st) {
  auto kern = attn_prefill_kernel<QUANT, CG, BK, LSE>;
  static int smem_set = 48 * 1024;                // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int rows = Tq * G, tiles = (rows + ROWS - 1) / ROWS;
  kern<<<dim3(B * KV * tiles, splits), THREADS, smem, st>>>(
      (const float*)q, k, v, (const float*)ks, (const float*)vs,
      (const int32_t*)lo, (const int32_t*)hi, (float*)out, lse, pml, pacc, Tq,
      S, KV, G, D, split_len);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)B * KV * rows * D;
    const int blocks = (int)min((total + 255) / 256, 4096LL);
    attn_prefill_kernel_merge<LSE><<<blocks, 256, 0, st>>>(
        pml, pacc, (float*)out, lse, B * KV, rows, KV, G, Tq, D, splits);
  }
  return 0;
}

}  // namespace

// q and out fp32; kv_dtype: 0 fp32, or 2 for int8 (then k_scale and
// v_scale are required). D must be a multiple of 16 from 16 to 256. The
// launch is the wrapper's plan: key_block keys a staged block (64 or 32),
// splits slices of split_len key positions across blocks (part_ml: fp32
// splits x B x KV x T G x 2, part_acc: splits x B x KV x T G x D, null
// when splits is 1), smem the dynamic shared memory bytes; lse null, or
// fp32 B x T x KV x G for each query row's log-sum-exp.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int attn_prefill_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lo, const void* hi, void* out,
                                   void* lse, void* part_ml, void* part_acc,
                                   int B,
                                   int Tq, int S, int KV, int G, int D,
                                   int kv_dtype, int key_block, int split_len,
                                   int splits, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 16 || D < 16 || D > 256 || splits < 1 || split_len < 1 ||
      (long long)split_len * splits < S || (splits > 1 && (!part_ml || !part_acc)) ||
      (kv_dtype != 0 && kv_dtype != 2) || (key_block != 32 && key_block != 64))
    return (int)cudaErrorInvalidValue;
  const bool quant = kv_dtype == 2;
  const Smem L(D, key_block, quant);
  const int need = 4 * (L.raw + (quant ? L.raw_words(D, key_block) : 0));
  if (smem < need) return (int)cudaErrorInvalidValue;
  const int cg = (D + 63) / 64;
  float* pml = (float*)part_ml;
  float* pacc = (float*)part_acc;
  int rc = 0;
#define RT_CFG(QQ, CC, BB)                                                    \
  if (quant == QQ && cg == CC && key_block == BB)                             \
    rc = lse ? launch_cfg<QQ, CC, BB, true>(                                  \
                   q, k, v, k_scale, v_scale, lo, hi, out, (float*)lse, pml,  \
                   pacc, B, Tq, S, KV, G, D, split_len, splits, smem, st)     \
             : launch_cfg<QQ, CC, BB, false>(                                 \
                   q, k, v, k_scale, v_scale, lo, hi, out, nullptr, pml,      \
                   pacc, B, Tq, S, KV, G, D, split_len, splits, smem, st);    \
  else
  RT_CFG(false, 1, 64) RT_CFG(false, 2, 64) RT_CFG(false, 3, 64)
  RT_CFG(false, 4, 64) RT_CFG(false, 1, 32) RT_CFG(false, 2, 32)
  RT_CFG(false, 3, 32) RT_CFG(false, 4, 32) RT_CFG(true, 1, 64)
  RT_CFG(true, 2, 64) RT_CFG(true, 3, 64) RT_CFG(true, 4, 64)
  RT_CFG(true, 1, 32) RT_CFG(true, 2, 32) RT_CFG(true, 3, 32)
  RT_CFG(true, 4, 32)
  return (int)cudaErrorInvalidValue;
#undef RT_CFG
  if (rc) return rc;
  return (int)cudaGetLastError();
}
