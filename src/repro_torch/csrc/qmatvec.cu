// qmatvec: y = (x . unpack3(W)) * delta + bias, W in 3-bit containers, the
// sum on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/qmatvec/kernel.py::qmatvec_pallas
// (body _kernel, unpack _unpack_tile).
//
// Layout: x (M, K) fp32 or bf16, row-major. W (KP, N) int32, row-major, with
// KP = ceil(K / 10): word j of column n holds the levels of k = 10j..10j+9 as
// ten two's-complement 3-bit fields (field f at bits 3f..3f+2). delta and the
// optional bias are (N,) fp32. y (M, N) fp32 or bf16.
//
// What bounds it on the H100: at decode (M = slots <= 16) each 0.4-byte
// weight feeds 2 M flops: bound by the bytes of W (0.4 B per weight, 5x
// fewer than bf16), but only if the arithmetic leaves the CUDA cores free
// (at M = 8, 40 flops a byte against their 20). At prefill (M = slots x
// bucket, up to 2048) it is bound by operations, which only the tensor
// cores carry.
//
// What the design does about it: the reference's product (levels cast to
// x's dtype, fp32 accumulation) runs as mma.sync m16n8k16 (bf16 in, fp32
// out): the levels -4..3 are exact in bf16, and fp32 x enters as three bf16
// planes (hi + mid + lo == x exactly), so every product stays exact, and
// each chunk's mma sums are added into an fp32 total on the CUDA cores
// (rt::promote), so the sum stays fp32's (fp32 x, or an fp32 output: rt::promotes). A is
// the weight tile (16 output columns x 16 K), B is x^T (16 K x 8 rows of
// x). K runs in chunks of 80 (8 container words). In a chunk, lane (g, t)
// of a warp loads 16 bytes of word row 2t and of word row 2t + 1, columns
// 4g..4g+3 of the warp's 32 (so 8 lanes read one whole 128-byte line): the
// levels of its 4 columns at k = 20t..20t+19 of the chunk. Columns 4g + 2u
// and 4g + 2u + 1 are rows g and g + 8 of mma tile u, and the chunk's K is
// permuted so that those 20 levels are exactly this lane's A-fragment
// slots over 5 k16 steps; B is read through the same permutation (x[m][20t
// + 4s .. + 4] at step s), so the sum is unchanged. A pair of 3-bit fields
// becomes a bf16x2 by one xor (bias +4), two shifts, a mask into the
// mantissa of 128.0 and one bf16x2 subtraction of 132, exactly.
//
// One kernel body behind two kernels (kernels/qmatvec/kernel.py::plan
// picks them by M): `decode` (M <= 16) and `prefill`. Tiles of 8 or 16
// rows of x (decode, and prefill below M = 256) read each lane's B
// fragments straight from x, which every warp of the SM shares through L1;
// tiles of 64 rows (prefill from M = 256) stage x in shared memory (bf16
// planes, zero past M and K) a piece of chunks at a time, so each W chunk
// loaded serves 64 rows. A block of 8 warps is CG column groups of 32 x KW
// = 8 / CG slices of K; the grid is column blocks x row tiles x ksplit
// slices of K. Each warp walks its chunks with the next chunks' loads in
// flight while it multiplies one (4 chunks of W, 4 KB a warp, with 8- or
// 16-row tiles; 2 with 64-row tiles).
// Partial sums meet in a fixed order, so two runs give the same bits: the
// KW slices in shared memory; where K is split across blocks (ksplit > 1),
// each block writes its fp32 partial and a second kernel sums them in rank
// order. The last step applies delta and bias in fp32 and makes one cast.
// No read passes K, the last word row or the last column.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int CHUNK_K = 80;   // K values per chunk (8 container words)
constexpr int XPAD = 8;       // bf16 pad per staged row of x (16 bytes)
constexpr uint32_t BIAS4 = 0x24924924u;   // bit 2 of every 3-bit field

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fields 2f and 2f + 1 of a biased word (w ^ BIAS4: field = level + 4) as a
// bf16x2, field 2f in the low half: 128 + field in bf16 (exponent 2^7, ulp
// 1), minus 132.
__device__ __forceinline__ uint32_t level_pair(uint32_t wb, int f) {
  const uint32_t lo = (wb >> (6 * f)) & 7u;
  const uint32_t hi = (wb >> (6 * f + 3)) & 7u;
  const uint32_t v = lo | (hi << 16) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(132.f, 132.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The 2 x 4 words of chunk c this lane feeds to its A fragments: word rows
// 8c + 2t and 8c + 2t + 1, columns n .. n + 3 (zero past KP or N).
template <bool VEC>
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ w,
                                           int c, int t, int n, int KP, int N,
                                           bool ok, uint4 (&out)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = 8 * c + 2 * t + j;
    out[j] = make_uint4(0u, 0u, 0u, 0u);
    if (!ok || row >= KP) continue;
    const int32_t* p = w + (size_t)row * N + n;
    if (VEC) {
      if (n < N) out[j] = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = n + i < N ? (uint32_t)__ldg(p + i) : 0u;
      out[j] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// x[m0 .. m0 + ROWS)[k0 .. k0 + kn) as P bf16 planes in xs (row stride ld
// elements, plane p at row p * ROWS), zero past M and K. Each thread issues
// a batch of independent loads before it converts and stores any: 16-byte
// loads where every row of x is 16-byte aligned, else one element at a
// time.
template <typename TIn, int ROWS>
__device__ __forceinline__ void stage_x(const TIn* __restrict__ x,
                                        __nv_bfloat16* xs, int ld, int m0,
                                        int M, int K, int k0, int kn) {
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;
  constexpr int E = 16 / sizeof(TIn);             // elements a 16-byte load
  constexpr int BATCH = 4;
  constexpr int T = WARPS * 32;
  auto put = [&](int r, int c, float v) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const __nv_bfloat16 hb = __float2bfloat16(v);
      xs[(size_t)(p * ROWS + r) * ld + c] = hb;
      v -= __bfloat162float(hb);
    }
  };
  if (K % E == 0 && (uintptr_t)x % 16 == 0) {
    const int vpr = kn / E, total = ROWS * vpr;   // kn is a multiple of 80
    for (int base = threadIdx.x; base < total; base += BATCH * T) {
      uint4 v[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = base + j * T;
        const int r = i / vpr, k = k0 + (i - r * vpr) * E;
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && m0 + r < M && k < K)
          v[j] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k));
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = base + j * T;
        if (i >= total) break;
        const int r = i / vpr, c = (i - r * vpr) * E;
        const TIn* e = reinterpret_cast<const TIn*>(&v[j]);
#pragma unroll
        for (int q = 0; q < E; ++q) put(r, c + q, rt::to_f(e[q]));
      }
    }
  } else {
    constexpr int SB = 8;
    const int total = ROWS * kn;
    for (int base = threadIdx.x; base < total; base += SB * T) {
      float v[SB];
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const int i = base + j * T;
        const int r = i / kn, k = k0 + i - r * kn;
        v[j] = (i < total && m0 + r < M && k < K)
                   ? rt::to_f(x[(size_t)(m0 + r) * K + k]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const int i = base + j * T;
        if (i >= total) break;
        const int r = i / kn;
        put(r, i - r * kn, v[j]);
      }
    }
  }
}

// x[m][k .. k + 4) as loaded: 4 bf16 (uint2) or 4 fp32 (float4), zero past
// M and K and where !ok; one 8- or 16-byte load where the rows of x are
// aligned to it (vecx), else one value at a time.
template <typename TIn>
using XRaw = typename std::conditional<sizeof(TIn) == 4, float4, uint2>::type;

template <typename TIn>
__device__ __forceinline__ XRaw<TIn> load_x4(const TIn* __restrict__ x, int m,
                                             int k, int M, int K, bool vecx,
                                             bool ok) {
  XRaw<TIn> r{};
  if (!ok || m >= M) return r;
  const TIn* p = x + (size_t)m * K + k;
  if (vecx && k + 4 <= K) return __ldg(reinterpret_cast<const XRaw<TIn>*>(p));
  TIn* e = reinterpret_cast<TIn*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < K) e[i] = p[i];
  return r;
}

// 4 values of x as the B fragment (two bf16x2) of each of P planes.
template <int P>
__device__ __forceinline__ void b_planes(const uint2& r, uint32_t (&b)[P][2]) {
  b[0][0] = r.x;                                  // bf16 x: its own bits
  b[0][1] = r.y;
}
template <int P>
__device__ __forceinline__ void b_planes(const float4& r, uint32_t (&b)[P][2]) {
  float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    b[q][0] = *reinterpret_cast<const uint32_t*>(&lo);
    b[q][1] = *reinterpret_cast<const uint32_t*>(&hi);
    const float2 lf = __bfloat1622float2(lo), hf = __bfloat1622float2(hi);
    v[0] -= lf.x; v[1] -= lf.y; v[2] -= hf.x; v[3] -= hf.y;
  }
}

template <typename TIn, typename TOut, int NT, bool VEC>
__device__ __forceinline__ void qmatvec_body(
    const TIn* __restrict__ x, const int32_t* __restrict__ w,
    const float* __restrict__ delta, const float* __restrict__ bias,
    TOut* __restrict__ y, float* __restrict__ part, int M, int K, int KP,
    int N, int CG, int cps, int piece) {
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;     // bf16 planes of x
  constexpr int ROWS = 8 * NT;                    // rows of x a block
  constexpr int ACC = 2 * NT * 4;                 // fp32 sums a lane
  constexpr bool STAGE = NT > 2;                  // 64-row tiles stage x
  constexpr int DEPTH = STAGE ? 2 : 4;            // W chunks in flight a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem);    // reused after the pieces

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int KW = WARPS / CG;
  const int cgi = warp % CG, kw = warp / CG;
  const int n = (blockIdx.x * CG + cgi) * 32 + 4 * g;   // this lane's columns
  const int m0 = blockIdx.y * ROWS;
  const int ksplit = gridDim.z, rank = blockIdx.z;
  const int nchunks = (KP + 7) / 8;
  const int c_begin = rank * cps, c_end = min(nchunks, c_begin + cps);
  const int ld = piece * CHUNK_K + XPAD;
  const bool vecx = K % 4 == 0 && (uintptr_t)x % 16 == 0;

  float acc[2][NT][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0.f;
  float tot[2][NT][4] = {};       // acc holds one chunk (promotes)

  // 64-row tiles: a piece of the block's chunks is staged in shared memory
  // at a time, the B fragments read from there; 8- and 16-row tiles: no
  // staging, each lane reads its B fragments straight from x. Each warp
  // walks its
  // chunks (kw, kw + KW, ...) with the W of the next DEPTH chunks in
  // flight while it multiplies one.
  for (int pc0 = c_begin; pc0 < c_end; pc0 += piece) {
    const int pn = min(piece, c_end - pc0);
    uint4 wq[DEPTH][2];                           // chunks ci .. + DEPTH - 1
#pragma unroll
    for (int i = 0; i < DEPTH; ++i)
      load_chunk<VEC>(w, pc0 + kw + i * KW, t, n, KP, N, kw + i * KW < pn,
                      wq[i]);
    if constexpr (STAGE) {
      __syncthreads();                            // the last piece is read
      stage_x<TIn, ROWS>(x, xs, ld, m0, M, K, pc0 * CHUNK_K, pn * CHUNK_K);
      __syncthreads();
    }
    // unstaged tiles: the B fragments' x values of the next chunk load
    // while this one is multiplied
    XRaw<TIn> xn[STAGE ? 1 : 5][NT];
    auto load_xn = [&](int ci) {
      if constexpr (!STAGE) {
#pragma unroll
        for (int s = 0; s < 5; ++s)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            xn[s][nt] = load_x4<TIn>(x, m0 + nt * 8 + g,
                                     (pc0 + ci) * CHUNK_K + 20 * t + 4 * s, M,
                                     K, vecx, ci < pn);
      }
    };
    load_xn(kw);
#pragma unroll 1
    for (int ci = kw; ci < pn; ci += KW) {
      const uint32_t wb[2][4] = {
          {wq[0][0].x ^ BIAS4, wq[0][0].y ^ BIAS4, wq[0][0].z ^ BIAS4,
           wq[0][0].w ^ BIAS4},
          {wq[0][1].x ^ BIAS4, wq[0][1].y ^ BIAS4, wq[0][1].z ^ BIAS4,
           wq[0][1].w ^ BIAS4}};
#pragma unroll
      for (int i = 0; i + 1 < DEPTH; ++i) {
        wq[i][0] = wq[i + 1][0];
        wq[i][1] = wq[i + 1][1];
      }
      load_chunk<VEC>(w, pc0 + ci + DEPTH * KW, t, n, KP, N,
                      ci + DEPTH * KW < pn, wq[DEPTH - 1]);
      XRaw<TIn> xc[STAGE ? 1 : 5][NT];
      if constexpr (!STAGE) {
#pragma unroll
        for (int s = 0; s < 5; ++s)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) xc[s][nt] = xn[s][nt];
        load_xn(ci + KW);
      }
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        // pair 2s -> slots {2t, 2t+1}, pair 2s + 1 -> {2t+8, 2t+9}; pair p
        // is fields 2 (p % 5), +1 of word row 2t + p / 5
        const int p0 = 2 * s, p1 = 2 * s + 1;
        uint32_t a[2][4];
#pragma unroll
        for (int tu = 0; tu < 2; ++tu) {
          a[tu][0] = level_pair(wb[p0 / 5][2 * tu], p0 % 5);
          a[tu][1] = level_pair(wb[p0 / 5][2 * tu + 1], p0 % 5);
          a[tu][2] = level_pair(wb[p1 / 5][2 * tu], p1 % 5);
          a[tu][3] = level_pair(wb[p1 / 5][2 * tu + 1], p1 % 5);
        }
        const int kk = ci * CHUNK_K + 20 * t + 4 * s;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t b0, b1;
            if constexpr (STAGE) {
              const uint2 bv = *reinterpret_cast<const uint2*>(
                  xs + (size_t)(p * ROWS + nt * 8 + g) * ld + kk);
              b0 = bv.x;
              b1 = bv.y;
            } else {
              uint32_t bp[P][2];
              b_planes<P>(xc[s][nt], bp);
              b0 = bp[p][0];
              b1 = bp[p][1];
            }
#pragma unroll
            for (int tu = 0; tu < 2; ++tu)
              mma_bf16_16816(acc[tu][nt], a[tu][0], a[tu][1], a[tu][2],
                             a[tu][3], b0, b1);
          }
      }
      if constexpr (rt::promotes<TIn, TOut>()) rt::promote(tot, acc);
    }
  }
  if constexpr (rt::promotes<TIn, TOut>()) rt::promote(acc, tot);

  // the KW slices of K, in order: slice 0's warps add the others'
  __syncthreads();                                // x no longer read
  if (KW > 1) {
    if (kw > 0) {
      float* dst = red + ((size_t)(kw * CG + cgi) * 32 + lane) * ACC;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(u * NT + nt) * 4 + e] = acc[u][nt][e];
    }
    __syncthreads();
    if (kw == 0)
      for (int q = 1; q < KW; ++q) {
        const float* src = red + ((size_t)(q * CG + cgi) * 32 + lane) * ACC;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][nt][e] += src[(u * NT + nt) * 4 + e];
      }
  }
  if (kw != 0) return;
  // c0, c1: mma row g (column n + 2u), x rows 2t, 2t + 1; c2, c3: mma row
  // g + 8 (column n + 2u + 1). With K split across blocks, this block's
  // fp32 partial goes to part[rank] for the second pass.
  float* pr = part + (size_t)rank * M * N;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n + 2 * u + h;
      if (col >= N) continue;
      const float d = delta[col];
      const float b = bias ? bias[col] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + nt * 8 + 2 * t + e;
          if (m >= M) continue;
          const float v = acc[u][nt][2 * h + e];
          if (ksplit > 1) pr[(size_t)m * N + col] = v;
          else y[(size_t)m * N + col] = rt::from_f<TOut>(v * d + b);
        }
    }
}

// The second pass where K was split across blocks: the ksplit partials of
// each output summed in rank order, then delta, bias and one cast.
template <typename TOut>
__device__ __forceinline__ void sum_body(const float* __restrict__ part,
                                         const float* __restrict__ delta,
                                         const float* __restrict__ bias,
                                         TOut* __restrict__ y, int M, int N,
                                         int ksplit) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int col = (int)(i % N);
    float v = 0.f;
    for (int r = 0; r < ksplit; ++r) v += part[r * total + i];
    y[i] = rt::from_f<TOut>(v * delta[col] + (bias ? bias[col] : 0.f));
  }
}

template <typename TIn, typename TOut, int NT, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
qmatvec_kernel_decode(const TIn* __restrict__ x, const int32_t* __restrict__ w,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias, TOut* __restrict__ y,
                      float* __restrict__ part, int M, int K, int KP, int N,
                      int CG, int cps, int piece) {
  qmatvec_body<TIn, TOut, NT, VEC>(x, w, delta, bias, y, part, M, K, KP, N,
                                   CG, cps, piece);
}

template <typename TIn, typename TOut, int NT, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
qmatvec_kernel_prefill(const TIn* __restrict__ x, const int32_t* __restrict__ w,
                       const float* __restrict__ delta,
                       const float* __restrict__ bias, TOut* __restrict__ y,
                       float* __restrict__ part, int M, int K, int KP, int N,
                       int CG, int cps, int piece) {
  qmatvec_body<TIn, TOut, NT, VEC>(x, w, delta, bias, y, part, M, K, KP, N,
                                   CG, cps, piece);
}

template <typename TOut>
__global__ void __launch_bounds__(256)
qmatvec_kernel_decode_sum(const float* __restrict__ part,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias, TOut* __restrict__ y,
                          int M, int N, int ksplit) {
  sum_body<TOut>(part, delta, bias, y, M, N, ksplit);
}

template <typename TOut>
__global__ void __launch_bounds__(256)
qmatvec_kernel_prefill_sum(const float* __restrict__ part,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias, TOut* __restrict__ y,
                           int M, int N, int ksplit) {
  sum_body<TOut>(part, delta, bias, y, M, N, ksplit);
}

// Launches variant V (0 decode, 1 prefill) with NT 8-row tiles of x a
// block, after checking the plan against what the body assumes, and the
// second pass where K is split across blocks.
template <typename TIn, typename TOut, int V, int NT, bool VEC>
int launch_nt(const void* x, const void* w, const void* delta,
              const void* bias, void* y, float* part, int M, int K, int KP,
              int N, int CG, int ksplit, int cps, int piece, int smem,
              cudaStream_t st) {
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;
  const int nchunks = (KP + 7) / 8;
  const int need = max(NT > 2 ? P * 8 * NT * (piece * CHUNK_K + XPAD) * 2 : 0,
                       WARPS * 32 * 2 * NT * 4 * 4);
  if ((CG != 1 && CG != 2 && CG != 4 && CG != 8) || ksplit < 1 ||
      cps < 1 || (long long)cps * ksplit < nchunks || piece < 1 ||
      piece > cps || smem < need || (ksplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  void (*kern)(const TIn*, const int32_t*, const float*, const float*, TOut*,
               float*, int, int, int, int, int, int, int);
  void (*sum)(const float*, const float*, const float*, TOut*, int, int, int);
  if constexpr (V == 0) {
    kern = qmatvec_kernel_decode<TIn, TOut, NT, VEC>;
    sum = qmatvec_kernel_decode_sum<TOut>;
  } else {
    kern = qmatvec_kernel_prefill<TIn, TOut, NT, VEC>;
    sum = qmatvec_kernel_prefill_sum<TOut>;
  }
  static int smem_set = 48 * 1024;                    // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid((N + 32 * CG - 1) / (32 * CG), (M + 8 * NT - 1) / (8 * NT),
                  ksplit);
  kern<<<grid, WARPS * 32, smem, st>>>((const TIn*)x, (const int32_t*)w,
                                        (const float*)delta,
                                        (const float*)bias, (TOut*)y, part, M,
                                        K, KP, N, CG, cps, piece);
  if (ksplit > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)M * N;
    const int blocks = (int)min((total + 255) / 256, 4096LL);
    sum<<<blocks, 256, 0, st>>>(part, (const float*)delta,
                                (const float*)bias, (TOut*)y, M, N, ksplit);
  }
  return 0;
}

template <typename TIn, typename TOut>
int launch(int variant, int nt, const void* x, const void* w,
           const void* delta, const void* bias, void* y, float* part, int M,
           int K, int KP, int N, int CG, int ksplit, int cps, int piece,
           int smem, cudaStream_t st) {
  const bool vec = N % 4 == 0 && (uintptr_t)w % 16 == 0;
#define RT_NT(V, NT_)                                                         \
  if (variant == V && nt == NT_)                                              \
    return vec ? launch_nt<TIn, TOut, V, NT_, true>(                          \
                     x, w, delta, bias, y, part, M, K, KP, N, CG, ksplit,     \
                     cps, piece, smem, st)                                    \
               : launch_nt<TIn, TOut, V, NT_, false>(                         \
                     x, w, delta, bias, y, part, M, K, KP, N, CG, ksplit,     \
                     cps, piece, smem, st);
  RT_NT(0, 1) RT_NT(0, 2) RT_NT(1, 2) RT_NT(1, 8)
#undef RT_NT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_dtype / y_dtype: 0 fp32, 1 bf16. bias may be null. The tile shape is
// the wrapper's plan: variant (0 decode with nt = 1 or 2, 1 prefill with
// nt = 2 or 8: nt 8-row tiles of x a block; x is staged for nt = 8), cg
// column groups of 32 a block, ksplit slices of K across blocks, cps chunks of 80 K a slice, piece
// chunks staged at a time, smem the dynamic shared memory (bytes). part is
// fp32 scratch of ksplit x M x N for the partial sums (null when ksplit is
// 1). Returns the CUDA error code of the launch (0 on success).
extern "C" int qmatvec_launch(const void* x, const void* w, const void* delta,
                              const void* bias, void* y, void* part, int M,
                              int K, int KP, int N, int x_dtype, int y_dtype,
                              int variant, int nt, int cg, int ksplit,
                              int cps, int piece, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* pt = (float*)part;
  int rc;
  if (x_dtype == 0 && y_dtype == 0)
    rc = launch<float, float>(variant, nt, x, w, delta, bias, y, pt, M, K, KP, N, cg, ksplit, cps, piece, smem, st);
  else if (x_dtype == 0 && y_dtype == 1)
    rc = launch<float, __nv_bfloat16>(variant, nt, x, w, delta, bias, y, pt, M, K, KP, N, cg, ksplit, cps, piece, smem, st);
  else if (x_dtype == 1 && y_dtype == 0)
    rc = launch<__nv_bfloat16, float>(variant, nt, x, w, delta, bias, y, pt, M, K, KP, N, cg, ksplit, cps, piece, smem, st);
  else if (x_dtype == 1 && y_dtype == 1)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(variant, nt, x, w, delta, bias, y, pt, M, K, KP, N, cg, ksplit, cps, piece, smem, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
