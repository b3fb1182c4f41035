// qmatmul: y = (x . W) * delta + bias, W as int8 levels with explicit strides.
//
// Replaces the TPU kernel src/repro/kernels/qmatmul/kernel.py::qmatmul_pallas
// (body _kernel).
//
// Layout: x (M, K) fp32 or bf16, row-major. W is a (K, N) int8 matrix given
// by a pointer and two element strides (stride_k, stride_n), so the tied
// readout passes the transposed view q.T of its (V, D) embedding table
// (stride_k = 1, stride_n = D) without copying the table each tick. delta
// and the optional bias are (N,) fp32; y (M, N) fp32 or bf16. Every layout
// sums in fp32, applies delta and bias in fp32 and casts once.
//
// What bounds it on the H100: the tied readout at decode (M = slots) reads
// the whole 151936 x 1536 int8 table (233 MB) once for 2 * M flops per
// byte, so it is bound by bytes (0.07 ms at 3.35 TB/s). Done on the CUDA
// cores that is 8 fp32 FMAs and a conversion per byte at M = 8, which
// alone would take about as long as the bytes. The paper MLP's 8-bit heads
// (K = 1022, N = 10 or 61) move under 1 MB: they are bound by latency, and
// a grid of a few blocks each walking all of K leaves the card idle. The q
// form's projections are bound by bytes at decode (qwen2-1.5b reads 1.31 GB
// of levels a tick, 0.39 ms) and by operations at prefill (M = slots x
// bucket, up to 2048 rows: 56 GFLOP for one `down` projection), so they
// need the tensor cores at both.
//
// The wrapper (kernels/qmatmul/kernel.py::plan) picks the layout from W's
// strides and N; each reads W coalesced:
//
// k_lanes: lanes along K, in two kernels by W's orientation.
//   K-contiguous W (stride_k == 1: the tied readout's q.T). The four lanes
//   of a quad read 16 bytes each of one table row, so a warp load covers 64
//   contiguous bytes of each of 8 rows and every byte of a sector is used.
//   The int8 levels become bf16 exactly (a byte permute into a float's
//   mantissa and one subtraction), and the sum over K runs on the tensor
//   cores (mma.sync m16n8k16, bf16 in, fp32 accumulation): a warp owns a
//   tile of 16 table rows, the M rows of x are the mma's 8 columns, and
//   the reduction across the lanes of the quad happens inside the
//   instruction. The K order inside a 64-wide chunk is permuted so that each
//   lane's 16 loaded bytes feed its own A fragment; x is read through the
//   same permutation, so the sum is unchanged. A step is two such chunks,
//   and the next step's 4 loads a lane are in flight while the current
//   step is multiplied, so each SM keeps enough bytes in flight to cover
//   the memory's latency. x is staged once per block in shared memory
//   (dynamic, padded against bank conflicts) in chunks of kc K values:
//   bf16 x as is, fp32 x split into three bf16 planes
//   (hi + mid + lo == x exactly), so the products stay exact and the fp32
//   result keeps fp32 accuracy. The grid is persistent: as many blocks as
//   the SMs hold at once, each staging x once and walking tiles in rounds
//   sized so every block gets the same number (no half-empty last wave).
//   A block serves 8 * NT rows of x; M beyond that is a grid dimension.
//   Row-major W with N <= 64 (the MoE routers, the MLP heads). W is small
//   (48 KB for mixtral-8x22b's router) and x is not: at an admission of
//   32768 tokens the router reads 403 MB of x for 2 M K N = 3.2 GFLOP, so
//   it is bound by the bytes of x (0.12 ms at 3.35 TB/s); at a tick (M =
//   8) by latency. The kernel (qmatmul_kernel_klanes_rows) gives a block
//   tiles of 16 rows (rw of them, one a warp, at large M) and stages W in
//   shared memory once a block (int8, n-major), so W is read from device
//   memory once and from L2 once a block rather than once a row; x streams
//   through each warp's own cp.async stages in 16-byte copies, two or three
//   steps of 64 K ahead, and the sum runs on the tensor cores (mma.sync
//   m16n8k16: the 16 rows are A, an n8 tile of W's columns is B, so N = 8
//   is one tile and 64 eight), fp32 x as three bf16 planes, each step
//   promoted into fp32. Where a tile of rows is all there is (M <= 16, a
//   decode tick, or too few tiles for the SMs), the 8 warps of a block
//   split K, and K is also split across the blocks of a cluster, whose
//   sums meet in distributed shared memory in a fixed order, so the grid
//   fills more of the card with one launch and reruns give the same bits.
//
// n_lanes (any other W: a row-major (K, N) matrix, the q form's
//   projections). Lanes along N: each lane reads 16 contiguous columns of a
//   K row (one 16-byte load), so four lanes cover the 64 columns a warp
//   owns and the warps of a block cover neighbouring lines. The levels
//   become bf16 exactly (as in k_lanes) and are stored in shared memory as
//   (K, N) bf16 tiles; ldmatrix.trans reads them as tensor-core fragments
//   with K pairs in one register, which the row-major int8 layout does not
//   give directly. Two kernels, picked by M in
//   kernels/qmatmul/kernel.py::plan, as qmatvec picks its own:
//   decode (M <= 16, bound by the bytes of W): W^T is the mma's 16-row A
//   operand (16 output columns) and the M rows of x its 8-wide B operand
//   (NT = 1 or 2 tiles of 8 rows). Every warp works alone: it keeps its
//   next 64-row chunk of its 64 columns in flight (cp.async into int8
//   stages of its own, 8 x 16 bytes a lane a chunk) while it widens the
//   current one into its own bf16 tile in shared memory and multiplies it;
//   only __syncwarp orders them. What bounds it is latency, not bytes: a
//   warp's chunk is a chain of copy, widen, ldmatrix and mma, so the plan
//   keeps two blocks of 4 warps on every SM (K split across blocks where
//   N / 64 is short of that) rather than deeper stages.
//   The K order inside a chunk is permuted as the tile is written, so
//   lane t's B fragments over the chunk's four k16 steps are 16
//   consecutive K values of x, loaded once (two 16-byte loads a row in
//   bf16); A is read through the same permutation, so the sum is
//   unchanged. A block is 64 columns x KW <= 4 warps splitting K (summed in
//   shared memory in a fixed order; three blocks fit an SM, so the grid
//   runs in one wave); K is also split across blocks, and a second kernel
//   sums the fp32 partials in rank order, then applies delta and bias
//   (qmatvec's split).
//   prefill (M > 16, bound by operations): a tiled GEMM on mma.sync, block
//   tile 128 (M) x 128 (N) x 64 (K), 8 warps of 64 x 32. x and the int8 W
//   go through a 3-stage cp.async pipeline into shared memory; each step
//   the block widens its W stage to a bf16 tile (and splits fp32 x into
//   its planes), then multiplies: x is the A operand (ldmatrix), W the B
//   operand (ldmatrix.trans of the bf16 tile). Two blocks an SM for bf16
//   x, one for fp32 (its planes take 55 KB). Four stages (one block an SM)
//   and a register-prefetched double buffer (the next step's tiles loaded
//   into registers while the current one is multiplied) both ran slower
//   on the H100 (PERF.md). W is read once per 128 rows of x. Each lane
//   stores its two neighbouring output columns as one word. Where the
//   grid has fewer blocks than SMs, K is split across blocks as for
//   decode.
//   fp32 x enters both as three bf16 planes (hi + mid + lo == x exactly),
//   so every product with an int8 level is exact; each run of 64 K (128 in
//   k_lanes) is summed by mma.sync and added into an fp32 total on the CUDA
//   cores (rt::promote), so the sum is fp32's (fp32 x, or an fp32 output:
//   rt::promotes).
//   W with other strides (or unaligned rows) is read one byte at a time
//   into the same stages.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 int8 levels (one uint4) as 16 bf16 (two uint4), in order.
__device__ __forceinline__ void widen16(const uint4 v, uint4& lo, uint4& hi) {
  const uint32_t u[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                         v.z ^ 0x80808080u, v.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[2 * j] = rt::bf16x2_of_levels(u[j], 0x7440, 0x7441);
    o[2 * j + 1] = rt::bf16x2_of_levels(u[j], 0x7442, 0x7443);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// W[k][n .. n + 16) as 16 bytes, zero past K and N: one streaming 16-byte
// load where W is row-major with 16-byte aligned rows (VEC) and the 16
// columns lie inside N, else one byte at a time through both strides.
template <bool VEC>
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w,
                                          long long sk, long long sn, int k,
                                          int n, int K, int N) {
  if (k >= K || n >= N) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = w + (size_t)k * sk + (size_t)n * sn;
  if (VEC && n + 16 <= N) return __ldcs(reinterpret_cast<const uint4*>(p));
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (n + i < N) wd[i >> 2] |= (uint32_t)(uint8_t)p[(size_t)i * sn] << (8 * (i & 3));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// E consecutive values of row m of x from column k as raw 32-bit words
// (bf16 pairs, or fp32 values), zero past M and K: 16-byte loads where the
// rows of x are aligned to them (vecx), else one value at a time.
template <typename TIn, int E>
__device__ __forceinline__ void load_x(const TIn* __restrict__ x, int m, int k,
                                       int M, int K, bool vecx,
                                       uint32_t (&r)[E * sizeof(TIn) / 4]) {
  constexpr int WORDS = E * sizeof(TIn) / 4;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) r[i] = 0u;
  if (m >= M) return;
  const TIn* p = x + (size_t)m * K + k;
  if (vecx && k + E <= K) {
#pragma unroll
    for (int j = 0; j < WORDS / 4; ++j) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + j);
      r[4 * j] = v.x;
      r[4 * j + 1] = v.y;
      r[4 * j + 2] = v.z;
      r[4 * j + 3] = v.w;
    }
    return;
  }
  __align__(16) TIn e[E];
#pragma unroll
  for (int i = 0; i < E; ++i) e[i] = k + i < K ? p[i] : rt::from_f<TIn>(0.f);
#pragma unroll
  for (int i = 0; i < WORDS; ++i)
    r[i] = reinterpret_cast<const uint32_t*>(e)[i];
}

// Two values as a bf16x2 of each of P planes (plane p: what the planes
// before it leave; one plane of a bf16 value is the value itself).
template <int P>
__device__ __forceinline__ void planes2(float a, float b, uint32_t (&o)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    o[p] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    a -= f.x;
    b -= f.y;
  }
}

// Values v, v + 1 of a raw run of x (v even) as the bf16x2 of each of P
// planes: a bf16 pair is its own word; fp32 values are split.
template <typename TIn, int P>
__device__ __forceinline__ void raw_planes(const uint32_t* r, int v,
                                           uint32_t (&o)[P]) {
  if constexpr (sizeof(TIn) == 2) {
    o[0] = r[v / 2];
  } else {
    planes2<P>(__uint_as_float(r[v]), __uint_as_float(r[v + 1]), o);
  }
}

// --- n_lanes, decode --------------------------------------------------------

constexpr int ND_COLS = 64;       // output columns a block (and a warp)
constexpr int ND_KC = 64;         // K rows a chunk: four k16 steps
constexpr int ND_LD = ND_COLS + 8;          // bf16 a tile row, padded
constexpr int ND_TILE = ND_KC * ND_LD * 2;  // bytes of a warp's bf16 tile
constexpr int ND_RAW = ND_KC * ND_COLS;     // bytes of an int8 chunk
constexpr int ND_STAGES = 2;      // int8 chunks a warp keeps in flight
constexpr int ND_WARP = ND_STAGES * ND_RAW + ND_TILE;   // smem bytes a warp

// Tile row of chunk row r: r = 16 t + 4 s + q goes to k16 step s, slot
// 2 t + q (q < 2) or 8 + 2 t + q - 2, so that lane t's B slots over the
// chunk are x[16 t .. 16 t + 16).
__device__ __forceinline__ int nd_tile_row(int r) {
  const int t = r >> 4, s = (r >> 2) & 3, q = r & 3;
  return 16 * s + (q < 2 ? 2 * t + q : 8 + 2 * t + q - 2);
}

// Each warp streams its chunks through ND_STAGES int8 stages of its own
// (cp.async, 16 bytes a copy; lane piece i is chunk row (lane >> 2) + 8 i,
// columns 16 (lane & 3) .. + 16, read back by the lane that copied it, so
// no barrier orders the stages), widens the current one into its bf16
// tile and multiplies it; W that cp.async cannot copy (other strides,
// unaligned rows) is read a byte at a time into the same stage.
template <typename TIn, typename TOut, int NT, bool VEC>
__global__ void __launch_bounds__(128)
qmatmul_kernel_nlanes_decode(const TIn* __restrict__ x,
                             const int8_t* __restrict__ w, long long sk,
                             long long sn, const float* __restrict__ delta,
                             const float* __restrict__ bias,
                             TOut* __restrict__ y, float* __restrict__ part,
                             int M, int K, int N, int cps) {
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;     // bf16 planes of x
  constexpr int ACC = 4 * NT * 4;                 // fp32 sums a lane
  constexpr int XW = 16 * sizeof(TIn) / 4;        // raw words of 16 values
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KW = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* stages = smem_raw + warp * ND_WARP;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(stages + ND_STAGES * ND_RAW);
  float* red = reinterpret_cast<float*>(smem_raw);          // after the loop
  const int n0 = blockIdx.x * ND_COLS;
  const int rank = blockIdx.y, ksplit = gridDim.y;
  const int nch = (K + ND_KC - 1) / ND_KC;
  const int c0 = rank * cps, cn = min(nch, c0 + cps) - c0;
  const bool vecx = K % (16 / (int)sizeof(TIn)) == 0 && (uintptr_t)x % 16 == 0;
  const int col = n0 + 16 * (lane & 3);           // this lane's 16 columns

  float acc[4][NT][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0.f;
  float tot[4][NT][4] = {};       // acc holds one chunk (promotes)

  // the warp's j-th chunk (ci = warp + j KW) into stage j % ND_STAGES; one
  // commit group a chunk, empty past the slice
  auto fetch = [&](int j) {
    const int ci = warp + j * KW;
    unsigned char* st = stages + (j % ND_STAGES) * ND_RAW;
    if (ci < cn) {
      const int kb = (c0 + ci) * ND_KC;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (lane >> 2) + 8 * i, k = kb + r;
        unsigned char* dst = st + r * ND_COLS + 16 * (lane & 3);
        if (VEC) {
          const int bytes = (k < K && col < N) ? min(16, N - col) : 0;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           smem_u32(dst)),
                       "l"(w + (bytes ? (size_t)k * sk + col : 0)), "r"(bytes)
                       : "memory");
        } else {
          *reinterpret_cast<uint4*>(dst) = load_w16<false>(w, sk, sn, k, col, K, N);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // this lane's B values of a chunk: x[8 nt + g][16 t .. 16 t + 16)
  auto load_xc = [&](int ci, uint32_t (&dst)[NT][XW]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      load_x<TIn, 16>(x, 8 * nt + g, (c0 + ci) * ND_KC + 16 * t,
                      ci < cn ? M : 0, K, vecx, dst[nt]);
  };

  uint32_t xv[NT][XW];
#pragma unroll
  for (int j = 0; j < ND_STAGES - 1; ++j) fetch(j);
  load_xc(warp, xv);
#pragma unroll 1
  for (int j = 0; warp + j * KW < cn; ++j) {
    const int ci = warp + j * KW;
    fetch(j + ND_STAGES - 1);         // into the stage chunk j - 1 left
    uint32_t xc[NT][XW];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < XW; ++i) xc[nt][i] = xv[nt][i];
    load_xc(ci + KW, xv);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(ND_STAGES - 1) : "memory");
    __syncwarp();                                 // the last tile is read
    const unsigned char* st = stages + (j % ND_STAGES) * ND_RAW;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (lane >> 2) + 8 * i;
      uint4 lo, hi;
      widen16(*reinterpret_cast<const uint4*>(st + r * ND_COLS + 16 * (lane & 3)),
              lo, hi);
      uint4* dst = reinterpret_cast<uint4*>(tile + nd_tile_row(r) * ND_LD +
                                            16 * (lane & 3));
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t b[NT][2][P];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        raw_planes<TIn, P>(xc[nt], 4 * s, b[nt][0]);
        raw_planes<TIn, P>(xc[nt], 4 * s + 2, b[nt][1]);
      }
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t a[4];
        ldsm_x4_trans(a, tile + (16 * s + r + 8 * (mi >> 1)) * ND_LD + 16 * u +
                             8 * (mi & 1));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int p = 0; p < P; ++p)
            mma_bf16_16816(acc[u][nt], a[0], a[1], a[2], a[3], b[nt][0][p],
                           b[nt][1][p]);
      }
    }
    if constexpr (rt::promotes<TIn, TOut>()) rt::promote(tot, acc);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if constexpr (rt::promotes<TIn, TOut>()) rt::promote(acc, tot);

  // the KW slices of K, in order: warp 0 adds the others'
  __syncthreads();                                // the stages are done
  if (KW > 1) {
    if (warp > 0) {
      float* dst = red + ((size_t)warp * 32 + lane) * ACC;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(u * NT + nt) * 4 + e] = acc[u][nt][e];
    }
    __syncthreads();
    if (warp == 0)
      for (int q = 1; q < KW; ++q) {
        const float* src = red + ((size_t)q * 32 + lane) * ACC;
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][nt][e] += src[(u * NT + nt) * 4 + e];
      }
  }
  if (warp != 0) return;
  // c0, c1: A row g (column n0 + 16 u + g), x rows 2t, 2t + 1 of tile nt;
  // c2, c3: A row g + 8
  float* pr = part + (size_t)rank * M * N;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = n0 + 16 * u + g + 8 * h;
      if (cc >= N) continue;
      const float d = delta[cc];
      const float bb = bias ? bias[cc] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * nt + 2 * t + e;
          if (m >= M) continue;
          const float v = acc[u][nt][2 * h + e];
          if (ksplit > 1) pr[(size_t)m * N + cc] = v;
          else y[(size_t)m * N + cc] = rt::from_f<TOut>(v * d + bb);
        }
    }
}

// --- n_lanes, prefill -------------------------------------------------------

constexpr int NP_BM = 128, NP_BN = 128, NP_BK = 64;
constexpr int NP_STAGES = 3;                  // cp.async stages of x and W
constexpr int NP_XLD = NP_BK + 8;             // bf16 an x tile row, padded
constexpr int NP_WLD = NP_BN + 8;             // bf16 a W tile row, padded

// One K step of a block tile: the warp's 64 x 32 outputs (rows 64 wm, columns
// 32 wn) += the x tile (P bf16 planes of NP_BM rows, row stride NP_XLD) . the
// W tile (NP_BK x NP_BN bf16, row stride NP_WLD).
template <int P>
__device__ __forceinline__ void np_mma(float (&acc)[4][4][4],
                                       const __nv_bfloat16* xb,
                                       const __nv_bfloat16* wb, int lane,
                                       int wm, int wn) {
#pragma unroll
  for (int ks = 0; ks < NP_BK / 16; ++ks) {
    uint32_t bf[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {            // two n8 tiles a load
      uint32_t r[4];
      const int mi = lane >> 3;
      ldsm_x4_trans(r, wb + (16 * ks + (lane & 7) + 8 * (mi & 1)) * NP_WLD +
                           32 * wn + 16 * np + 8 * (mi >> 1));
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, xb + (p * NP_BM + 64 * wm + 16 * mt + (lane & 15)) * NP_XLD +
                       16 * ks + 8 * (lane >> 4));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], a[0], a[1], a[2], a[3], bf[nt][0],
                         bf[nt][1]);
      }
  }
}

// The prefill epilogue of a warp's 64 x 32 tile at (mw, nw): delta, bias
// and one cast into y, or the raw fp32 sums into this rank's partials where
// K was split. c0, c1: row 16 mt + g, columns 8 nt + 2 t, + 1; c2, c3: row
// + 8. The two columns go out as one word where both lie inside N and the
// row is aligned to it (N even).
template <typename TOut>
__device__ __forceinline__ void np_store(const float (&acc)[4][4][4],
                                         TOut* __restrict__ y,
                                         float* __restrict__ part,
                                         const float* __restrict__ delta,
                                         const float* __restrict__ bias,
                                         int M, int N, int mw, int nw, int g,
                                         int t, int rank, int ksplit) {
  float* pr = part + (size_t)rank * M * N;
  const bool pair = N % 2 == 0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = nw + 8 * nt + 2 * t;
    if (col >= N) continue;
    const bool two = pair && col + 1 < N;
    float d[2], bb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = min(col + e, N - 1);
      d[e] = delta[c];
      bb[e] = bias ? bias[c] : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mw + 16 * mt + g + 8 * h;
        if (m >= M) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        const size_t o = (size_t)m * N + col;
        if (ksplit > 1) {
          if (two) *reinterpret_cast<float2*>(pr + o) = make_float2(v0, v1);
          else pr[o] = v0;
        } else {
          const TOut r0 = rt::from_f<TOut>(v0 * d[0] + bb[0]);
          const TOut r1 = rt::from_f<TOut>(v1 * d[1] + bb[1]);
          if (two) {
            if constexpr (sizeof(TOut) == 4) {
              *reinterpret_cast<float2*>(y + o) = make_float2(r0, r1);
            } else {
              __nv_bfloat162 p2;
              p2.x = r0;
              p2.y = r1;
              *reinterpret_cast<__nv_bfloat162*>(y + o) = p2;
            }
          } else {
            y[o] = r0;
          }
        }
        if (!two && col + 1 < N) {            // odd N: the second column
          if (ksplit > 1) pr[o + 1] = v1;
          else y[o + 1] = rt::from_f<TOut>(v1 * d[1] + bb[1]);
        }
      }
  }
}

// The prefill's shared memory, bytes: NP_STAGES stages, each the raw x tile
// (NP_BM rows of NP_BK values, padded by 16 bytes a row) and the raw int8 W
// tile (NP_BK rows of NP_BN bytes); the bf16 W tile; for fp32 x the tile of
// its three bf16 planes. bf16 x: 97 280 bytes, two blocks an SM; fp32 x:
// 201 728, one.
template <typename TIn>
struct NpSmem {
  static constexpr int XRLD = NP_BK + 16 / (int)sizeof(TIn);  // values a row
  static constexpr int XR = NP_BM * XRLD * (int)sizeof(TIn);
  static constexpr int STAGE = XR + NP_BK * NP_BN;
  static constexpr int WT = NP_BK * NP_WLD * 2;
  static constexpr int PT = sizeof(TIn) == 4 ? 3 * NP_BM * NP_XLD * 2 : 0;
  static constexpr int BYTES = NP_STAGES * STAGE + WT + PT;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Block tile NP_BM x NP_BN, 8 warps of 64 x 32, fed by an NP_STAGES-stage
// cp.async pipeline: x and the int8 W land in shared memory NP_STAGES - 1
// steps ahead (16-byte copies, zero-filled past M, K and N); each step the
// block widens its W stage into the bf16 tile (and splits fp32 x into its
// planes), then multiplies. Two barriers a step: one before the next copy
// reuses the stage the last step read, one before the widened tile is read.
// W or x that cp.async cannot copy (other strides, unaligned rows) is read
// into the same stage with plain loads.
template <typename TIn, typename TOut, bool VEC>
__global__ void __launch_bounds__(256, (NpSmem<TIn>::BYTES <= 112 * 1024 ? 2 : 1))
qmatmul_kernel_nlanes_prefill(const TIn* __restrict__ x,
                              const int8_t* __restrict__ w, long long sk,
                              long long sn, const float* __restrict__ delta,
                              const float* __restrict__ bias,
                              TOut* __restrict__ y, float* __restrict__ part,
                              int M, int K, int N, int cps) {
  using L = NpSmem<TIn>;
  constexpr int S = NP_STAGES;
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;     // bf16 planes of x
  constexpr int XV = 16 / sizeof(TIn);            // x values a 16-byte copy
  constexpr int CPR = NP_BK / XV;                 // copies an x row
  constexpr int XL = NP_BM * CPR / 256;           // x copies a thread a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_raw + S * L::STAGE);
  __nv_bfloat16* pt = wt + NP_BK * NP_WLD;        // fp32 x: its planes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;       // warp tile 64 x 32
  const int n0 = blockIdx.x * NP_BN, m0 = blockIdx.y * NP_BM;
  const int rank = blockIdx.z, ksplit = gridDim.z;
  const int nkt = (K + NP_BK - 1) / NP_BK;
  const int kt0 = rank * cps, ktn = min(nkt, kt0 + cps) - kt0;
  const bool vecx = K % XV == 0 && (uintptr_t)x % 16 == 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float tot[4][4][4] = {};        // acc holds one K step (promotes)

  // step kt of the slice into stage kt % S; one commit group a step, empty
  // past the slice. x copy j: row i / CPR, values XV (i % CPR) (i = tid +
  // 256 j); W copy j: row i / 8, columns 16 (i % 8)
  auto issue = [&](int kt) {
    if (kt < ktn) {
      unsigned char* st = smem_raw + (kt % S) * L::STAGE;
      const int kb = (kt0 + kt) * NP_BK;
#pragma unroll
      for (int j = 0; j < XL; ++j) {
        const int i = tid + 256 * j, row = i / CPR, m = m0 + row;
        const int k = kb + XV * (i % CPR);
        unsigned char* dst = st + (row * L::XRLD + XV * (i % CPR)) * sizeof(TIn);
        if (vecx) {
          const int bytes = (m < M && k < K) ? 16 : 0;
          cp_async16(dst, x + (bytes ? (size_t)m * K + k : 0), bytes);
        } else {
          uint32_t r[4];
          load_x<TIn, XV>(x, m, k, M, K, false, r);
          *reinterpret_cast<uint4*>(dst) = make_uint4(r[0], r[1], r[2], r[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = tid + 256 * j, k = kb + (i >> 3);
        const int col = n0 + 16 * (i & 7);
        unsigned char* dst = st + L::XR + (i >> 3) * NP_BN + 16 * (i & 7);
        if (VEC) {
          const int bytes = (k < K && col < N) ? min(16, N - col) : 0;
          cp_async16(dst, w + (bytes ? (size_t)k * sk + col : 0), bytes);
        } else {
          *reinterpret_cast<uint4*>(dst) = load_w16<false>(w, sk, sn, k, col, K, N);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
#pragma unroll 1
  for (int kt = 0; kt < ktn; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2) : "memory");
    __syncthreads();            // step kt landed; step kt - 1 is read
    issue(kt + S - 1);          // into the stage step kt - 1 left
    const unsigned char* st = smem_raw + (kt % S) * L::STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + 256 * j;
      uint4 lo, hi;
      widen16(*reinterpret_cast<const uint4*>(st + L::XR + (i >> 3) * NP_BN +
                                              16 * (i & 7)),
              lo, hi);
      uint4* dst = reinterpret_cast<uint4*>(wt + (i >> 3) * NP_WLD + 16 * (i & 7));
      dst[0] = lo;
      dst[1] = hi;
    }
    const __nv_bfloat16* xb;
    if constexpr (P == 1) {
      xb = reinterpret_cast<const __nv_bfloat16*>(st);   // row stride NP_XLD
    } else {
#pragma unroll
      for (int j = 0; j < NP_BM * NP_BK / 4 / 256; ++j) {
        const int i = tid + 256 * j, row = i / (NP_BK / 4);
        const int col = 4 * (i % (NP_BK / 4));
        const float4 v = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(st) + row * L::XRLD + col);
        uint32_t o[2][P];
        planes2<P>(v.x, v.y, o[0]);
        planes2<P>(v.z, v.w, o[1]);
#pragma unroll
        for (int p = 0; p < P; ++p)
          *reinterpret_cast<uint2*>(pt + (p * NP_BM + row) * NP_XLD + col) =
              make_uint2(o[0][p], o[1][p]);
      }
      xb = pt;
    }
    __syncthreads();            // the widened tiles are written
    np_mma<P>(acc, xb, wt, lane, wm, wn);
    if constexpr (rt::promotes<TIn, TOut>()) rt::promote(tot, acc);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if constexpr (rt::promotes<TIn, TOut>()) rt::promote(acc, tot);

  np_store<TOut>(acc, y, part, delta, bias, M, N, m0 + 64 * wm,
                 n0 + 32 * wn, g, t, rank, ksplit);
}

// The second pass where K was split across blocks: the ksplit partials of
// each output summed in rank order, then delta, bias and one cast.
template <typename TOut>
__global__ void __launch_bounds__(256)
qmatmul_kernel_nlanes_sum(const float* __restrict__ part,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias, TOut* __restrict__ y,
                          int M, int N, int ksplit) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int col = (int)(i % N);
    float v = 0.f;
    for (int r = 0; r < ksplit; ++r) v += part[r * total + i];
    y[i] = rt::from_f<TOut>(v * delta[col] + (bias ? bias[col] : 0.f));
  }
}

// --- k_lanes ----------------------------------------------------------------

constexpr int KL_WARPS = 8;
constexpr int KL_STEP = 128;                      // K per step: 2 chunks of 64
constexpr int KL_PAD = 8;                         // bf16 pad per staged row

// 16 bytes of a W^T row from K index k (zero past K, or for a missing row).
template <bool VEC>
__device__ __forceinline__ uint4 load_row16(const int8_t* row, int k, int K,
                                            bool valid) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!valid) return v;
  if (VEC && k + 16 <= K) return __ldcs(reinterpret_cast<const uint4*>(row + k));
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k + i < K) wd[i >> 2] |= (uint32_t)(uint8_t)row[k + i] << (8 * (i & 3));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// A persistent grid: warp w of block b takes the tiles of 16 table rows
// b * KL_WARPS + w + i * gridDim.x * KL_WARPS, in rounds that are uniform
// across the block (so its barriers stay uniform).
template <typename TIn, typename TOut, int NT, bool VEC>
__global__ void __launch_bounds__(KL_WARPS * 32)
qmatmul_kernel_klanes(const TIn* __restrict__ x, const int8_t* __restrict__ w,
                      long long stride_n, const float* __restrict__ delta,
                      const float* __restrict__ bias, TOut* __restrict__ y,
                      int M, int K, int N, int kc) {
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;     // bf16 planes of x
  constexpr int MB = 8 * NT;                      // rows of x per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int ld = kc + KL_PAD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * MB;
  const int tiles = (N + 15) / 16;

  // x[m0 .. m0 + MB)[k0 .. k0 + kn) as P bf16 planes, zero past M and K
  auto stage_x = [&](int k0, int kn) {
    const int kr = (kn + KL_STEP - 1) / KL_STEP * KL_STEP;
    __syncthreads();
    for (int i = threadIdx.x; i < MB * kr; i += blockDim.x) {
      const int r = i / kr;
      const int c = i - r * kr;
      const int m = m0 + r;
      float v = (m < M && c < kn) ? rt::to_f(x[(size_t)m * K + k0 + c]) : 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const __nv_bfloat16 hb = __float2bfloat16(v);
        xs[(size_t)(p * MB + r) * ld + c] = hb;
        v -= __bfloat162float(hb);
      }
    }
    __syncthreads();
  };
  const bool one_chunk = kc >= K;
  if (one_chunk) stage_x(0, K);

  for (int base = blockIdx.x * KL_WARPS; base < tiles;
       base += gridDim.x * KL_WARPS) {
    const int ra = (base + warp) * 16 + g;        // this lane's rows ra, ra + 8
    const bool va = ra < N, vb = ra + 8 < N;
    const int8_t* wa_row = w + (size_t)(va ? ra : 0) * stride_n;
    const int8_t* wb_row = w + (size_t)(vb ? ra + 8 : 0) * stride_n;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    float tot[NT][4] = {};        // acc holds one step (promotes)

    for (int k0 = 0; k0 < K; k0 += kc) {
      const int kn = min(kc, K - k0);
      if (!one_chunk) stage_x(k0, kn);
      // A step is two chunks of 64 K values; in chunk u this lane's 16
      // start at kk + 64 u + 16 t, so each warp load covers 64 contiguous
      // bytes of 8 rows. The next step's table bytes (4 loads a lane) load
      // while this step's are multiplied.
      uint4 wv[2][2], wn[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        wv[u][0] = load_row16<VEC>(wa_row, k0 + 64 * u + 16 * t, K, va);
        wv[u][1] = load_row16<VEC>(wb_row, k0 + 64 * u + 16 * t, K, vb);
      }
      for (int kk = 0; kk < kn; kk += KL_STEP) {
        const bool more = kk + KL_STEP < kn;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int knext = k0 + kk + KL_STEP + 64 * u + 16 * t;
          wn[u][0] = load_row16<VEC>(wa_row, knext, K, va && more);
          wn[u][1] = load_row16<VEC>(wb_row, knext, K, vb && more);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kq = kk + 64 * u + 16 * t;
          const uint4 wva = wv[u][0], wvb = wv[u][1];
          const uint32_t ua[4] = {wva.x ^ 0x80808080u, wva.y ^ 0x80808080u,
                                  wva.z ^ 0x80808080u, wva.w ^ 0x80808080u};
          const uint32_t ub[4] = {wvb.x ^ 0x80808080u, wvb.y ^ 0x80808080u,
                                  wvb.z ^ 0x80808080u, wvb.w ^ 0x80808080u};
          uint32_t a[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // logical k {2t, 2t+1} <- bytes 0-1 of word j, {2t+8, 2t+9} <- 2-3
            a[j][0] = rt::bf16x2_of_levels(ua[j], 0x7440, 0x7441);
            a[j][1] = rt::bf16x2_of_levels(ub[j], 0x7440, 0x7441);
            a[j][2] = rt::bf16x2_of_levels(ua[j], 0x7442, 0x7443);
            a[j][3] = rt::bf16x2_of_levels(ub[j], 0x7442, 0x7443);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const uint4* src = reinterpret_cast<const uint4*>(
                  xs + (size_t)(p * MB + nt * 8 + g) * ld + kq);
              const uint4 lo = src[0], hi = src[1];
              const uint32_t xb[8] = {lo.x, lo.y, lo.z, lo.w,
                                      hi.x, hi.y, hi.z, hi.w};
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_bf16_16816(acc[nt], a[j][0], a[j][1], a[j][2], a[j][3],
                               xb[2 * j], xb[2 * j + 1]);
            }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          wv[u][0] = wn[u][0];
          wv[u][1] = wn[u][1];
        }
        if constexpr (rt::promotes<TIn, TOut>()) rt::promote(tot, acc);
      }
    }
    if constexpr (rt::promotes<TIn, TOut>()) rt::promote(acc, tot);
    // c0, c1: table row g, x rows 2t, 2t+1; c2, c3: table row g + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      if (r >= N) continue;
      const float d = delta[r];
      const float b = bias ? bias[r] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + nt * 8 + 2 * t + e;
          if (m < M) y[(size_t)m * N + r] = rt::from_f<TOut>(acc[nt][2 * h + e] * d + b);
        }
    }
  }
}

// --- k_lanes, row-major W with narrow N --------------------------------------

constexpr int KR_WARPS = 8;
constexpr int KR_SUB = 64;            // K values a warp step (a promoted run)
constexpr int KR_MAX_CLUSTER = 8;     // K slices: a portable cluster's blocks

// Shared memory of the row-major kernel: the staged W chunk (int8 levels,
// n-major: NT * 8 rows of kch + pad bytes, the row stride 32 past a
// multiple of 128 so a quad's 8-byte reads of four rows hit distinct
// banks), then each warp's x stages (XQ 16-byte slots a lane a stage,
// lane-major so a warp's slots are contiguous); the cross-warp sum, then
// the block's sums of its rows, reuse it from 0 at the end.
template <typename TIn>
struct KrSmem {
  static constexpr int XQ = sizeof(TIn) == 4 ? 8 : 4;   // uint4 a lane
  static constexpr int STAGES = sizeof(TIn) == 4 ? 2 : 4;
  static constexpr int WARP_X = STAGES * XQ * 32 * 16;  // bytes a warp
  static __host__ __device__ int w_ld(int kch) {
    return kch + ((32 - kch) % 128 + 128) % 128;
  }
  static __host__ __device__ int w_bytes(int nt, int kch) {
    return nt * 8 * w_ld(kch);
  }
  static __host__ __device__ int bytes(int nt, int kch, int rw) {
    const int a = w_bytes(nt, kch) + KR_WARPS * WARP_X;
    const int red = (KR_WARPS + rw) * 16 * nt * 8 * 4;
    return a > red ? a : red;
  }
};

// y = (x . W) * delta + bias for a row-major (K, N) W of N <= 64 columns
// (the MoE routers and the MLP heads), on the tensor cores.
//
// A block of 8 warps is rw row warps x kw = 8 / rw K warps: row warp r
// owns 16 rows of x (one m16 tile: NT n8 tiles of W span every column),
// K warp j the 64-wide steps j, j + kw, ... of the block's slice of K
// (blockIdx.y of ksplit slices). Each step a lane takes 16 values of its
// two rows (g, g + 8): x[k + 8 t .. + 8) and x[k + 32 + 8 t .. + 8), so a
// quad of lanes covers 64 contiguous K of a row. Where x's rows are
// 16-byte aligned (VEC) they stream through the lane's own slots of its
// warp's cp.async stages, STAGES - 1 steps ahead (a lane reads back only
// what it copied, so no barrier orders them); else they are loaded one
// value at a time a step ahead. The 16 values' order is the A fragments'
// K order (pair w of a lane's 8 words is k16 step w / 2, slot 2 t or
// 2 t + 8), and W is read through the same permutation, so the sum is
// unchanged; fp32 x enters as three bf16 planes. A step's four mma are
// summed into an fp32 total on the CUDA cores (rt::promote). W is staged
// in the block's shared memory as int8 levels, n-major, in chunks of kch
// K (once a block where it fits; 16-byte loads where W's rows are
// packed), after the first steps of x are in flight, and widened exactly
// to bf16 fragments as it is read (two 8-byte reads of row n a step).
// (Each warp reading its own W from L2 instead, with no barrier, measured
// slower at every shape but one.) At the end the K warps' totals are
// summed in shared memory in warp order and written as y; with K split
// across the blocks of a cluster (grid y, the cluster's shape), each
// block's sums are read by the cluster's blocks through distributed shared
// memory and added in rank order, each block writing its share of y (no
// atomics, no second kernel: every run gives the same bits).
template <typename TIn, typename TOut, int NT, bool VEC>
__global__ void __launch_bounds__(KR_WARPS * 32)
qmatmul_kernel_klanes_rows(const TIn* __restrict__ x,
                           const int8_t* __restrict__ w, long long sk,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias,
                           TOut* __restrict__ y, int M, int K, int N, int rw,
                           int kch) {
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;       // bf16 planes of x
  constexpr int EL = 16 / sizeof(TIn);              // x values a 16-byte slot
  constexpr int XW = 16 * sizeof(TIn) / 4;          // words of a row a step
  using SM = KrSmem<TIn>;
  constexpr int XQ = SM::XQ, XS = SM::STAGES;
  constexpr int NP = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* wt = reinterpret_cast<int8_t*>(smem);
  const int wld = SM::w_ld(kch);                    // bytes a staged W row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kw = KR_WARPS / rw;
  const int rwi = warp % rw, kwi = warp / rw;
  const int row0 = (blockIdx.x * rw + rwi) * 16;
  uint4* xs = reinterpret_cast<uint4*>(smem + SM::w_bytes(NT, kch)
                                       + warp * SM::WARP_X);
  // the block's slice of K, in whole steps
  const int nsub = (K + KR_SUB - 1) / KR_SUB;
  const int spz = (nsub + gridDim.y - 1) / gridDim.y;
  const int kz0 = blockIdx.y * spz * KR_SUB;
  const int kz1 = min((blockIdx.y + 1) * spz, nsub) * KR_SUB;

  float tot[NT][4], run[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[nt][i] = run[nt][i] = 0.f;

  // slot q of a lane: row g (q < XQ / 2) or g + 8, 16 bytes at K offset
  // 8 t + 32 (q / (XQ / 4) odd) + EL (q % (XQ / 4)) of the step
  auto slot_k = [&](int q) {
    const int qq = q % (XQ / 2);
    return 8 * t + 32 * (qq / (XQ / 4)) + EL * (qq % (XQ / 4));
  };
  auto issue = [&](int k, int stage) {        // x[.., k .. k + 64) to stage
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      const int r = row0 + g + 8 * (q / (XQ / 2));
      const int kk = k + slot_k(q);
      const bool ok = r < M && kk < K;
      const TIn* src = x + (ok ? (size_t)r * K + kk : 0);
      // L2 fetches 256 bytes: the row's next step is on its way too
      // (without the hint, or with 128, or with an explicit prefetch
      // further ahead, mixtral's 32768-row router measured slower)
      asm volatile(
          "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
              smem_u32(xs + (stage * XQ + q) * 32 + lane)),
          "l"(src), "r"(ok ? 16 : 0)
          : "memory");
    }
  };
  // a lane's 16 values of row g + 8 h as raw 32-bit words, one at a time
  auto direct = [&](int k, int h, uint32_t (&r)[XW]) {
    const int m = row0 + g + 8 * h;
#pragma unroll
    for (int q = 0; q < XQ / 2; ++q) {
      __align__(16) TIn e[EL];
      const int kk = k + slot_k(q);
#pragma unroll
      for (int i = 0; i < EL; ++i)
        e[i] = m < M && kk + i < K ? x[(size_t)m * K + kk + i]
                                   : rt::from_f<TIn>(0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[4 * q + i] = reinterpret_cast<const uint32_t*>(e)[i];
    }
  };

  for (int kc0 = kz0; kc0 < kz1; kc0 += kch) {
    const int kc1 = min(kc0 + kch, kz1);
    const int nsc = (kc1 - kc0) / KR_SUB;        // steps in the chunk
    const int mine = kwi < nsc ? (nsc - kwi + kw - 1) / kw : 0;
    auto step_k = [&](int i) { return kc0 + (kwi + i * kw) * KR_SUB; };
    uint32_t ra[XW], rb[XW];
    if constexpr (VEC) {                         // x in flight first
#pragma unroll
      for (int i = 0; i < XS - 1; ++i) {
        if (i < mine) issue(step_k(i), i);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
    } else if (mine > 0) {                       // a step ahead in registers
      direct(step_k(0), 0, ra);
      direct(step_k(0), 1, rb);
    }
    {
      __syncthreads();                   // the last chunk's W is read
      // W[kc0 .. kc1) n-major, zero past K (the rows past N are never
      // written: their columns are not stored); 16 bytes a load where the
      // chunk's rows are packed and aligned
      const int nk = kc1 - kc0;
      const int8_t* src = w + (size_t)kc0 * sk;
      if (sk == N && (uintptr_t)src % 16 == 0) {
        const int have = max(0, min(nk, K - kc0)) * N;   // bytes inside K
        for (int f0 = 16 * tid; f0 < nk * N; f0 += 16 * KR_WARPS * 32) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (f0 + 16 <= have) {
            v = __ldg(reinterpret_cast<const uint4*>(src + f0));
          } else {
            uint32_t wd[4] = {0u, 0u, 0u, 0u};
            for (int i = 0; i < 16 && f0 + i < have; ++i)
              wd[i >> 2] |= (uint32_t)(uint8_t)src[f0 + i] << (8 * (i & 3));
            v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
          }
          const int8_t* b = reinterpret_cast<const int8_t*>(&v);
          int kk = f0 / N, n = f0 - kk * N;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            if (kk < nk) wt[n * wld + kk] = b[i];
            if (++n == N) {
              n = 0;
              ++kk;
            }
          }
        }
      } else {
        for (int i = tid; i < nk * N; i += KR_WARPS * 32) {
          const int kk = i / N, n = i - kk * N;
          const int k = kc0 + kk;
          wt[n * wld + kk] = k < K ? w[(size_t)k * sk + n] : (int8_t)0;
        }
      }
      __syncthreads();
    }
    for (int i = 0; i < mine; ++i) {
      const int kk = step_k(i) - kc0;            // the step's offset
      uint32_t na[XW], nb[XW];
      if constexpr (!VEC) {
        if (i + 1 < mine) {
          direct(step_k(i + 1), 0, na);
          direct(step_k(i + 1), 1, nb);
        }
      } else {
        if (i + XS - 1 < mine) issue(step_k(i + XS - 1), (i + XS - 1) % XS);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group %0;\n" ::"n"(XS - 1) : "memory");
        const uint4* sl = xs + (i % XS) * XQ * 32 + lane;
#pragma unroll
        for (int q = 0; q < XQ / 2; ++q) {
          const uint4 va = sl[q * 32], vb = sl[(q + XQ / 2) * 32];
          ra[4 * q] = va.x; ra[4 * q + 1] = va.y;
          ra[4 * q + 2] = va.z; ra[4 * q + 3] = va.w;
          rb[4 * q] = vb.x; rb[4 * q + 1] = vb.y;
          rb[4 * q + 2] = vb.z; rb[4 * q + 3] = vb.w;
        }
      }
      // the A fragments of the four k16 steps, per plane
      uint32_t a[4][P][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t p0[P], p1[P], p2[P], p3[P];
        raw_planes<TIn, P>(ra, 4 * s, p0);       // row g, slot 2 t
        raw_planes<TIn, P>(rb, 4 * s, p1);       // row g + 8, slot 2 t
        raw_planes<TIn, P>(ra, 4 * s + 2, p2);   // row g, slot 2 t + 8
        raw_planes<TIn, P>(rb, 4 * s + 2, p3);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          a[s][p][0] = p0[p];
          a[s][p][1] = p1[p];
          a[s][p][2] = p2[p];
          a[s][p][3] = p3[p];
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // W row n = 8 nt + g at the lane's 16 K, widened exactly to bf16
        const int8_t* wr = wt + (nt * 8 + g) * wld + kk + 8 * t;
        const uint2 w0 = *reinterpret_cast<const uint2*>(wr);
        const uint2 w1 = *reinterpret_cast<const uint2*>(wr + 32);
        const uint32_t u[4] = {w0.x, w0.y, w1.x, w1.y};
        uint32_t wv[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t uj = u[j] ^ 0x80808080u;
          wv[2 * j] = rt::bf16x2_of_levels(uj, 0x7440, 0x7441);
          wv[2 * j + 1] = rt::bf16x2_of_levels(uj, 0x7442, 0x7443);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int p = 0; p < P; ++p)
            mma_bf16_16816(run[nt], a[s][p][0], a[s][p][1], a[s][p][2],
                           a[s][p][3], wv[2 * s], wv[2 * s + 1]);
      }
      rt::promote(tot, run);
      if constexpr (!VEC) {
        if (i + 1 < mine) {
#pragma unroll
          for (int j = 0; j < XW; ++j) {
            ra[j] = na[j];
            rb[j] = nb[j];
          }
        }
      }
    }
    if constexpr (VEC) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }

  // the K warps' totals, summed in warp order: c0, c1 row g, columns 2 t,
  // 2 t + 1 of each n8 tile; c2, c3 row g + 8
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [kw][rw][16][NP]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i >> 1), c = nt * 8 + 2 * t + (i & 1);
      red[((kwi * rw + rwi) * 16 + r) * NP + c] = tot[nt][i];
    }
  __syncthreads();
  const int rows = rw * 16;
  // the block's sums of its rows; with a K split across the blocks of a
  // cluster, summed over the cluster's blocks in rank order through
  // distributed shared memory (no atomics: every run the same bits), each
  // block writing its share of the outputs
  float* fin = red + KR_WARPS * 16 * NP;          // [rows][N]
  for (int i = tid; i < rows * N; i += KR_WARPS * 32) {
    const int rr = i / N, n = i - rr * N;
    float v = 0.f;
    for (int j = 0; j < kw; ++j) v += red[(j * rows + rr) * NP + n];
    const int m = blockIdx.x * rows + rr;
    if (gridDim.y > 1)
      fin[i] = v;
    else if (m < M)
      y[(size_t)m * N + n] = rt::from_f<TOut>(v * delta[n] + (bias ? bias[n] : 0.f));
  }
  if (gridDim.y == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                                 // every block's sums
  const int ks = gridDim.y, z = blockIdx.y;
  const int per = (rows * N + ks - 1) / ks;
  for (int i = z * per + tid; i < min((z + 1) * per, rows * N);
       i += KR_WARPS * 32) {
    const int rr = i / N, n = i - rr * N;
    const int m = blockIdx.x * rows + rr;
    if (m >= M) continue;
    float v = 0.f;
    for (int r = 0; r < ks; ++r) v += cluster.map_shared_rank(fin, r)[i];
    y[(size_t)m * N + n] = rt::from_f<TOut>(v * delta[n] + (bias ? bias[n] : 0.f));
  }
  cluster.sync();                                 // reads done: may exit
}

// --- launch -----------------------------------------------------------------

enum Layout { N_LANES = 0, K_LANES = 1 };

template <typename TIn, typename TOut, int NT, bool VEC>
int launch_klanes(const void* x, const void* w, long long sn, const void* delta,
                  const void* bias, void* y, int M, int K, int N, int kc,
                  int smem, cudaStream_t st) {
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;
  if (kc <= 0 || kc % KL_STEP ||
      smem < P * 8 * NT * (kc + KL_PAD) * (int)sizeof(__nv_bfloat16))
    return (int)cudaErrorInvalidValue;
  auto kern = qmatmul_kernel_klanes<TIn, TOut, NT, VEC>;
  // per instantiation: the dynamic shared memory set, and the blocks an SM
  // holds at that size (the persistent grid's width)
  static int smem_set = 48 * 1024, occ_smem = -1, per_sm = 1;
  cudaError_t e;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  if (smem != occ_smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      KL_WARPS * 32, smem);
    if (e != cudaSuccess) return (int)e;
    per_sm = max(per_sm, 1);
    occ_smem = smem;
  }
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)e;
  // as many rounds of KL_WARPS tiles per block as the resident blocks need,
  // then the fewest blocks that carry that many rounds, so rounds come out
  // even across the SMs
  const int gy = (M + 8 * NT - 1) / (8 * NT);
  const int tiles = (N + 15) / 16;
  const int resident = max(1, sms * per_sm / gy);
  const int rounds = (tiles + resident * KL_WARPS - 1) / (resident * KL_WARPS);
  const int gx = (tiles + rounds * KL_WARPS - 1) / (rounds * KL_WARPS);
  kern<<<dim3(gx, gy), KL_WARPS * 32, smem, st>>>(
      (const TIn*)x, (const int8_t*)w, sn, (const float*)delta,
      (const float*)bias, (TOut*)y, M, K, N, kc);
  return 0;
}

// k_lanes, row-major W of N <= 64 columns: rw row warps a block (1, 2, 4
// or 8), kch K values of W staged a chunk (a multiple of 64), ksplit slices
// of K across the blocks of a cluster (1 to 8; grid y), summed through
// distributed shared memory.
template <typename TIn, typename TOut>
int launch_klanes_rows(const void* x, const void* w, long long sk,
                       long long sn, const void* delta, const void* bias,
                       void* y, int M, int K, int N, int rw, int kch,
                       int ksplit, int smem, cudaStream_t st) {
  const int nt = N <= 8 ? 1 : N <= 16 ? 2 : N <= 32 ? 4 : 8;
  const int nsub = (K + KR_SUB - 1) / KR_SUB;
  if (sn != 1 || N < 1 || N > 64 || (rw != 1 && rw != 2 && rw != 4 &&
      rw != 8) || kch <= 0 || kch % KR_SUB || ksplit < 1 ||
      ksplit > KR_MAX_CLUSTER || ksplit > nsub ||
      smem < KrSmem<TIn>::bytes(nt, kch, rw))
    return (int)cudaErrorInvalidValue;
  const int spz = (nsub + ksplit - 1) / ksplit;
  if ((long long)(ksplit - 1) * spz >= nsub)       // an empty slice
    return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)x % 16 == 0 &&
                   ((long long)K * (long long)sizeof(TIn)) % 16 == 0;
  void (*kern)(const TIn*, const int8_t*, long long, const float*,
               const float*, TOut*, int, int, int, int, int) = nullptr;
#define RT_KR(NT_)                                                         \
  if (nt == NT_)                                                           \
    kern = vec ? qmatmul_kernel_klanes_rows<TIn, TOut, NT_, true>          \
               : qmatmul_kernel_klanes_rows<TIn, TOut, NT_, false>;
  RT_KR(1) RT_KR(2) RT_KR(4) RT_KR(8)
#undef RT_KR
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + 16 * rw - 1) / (16 * rw), ksplit);
  cfg.blockDim = dim3(KR_WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ksplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, (const TIn*)x, (const int8_t*)w,
                                 sk, (const float*)delta, (const float*)bias,
                                 (TOut*)y, M, K, N, rw, kch);
}

// n_lanes: variant 0 decode (p0 = warps a block splitting K, NT 8-row
// tiles of x from M), 1 prefill (p0 unused); p1 = K chunks (decode, 64 each) or K steps
// (prefill, 64 each) a slice; ksplit slices across blocks, summed by the
// second kernel into y where ksplit > 1 (part: ksplit x M x N fp32).
template <typename TIn, typename TOut>
int launch_nlanes(int variant, const void* x, const void* w, long long sk,
                  long long sn, const void* delta, const void* bias, void* y,
                  float* part, int M, int K, int N, int kw, int cps,
                  int ksplit, int smem, cudaStream_t st) {
  constexpr int P = sizeof(TIn) == 4 ? 3 : 1;
  const int nch = (K + 63) / 64;                  // 64-row chunks / steps
  const bool vec = sn == 1 && sk % 16 == 0 && (uintptr_t)w % 16 == 0;
  if (cps < 1 || ksplit < 1 || (long long)cps * ksplit < nch ||
      (long long)(ksplit - 1) * cps >= nch || (ksplit > 1 && !part))
    return (int)cudaErrorInvalidValue;
  void (*kern)(const TIn*, const int8_t*, long long, long long, const float*,
               const float*, TOut*, float*, int, int, int, int);
  dim3 grid, block;
  int need;
  if (variant == 0) {
    if ((kw != 1 && kw != 2 && kw != 4) || M > 16)
      return (int)cudaErrorInvalidValue;
    need = kw * ND_WARP;
    if (M <= 8)
      kern = vec ? qmatmul_kernel_nlanes_decode<TIn, TOut, 1, true>
                 : qmatmul_kernel_nlanes_decode<TIn, TOut, 1, false>;
    else
      kern = vec ? qmatmul_kernel_nlanes_decode<TIn, TOut, 2, true>
                 : qmatmul_kernel_nlanes_decode<TIn, TOut, 2, false>;
    grid = dim3((N + ND_COLS - 1) / ND_COLS, ksplit);
    block = dim3(32 * kw);
  } else if (variant == 1) {
    need = NpSmem<TIn>::BYTES;
    kern = vec ? qmatmul_kernel_nlanes_prefill<TIn, TOut, true>
               : qmatmul_kernel_nlanes_prefill<TIn, TOut, false>;
    grid = dim3((N + NP_BN - 1) / NP_BN, (M + NP_BM - 1) / NP_BM, ksplit);
    block = dim3(256);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (smem < need) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {   // once a size per kernel is enough, but cheap
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, block, smem, st>>>((const TIn*)x, (const int8_t*)w, sk, sn,
                                  (const float*)delta, (const float*)bias,
                                  (TOut*)y, part, M, K, N, cps);
  if (ksplit > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)M * N;
    const int blocks = (int)min((total + 255) / 256, 4096LL);
    qmatmul_kernel_nlanes_sum<TOut><<<blocks, 256, 0, st>>>(
        part, (const float*)delta, (const float*)bias, (TOut*)y, M, N, ksplit);
  }
  return 0;
}

template <typename TIn, typename TOut>
int launch(int layout, int variant, const void* x, const void* w, long long sk,
           long long sn, const void* delta, const void* bias, void* y,
           float* part, int M, int K, int N, int p0, int p1, int ksplit,
           int smem, cudaStream_t st) {
  if (layout == N_LANES)
    return launch_nlanes<TIn, TOut>(variant, x, w, sk, sn, delta, bias, y,
                                    part, M, K, N, p0, p1, ksplit, smem, st);
  if (layout != K_LANES) return (int)cudaErrorInvalidValue;
  if (sk == 1) {              // K-contiguous W: p0 = NT, p1 = kc
    const bool vec = ((uintptr_t)w % 16 == 0) && (sn % 16 == 0);
#define RT_KL(NT_)                                                            \
  if (p0 == NT_)                                                              \
    return vec ? launch_klanes<TIn, TOut, NT_, true>(x, w, sn, delta, bias, y, \
                                                     M, K, N, p1, smem, st)   \
               : launch_klanes<TIn, TOut, NT_, false>(x, w, sn, delta, bias,  \
                                                      y, M, K, N, p1, smem, st);
    RT_KL(1) RT_KL(2) RT_KL(4)
#undef RT_KL
    return (int)cudaErrorInvalidValue;
  }
  // row-major W, N <= 64: p0 = row warps a block, p1 = K staged a chunk
  return launch_klanes_rows<TIn, TOut>(x, w, sk, sn, delta, bias, y, M, K,
                                       N, p0, p1, ksplit, smem, st);
}

}  // namespace

// x_dtype / y_dtype: 0 fp32, 1 bf16. bias may be null. Strides are in
// elements. layout: 0 n_lanes, whose variant (0 decode, M <= 16; 1 prefill)
// and tiling are the wrapper's plan: p0 = warps a block (decode), p1 = 64-K
// chunks a slice, ksplit slices across blocks, part = fp32 scratch of
// ksplit x M x N (null when ksplit is 1), smem = the dynamic shared memory
// bytes. layout 1: k_lanes, whose kernel follows W's strides: stride_k ==
// 1 takes the tensor-core kernel (p0 = 8-row tiles of x per block, 1 / 2 /
// 4; p1 = K values staged per chunk, a multiple of 64; smem = its dynamic
// shared memory bytes; variant, ksplit and part unused), stride_n == 1
// with N <= 64 the row-major one (p0 = row warps a block, 1 / 2 / 4 / 8;
// p1 = K values of W staged a chunk, a multiple of 64; ksplit slices of K
// across the blocks of a cluster, 1 to 8; part unused; smem its dynamic
// shared memory bytes). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int qmatmul_launch(const void* x, const void* w, long long stride_k,
                              long long stride_n, const void* delta,
                              const void* bias, void* y, void* part, int M,
                              int K, int N, int x_dtype, int y_dtype,
                              int layout, int variant, int p0, int p1,
                              int ksplit, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* pt = (float*)part;
  int rc;
  if (x_dtype == 0 && y_dtype == 0)
    rc = launch<float, float>(layout, variant, x, w, stride_k, stride_n, delta, bias, y, pt, M, K, N, p0, p1, ksplit, smem, st);
  else if (x_dtype == 0 && y_dtype == 1)
    rc = launch<float, __nv_bfloat16>(layout, variant, x, w, stride_k, stride_n, delta, bias, y, pt, M, K, N, p0, p1, ksplit, smem, st);
  else if (x_dtype == 1 && y_dtype == 0)
    rc = launch<__nv_bfloat16, float>(layout, variant, x, w, stride_k, stride_n, delta, bias, y, pt, M, K, N, p0, p1, ksplit, smem, st);
  else if (x_dtype == 1 && y_dtype == 1)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(layout, variant, x, w, stride_k, stride_n, delta, bias, y, pt, M, K, N, p0, p1, ksplit, smem, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
