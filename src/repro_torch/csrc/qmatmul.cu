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
// a grid of a few blocks each walking all of K leaves the card idle.
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
//   Row-major W with N <= 64 (the MLP heads). Lane = K row: a warp reads 32
//   consecutive rows of W, 32 * N contiguous bytes. One block per row of x
//   and group of 16 columns, its 8 warps splitting K; each lane keeps a
//   partial sum per column, reduced across the warp with shuffles and
//   across the warps in shared memory.
//
// n_lanes (any other W: a wide row-major matrix, the q form). One thread
//   per output column, 32 columns per block; the four warps of a block
//   split each staged K chunk and sum their partials in shared memory.
//   Neighbouring lanes read neighbouring bytes of a row.
#include "common.cuh"

namespace {

// --- n_lanes ----------------------------------------------------------------

constexpr int MT = 8;       // rows of x per block
constexpr int KT = 256;     // K values per staged chunk
constexpr int COLS = 32;    // output columns per block
constexpr int WARPS = 4;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(COLS * WARPS)
qmatmul_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ w,
               long long stride_k, long long stride_n,
               const float* __restrict__ delta, const float* __restrict__ bias,
               TOut* __restrict__ y, int M, int K, int N) {
  __shared__ float xs[MT][KT];
  __shared__ float part[WARPS][MT][COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * COLS + lane;
  const int m0 = blockIdx.y * MT;

  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;
  const int8_t* wcol = w + (size_t)(n < N ? n : 0) * stride_n;

  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < MT * KT; i += blockDim.x) {
      const int r = i / KT;
      const int c = i - r * KT;
      const int m = m0 + r;
      const int k = k0 + c;
      xs[r][c] = (m < M && k < K) ? rt::to_f(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int kend = min(KT, K - k0);
      for (int kk = warp; kk < kend; kk += WARPS) {
        const float fl = (float)wcol[(size_t)(k0 + kk) * stride_k];
#pragma unroll
        for (int r = 0; r < MT; ++r) acc[r] = fmaf(xs[r][kk], fl, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  if (warp == 0 && n < N) {
    const float d = delta[n];
    const float b = bias ? bias[n] : 0.f;
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int m = m0 + r;
      if (m >= M) break;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) s += part[q][r][lane];
      y[(size_t)m * N + n] = rt::from_f<TOut>(s * d + b);
    }
  }
}

// --- k_lanes ----------------------------------------------------------------

constexpr int KL_WARPS = 8;
constexpr int KL_STEP = 128;                      // K per step: 2 chunks of 64
constexpr int KL_PAD = 8;                         // bf16 pad per staged row

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
      }
    }
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

constexpr int KN_THREADS = 256;
constexpr int KN_COLS = 16;                       // output columns per block

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(KN_THREADS)
qmatmul_kernel_klanes_narrow(const TIn* __restrict__ x,
                             const int8_t* __restrict__ w, long long stride_k,
                             const float* __restrict__ delta,
                             const float* __restrict__ bias,
                             TOut* __restrict__ y, int K, int N) {
  __shared__ float part[KN_THREADS / 32][KN_COLS];
  const int m = blockIdx.x;                       // one row of x per block
  const int n0 = blockIdx.y * KN_COLS;
  const int nn = min(KN_COLS, N - n0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[KN_COLS];
#pragma unroll
  for (int n = 0; n < KN_COLS; ++n) acc[n] = 0.f;
  const TIn* xr = x + (size_t)m * K;
  for (int k = threadIdx.x; k < K; k += KN_THREADS) {   // lane = K row
    const float xv = rt::to_f(xr[k]);
    const int8_t* wk = w + (size_t)k * stride_k + n0;
#pragma unroll
    for (int n = 0; n < KN_COLS; ++n)
      if (n < nn) acc[n] = fmaf(xv, (float)wk[n], acc[n]);
  }
#pragma unroll
  for (int n = 0; n < KN_COLS; ++n) {
    if (n < nn) {
      const float v = rt::warp_sum(acc[n]);
      if (lane == 0) part[warp][n] = v;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < nn) {
    const int n = n0 + threadIdx.x;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < KN_THREADS / 32; ++q) s += part[q][threadIdx.x];
    y[(size_t)m * N + n] = rt::from_f<TOut>(s * delta[n] + (bias ? bias[n] : 0.f));
  }
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

template <typename TIn, typename TOut>
int launch(int layout, const void* x, const void* w, long long sk, long long sn,
           const void* delta, const void* bias, void* y, int M, int K, int N,
           int p0, int p1, int smem, cudaStream_t st) {
  if (layout == N_LANES) {
    dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
    qmatmul_kernel<TIn, TOut><<<grid, COLS * WARPS, 0, st>>>(
        (const TIn*)x, (const int8_t*)w, sk, sn, (const float*)delta,
        (const float*)bias, (TOut*)y, M, K, N);
    return 0;
  }
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
  if (sn != 1 || N > 4 * KN_COLS) return (int)cudaErrorInvalidValue;
  dim3 grid(M, (N + KN_COLS - 1) / KN_COLS);    // row-major W, narrow N
  qmatmul_kernel_klanes_narrow<TIn, TOut><<<grid, KN_THREADS, 0, st>>>(
      (const TIn*)x, (const int8_t*)w, sk, (const float*)delta,
      (const float*)bias, (TOut*)y, K, N);
  return 0;
}

}  // namespace

// x_dtype / y_dtype: 0 fp32, 1 bf16. bias may be null. Strides are in
// elements. layout: 0 n_lanes; 1 k_lanes, whose kernel follows W's
// strides: stride_k == 1 takes the tensor-core kernel (p0 = 8-row tiles of
// x per block, 1 / 2 / 4; p1 = K values staged per chunk, a multiple of
// 64; smem = its dynamic shared memory bytes, as the wrapper's plan
// computed them), stride_n == 1 with N <= 64 the narrow one (p0, p1, smem
// unused). Returns the CUDA error code of the launch (0 on success).
extern "C" int qmatmul_launch(const void* x, const void* w, long long stride_k,
                              long long stride_n, const void* delta,
                              const void* bias, void* y, int M, int K, int N,
                              int x_dtype, int y_dtype, int layout, int p0,
                              int p1, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (x_dtype == 0 && y_dtype == 0)
    rc = launch<float, float>(layout, x, w, stride_k, stride_n, delta, bias, y, M, K, N, p0, p1, smem, st);
  else if (x_dtype == 0 && y_dtype == 1)
    rc = launch<float, __nv_bfloat16>(layout, x, w, stride_k, stride_n, delta, bias, y, M, K, N, p0, p1, smem, st);
  else if (x_dtype == 1 && y_dtype == 0)
    rc = launch<__nv_bfloat16, float>(layout, x, w, stride_k, stride_n, delta, bias, y, M, K, N, p0, p1, smem, st);
  else if (x_dtype == 1 && y_dtype == 1)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(layout, x, w, stride_k, stride_n, delta, bias, y, M, K, N, p0, p1, smem, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
