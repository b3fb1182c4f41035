// qmatmul: y = (x . W) * delta + bias, W as int8 levels with explicit strides.
//
// Replaces the TPU kernel src/repro/kernels/qmatmul/kernel.py::qmatmul_pallas
// (body _kernel).
//
// Layout: x (M, K) fp32 or bf16, row-major. W is a (K, N) int8 matrix given
// by a pointer and two element strides (stride_k, stride_n), so the tied
// readout passes the transposed view q.T of its (V, D) embedding table
// (stride_k = 1, stride_n = D) without copying the table each tick. delta
// and the optional bias are (N,) fp32; y (M, N) fp32 or bf16.
//
// What bounds it on the H100: the tied readout at decode (M = slots) reads
// the whole 151936 x 1536 int8 table (233 MB) for 2 * M flops per byte: it
// is bound by bytes. At prefill M the product is done on the CUDA cores in
// fp32 and is bound by operations.
//
// What the design does about it: one thread per output column, 32 columns
// per block; the four warps of a block split each staged K chunk and sum
// their partials in shared memory, so a block reads each weight once and
// there are N / 32 blocks per tile of MT rows. x is staged in shared memory
// per chunk and zero past K and M. For a row-major W (stride_n = 1) a warp
// reads 32 neighbouring bytes of a row; for the transposed readout view the
// 32 lanes read 32 different rows of the table, which is uncoalesced: each
// lane walks its own row through L1, and the table is still read about
// once from device memory, but with 32 transactions per warp load. A layout
// that coalesces the transposed case (lanes along K, a reduction across
// lanes) is later work.
#include "common.cuh"

namespace {

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

template <typename TIn, typename TOut>
void launch(const void* x, const void* w, long long sk, long long sn,
            const void* delta, const void* bias, void* y, int M, int K, int N,
            cudaStream_t st) {
  dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  qmatmul_kernel<TIn, TOut><<<grid, COLS * WARPS, 0, st>>>(
      (const TIn*)x, (const int8_t*)w, sk, sn, (const float*)delta,
      (const float*)bias, (TOut*)y, M, K, N);
}

}  // namespace

// x_dtype / y_dtype: 0 fp32, 1 bf16. bias may be null. Strides are in
// elements. Returns the CUDA error code of the launch (0 on success).
extern "C" int qmatmul_launch(const void* x, const void* w, long long stride_k,
                              long long stride_n, const void* delta,
                              const void* bias, void* y, int M, int K, int N,
                              int x_dtype, int y_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0 && y_dtype == 0)
    launch<float, float>(x, w, stride_k, stride_n, delta, bias, y, M, K, N, st);
  else if (x_dtype == 0 && y_dtype == 1)
    launch<float, __nv_bfloat16>(x, w, stride_k, stride_n, delta, bias, y, M, K, N, st);
  else if (x_dtype == 1 && y_dtype == 0)
    launch<__nv_bfloat16, float>(x, w, stride_k, stride_n, delta, bias, y, M, K, N, st);
  else if (x_dtype == 1 && y_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, stride_k, stride_n, delta, bias, y, M, K, N, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
