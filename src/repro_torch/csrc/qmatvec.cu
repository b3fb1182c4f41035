// qmatvec: y = (x . unpack3(W)) * delta + bias, W in 3-bit containers.
//
// Replaces the TPU kernel src/repro/kernels/qmatvec/kernel.py::qmatvec_pallas
// (body _kernel, unpack _unpack_tile).
//
// Layout: x (M, K) fp32 or bf16, row-major. W (KP, N) int32, row-major, with
// KP = ceil(K / 10): word j of column n holds the levels of k = 10j..10j+9 as
// ten two's-complement 3-bit fields (field f at bits 3f..3f+2). delta and the
// optional bias are (N,) fp32. y (M, N) fp32 or bf16.
//
// What bounds it on the H100: at decode (M = slots <= 16) each weight word
// is used by M rows only, about 2 * 10 * M flops per 4 bytes, far below the
// card's ~300 flops per byte: the kernel is bound by the bytes of W it
// streams (0.4 B per weight, 5x fewer than bf16). At prefill (M = slots x
// bucket) it does the whole product on the CUDA cores in fp32 and is bound
// by operations; tensor cores (wgmma on an unpacked bf16 tile) are later
// work.
//
// What the design does about it: one thread per output column, 32 columns
// per block, so the 32 lanes of a warp read 32 neighbouring words of a row
// of W (one 128-byte transaction). The four warps of a block split the K
// words of a chunk between them and add their partial sums through shared
// memory at the end, so a block streams each word once and the grid has
// N / 32 blocks per M tile. The block stages its (MT x 10 KT) slice of x in
// shared memory, zero past K and past M, so no read of x passes K even
// where the last word is padded; unpacking is a shift, a mask and a sign
// extension in registers, and each field feeds MT fp32 FMAs. The epilogue
// applies delta and bias in fp32 and makes one cast, as the reference does.
#include "common.cuh"

namespace {

constexpr int MT = 8;       // rows of x per block
constexpr int KT = 32;      // container words per staged chunk
constexpr int COLS = 32;    // output columns per block (one per lane)
constexpr int WARPS = 4;    // warps per block, splitting the K words

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(COLS * WARPS)
qmatvec_kernel(const TIn* __restrict__ x, const int32_t* __restrict__ w,
               const float* __restrict__ delta, const float* __restrict__ bias,
               TOut* __restrict__ y, int M, int K, int KP, int N) {
  __shared__ float xs[MT][KT * 10];
  __shared__ float part[WARPS][MT][COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * COLS + lane;
  const int m0 = blockIdx.y * MT;

  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < KP; j0 += KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < MT * KT * 10; i += blockDim.x) {
      const int r = i / (KT * 10);
      const int c = i - r * (KT * 10);
      const int m = m0 + r;
      const int k = j0 * 10 + c;
      xs[r][c] = (m < M && k < K) ? rt::to_f(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int jend = min(KT, KP - j0);
      for (int jj = warp; jj < jend; jj += WARPS) {
        const int word = w[(size_t)(j0 + jj) * N + n];
#pragma unroll
        for (int f = 0; f < 10; ++f) {
          int lv = (word >> (3 * f)) & 7;
          lv -= (lv & 4) << 1;                       // sign-extend 3-bit
          const float fl = (float)lv;
#pragma unroll
          for (int r = 0; r < MT; ++r)
            acc[r] = fmaf(xs[r][jj * 10 + f], fl, acc[r]);
        }
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
void launch(const void* x, const void* w, const void* delta, const void* bias,
            void* y, int M, int K, int KP, int N, cudaStream_t st) {
  dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  qmatvec_kernel<TIn, TOut><<<grid, COLS * WARPS, 0, st>>>(
      (const TIn*)x, (const int32_t*)w, (const float*)delta,
      (const float*)bias, (TOut*)y, M, K, KP, N);
}

}  // namespace

// x_dtype / y_dtype: 0 fp32, 1 bf16. bias may be null. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int qmatvec_launch(const void* x, const void* w, const void* delta,
                              const void* bias, void* y, int M, int K, int KP,
                              int N, int x_dtype, int y_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0 && y_dtype == 0)
    launch<float, float>(x, w, delta, bias, y, M, K, KP, N, st);
  else if (x_dtype == 0 && y_dtype == 1)
    launch<float, __nv_bfloat16>(x, w, delta, bias, y, M, K, KP, N, st);
  else if (x_dtype == 1 && y_dtype == 0)
    launch<__nv_bfloat16, float>(x, w, delta, bias, y, M, K, KP, N, st);
  else if (x_dtype == 1 && y_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, delta, bias, y, M, K, KP, N, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
