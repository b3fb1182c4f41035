// attn_prefill on the tensor cores: blocked online-softmax attention with
// per-query [lo, hi) windows, for bucketed prefill admission, with bf16
// queries and a bf16 or int8 K/V. (fp32 queries run attn_prefill.cu: its
// parity gates do not admit the tensor cores' bf16 operands.)
//
// Replaces the TPU kernel
// src/repro/kernels/attn_prefill/kernel.py::attn_prefill_pallas (body
// _kernel), for the bf16 compute dtype.
//
// Layout: q (B, T, KV, G, D) bf16, already scaled by 1/sqrt(D). k, v
// (B, S, KV, D) bf16, or int8 with per-token fp32 scales k_scale, v_scale
// (B, S). lo, hi (B, T) int32: query t of row b sees the key positions
// lo[b, t] <= p < hi[b, t] (lo may be null, for all zeros). out
// (B, T, KV, G, D) bf16. lse, where not null, (B, T, KV, G) fp32: each
// query row's log-sum-exp m + log(l) from the final m and l, -inf for a
// row with no visible key; the store is a template parameter, so a launch
// without lse runs the kernel that has none. D is a multiple of 16 from
// 16 to 256.
//
// Numerics, as the reference, per block of BK keys (the TPU kernel's are
// 128): fp32 scores; int8 k_scale per key column after Q.K; an online
// softmax with m, l and the accumulator in fp32, rescaled once per key
// block; probabilities (times v_scale for int8 V) rounded to bf16 before
// P.V; one division by l at the end. int8 K and V enter the tensor cores
// as bf16, which holds every int8 value exactly. A query whose window is
// empty writes exact zeros: its probabilities are zero, so l stays 0.
//
// What bounds it on the H100: a T-token bucket does about 4 * T^2 / 2 * D
// flops per head for 2 * T * D bytes of K and V per head, so for T >= 64
// it is bound by operations; on the tensor cores (989 TFLOP/s bf16) the
// engine's buckets take microseconds, and what is left is latency: loads,
// the softmax between the two products, and the launch.
//
// What the design does about it: one warpgroup (128 threads) per block and
// 64 query rows per block, the rows of one (batch row b, KV head h)
// flattened as r = t * G + g, so each staged K/V block serves all G heads
// of the group. S = Q.K^T is a wgmma m64n64k16 chain with Q and the K
// block in shared memory (both K-major); P, converted to bf16 in
// registers, is the A operand of O += P.V, whose B is the V block in its
// natural (key, D) layout read through the descriptor's transpose bit. P.V
// covers D in column chunks of 128, 64, 32 and 16 (D = 80: m64n64k16 and
// m64n16k16 on the same P fragment), each chunk a slice of the accumulator
// registers and of the V block's 8-column core matrices, so every D that
// is a multiple of 16 runs with the wgmma shapes of its binary digits.
// K/V blocks (and int8 scales) are staged by cp.async, two buffers deep,
// so block j + 1 loads while block j is multiplied; int8
// blocks are widened to bf16 in shared memory. A block walks only the keys
// [min lo, max hi) of its 64 rows and runs no key block at all when every
// row's window is empty; blocks start with the last tile of rows (the
// longest causal windows) so the longest blocks are scheduled first.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;       // query rows per block: wgmma's M
constexpr int BK = 64;         // keys per staged block
constexpr int THREADS = 128;   // one warpgroup
constexpr float NEG = -1e30f;  // a masked score

// D (64 x 64, fp32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major;
// scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, fp32) += A (64 x 16, registers) . B (16 x N, smem, MN-major:
// the transpose bit), for N = 16, 32, 64, 128; d is N / 2 accumulator
// registers of this thread.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory matrix descriptor, no swizzle: core matrices of 8
// rows x 16 bytes (128 contiguous bytes); lbo is the byte distance between
// core matrices along K, sbo along M / N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// O += P . V over the D columns of the accumulator, in chunks of the
// largest of 128, 64, 32, 16 columns that fit: the chunk from column C0
// holds accumulator registers C0 / 2 .. and starts C0 / 8 core matrices
// (of 128 bytes) into the V block's k-step. lbo: bytes between the two
// 8-key halves of the k-step.
template <int D, int C0 = 0>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t v_kk) {
  if constexpr (C0 < D) {
    constexpr int R = D - C0;
    constexpr int N = R >= 128 ? 128 : R >= 64 ? 64 : R >= 32 ? 32 : 16;
    wgmma_rs<N>(o + C0 / 2, a, make_desc(v_kk + (C0 / 8) * 128, D * 16, 128));
    wgmma_pv<D, C0 + N>(o, a, v_kk);
  }
}
// Generic-proxy writes to shared memory (cp.async, st.shared) before
// async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory layout of a tile of rows x D bf16 (query or key rows): the
// 16-byte chunk c (8 values along D) of row r sits at byte
//   (r / 8) * (D * 16) + c * 128 + (r % 8) * 16,
// wgmma's core matrices without swizzle, D / 8 of them side by side per 8
// rows. Chunk number i = ((r / 8) * (D / 8) + c) * 8 + r % 8 lands at byte
// 16 i, so copy i of a thread is linear in shared memory, and a warp's 32
// copies read 64 contiguous bytes of each of 8 rows.
template <int D>
struct TileChunk {
  int row, chunk;
  __device__ __forceinline__ explicit TileChunk(int i)
      : row(((i >> 3) / (D / 8)) * 8 + (i & 7)), chunk((i >> 3) % (D / 8)) {}
};

template <typename TKV, int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
attn_prefill_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                          const TKV* __restrict__ k, const TKV* __restrict__ v,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int32_t* __restrict__ lo,
                          const int32_t* __restrict__ hi,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int Tq, int S, int KV,
                          int G) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int TILE = BK * D * 2;          // bytes of a bf16 K or V block
  constexpr int RAW = BK * D;               // bytes of an int8 K or V block
  constexpr int KSTEPS = D / 16;            // wgmma k-steps of Q.K^T
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;                               // ROWS x D bf16
  unsigned char* kvs = smem + ROWS * D * 2;               // bf16 blocks
  unsigned char* raw = kvs + (QUANT ? 2 : 4) * TILE;      // int8 blocks
  float* scl = reinterpret_cast<float*>(raw + (QUANT ? 4 * RAW : 0));
  __shared__ int red[2][4];

  const int R = Tq * G;
  const int ntile = (R + ROWS - 1) / ROWS;
  const int tile = ntile - 1 - (int)(blockIdx.x % ntile);
  const int bh = blockIdx.x / ntile;
  const int h = bh % KV;
  const int b = bh / KV;
  const int r0 = tile * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;

  // This thread's two accumulator rows: warp * 16 + g8 and that + 8.
  int rlo[2], rhi[2];
  int kmin = S, kmax = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int rr = r0 + warp * 16 + g8 + 8 * j;
    rlo[j] = 0;
    rhi[j] = 0;                               // padded row: empty window
    if (rr < R) {
      const int tq = rr / G;
      rlo[j] = lo ? max(lo[(size_t)b * Tq + tq], 0) : 0;
      rhi[j] = min(hi[(size_t)b * Tq + tq], S);
    }
    if (rhi[j] > rlo[j]) {
      kmin = min(kmin, rlo[j]);
      kmax = max(kmax, rhi[j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
  }
  if (lane == 0) {
    red[0][warp] = kmin;
    red[1][warp] = kmax;
  }
  __syncthreads();
  kmin = min(min(red[0][0], red[0][1]), min(red[0][2], red[0][3]));
  kmax = max(max(red[1][0], red[1][1]), max(red[1][2], red[1][3]));
  const int nblk = kmax > kmin ? (kmax - kmin + BK - 1) / BK : 0;

  const size_t head0 = ((size_t)b * S * KV + h) * D;     // k/v of (b, 0, h)
  const size_t key_stride = (size_t)KV * D;
  auto stage = [&](int j, int buf) {
    const int kb = kmin + j * BK;
    if constexpr (!QUANT) {
      unsigned char* kt = kvs + 2 * buf * TILE;
      unsigned char* vt = kt + TILE;
      for (int i = tid; i < BK * D / 8; i += THREADS) {
        const TileChunk<D> c(i);
        const int key = kb + c.row;
        const bool ok = key < kmax;
        const size_t off = head0 + (size_t)(ok ? key : kmin) * key_stride + c.chunk * 8;
        cp_async16(smem_u32(kt + 16 * i), k + off, ok);
        cp_async16(smem_u32(vt + 16 * i), v + off, ok);
      }
    } else {
      unsigned char* kr = raw + 2 * buf * RAW;
      unsigned char* vr = kr + RAW;
      for (int i = tid; i < RAW / 16; i += THREADS) {
        const int key = kb + i / (D / 16);
        const bool ok = key < kmax;
        const size_t off = head0 + (size_t)(ok ? key : kmin) * key_stride + (i % (D / 16)) * 16;
        cp_async16(smem_u32(kr + 16 * i), k + off, ok);
        cp_async16(smem_u32(vr + 16 * i), v + off, ok);
      }
      for (int i = tid; i < BK; i += THREADS) {
        const int key = kb + i;
        const bool ok = key < kmax;
        const size_t off = (size_t)b * S + (ok ? key : kmin);
        cp_async4(smem_u32(scl + 2 * buf * BK + i), k_scale + off, ok);
        cp_async4(smem_u32(scl + (2 * buf + 1) * BK + i), v_scale + off, ok);
      }
    }
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  if (nblk > 0) {
    for (int i = tid; i < ROWS * D / 8; i += THREADS) {
      const TileChunk<D> c(i);
      const int rr = r0 + c.row;
      const bool ok = rr < R;
      const int tq = ok ? rr / G : 0;
      const int gq = ok ? rr - tq * G : 0;
      const __nv_bfloat16* src =
          q + ((((size_t)b * Tq + tq) * KV + h) * G + gq) * D + c.chunk * 8;
      cp_async16(smem_u32(qs + 16 * i), src, ok);
    }
    stage(0, 0);
    cp_commit();
  }
  const uint32_t q_addr = smem_u32(qs);

  for (int j = 0; j < nblk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nblk) {
      stage(j + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    const unsigned char* kt;
    const unsigned char* vt;
    if constexpr (QUANT) {
      __syncthreads();                       // every thread's copies landed
      const unsigned char* kr = raw + 2 * buf * RAW;
      const unsigned char* vr = kr + RAW;
      for (int i = tid; i < RAW / 16; i += THREADS) {
        const int key = i / (D / 16);
        const int c2 = 2 * (i % (D / 16));   // the two bf16 chunks it fills
        const size_t dst = (size_t)(key / 8) * (D * 16) + (key % 8) * 16;
#pragma unroll
        for (int kvi = 0; kvi < 2; ++kvi) {
          const uint4 w = *reinterpret_cast<const uint4*>((kvi ? vr : kr) + 16 * i);
          unsigned char* tb = kvs + kvi * TILE + dst;
          const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                 w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint4 bf;
            bf.x = rt::bf16x2_of_levels(u[2 * half], 0x7440, 0x7441);
            bf.y = rt::bf16x2_of_levels(u[2 * half], 0x7442, 0x7443);
            bf.z = rt::bf16x2_of_levels(u[2 * half + 1], 0x7440, 0x7441);
            bf.w = rt::bf16x2_of_levels(u[2 * half + 1], 0x7442, 0x7443);
            *reinterpret_cast<uint4*>(tb + (c2 + half) * 128) = bf;
          }
        }
      }
      kt = kvs;
      vt = kvs + TILE;
    } else {
      kt = kvs + 2 * buf * TILE;
      vt = kt + TILE;
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q . K^T: 64 rows x BK keys, fp32
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    const uint32_t k_addr = smem_u32(kt);
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_m64n64k16(s, make_desc(q_addr + 256 * kk, 128, D * 16),
                         make_desc(k_addr + 256 * kk, 128, D * 16), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // s[4i + 2jr + e]: row warp * 16 + g8 + 8 jr, key column 8i + 2 t4 + e
    const int kb = kmin + j * BK;
    const float* ks = scl + 2 * buf * BK;
    const float* vs = ks + BK;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * t4 + e;
        const int key = kb + col;
        const float kscale = QUANT ? ks[col] : 1.f;
#pragma unroll
        for (int jr = 0; jr < 2; ++jr) {
          float& sv = s[4 * i + 2 * jr + e];
          sv = (key >= rlo[jr] && key < rhi[jr]) ? sv * kscale : NEG;
          mx[jr] = fmaxf(mx[jr], sv);
        }
      }
    float corr[2], mnew[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int jr = 0; jr < 2; ++jr) {
      mx[jr] = fmaxf(mx[jr], __shfl_xor_sync(0xffffffffu, mx[jr], 1));
      mx[jr] = fmaxf(mx[jr], __shfl_xor_sync(0xffffffffu, mx[jr], 2));
      mnew[jr] = fmaxf(m_run[jr], mx[jr]);
      corr[jr] = __expf(m_run[jr] - mnew[jr]);
      m_run[jr] = mnew[jr];
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * t4 + e;
        const float vscale = QUANT ? vs[col] : 1.f;
#pragma unroll
        for (int jr = 0; jr < 2; ++jr) {
          float& sv = s[4 * i + 2 * jr + e];
          const float p = sv > 0.5f * NEG ? __expf(sv - mnew[jr]) : 0.f;
          psum[jr] += p;
          sv = QUANT ? p * vscale : p;
        }
      }
#pragma unroll
    for (int jr = 0; jr < 2; ++jr) l_run[jr] = l_run[jr] * corr[jr] + psum[jr];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i + 0] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    // P as wgmma's A fragment: k-step kk covers key chunks 2kk and 2kk + 1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P . V: the V block is (key, D), MN-major for this product
    const uint32_t v_addr = smem_u32(vt);
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<D>(o, pa[kk], v_addr + kk * 2 * D * 16);
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    __syncthreads();                          // before the buffer refills
  }

#pragma unroll
  for (int jr = 0; jr < 2; ++jr) {
    float l = l_run[jr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int rr = r0 + warp * 16 + g8 + 8 * jr;
    if (rr >= R) continue;
    const int tq = rr / G;
    const int gq = rr - tq * G;
    const size_t orow = (((size_t)b * Tq + tq) * KV + h) * G + gq;
    if constexpr (LSE)
      if (t4 == 0) lse[orow] = l > 0.f ? m_run[jr] + logf(l) : -INFINITY;
    __nv_bfloat16* dst = out + orow * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dst + 8 * i) =
          pack_bf16(o[4 * i + 2 * jr] * inv, o[4 * i + 2 * jr + 1] * inv);
  }
}

template <typename TKV, int D, bool LSE>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lo, const void* hi, void* out,
           float* lse, int B, int Tq, int S, int KV, int G, int smem,
           cudaStream_t st) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int need = ROWS * D * 2 + (QUANT ? 2 * BK * D * 2 + 4 * BK * D + 4 * BK * 4
                                             : 4 * BK * D * 2);
  if (smem < need) return (int)cudaErrorInvalidValue;
  auto kern = attn_prefill_kernel_wgmma<TKV, D, LSE>;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int ntile = (Tq * G + ROWS - 1) / ROWS;
  kern<<<B * KV * ntile, THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const TKV*)k, (const TKV*)v, (const float*)ks,
      (const float*)vs, (const int32_t*)lo, (const int32_t*)hi,
      (__nv_bfloat16*)out, lse, Tq, S, KV, G);
  return 0;
}

}  // namespace

// q bf16; kv_dtype: 1 bf16 or 2 int8 (then k_scale and v_scale are
// required); D a multiple of 16 from 16 to 256. smem: the dynamic shared
// memory bytes of the launch, as the wrapper's plan computed them. lse:
// null, or fp32 B x T x KV x G for each query row's log-sum-exp. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int attn_prefill_tc_launch(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, const void* lo,
                                      const void* hi, void* out, void* lse,
                                      int B, int Tq,
                                      int S, int KV, int G, int D, int kv_dtype,
                                      int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
#define RT_LAUNCH(TT, DD, LL)                                                  \
  launch<TT, DD, LL>(q, k, v, k_scale, v_scale, lo, hi, out, (float*)lse, B,   \
                     Tq, S, KV, G, smem, st)
#define RT_CASE(DD)                                                            \
  case DD:                                                                     \
    rc = kv_dtype == 1                                                         \
        ? (lse ? RT_LAUNCH(__nv_bfloat16, DD, true)                            \
               : RT_LAUNCH(__nv_bfloat16, DD, false))                          \
        : (lse ? RT_LAUNCH(int8_t, DD, true) : RT_LAUNCH(int8_t, DD, false));  \
    break;
  if (kv_dtype != 1 && kv_dtype != 2) return (int)cudaErrorInvalidValue;
  switch (D) {
    RT_CASE(16) RT_CASE(32) RT_CASE(48) RT_CASE(64) RT_CASE(80) RT_CASE(96)
    RT_CASE(112) RT_CASE(128) RT_CASE(144) RT_CASE(160) RT_CASE(176)
    RT_CASE(192) RT_CASE(208) RT_CASE(224) RT_CASE(240) RT_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_CASE
#undef RT_LAUNCH
  if (rc) return rc;
  return (int)cudaGetLastError();
}
