// K6 dense_residual: the SAM encoder's attention projection with its
// residual add, bf16 in and out, f32 sums.  (K7 mlp_fused, the MLP, is in
// mlp_fused.cu.)
//
// K6 replaces protosam_tpu/ops/mlp_pallas.py `dense_residual` (:88, kernel
// `_dense_kernel`): out = x W^T + b + residual, one rounding at the end.
// The weight is in the nn.Linear layout (out, in), as stored.
//
// Bound on the card: a matrix product with K = 1280 (ViT-H), so the tensor
// cores and the bytes they are fed bound it.  Products run on the tensor
// cores through nvcuda::wmma (mma.sync, 16x16x16, bf16 in, f32
// accumulate); bias and residual run in f32 in the epilogue.
//
// K6 design: a plain tiled GEMM.  A 128 x 128 output tile per block of 8
// warps (4 along M x 2 along N, 32 x 64 each); x and W tiles of depth 32
// are copied into a two-stage shared-memory ring with cp.async, so the
// next tile's copy overlaps this tile's products.
//
// It uses no atomics, so the output is bit-identical run to run.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;  // 8 warps
constexpr int kLDS = 20;       // f32 scratch row stride of one 16 x 16 tile

// 16 bytes global -> shared, zero-filled when `pred` is false.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ K6

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLDT = kBK + 8;  // bf16 row stride of a shared tile

// One 128 x 32 tile of a row-major (rows, k) matrix into shared memory.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long rows, int k, long r0,
                                          int k0) {
  constexpr int kVecPerRow = kBK / 8;
  for (int idx = threadIdx.x; idx < kBM * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow, c = (idx % kVecPerRow) * 8;
    const bool in = r0 + r < rows && k0 + c < k;  // k % 8 == 0
    const bf16* g = in ? src + (r0 + r) * k + k0 + c : src;
    cp_async16(dst + r * kLDT + c, g, in);
  }
}

__global__ void __launch_bounds__(kThreads)
dense_residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const bf16* __restrict__ b,
                      const bf16* __restrict__ res, bf16* __restrict__ out,
                      long m, int k, int n) {
  __shared__ __align__(128) bf16 as[2][kBM * kLDT];
  __shared__ __align__(128) bf16 bs[2][kBN * kLDT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // 32 x 64 warp tile
  const long m0 = (long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int ktiles = (k + kBK - 1) / kBK;
  load_tile(as[0], x, m, k, m0, 0);
  load_tile(bs[0], w, n, k, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile(as[st ^ 1], x, m, k, m0, (kt + 1) * kBK);
      load_tile(bs[st ^ 1], w, n, k, n0, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA af[2];
      FragB bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as[st] + (wm * 32 + i * 16) * kLDT + kk,
                               kLDT);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfr[j],
                               bs[st] + (wn * 64 + j * 16) * kLDT + kk, kLDT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // this stage is refilled two iterations on
  }

  // epilogue through a per-warp 16 x 16 f32 scratch (the ring is free now)
  float* scratch = reinterpret_cast<float*>(&as[0][0]) + warp * 16 * kLDS;
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], kLDS, wmma::mem_row_major);
      __syncwarp();
      const long gm = m0 + wm * 32 + i * 16 + r;
      const int gn = n0 + wn * 64 + j * 16 + c8;
      if (gm < m) {
        for (int c = 0; c < 8 && gn + c < n; ++c) {
          float y = scratch[r * kLDS + c8 + c];
          y += __bfloat162float(b[gn + c]);
          y += __bfloat162float(res[gm * n + gn + c]);
          out[gm * n + gn + c] = __float2bfloat16(y);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x: (m, k); w: (n, k); b: (n,); res, out: (m, n); all bf16.  k a
// multiple of 8; pointers 16-byte aligned.
extern "C" int ptk_dense_residual(const void* x, const void* w,
                                  const void* b, const void* res, void* out,
                                  long m, int k, int n, void* stream) {
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  if (k % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (unsigned)((m + kBM - 1) / kBM));
  dense_residual_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), m, k, n);
  return (int)cudaGetLastError();
}
