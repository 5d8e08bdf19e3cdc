// K6 dense_residual and K7 mlp_fused: the SAM encoder's attention
// projection and MLP with their residual adds, bf16 in and out, f32 sums.
//
// K6 replaces protosam_tpu/ops/mlp_pallas.py `dense_residual` (:88, kernel
// `_dense_kernel`): out = x W^T + b + residual, one rounding at the end.
// K7 replaces protosam_tpu/ops/mlp_pallas.py `mlp_fused` (:125, kernel
// `_kernel`): out = gelu_tanh(x W1^T + b1) W2^T + b2 (+ residual), the
// hidden activation cast to bf16 before the second product, as the TPU
// kernel does.  Weights are in the nn.Linear layout (out, in), as stored.
//
// Bound on the card: both are matrix products with K = 1280 (ViT-H), so
// the tensor cores and the bytes they are fed bound them.  Products run
// on the tensor cores through nvcuda::wmma (mma.sync, 16x16x16, bf16 in,
// f32 accumulate); bias, GELU and residual run in f32 in the epilogue.
//
// K6 design: a plain tiled GEMM.  A 128 x 128 output tile per block of 8
// warps (4 along M x 2 along N, 32 x 64 each); x and W tiles of depth 32
// are copied into a two-stage shared-memory ring with cp.async, so the
// next tile's copy overlaps this tile's products.
//
// K7 design: what makes it this kernel is that the (M, 4C) hidden
// activation never reaches device memory.  The TPU kernel keeps W1 and W2
// (25 MB at ViT-H) resident in VMEM and streams row tiles; a Hopper block
// has 227 KB of shared memory, and a 64 x 1280 f32 output accumulator
// alone is 320 KB.  So a block owns 16 rows and all C output columns: the
// 16 x C f32 accumulator lives in registers (C / 128 fragments per warp,
// 80 floats per thread at C = 1280), the 16 x C x tile in shared memory
// (40 KB).  The block walks the hidden dimension in chunks of 128: each
// warp computes one 16 x 16 piece of the fc1 chunk, adds b1, applies the
// tanh GELU in f32 and writes it as bf16 into a 16 x 128 shared tile; then
// every warp accumulates that tile times its own W2 columns.  Each W1 row
// and each W2 column is used by exactly one warp of the block, so staging
// the weights through shared memory would buy no reuse: the warps load
// their weight fragments straight from L2.  (The other design, output
// column strips with fc1 recomputed per strip, multiplies the fc1 work.)
// The cost of this one is that every 16-row block reads both weight
// matrices once, from L2; a larger row tile needs the accumulator split
// across a cluster, which is later work.
//
// Neither kernel uses atomics, so the output is bit-identical run to run.
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

constexpr int kThreads = 256;  // 8 warps in both kernels
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

// ------------------------------------------------------------------ K7

constexpr int kRows = 16;    // rows per block
constexpr int kChunk = 128;  // hidden units per chunk: one 16-wide piece
                             // per warp
constexpr int kLDG = kChunk + 8;

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True) / torch gelu(approximate="tanh")
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

struct MlpArgs {
  const bf16* x;
  const bf16* w1;  // (h, c)
  const bf16* b1;
  const bf16* w2;  // (c, h)
  const bf16* b2;
  const bf16* res;  // may be null
  bf16* out;
  long m;
  int c, h;
};

size_t mlp_smem_bytes(int c) {
  return sizeof(bf16) * kRows * (c + 8) + sizeof(bf16) * kRows * kLDG +
         sizeof(float) * 8 * 16 * kLDS;
}

// NF = output fragments per warp: warp w owns columns (f * 8 + w) * 16.
template <int NF>
__global__ void __launch_bounds__(kThreads) mlp_fused_kernel(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = a.c + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = xs + kRows * ldx;  // kRows * ldx * 2 bytes: a 32-byte multiple
  float* scratch = reinterpret_cast<float*>(gs + kRows * kLDG);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wscratch = scratch + warp * 16 * kLDS;
  const long m0 = (long)blockIdx.x * kRows;
  const int r = lane / 2, c8 = (lane % 2) * 8;

  // the 16 x C x tile, zero rows past m
  const int vec_per_row = a.c / 8;
  for (int idx = threadIdx.x; idx < kRows * vec_per_row; idx += kThreads) {
    const int rr = idx / vec_per_row, cc = (idx % vec_per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + rr < a.m)
      v = *reinterpret_cast<const uint4*>(a.x + (m0 + rr) * a.c + cc);
    *reinterpret_cast<uint4*>(xs + rr * ldx + cc) = v;
  }
  __syncthreads();

  FragC acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int h0 = 0; h0 < a.h; h0 += kChunk) {
    // fc1: this warp's 16 hidden units of the chunk, + b1, GELU -> bf16
    const int j0 = h0 + 16 * warp;
    if (j0 < a.h) {
      FragC hf;
      wmma::fill_fragment(hf, 0.f);
      const bf16* w1p = a.w1 + (long)j0 * a.c;
      for (int k0 = 0; k0 < a.c; k0 += 16) {
        FragA af;
        FragB bfr;
        wmma::load_matrix_sync(af, xs + k0, ldx);
        wmma::load_matrix_sync(bfr, w1p + k0, a.c);
        wmma::mma_sync(hf, af, bfr, hf);
      }
      wmma::store_matrix_sync(wscratch, hf, kLDS, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float v = wscratch[r * kLDS + c8 + c] +
                        __bfloat162float(a.b1[j0 + c8 + c]);
        gs[r * kLDG + 16 * warp + c8 + c] = __float2bfloat16(gelu_tanh(v));
      }
      __syncwarp();
    } else {  // past h: zeros, so the fc2 product below skips nothing
#pragma unroll
      for (int c = 0; c < 8; ++c)
        gs[r * kLDG + 16 * warp + c8 + c] = __float2bfloat16(0.f);
    }
    __syncthreads();

    // fc2: acc += gelu chunk (16 x 128) x W2[cols, h0 : h0 + 128]^T
    const int kend = min(kChunk, a.h - h0);
    for (int kk = 0; kk < kend; kk += 16) {
      FragA af;
      wmma::load_matrix_sync(af, gs + kk, kLDG);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int n0 = (f * 8 + warp) * 16;
        if (n0 < a.c) {
          FragB bfr;
          wmma::load_matrix_sync(bfr, a.w2 + (long)n0 * a.h + h0 + kk, a.h);
          wmma::mma_sync(acc[f], af, bfr, acc[f]);
        }
      }
    }
    __syncthreads();  // gs is rewritten by the next chunk
  }

  // epilogue: + b2 (+ residual) in f32, one rounding
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n0 = (f * 8 + warp) * 16;
    if (n0 >= a.c) continue;
    wmma::store_matrix_sync(wscratch, acc[f], kLDS, wmma::mem_row_major);
    __syncwarp();
    const long gm = m0 + r;
    if (gm < a.m) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int gn = n0 + c8 + c;
        float y = __bfloat162float(a.b2[gn]);
        if (a.res != nullptr) y += __bfloat162float(a.res[gm * a.c + gn]);
        y += wscratch[r * kLDS + c8 + c];
        a.out[gm * a.c + gn] = __float2bfloat16(y);
      }
    }
    __syncwarp();
  }
}

template <int NF>
int launch_mlp(const MlpArgs& a, cudaStream_t st) {
  const size_t smem = mlp_smem_bytes(a.c);
  auto kern = mlp_fused_kernel<NF>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.m + kRows - 1) / kRows));
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
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

// x, res, out: (m, c); w1: (h, c); b1: (h,); w2: (c, h); b2: (c,); all
// bf16, res may be null.  c and h multiples of 16, c <= 1280; w1 and w2
// 32-byte aligned (their fragments load straight from device memory).
extern "C" int ptk_mlp_fused(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* res,
                             void* out, long m, int c, int h, void* stream) {
  if (m == 0) return (int)cudaGetLastError();
  if (c % 16 || h % 16 || c > 1280 || h == 0)
    return (int)cudaErrorInvalidValue;
  MlpArgs a{static_cast<const bf16*>(x),  static_cast<const bf16*>(w1),
            static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
            static_cast<const bf16*>(b2), static_cast<const bf16*>(res),
            static_cast<bf16*>(out),      m, c, h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((c + 127) / 128) {
    case 1: return launch_mlp<1>(a, st);
    case 2: return launch_mlp<2>(a, st);
    case 3: return launch_mlp<3>(a, st);
    case 4: return launch_mlp<4>(a, st);
    case 5: return launch_mlp<5>(a, st);
    case 6: return launch_mlp<6>(a, st);
    case 7: return launch_mlp<7>(a, st);
    case 8: return launch_mlp<8>(a, st);
    case 9: return launch_mlp<9>(a, st);
    case 10: return launch_mlp<10>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
