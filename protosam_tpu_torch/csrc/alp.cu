// K5 alp_match: fused ALP prototype matching for a (N, C, H, W) f32 query.
//
// Replaces protosam_tpu/ops/alp_pallas.py `_kernel` (:30, launched by
// `_alp_match_fused` :82).  For every query pixel: L2-normalise its C
// channels (x * rsqrt(max(|x|^2, 1e-8))), d_p = 20 * q . p against every
// prototype (already normalised by the wrapper), and return
// sum_p softmax(d)_p * d_p over the valid prototypes only.  A pixel whose
// prototypes are all invalid gets exactly 0, as the TPU kernel's masked
// softmax gives.  One f32 value per pixel, written as (N, 1, H, W).
//
// Bound on the card: the f32 product, 2 * rows * P * C flops (11 GFLOP at
// 9216 rows, 577 prototypes, C = 1024) on the CUDA cores: the coarse tail
// runs at full f32 precision, so the products are exact FMAs and never
// TF32.  The TPU kernel held all P x C prototypes in VMEM and walked the
// grid in order; on the card the work has to spread over 132 SMs.  So the
// prototype range is split across blocks: the grid is (64-pixel tiles,
// 128-prototype splits, N), 720 blocks at the flagship shapes.  Each block
// is a small f32 GEMM tile: the query chunk (16 channels x 64 pixels, read
// in its NCHW layout, pixels contiguous) and the prototype chunk (16 x 128
// of pn^T, which the wrapper hands over transposed and zero-padded to whole
// splits) stream through a two-stage cp.async ring with one __syncthreads
// per chunk; each thread keeps an 8 x 8 register tile (pixels ty*4 + i and
// 32 + ty*4 + i, prototypes tx*4 + j and 64 + tx*4 + j, so both operands
// load as conflict-free float4s), 64 FMAs for 4 shared loads.  The squared
// norm of each pixel accumulates from the same shared query chunks.  The
// block then writes, per pixel, its online-softmax partial (max m,
// sum e, sum e*d over its valid prototypes; m = -inf and zero sums where
// it has none) to an f32 scratch, and a combine launch merges the splits
// in a fixed order with no atomics, so reruns are bit-identical.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTQ = 64;   // query pixels per block
constexpr int kTP = 128;  // prototypes per block (one split)
constexpr int kBK = 16;   // channels per chunk
// each thread owns 8 pixels (two groups of 4) and 8 prototypes (two groups
// of 4): kTY thread rows by kTX thread columns
constexpr int kTY = kTQ / 8, kTX = kTP / 8, kThreads = kTY * kTX;
constexpr int kNormShare = kThreads / kTQ;  // threads summing one pixel
static_assert(kBK % kNormShare == 0 && 32 % kTX == 0,
              "norm shares and pixel rows must divide evenly");
constexpr int kCombineThreads = 256;
constexpr float kScale = 20.f;

// 4 bytes global -> shared through L1; zero-filled where !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

struct Smem {
  float q[2][kBK][kTQ];
  float p[2][kBK][kTP];
  float red[kNormShare][kTQ];
  float rnorm[kTQ];
};

// stage chunk c0 of the query (pixels t0..t0+63 of image qn) and of pn^T
// (prototypes s0..s0+127) into buffer `buf`; channels >= c and pixels >= hw
// are zero-filled.  VEC: hw % 4 == 0, so a float4 of pixels is all in or
// all out of the image.
template <bool VEC>
__device__ __forceinline__ void load_chunk(Smem& sm, int buf,
                                           const float* qn,
                                           const float* pt, int c, int hw,
                                           int pp, int t0, int s0, int c0) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int k = 0; k < kBK * kTQ / 4 / kThreads; ++k) {
      const int idx = tid + k * kThreads, ch = idx / (kTQ / 4);
      const int col = (idx % (kTQ / 4)) * 4;
      const bool ok = c0 + ch < c && t0 + col < hw;
      ptk::cp_async16(ptk::smem_u32(&sm.q[buf][ch][col]),
                      ok ? qn + (long)(c0 + ch) * hw + t0 + col : qn, ok);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kBK * kTQ / kThreads; ++k) {
      const int idx = tid + k * kThreads, ch = idx / kTQ, col = idx % kTQ;
      const bool ok = c0 + ch < c && t0 + col < hw;
      cp_async4(ptk::smem_u32(&sm.q[buf][ch][col]),
                ok ? qn + (long)(c0 + ch) * hw + t0 + col : qn, ok);
    }
  }
#pragma unroll
  for (int k = 0; k < kBK * kTP / 4 / kThreads; ++k) {
    const int idx = tid + k * kThreads, ch = idx / (kTP / 4);
    const int col = (idx % (kTP / 4)) * 4;
    const bool ok = c0 + ch < c;
    ptk::cp_async16(ptk::smem_u32(&sm.p[buf][ch][col]),
                    ok ? pt + (long)(c0 + ch) * pp + s0 + col : pt, ok);
  }
  ptk::cp_async_commit();
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
alp_split_kernel(const float* __restrict__ q, const float* __restrict__ pt,
                 const uint8_t* __restrict__ valid, float* __restrict__ part,
                 int c, int hw, int pp) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTQ, s0 = blockIdx.y * kTP;
  const int nsplit = gridDim.y;
  const float* qn = q + (long)blockIdx.z * c * hw;

  // pixels g * 32 + ty * 4 + i, prototypes h * 64 + tx * 4 + j: both
  // operands load as float4s, the prototypes' consecutive across tx
  const int ty = tid / kTX, tx = tid % kTX;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // the squared norm of pixel tid % 64 over its share of a chunk's channels
  const int npx = tid % kTQ, nh = tid / kTQ;
  constexpr int kNormCh = kBK / kNormShare;
  float n2 = 0.f;

  const int chunks = (c + kBK - 1) / kBK;
  load_chunk<VEC>(sm, 0, qn, pt, c, hw, pp, t0, s0, 0);
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    ptk::cp_async_wait_all();
    // chunk k has landed for every thread, and every thread is done with
    // chunk k - 1, whose buffer the next copy overwrites
    __syncthreads();
    if (k + 1 < chunks)
      load_chunk<VEC>(sm, buf ^ 1, qn, pt, c, hw, pp, t0, s0, (k + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kNormCh; ++kk) {
      const float v = sm.q[buf][nh * kNormCh + kk][npx];
      n2 = fmaf(v, v, n2);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float* qr = sm.q[buf][kk];
      const float* pr = sm.p[buf][kk];
      float a[8], b[8];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(qr + g * (kTQ / 2) + ty * 4);
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(pr + h * (kTP / 2) + tx * 4);
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z;
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  sm.red[nh][npx] = n2;
  __syncthreads();
  if (tid < kTQ) {
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < kNormShare; ++h) s += sm.red[h][tid];
    sm.rnorm[tid] = rsqrtf(fmaxf(s, 1e-8f));
  }
  __syncthreads();

  bool ok[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    ok[j] = valid[s0 + (j / 4) * (kTP / 2) + tx * 4 + j % 4] != 0;
  float* out = part + (long)(blockIdx.z * nsplit + blockIdx.y) * 3 * hw;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int px = (i / 4) * (kTQ / 2) + ty * 4 + i % 4;
    const float rn = sm.rnorm[px];
    float d[8];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      d[j] = kScale * (acc[i][j] * rn);
      if (ok[j]) mx = fmaxf(mx, d[j]);
    }
    // the kTX threads of a pixel row are consecutive lanes of one warp
#pragma unroll
    for (int o = kTX / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float se = 0.f, sed = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (ok[j]) {  // mx is finite wherever some j is valid
        const float e = expf(d[j] - mx);
        se += e;
        sed = fmaf(e, d[j], sed);
      }
    }
#pragma unroll
    for (int o = kTX / 2; o > 0; o >>= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, o);
      sed += __shfl_xor_sync(0xffffffffu, sed, o);
    }
    const int t = t0 + px;
    if (tx == 0 && t < hw) {
      out[t] = mx;
      out[hw + t] = se;
      out[2 * hw + t] = sed;
    }
  }
}

// out[z, t] = sum_s a_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s,
// over the splits in order; 0 where no split saw a valid prototype
__global__ void __launch_bounds__(kCombineThreads)
alp_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int nsplit, int hw, long total) {
  const long idx = (long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (idx >= total) return;
  const long z = idx / hw, t = idx - z * hw;
  const float* pz = part + z * nsplit * 3 * hw + t;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, pz[(long)s * 3 * hw]);
  float l = 0.f, a = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < nsplit; ++s) {
      const float* ps = pz + (long)s * 3 * hw;
      const float ms = ps[0];
      if (ms == -INFINITY) continue;
      const float f = expf(ms - m);
      l = fmaf(ps[hw], f, l);
      a = fmaf(ps[2 * hw], f, a);
    }
  }
  out[idx] = l > 0.f ? a / l : 0.f;
}

}  // namespace

// q: (n, c, hw) f32; pt: (c, p) f32, pn^T with the prototype rows
// L2-normalised and p padded with zero columns to a multiple of 128;
// valid: (p,) uint8, 0 on the padding; part: (n, p / 128, 3, hw) f32
// scratch; out: (n, hw) f32.
extern "C" int ptk_alp_match(const void* q, const void* pt, const void* valid,
                             void* part, void* out, int n, int c, int hw,
                             int p, void* stream) {
  if (p <= 0 || p % kTP != 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || hw == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((hw + kTQ - 1) / kTQ, p / kTP, n);
  const float* qf = static_cast<const float*>(q);
  const float* pf = static_cast<const float*>(pt);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  float* partf = static_cast<float*>(part);
  if (hw % 4 == 0)
    alp_split_kernel<true>
        <<<grid, kThreads, 0, st>>>(qf, pf, vf, partf, c, hw, p);
  else
    alp_split_kernel<false>
        <<<grid, kThreads, 0, st>>>(qf, pf, vf, partf, c, hw, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long total = (long)n * hw;
  alp_combine_kernel<<<(unsigned)((total + kCombineThreads - 1) /
                                  kCombineThreads),
                       kCombineThreads, 0, st>>>(
      partf, static_cast<float*>(out), p / kTP, hw, total);
  return (int)cudaGetLastError();
}
