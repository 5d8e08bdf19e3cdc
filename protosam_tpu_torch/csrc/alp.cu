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
// TF32.  The TPU kernel held all P x C prototypes in VMEM (2.4 MB at the
// flagship shapes); a Hopper block has 227 KB of shared memory.  So a
// block owns 64 query pixels of one image and streams the prototypes in
// tiles of 64 with an online max / sum e / sum e*d per pixel in f32, as
// the attention core does for keys; each tile's 64 x 64 scores are
// reduced over C in chunks of 32 channels held in shared memory, one 4 x 4
// register tile per thread.  The query is read in its NCHW layout
// (pixels are contiguous per channel, so the loads coalesce): no
// transpose and no padding of pixels or prototypes; the ragged ends are
// masked.  Invalid prototypes are skipped (weight 0, term 0); a running
// sum that stays 0 gives the output 0.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTQ = 64;  // query pixels per block
constexpr int kTP = 64;  // prototypes per tile
constexpr int kBC = 32;  // channels per chunk
constexpr int kThreads = 256;
constexpr float kScale = 20.f;

__global__ void __launch_bounds__(kThreads)
alp_match_kernel(const float* __restrict__ q, const float* __restrict__ pn,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 int c, int hw, int p) {
  __shared__ __align__(16) float qs[kBC][kTQ + 4];
  __shared__ __align__(16) float ps[kBC][kTP + 4];
  __shared__ float red[kThreads / kTQ][kTQ];
  __shared__ float rnorm[kTQ];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTQ;
  const float* qn = q + (long)blockIdx.y * c * hw;

  // 1/max(|q|, 1e-4) per pixel: 4 threads per pixel, coalesced over pixels
  {
    const int t = tid % kTQ, g = tid / kTQ;
    float s = 0.f;
    if (t0 + t < hw)
      for (int ch = g; ch < c; ch += kThreads / kTQ) {
        const float v = qn[(long)ch * hw + t0 + t];
        s = fmaf(v, v, s);
      }
    red[g][t] = s;
    __syncthreads();
    if (tid < kTQ) {
      float n2 = 0.f;
#pragma unroll
      for (int i = 0; i < kThreads / kTQ; ++i) n2 += red[i][tid];
      rnorm[tid] = rsqrtf(fmaxf(n2, 1e-8f));
    }
  }

  // thread (ty, tx) owns pixels ty*4 + i and prototypes tx*4 + j of a tile;
  // the 16 tx threads of a pixel row share one half-warp
  const int ty = tid / 16, tx = tid % 16;
  float m_run[4], l_run[4], a_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
    a_run[i] = 0.f;
  }

  for (int p0 = 0; p0 < p; p0 += kTP) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < c; c0 += kBC) {
      __syncthreads();  // the previous chunk's reads (and rnorm) are done
      for (int idx = tid; idx < kBC * kTQ; idx += kThreads) {
        const int ch = idx / kTQ, t = idx % kTQ;
        float v = 0.f;
        if (c0 + ch < c && t0 + t < hw)
          v = qn[(long)(c0 + ch) * hw + t0 + t] * rnorm[t];
        qs[ch][t] = v;
      }
      for (int idx = tid; idx < kBC * kTP; idx += kThreads) {
        const int pp = idx / kBC, ch = idx % kBC;
        float v = 0.f;
        if (p0 + pp < p && c0 + ch < c) v = pn[(long)(p0 + pp) * c + c0 + ch];
        ps[ch][pp] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int ch = 0; ch < kBC; ++ch) {
        const float4 qa = *reinterpret_cast<const float4*>(&qs[ch][ty * 4]);
        const float4 pb = *reinterpret_cast<const float4*>(&ps[ch][tx * 4]);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float pv[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], pv[j], acc[i][j]);
      }
    }

    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + tx * 4 + j;
      ok[j] = col < p && valid[col] != 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float d[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[j] = kScale * acc[i][j];
        if (ok[j]) mx = fmaxf(mx, d[j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // while nothing valid has been seen, m stays -inf, alpha and every
      // e are 0, so l and a stay 0 (no branch: all lanes shuffle below)
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha =
          m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
      float se = 0.f, sed = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ok[j]) {
          const float e = expf(d[j] - m_new);
          se += e;
          sed = fmaf(e, d[j], sed);
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        se += __shfl_xor_sync(0xffffffffu, se, o);
        sed += __shfl_xor_sync(0xffffffffu, sed, o);
      }
      l_run[i] = l_run[i] * alpha + se;
      a_run[i] = a_run[i] * alpha + sed;
      m_run[i] = m_new;
    }
  }

  if (tx == 0) {
    float* o = out + (long)blockIdx.y * hw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t < hw) o[t] = l_run[i] > 0.f ? a_run[i] / l_run[i] : 0.f;
    }
  }
}

}  // namespace

// q: (n, c, hw) f32; pn: (p, c) f32, rows L2-normalised; valid: (p,) uint8;
// out: (n, hw) f32.
extern "C" int ptk_alp_match(const void* q, const void* pn, const void* valid,
                             void* out, int n, int c, int hw, int p,
                             void* stream) {
  if (n == 0 || hw == 0) return (int)cudaGetLastError();
  const dim3 grid((hw + kTQ - 1) / kTQ, n);
  alp_match_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(pn),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), c, hw, p);
  return (int)cudaGetLastError();
}
