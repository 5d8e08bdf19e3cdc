// K1 layer_norm_rows: LayerNorm over the last axis of an (N, C) matrix.
//
// Replaces the Pallas kernel protosam_tpu/ops/norm.py `_ln_kernel` (:86,
// launched by `_ln_pallas`).  Numerics are flax nn.LayerNorm's: f32 sums,
// the fast variance E[x^2] - mean^2 clipped at 0, y = (x - mean) *
// (rsqrt(var + eps) * gamma) + beta, then one cast to the output type.
//
// Bound on the card: device memory.  The row is read twice and written
// once at ~0.5 flop per byte, far under the H100's ~295 flop/byte ridge.
// Design: one warp per row, so the two reductions are warp shuffles with
// no shared memory and no block barrier; the second read of the row comes
// from L1/L2 (a 1024-wide bf16 row is 2 KB).  gamma/beta are always f32,
// as flax keeps LayerNorm params in f32 under a bf16 build.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_rows_kernel(const Tin* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       Tout* __restrict__ y, long n_rows, int c, float eps) {
  const long row = (long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const Tin* xr = x + row * c;
  float s = 0.f, s2 = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float v = ptk::to_f32(xr[i]);
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s / c;
  const float var = fmaxf(s2 / c - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  Tout* yr = y + row * c;
  for (int i = lane; i < c; i += 32) {
    const float v = ptk::to_f32(xr[i]);
    yr[i] = ptk::from_f32<Tout>((v - mean) * (rstd * gamma[i]) + beta[i]);
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           long n_rows, int c, float eps, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  layer_norm_rows_kernel<Tin, Tout><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<Tout*>(y), n_rows, c, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptk_layer_norm_rows(const void* x, const void* gamma,
                                   const void* beta, void* y, long n_rows,
                                   int c, float eps, int in_dtype,
                                   int out_dtype, void* stream) {
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_dtype == ptk::kF32 && out_dtype == ptk::kF32)
    return launch<float, float>(x, gamma, beta, y, n_rows, c, eps, st);
  if (in_dtype == ptk::kF32 && out_dtype == ptk::kBF16)
    return launch<float, bf16>(x, gamma, beta, y, n_rows, c, eps, st);
  if (in_dtype == ptk::kBF16 && out_dtype == ptk::kF32)
    return launch<bf16, float>(x, gamma, beta, y, n_rows, c, eps, st);
  if (in_dtype == ptk::kBF16 && out_dtype == ptk::kBF16)
    return launch<bf16, bf16>(x, gamma, beta, y, n_rows, c, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
