// K1 layer_norm_rows: LayerNorm over the last axis of an (N, C) matrix.
//
// Replaces the Pallas kernel protosam_tpu/ops/norm.py `_ln_kernel` (:86,
// launched by `_ln_pallas`).  Numerics are flax nn.LayerNorm's: f32 sums,
// the fast variance E[x^2] - mean^2 clipped at 0, y = (x - mean) *
// (rsqrt(var + eps) * gamma) + beta, then one cast to the output type.
//
// Bound on the card: device memory.  Each row is read once and written
// once at ~0.5 flop per byte, far under the H100's ~295 flop/byte ridge, so
// what counts is moving those bytes in as few, as wide and as early
// transactions as possible.
// Design: one warp per row, so the two reductions are warp shuffles with
// no shared memory and no block barrier.  Each lane loads its share of the
// row as 16-byte vectors (8 bf16 or 4 f32) into registers, all at once and
// once only: V vectors a lane, a template parameter (3, 4 or 5 at bf16 C =
// 768, 1024 or 1280), the last one predicated where C / 8 (or C / 4) is
// not a multiple of 32.  They stay packed (4 registers a vector), so at
// DINOv2-L's 4864 rows every row fits the card at once.  Both sums come
// from those registers, and so does the output, stored as 16-byte
// vectors; gamma/beta (always f32, as flax keeps LayerNorm params in f32
// under a bf16 build) are read as float4.
// A C that is not a multiple of the vector width, or too wide for
// kMaxVecs vectors a lane, takes the scalar kernel: strided 2- or 4-byte
// loads, and a second read of the row for the output.  So do f32 rows
// that the scalar kernel holds in one wave where the vector kernel, which
// keeps the row in registers and so fits fewer blocks an SM, would put
// less than half a wave into a second: f32 scalar loads are already whole
// 128-byte transactions, so the one read saves less than that second
// wave's tail costs (f32 C = 1024 at DINOv2-L's 4864 rows: 62 registers,
// 4224 rows a wave).
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxVecs = 10;  // a lane: C <= 2560 at bf16, 1280 at f32

// W floats (W a multiple of 4) as float4 loads
template <int W>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[W]) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// 16 bytes of the row (8 bf16 or 4 f32) as floats
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// W outputs, as W / 4 float4 or W / 2 packed bf16 pairs in one store
template <int W>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[W]) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int W>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[W]) {
  uint32_t u[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (W == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
}

__device__ __forceinline__ void warp_sums(float& s, float& s2) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
}

// C a multiple of W = 16 / sizeof(Tin), C / W <= 32 V: the row read once
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_rows_vec_kernel(const Tin* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           Tout* __restrict__ y, long n_rows, int c,
                           float eps) {
  constexpr int W = 16 / sizeof(Tin);
  const long row = (long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int nvec = c / W;
  const Tin* xr = x + row * c;
  // the row held as it was read, 4 registers a vector (converted where
  // used), so that enough warps fit an SM to read every row at once
  uint4 raw[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = (32 * i + lane) * W;
    raw[i] = 32 * i + lane < nvec
                 ? *reinterpret_cast<const uint4*>(xr + e)
                 : make_uint4(0u, 0u, 0u, 0u);  // +0.0 in both types
  }
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float v[W];
    unpack(raw[i], v);
#pragma unroll
    for (int q = 0; q < W; ++q) {
      s += v[q];
      s2 += v[q] * v[q];
    }
  }
  warp_sums(s, s2);
  const float mean = s / c;
  const float var = fmaxf(s2 / c - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  Tout* yr = y + row * c;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = (32 * i + lane) * W;
    if (32 * i + lane >= nvec) continue;
    float v[W], gm[W], bt[W], o[W];
    unpack(raw[i], v);
    load_f32<W>(gamma + e, gm);
    load_f32<W>(beta + e, bt);
#pragma unroll
    for (int q = 0; q < W; ++q)
      o[q] = (v[q] - mean) * (rstd * gm[q]) + bt[q];
    store_vec<W>(yr + e, o);
  }
}

// any C: strided scalar loads, the row read twice (the second time from
// L1/L2)
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
  warp_sums(s, s2);
  const float mean = s / c;
  const float var = fmaxf(s2 / c - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  Tout* yr = y + row * c;
  for (int i = lane; i < c; i += 32) {
    const float v = ptk::to_f32(xr[i]);
    yr[i] = ptk::from_f32<Tout>((v - mean) * (rstd * gamma[i]) + beta[i]);
  }
}

struct Launch {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  long n_rows;
  int c;
  float eps;
  cudaStream_t stream;
  dim3 grid() const {
    return dim3((unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  }
};

// rows that one wave of `kern` holds on the current device: its resident
// blocks an SM (a property of the kernel and the architecture, the same on
// every card the library is built for, so queried once) times the SMs
// times the rows a block; 0 on an error
template <auto kern>
long rows_per_wave() {
  static const int blocks = [] {
    int b = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &b, kern, kWarpsPerBlock * 32, 0) == cudaSuccess
               ? b
               : 0;
  }();
  return (long)blocks * ptk::sm_count() * kWarpsPerBlock;
}

template <typename Tin, typename Tout>
int launch_scalar(const Launch& l) {
  layer_norm_rows_kernel<Tin, Tout>
      <<<l.grid(), kWarpsPerBlock * 32, 0, l.stream>>>(
          static_cast<const Tin*>(l.x), l.gamma, l.beta,
          static_cast<Tout*>(l.y), l.n_rows, l.c, l.eps);
  return (int)cudaGetLastError();
}

// the vector kernel with V = v (1 <= v <= kMaxVecs), or the scalar kernel
// where f32 rows fit its one wave and would spill less than half a wave
// of the vector kernel's into a second
template <typename Tin, typename Tout, int V = 1>
int launch_vec(const Launch& l, int v) {
  if constexpr (V > kMaxVecs) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (v != V) return launch_vec<Tin, Tout, V + 1>(l, v);
    if constexpr (sizeof(Tin) == 4) {
      constexpr auto vec_kern = layer_norm_rows_vec_kernel<Tin, Tout, V>;
      const long vec = rows_per_wave<vec_kern>();
      const long scalar = rows_per_wave<layer_norm_rows_kernel<Tin, Tout>>();
      if (l.n_rows > vec && l.n_rows <= scalar && 2 * (l.n_rows - vec) < vec)
        return launch_scalar<Tin, Tout>(l);
    }
    layer_norm_rows_vec_kernel<Tin, Tout, V>
        <<<l.grid(), kWarpsPerBlock * 32, 0, l.stream>>>(
            static_cast<const Tin*>(l.x), l.gamma, l.beta,
            static_cast<Tout*>(l.y), l.n_rows, l.c, l.eps);
    return (int)cudaGetLastError();
  }
}

template <typename Tin, typename Tout>
int launch(const Launch& l) {
  constexpr int W = 16 / sizeof(Tin);
  const int vecs = (l.c / W + 31) / 32;  // a lane
  if (l.c > 0 && l.c % W == 0 && vecs <= kMaxVecs)
    return launch_vec<Tin, Tout>(l, vecs);
  return launch_scalar<Tin, Tout>(l);
}

}  // namespace

// x: (n_rows, c) of in_dtype; gamma, beta: (c,) f32; y: (n_rows, c) of
// out_dtype; pointers 16-byte aligned.
extern "C" int ptk_layer_norm_rows(const void* x, const void* gamma,
                                   const void* beta, void* y, long n_rows,
                                   int c, float eps, int in_dtype,
                                   int out_dtype, void* stream) {
  if (n_rows == 0) return (int)cudaGetLastError();
  const Launch l{x, static_cast<const float*>(gamma),
                 static_cast<const float*>(beta), y, n_rows, c, eps,
                 static_cast<cudaStream_t>(stream)};
  if (in_dtype == ptk::kF32 && out_dtype == ptk::kF32)
    return launch<float, float>(l);
  if (in_dtype == ptk::kF32 && out_dtype == ptk::kBF16)
    return launch<float, bf16>(l);
  if (in_dtype == ptk::kBF16 && out_dtype == ptk::kF32)
    return launch<bf16, float>(l);
  if (in_dtype == ptk::kBF16 && out_dtype == ptk::kBF16)
    return launch<bf16, bf16>(l);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
