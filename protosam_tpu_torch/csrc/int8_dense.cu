// K8 quantize_rows and K9 int8_dense: the int8 W8A8 dense path.
//
// Replaces JAX protosam_tpu/ops/quant.py `quantize_symmetric` (:37) and
// `int8_dense` (:51), which are not Pallas kernels: XLA fuses the quantize
// into the int8 dot's operand stream and the dequant into its output.
// Here the quantize is its own kernel (K8), run once on the activations
// and once on the weight, and the dequant is the epilogue of the product
// (K9).  Both hold JAX's numerics bit for bit:
//
//   scale = max(amax(|x|), 1e-12) / 127 (f32), q = round_half_even(x / scale)
//   out   = ((f32(qa . qb) * sx[m]) * sw[n]) + bias[n], cast to the out type
//
// nvcc contracts a * b + c into one FMA by default, which rounds once where
// JAX (and the plain PyTorch version) round twice; so every step is an
// explicitly rounded intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn,
// __int2float_rn, __float2int_rn).
//
// K8: bound by device memory (one read, a quarter or half the bytes
// written).  One warp a row: each lane loads its share of the row as
// 16-byte vectors into registers, once (V vectors a lane, a template
// parameter), the amax is a shuffle reduction, and the codes go out from
// the same registers.  The weight takes the same kernel: nn.Linear's (N, K)
// rows are its output channels, JAX's per-channel scale of the (K, N)
// kernel.  Rows longer than kMaxVecs vectors a lane (f32 weights at K >=
// 3072) or not a whole number of vectors take a loop kernel that reads the
// row a second time (from L1/L2) for the codes.
//
// K9: A (M, K) and B (N, K) int8, both K-major as they stand, the layout
// the 8-bit tensor-core instructions take.  mma.sync m16n8k32 s8 x s8 ->
// s32, 128 x 128 block tiles over 8 warps (2 x 4, 64 x 32 each), a K step
// of 64 bytes through a two-stage cp.async ring; rows padded to 80 bytes so
// ldmatrix reads are free of bank conflicts.  The accumulator is exact:
// |sum| <= K * 127^2 < 2^31 for K < 133,000.  The rank-1 dequant, the bias
// and the cast run in the epilogue, masked to M and N.  K must be a
// multiple of 16 (16-byte copies; the wrapper raises otherwise).  A simple
// kernel: wgmma, TMA and a persistent schedule are later work.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ K8

constexpr int kQuantWarps = 8;  // rows a block
constexpr int kMaxVecs = 20;    // a lane: bf16 K <= 5120, f32 K <= 2560

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
}

// round half to even, as jnp.round and torch.round; |x / scale| <= 127
__device__ __forceinline__ uint32_t code(float x, float scale) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fdiv_rn(x, scale));
}

// W codes (W = 4 or 8) as one 4- or 8-byte store
template <int W>
__device__ __forceinline__ void store_codes(int8_t* p, const float (&v)[W],
                                            float scale) {
  uint32_t u[W / 4];
#pragma unroll
  for (int i = 0; i < W / 4; ++i)
    u[i] = code(v[4 * i], scale) | code(v[4 * i + 1], scale) << 8 |
           code(v[4 * i + 2], scale) << 16 | code(v[4 * i + 3], scale) << 24;
  if constexpr (W == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = u[0];
}

// K a multiple of W = 16 / sizeof(Tin), K / W <= 32 V: the row read once
template <typename Tin, int V>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_vec_kernel(const Tin* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, long n_rows, int k) {
  constexpr int W = 16 / sizeof(Tin);
  const long row = (long)blockIdx.x * kQuantWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int nvec = k / W;
  const Tin* xr = x + row * k;
  uint4 raw[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    raw[i] = 32 * i + lane < nvec
                 ? *reinterpret_cast<const uint4*>(xr + (32 * i + lane) * W)
                 : make_uint4(0u, 0u, 0u, 0u);  // +0.0 in both types
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float v[W];
    unpack(raw[i], v);
#pragma unroll
    for (int j = 0; j < W; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  const float s = row_scale(warp_max(amax));
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + row * k;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (32 * i + lane >= nvec) continue;
    float v[W];
    unpack(raw[i], v);
    store_codes<W>(qr + (32 * i + lane) * W, v, s);
  }
}

// any K: strided scalar loads, the row read a second time for the codes
template <typename Tin>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_loop_kernel(const Tin* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ scale, long n_rows, int k) {
  const long row = (long)blockIdx.x * kQuantWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const Tin* xr = x + row * k;
  float amax = 0.f;
  for (int i = lane; i < k; i += 32) amax = fmaxf(amax, fabsf(ptk::to_f32(xr[i])));
  const float s = row_scale(warp_max(amax));
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + row * k;
  for (int i = lane; i < k; i += 32)
    qr[i] = (int8_t)__float2int_rn(__fdiv_rn(ptk::to_f32(xr[i]), s));
}

template <typename Tin, int V>
int launch_quant_vec(const Tin* x, int8_t* q, float* scale, long n_rows,
                     int k, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_rows + kQuantWarps - 1) / kQuantWarps));
  quantize_rows_vec_kernel<Tin, V>
      <<<grid, kQuantWarps * 32, 0, stream>>>(x, q, scale, n_rows, k);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch_quant(const void* xv, int8_t* q, float* scale, long n_rows, int k,
                 cudaStream_t stream) {
  const Tin* x = static_cast<const Tin*>(xv);
  constexpr int W = 16 / sizeof(Tin);
  const int vecs = (k / W + 31) / 32;  // a lane
  if (k % W == 0) {
    // the smallest instantiation that holds the row
    if (vecs <= 1) return launch_quant_vec<Tin, 1>(x, q, scale, n_rows, k, stream);
    if (vecs <= 2) return launch_quant_vec<Tin, 2>(x, q, scale, n_rows, k, stream);
    if (vecs <= 3) return launch_quant_vec<Tin, 3>(x, q, scale, n_rows, k, stream);
    if (vecs <= 4) return launch_quant_vec<Tin, 4>(x, q, scale, n_rows, k, stream);
    if (vecs <= 5) return launch_quant_vec<Tin, 5>(x, q, scale, n_rows, k, stream);
    if (vecs <= 6) return launch_quant_vec<Tin, 6>(x, q, scale, n_rows, k, stream);
    if (vecs <= 8) return launch_quant_vec<Tin, 8>(x, q, scale, n_rows, k, stream);
    if (vecs <= 10) return launch_quant_vec<Tin, 10>(x, q, scale, n_rows, k, stream);
    if (vecs <= 12) return launch_quant_vec<Tin, 12>(x, q, scale, n_rows, k, stream);
    if (vecs <= 16) return launch_quant_vec<Tin, 16>(x, q, scale, n_rows, k, stream);
    if (vecs <= kMaxVecs)
      return launch_quant_vec<Tin, kMaxVecs>(x, q, scale, n_rows, k, stream);
  }
  const dim3 grid((unsigned)((n_rows + kQuantWarps - 1) / kQuantWarps));
  quantize_rows_loop_kernel<Tin>
      <<<grid, kQuantWarps * 32, 0, stream>>>(x, q, scale, n_rows, k);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K9

constexpr int kBM = 128, kBN = 128, kBK = 64;  // tile; K step in bytes
constexpr int kPitch = kBK + 16;  // a shared row: 80 bytes, 5 chunks
constexpr int kThreads = 256;     // 8 warps: 2 (M) x 4 (N), 64 x 32 each

// d += a b: a 16 x 32 s8 (row), b 32 x 8 s8 (col), d 16 x 8 s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw,
                                         float b, bool has_bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  return has_bias ? __fadd_rn(y, b) : y;
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads, 2)
int8_dense_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const float* __restrict__ bias, Tout* __restrict__ out,
                  int m, int n, int k) {
  __shared__ __align__(16) int8_t sa[2][kBM * kPitch];
  __shared__ __align__(16) int8_t sb[2][kBN * kPitch];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  // each thread copies two 16-byte chunks of A and two of B a stage;
  // chunks past M, N or K are zero-filled
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, kc = (c & 3) * 16;
      const bool kin = k0 + kc < k;
      const bool oka = kin && m0 + r < m, okb = kin && n0 + r < n;
      ptk::cp_async16(ptk::smem_u32(&sa[stage][r * kPitch + kc]),
                      oka ? a + (long)(m0 + r) * k + k0 + kc : a, oka);
      ptk::cp_async16(ptk::smem_u32(&sb[stage][r * kPitch + kc]),
                      okb ? b + (long)(n0 + r) * k + k0 + kc : b, okb);
    }
    ptk::cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (k + kBK - 1) / kBK;
  load(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load((t + 1) & 1, (t + 1) * kBK);
      ptk::cp_async_wait<1>();
    } else {
      ptk::cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* ta = sa[t & 1];
    const int8_t* tb = sb[t & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // A: lanes 0-15 address rows 0-15 at bytes [kk, kk + 16), lanes
      // 16-31 the same rows at [kk + 16, kk + 32): a0-a3 of m16n8k32
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ptk::ldsm_x4(af[mi], ptk::smem_u32(
            ta + (wm + mi * 16 + (lane & 15)) * kPitch + kk +
            (lane >> 4) * 16));
      // B: matrices (n 0-7, lo), (n 0-7, hi), (n 8-15, lo), (n 8-15, hi)
      uint32_t bfr[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ptk::ldsm_x4(r, ptk::smem_u32(
            tb + (wn + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * kPitch +
            kk + ((lane >> 3) & 1) * 16));
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    __syncthreads();  // the stage is free for the load after next
  }

  // epilogue: thread (g, t) of the warp holds rows g, g + 8 and columns
  // 2t, 2t + 1 of every 16 x 8 tile
  const int g = lane >> 2, tq = lane & 3;
  const bool has_bias = bias != nullptr;
  const bool pairs = n % 2 == 0;
  float swv[4][2], bv[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn + ni * 8 + 2 * tq + e;
      swv[ni][e] = col < n ? sw[col] : 0.f;
      bv[ni][e] = has_bias && col < n ? bias[col] : 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + 8 * h;
      if (row >= m) continue;
      const float sxr = sx[row];
      Tout* orow = out + (long)row * n;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * tq;
        if (col >= n) continue;
        const float v0 = dequant(acc[mi][ni][2 * h], sxr, swv[ni][0],
                                 bv[ni][0], has_bias);
        const float v1 = dequant(acc[mi][ni][2 * h + 1], sxr, swv[ni][1],
                                 bv[ni][1], has_bias);
        if (pairs) {
          store_pair(orow + col, v0, v1);
        } else {
          orow[col] = ptk::from_f32<Tout>(v0);
          if (col + 1 < n) orow[col + 1] = ptk::from_f32<Tout>(v1);
        }
      }
    }
}

}  // namespace

// x: (n_rows, k) of in_dtype; q: (n_rows, k) int8; scale: (n_rows,) f32;
// pointers 16-byte aligned.
extern "C" int ptk_quantize_rows(const void* x, void* q, void* scale,
                                 long n_rows, int k, int in_dtype,
                                 void* stream) {
  if (n_rows == 0 || k == 0) return (int)cudaGetLastError();
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == ptk::kF32) return launch_quant<float>(x, qp, sp, n_rows, k, s);
  if (in_dtype == ptk::kBF16) return launch_quant<bf16>(x, qp, sp, n_rows, k, s);
  return (int)cudaErrorInvalidValue;
}

// a: (m, k) int8; b: (n, k) int8; sx: (m,), sw: (n,), bias: (n,) f32 or
// null; out: (m, n) of out_dtype; k a multiple of 16, pointers 16-byte
// aligned.
extern "C" int ptk_int8_dense(const void* a, const void* b, const void* sx,
                              const void* sw, const void* bias, void* out,
                              int m, int n, int k, int out_dtype,
                              void* stream) {
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  if (k <= 0 || k % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kBN - 1) / kBN),
                  (unsigned)((m + kBM - 1) / kBM));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const int8_t*>(a);
  const auto* bp = static_cast<const int8_t*>(b);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  const auto* biasp = static_cast<const float*>(bias);
  if (out_dtype == ptk::kF32)
    int8_dense_kernel<float><<<grid, kThreads, 0, s>>>(
        ap, bp, sxp, swp, biasp, static_cast<float*>(out), m, n, k);
  else if (out_dtype == ptk::kBF16)
    int8_dense_kernel<bf16><<<grid, kThreads, 0, s>>>(
        ap, bp, sxp, swp, biasp, static_cast<bf16*>(out), m, n, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
