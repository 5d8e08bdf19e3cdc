// K2 packed_masked_attention in f32 and with bf16 scores, and K4
// relpos_patch_attention in f32: one online-softmax attention core read
// straight from a packed qkv buffer.  The bf16 kernels the main path runs
// are packed_attention.cu (K2) and relpos_attention.cu (K4); their C
// entries take the instantiations here (packed_attention_f32_or_bf16_scores,
// relpos_attention_f32).
//
// K2 replaces protosam_tpu/ops/attention.py `_packed_aug_kernel` (:161,
// the default of `_masked_flash_packed`; its alternatives
// `_packed_grid_kernel` :225 and `_packed_kernel` :110 compute the same).
// DINOv2 multi-head attention over qkv (B, S, 3C) in channel order
// (3, heads, hd); keys at index >= n_valid are excluded; output (B, S, C).
//
// K4 replaces protosam_tpu/ops/vitdet_flash.py
// `_window_packed_flat_kernel` (:478) and `_global_packed_kernel` (:264).
// ViTDet attention over square P x P patches of a packed qkv
// (B, Hp, Wp, 3C): P = 14 for the windowed layers (on the window-padded
// grid), P = H = W for the global ones.  score[q, k] = scale * q.k +
// bias_h[q, row(k)] + bias_w[q, col(k)], with the compact per-query bias
// (B, Hp, Wp, nh * 2P) laid out [bias_h(P) | bias_w(P)] per head.  All P^2
// keys take part: window-pad tokens carry the qkv bias and are not masked,
// as in the reference.
//
// Bound on the card: the two products per key tile (2 * 64 * 64 * hd
// flops) against one 64 x hd tile of K and of V read per block; at hd 64
// this is compute-heavy enough for the tensor cores (K2 with bf16 scores;
// the f32 parity instantiations run on the CUDA cores).  The TPU kernels kept
// the whole (S, S) f32 score block in VMEM; a Hopper block has at most
// 227 KB of shared memory, so this core streams 64-key tiles with a
// running max and sum in f32 (flash attention), and nothing quadratic
// reaches device memory.  Each block owns 64 query rows of one head; each
// of its 4 warps owns 16 rows end to end (products, softmax, output), so
// only the K/V tile loads need block barriers.  Q, K and V are read by
// stride from the packed buffer: no head-split copy exists.  bf16 products
// run on the tensor cores through nvcuda::wmma (mma.sync, 16x16x16, f32
// accumulate); f32 inputs take exact f32 FMAs on the CUDA cores.  hd is
// zero-padded to a multiple of 16 in shared memory (40 -> 48).
//
// The bf16-score instantiation of K2 (SCORE_BF16, taken by
// ptk_packed_masked_attention with score_bf16 set) is the port of variant v3 of
// tools/microbench_attn.py `build` (:149, `_v2_kernel` with bf16 scores):
// q is pre-scaled and rounded to bf16, each score is rounded to bf16 after
// the product, and p = exp(s - m) is taken on the bf16 difference and
// rounded to bf16.  The running max, the rescale and the output sums stay
// f32, so the online form differs from v3's one pass only at the bf16
// level.  Only bf16 inputs take it; the main path never does.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct AttnArgs {
  const void* qkv;
  const void* bias;  // K4 only
  void* out;
  int n_q;    // queries per sequence (K2: S) or patch (K4: P*P)
  int n_k;    // keys that take part (K2: n_valid; K4: P*P)
  int c;      // model width = nh * hd
  int hd;
  int nh;
  float scale;
  int seq;    // K2: S
  int hp, wp, patch, nwy, nwx;  // K4 geometry
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <typename T, int DP>
struct Layout {
  static constexpr int LD = DP + 8;                        // Q/K/V rows
  static constexpr int LS = (DP > kBK ? DP : kBK) + 4;     // f32 scratch
  static constexpr int LP = kBK + 8;                       // P rows
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(sizeof(T) * kBQ * LD);
  static constexpr size_t v_off = k_off + align128(sizeof(T) * kBK * LD);
  static constexpr size_t s_off = v_off + align128(sizeof(T) * kBK * LD);
  static constexpr size_t p_off = s_off + align128(sizeof(float) * kBQ * LS);
  static constexpr size_t bias_off = p_off + align128(sizeof(T) * kBQ * LP);
  static size_t bytes(int patch) {
    return bias_off + sizeof(float) * kBQ * 2 * patch;
  }
};

// Row (token) index of token t of the sequence / patch this block serves.
template <bool RELPOS>
__device__ __forceinline__ long token_row(const AttnArgs& a, int t, int z) {
  if constexpr (RELPOS) {
    const int per_img = a.nwy * a.nwx;
    const int b = z / per_img, wy = (z % per_img) / a.nwx, wx = z % a.nwx;
    const int y = wy * a.patch + t / a.patch;
    const int x = wx * a.patch + t % a.patch;
    return ((long)b * a.hp + y) * a.wp + x;
  } else {
    return (long)z * a.seq + t;
  }
}

// 64 token rows [t0, t0 + 64) of channels [chan, chan + hd) into smem,
// zero-filled past `limit` tokens and past hd columns (up to DP).
template <typename T, int DP, bool RELPOS>
__device__ __forceinline__ void load_rows(T* dst, const AttnArgs& a, int t0,
                                          int limit, int chan, int z) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = DP / kVec;
  constexpr int LD = Layout<T, DP>::LD;
  const T* qkv = static_cast<const T*>(a.qkv);
  for (int idx = threadIdx.x; idx < kBK * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int d0 = (idx % kVecPerRow) * kVec;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < limit && d0 < a.hd) {
      const T* src = qkv + token_row<RELPOS>(a, t, z) * 3L * a.c + chan + d0;
      val = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + d0) = val;
  }
}

// This warp's 16 rows of S = Q K^T (f32) into the scratch buffer.
template <typename T, int DP>
__device__ __forceinline__ void warp_qk(const T* qs, const T* ks, float* ss,
                                        int warp, int lane) {
  using L = Layout<T, DP>;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int k0 = 0; k0 < DP; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, qs + (16 * warp) * L::LD + k0, L::LD);
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, ks + (16 * n) * L::LD + k0, L::LD);
        wmma::mma_sync(acc[n], af, bf, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n)
      wmma::store_matrix_sync(ss + (16 * warp) * L::LS + 16 * n, acc[n],
                              L::LS, wmma::mem_row_major);
  } else {
    const int row = 16 * warp + (lane >> 1);
    const int c0 = (lane & 1) * (kBK / 2);
    float acc[kBK / 2];
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) acc[j] = 0.f;
    for (int d = 0; d < DP; ++d) {
      const float q = qs[row * L::LD + d];
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j)
        acc[j] = fmaf(q, ks[(c0 + j) * L::LD + d], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) ss[row * L::LS + c0 + j] = acc[j];
  }
}

// This warp's 16 rows of P V (f32) into the scratch buffer.
template <typename T, int DP>
__device__ __forceinline__ void warp_pv(const T* ps, const T* vs, float* ss,
                                        int warp, int lane) {
  using L = Layout<T, DP>;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DP / 16];
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, ps + (16 * warp) * L::LP + k0, L::LP);
#pragma unroll
      for (int n = 0; n < DP / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, vs + k0 * L::LD + 16 * n, L::LD);
        wmma::mma_sync(acc[n], af, bf, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < DP / 16; ++n)
      wmma::store_matrix_sync(ss + (16 * warp) * L::LS + 16 * n, acc[n],
                              L::LS, wmma::mem_row_major);
  } else {
    const int row = 16 * warp + (lane >> 1);
    const int d0 = (lane & 1) * (DP / 2);
    float acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
    for (int k = 0; k < kBK; ++k) {
      const float p = ps[row * L::LP + k];
#pragma unroll
      for (int j = 0; j < DP / 2; ++j)
        acc[j] = fmaf(p, vs[k * L::LD + d0 + j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) ss[row * L::LS + d0 + j] = acc[j];
  }
}

// round an f32 to the nearest bf16 and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// grid: (ceil(n_q / 64), nh, z) with z = batch (K2) or batch * patches (K4)
template <typename T, int DP, bool RELPOS, bool SCORE_BF16 = false>
__global__ void __launch_bounds__(kThreads) attention_kernel(AttnArgs a) {
  static_assert(!SCORE_BF16 || (std::is_same<T, bf16>::value && !RELPOS),
                "bf16 scores: K2 on bf16 inputs only");
  using L = Layout<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* ps = reinterpret_cast<T*>(smem + L::p_off);
  float* bias_s = reinterpret_cast<float*>(smem + L::bias_off);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int two_p = 2 * a.patch;

  load_rows<T, DP, RELPOS>(qs, a, q0, a.n_q, h * a.hd, z);
  if constexpr (SCORE_BF16) {  // q * scale, rounded to bf16 (v3)
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBQ * DP; idx += kThreads) {
      T* e = qs + (idx / DP) * L::LD + idx % DP;
      *e = ptk::from_f32<T>(ptk::to_f32(*e) * a.scale);
    }
  }
  if constexpr (RELPOS) {
    const T* bias = static_cast<const T*>(a.bias);
    for (int idx = threadIdx.x; idx < kBQ * two_p; idx += kThreads) {
      const int r = idx / two_p, j = idx % two_p;
      const int t = q0 + r;
      bias_s[idx] = t < a.n_q
          ? ptk::to_f32(bias[token_row<RELPOS>(a, t, z) * a.nh * two_p +
                             h * two_p + j])
          : 0.f;
    }
  }

  // lane pair (2r, 2r+1) owns row r of this warp's 16: 32 score columns
  // and DP/2 output columns each
  const int row = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  float o[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  const int n_tiles = (a.n_k + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // previous tile's K/V reads are done
    load_rows<T, DP, RELPOS>(ks, a, kt * kBK, a.n_k, a.c + h * a.hd, z);
    load_rows<T, DP, RELPOS>(vs, a, kt * kBK, a.n_k, 2 * a.c + h * a.hd, z);
    __syncthreads();

    warp_qk<T, DP>(qs, ks, ss, warp, lane);
    __syncwarp();

    float* srow = ss + row * L::LS;
    float mx = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < kBK / 2; ++j) {
      const int col = half * (kBK / 2) + j;
      const int key = kt * kBK + col;
      float s = -INFINITY;
      if (key < a.n_k) {
        if constexpr (SCORE_BF16) {
          s = round_bf16(srow[col]);  // q carries the scale
        } else {
          s = srow[col] * a.scale;
          if constexpr (RELPOS)
            s += bias_s[row * two_p + key / a.patch] +
                 bias_s[row * two_p + a.patch + key % a.patch];
        }
      }
      srow[col] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
    float lsum = 0.f;
#pragma unroll 8
    for (int j = 0; j < kBK / 2; ++j) {
      const int col = half * (kBK / 2) + j;
      const float s = srow[col];
      const float d = SCORE_BF16 ? round_bf16(s - m_new) : s - m_new;
      const T p = ptk::from_f32<T>(s == -INFINITY ? 0.f : expf(d));
      ps[row * L::LP + col] = p;
      lsum += ptk::to_f32(p);  // normalise by the weights PV really uses
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l_run = l_run * alpha + lsum;
    m_run = m_new;
    __syncwarp();

    warp_pv<T, DP>(ps, vs, ss, warp, lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP / 2; ++j)
      o[j] = o[j] * alpha + srow[half * (DP / 2) + j];
    __syncwarp();
  }

  const int t = q0 + row;
  if (t >= a.n_q) return;
  const float inv = 1.f / l_run;
  T* out = static_cast<T*>(a.out) + token_row<RELPOS>(a, t, z) * a.c +
           h * a.hd + half * (DP / 2);
#pragma unroll
  for (int j = 0; j < DP / 2; ++j)
    if (half * (DP / 2) + j < a.hd) out[j] = ptk::from_f32<T>(o[j] * inv);
}

template <typename T, int DP, bool RELPOS, bool SCORE_BF16>
int launch(const AttnArgs& a, dim3 grid, cudaStream_t st) {
  const size_t smem = Layout<T, DP>::bytes(RELPOS ? a.patch : 0);
  auto kern = attention_kernel<T, DP, RELPOS, SCORE_BF16>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool RELPOS, bool SCORE_BF16 = false>
int dispatch_dp(const AttnArgs& a, dim3 grid, cudaStream_t st) {
  switch ((a.hd + 15) / 16 * 16) {
    case 32: return launch<T, 32, RELPOS, SCORE_BF16>(a, grid, st);
    case 48: return launch<T, 48, RELPOS, SCORE_BF16>(a, grid, st);
    case 64: return launch<T, 64, RELPOS, SCORE_BF16>(a, grid, st);
    case 80: return launch<T, 80, RELPOS, SCORE_BF16>(a, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

AttnArgs packed_args(const void* qkv, void* out, int s, int nh, int hd,
                     int n_valid, float scale) {
  AttnArgs a{};
  a.qkv = qkv;
  a.out = out;
  a.n_q = s;
  a.n_k = n_valid;
  a.c = nh * hd;
  a.hd = hd;
  a.nh = nh;
  a.scale = scale;
  a.seq = s;
  return a;
}

}  // namespace

namespace ptk {

// K2's CUDA-core f32 instantiation (the parity type) and its bf16-score
// instantiation (score_bf16, bf16 inputs only: variant v3 of
// tools/microbench_attn.py); packed_attention.cu's
// ptk_packed_masked_attention takes them.  qkv: (b, s, 3 * nh * hd); out:
// (b, s, nh * hd); hd <= 80 and a multiple of 8 (bf16) or 4 (f32),
// pointers 16-byte aligned.
int packed_attention_f32_or_bf16_scores(const void* qkv, void* out, int b,
                                        int s, int nh, int hd, int n_valid,
                                        float scale, int dtype,
                                        int score_bf16, cudaStream_t stream) {
  const AttnArgs a = packed_args(qkv, out, s, nh, hd, n_valid, scale);
  const dim3 grid((s + kBQ - 1) / kBQ, nh, b);
  if (score_bf16)
    return dtype == kBF16 ? dispatch_dp<bf16, false, true>(a, grid, stream)
                          : (int)cudaErrorInvalidValue;
  return dtype == kF32 ? dispatch_dp<float, false>(a, grid, stream)
                       : (int)cudaErrorInvalidValue;
}

// K4's f32 instantiation, the parity type; relpos_attention.cu's
// ptk_relpos_patch_attention takes it for float32 inputs.  qkv: (b, hp, wp,
// 3 * nh * hd); bias: (b, hp, wp, nh * 2 * patch); out: (b, hp, wp, nh *
// hd); hp and wp multiples of patch, patch <= 64.
int relpos_attention_f32(const void* qkv, const void* bias, void* out, int b,
                         int hp, int wp, int nh, int hd, int patch,
                         float scale, cudaStream_t stream) {
  AttnArgs a{};
  a.qkv = qkv;
  a.bias = bias;
  a.out = out;
  a.n_q = patch * patch;
  a.n_k = patch * patch;
  a.c = nh * hd;
  a.hd = hd;
  a.nh = nh;
  a.scale = scale;
  a.hp = hp;
  a.wp = wp;
  a.patch = patch;
  a.nwy = hp / patch;
  a.nwx = wp / patch;
  const dim3 grid((patch * patch + kBQ - 1) / kBQ, nh, b * a.nwy * a.nwx);
  return dispatch_dp<float, true>(a, grid, stream);
}
}  // namespace ptk
