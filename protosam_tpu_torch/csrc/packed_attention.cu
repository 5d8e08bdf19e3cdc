// K2 packed_masked_attention in bf16: DINOv2 multi-head attention read
// straight from the packed qkv buffer, on Hopper's warpgroup tensor cores.
//
// Replaces protosam_tpu/ops/attention.py `_packed_aug_kernel` (:161, its
// pallas_call :268; `_packed_grid_kernel` :225 and `_packed_kernel` :110
// compute the same).  Over qkv (B, S, 3C) in channel order (3, heads, hd):
//   out[b, t, h] = softmax_k(bf16(q[b, t, h] * scale) . k[b, k, h]) v[b, k, h]
// over keys k < n_valid, for every row t < S (rows past n_valid too, as the
// JAX kernel computes them); out (B, S, C).  As in JAX (:188, :203,
// :206-210): q * scale is taken in f32 and rounded to bf16, p = exp(s - m)
// is rounded to bf16, and the normaliser sums the rounded p.
//
// What bounds it on an H100 (tools/roofline.py `_packed_masked_attention`):
// operations, 4 * hd flops per score (q.k and p.v) on the bf16 tensor
// cores.  DINOv2-L at B = 2 (S 2432, n_valid 2305, 16 heads of 64) is 45.9
// GFLOP, 0.046 ms at the peak, against 0.012 ms to move its 40 MB of qkv
// and output once.  Beside the products, the softmax costs one exp per
// score, and the SM's 16 exp a clock against 4096 bf16 flops a clock make
// the exps alone as long as the products at hd 64: the scalar work per
// score decides how close the kernel comes to the bound.
//
// The design, FlashAttention style on wgmma:
// - A block of two warpgroups (256 threads) serves 128 query rows of one
//   (batch, head); each warpgroup owns 64 rows end to end, and both share
//   every K/V tile, so a tile read from L2 feeds 128 rows.  At <= 128
//   registers two blocks share an SM, and the four warpgroups' products
//   and softmaxes overlap one another.
// - Q, K and V tiles sit in shared memory in the 128B-swizzled layout that
//   a wgmma descriptor reads (mma.cuh): hd 64 is one 128-byte row; hd below
//   64 is zero-filled to 64, hd 72 and 80 take a second 64-column panel
//   (DP = 128).  Q is scaled in f32 and rounded to bf16 in place, once.
// - S = Q K^T runs as m64n64k16 wgmma with both operands in shared memory,
//   K-major; the 64 x 64 scores stay in registers (32 a thread, in the
//   mma.sync m16n8 layout).  Only ceil(n_valid / 64) key tiles are read,
//   and only the last of them, which holds n_valid, sets its columns past
//   n_valid to -inf: the other tiles take no compare.
// - The online softmax keeps the running max in f32 and reduces it across
//   the four lanes of a quad; a warp whose rows all kept their max skips
//   the rescale of O (alpha is exactly 1).  P is rounded to bf16 and
//   repacked in place as the register A fragments of P V (two n8 score
//   tiles are one k16 fragment), which runs as register-A wgmma with V read
//   from shared memory through the descriptor's transpose (MN-major) mode.
//   The row sums are a third product, P 1 (m64n8k16 against a tile of
//   ones): the sum of the rounded p that P V uses, accumulated in f32 on the
//   tensor cores instead of two scalar ops a score.  O is written once,
//   through the warpgroup's own Q rows, in 16-byte stores.
// - K and V tiles load through a three-stage cp.async ring (16 bytes a
//   copy, zero-filled past n_valid and past hd) shared by both warpgroups:
//   tiles kt + 1 and kt + 2 are in flight while tile kt's products run, and
//   a stage is refilled only after the block barrier that follows both
//   warpgroups' last read of it.
// - Issuing S of tile kt + 1 before the softmax of tile kt (the
//   intra-warpgroup overlap of FlashAttention-3) needs a second score
//   array: at two blocks per SM it spilled, at one block it ran slower
//   than this kernel, so each warpgroup waits for its own products.
// f32 inputs (the parity type) and the bf16-score variant take
// attention.cu's CUDA-core and wmma instantiations.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace ptk {
int packed_attention_f32_or_bf16_scores(const void* qkv, void* out, int b,
                                        int s, int nh, int hd, int n_valid,
                                        float scale, int dtype,
                                        int score_bf16, cudaStream_t stream);
}  // namespace ptk

namespace {

using namespace ptk;
using bf16 = __nv_bfloat16;

constexpr int kGroups = 2;                 // warpgroups per block
constexpr int kThreads = 128 * kGroups;
constexpr int kRows = 64;                  // query rows per warpgroup
constexpr int kKeys = 64;                  // keys per tile
constexpr int kStages = 3;                 // K/V ring depth
constexpr int kPanel = 64 * 128;           // bytes of a 64 x 64 bf16 panel
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* qkv;
  bf16* out;
  int s, nh, hd, n_valid;
  float scale;
};

// Dynamic shared memory, from a 1024-byte aligned base: one Q tile per
// warpgroup, then kStages K tiles and kStages V tiles (a tile is 64 rows of
// DP / 64 panels), then 1 KB of bf16 ones, the B operand of the row sums.
// 1 KB of slack pays for the alignment.
template <int DP>
struct Smem {
  static constexpr int kPanels = DP / 64;
  static constexpr int kTile = kPanels * kPanel;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kGroups * kTile;
  static constexpr int v_off = k_off + kStages * kTile;
  static constexpr int ones_off = v_off + kStages * kTile;
  static constexpr int bytes = ones_off + 1024 + 1024;
};

// Blocks per SM the registers must allow: two (128 registers a thread) at
// DP = 64; at DP = 128 the output accumulator alone is 64 registers.
template <int DP>
constexpr int min_blocks() {
  return DP == 64 ? 2 : 1;
}

// byte offset of 16-byte chunk ci of row r in a swizzled tile of DP / 64
// panels; rows 64 and up fall in the next tile (the second warpgroup's Q)
template <int DP>
__device__ __forceinline__ uint32_t swz(int r, int ci) {
  return ((r >> 6) * (DP / 64) + (ci >> 3)) * kPanel + (r & 63) * 128 +
         (((ci & 7) ^ (r & 7)) << 4);
}

// grid: (ceil(S / 128), nh, B)
template <int DP>
__global__ void __launch_bounds__(kThreads, (min_blocks<DP>()))
    packed_kernel(Args a) {
  using L = Smem<DP>;
  constexpr int kChunks = DP / 8;  // 16-byte copies per row
  constexpr int kNt = DP / 8;      // n8 tiles of the output
  constexpr int kStep = kThreads / kChunks;  // rows between a thread's copies
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;  // warp of the group
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kGroups * kRows;
  const long c = (long)a.nh * a.hd;
  const bf16* qkv = a.qkv + (long)blockIdx.z * a.s * 3 * c;
  const int n_tiles = (a.n_valid + kKeys - 1) / kKeys;

  // Q: tokens [q0, q0 + 128) of channels [h hd, (h + 1) hd), zero-filled
  // past S and past hd
  for (int idx = tid; idx < kGroups * kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ci = idx % kChunks;
    const int t = q0 + r;
    const bool ok = t < a.s && ci * 8 < a.hd;
    cp_async16(base + L::q_off + swz<DP>(r, ci),
               ok ? qkv + t * 3 * c + (long)h * a.hd + ci * 8 : a.qkv, ok);
  }
  // K and V tile kt into stage kt % kStages: this thread copies chunk lc of
  // rows lr + i kStep, which share one swizzle column; zero-filled past
  // n_valid and past hd
  const int lr = tid / kChunks, lc = tid % kChunks;
  const bool lc_ok = lc * 8 < a.hd;
  const uint32_t l_dst = base + swz<DP>(lr, lc);
  const bf16* l_src = qkv + lr * 3 * c + c + (long)h * a.hd + lc * 8;
  auto load_kv = [&](int kt) {
    const uint32_t st = (kt % kStages) * L::kTile;
    const bf16* src = l_src + (long)kt * kKeys * 3 * c;
#pragma unroll
    for (int i = 0; i < kKeys / kStep; ++i) {
      const bool ok = lc_ok && kt * kKeys + lr + i * kStep < a.n_valid;
      const bf16* k = src + (long)i * kStep * 3 * c;
      cp_async16(l_dst + L::k_off + st + i * kStep * 128, ok ? k : a.qkv,
                 ok);
      cp_async16(l_dst + L::v_off + st + i * kStep * 128,
                 ok ? k + c : a.qkv, ok);
    }
  };

  // group 0: Q and tile 0; then tiles 1 .. kStages - 2, one group each
  load_kv(0);
  cp_async_commit();
#pragma unroll
  for (int kt = 1; kt < kStages - 1; ++kt) {
    if (kt < n_tiles) load_kv(kt);
    cp_async_commit();
  }
  // the ones of the row-sum product
  reinterpret_cast<uint2*>(smem + L::ones_off)[tid % 128] =
      make_uint2(0x3f803f80u, 0x3f803f80u);
  cp_async_wait<kStages - 2>();
  __syncthreads();
  // Q * scale in f32, rounded to bf16, in place (zero padding stays 0)
  for (int idx = tid; idx < kGroups * L::kTile / 16; idx += kThreads) {
    uint4* p = reinterpret_cast<uint4*>(smem + L::q_off) + idx;
    uint4 v = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(w[i]);
      w[i] = pack_bf16(f.x * a.scale, f.y * a.scale);
    }
    *p = v;
  }
  fence_proxy_async();
  __syncthreads();

  const uint64_t dq = wgmma_desc(base + L::q_off + wg * L::kTile, 16, 1024);
  const uint64_t dk = wgmma_desc(base + L::k_off, 16, 1024);
  const uint64_t dv = wgmma_desc(base + L::v_off, kPanel, 1024);
  const uint64_t d1 = wgmma_desc(base + L::ones_off, 16, 1024);
  // O and the row sums l (every column of l holds its row's sum) run as
  // accumulators of the P V and P 1 products
  float o[kNt * 4], l[4];
#pragma unroll
  for (int i = 0; i < kNt * 4; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt > 0) {  // tile kt has landed; both groups are done with kt - 1
      cp_async_wait<kStages - 2>();
      fence_proxy_async();
      __syncthreads();
    }
    // refill the stage that tile kt - 1 used with tile kt + kStages - 1
    if (kt + kStages - 1 < n_tiles) load_kv(kt + kStages - 1);
    cp_async_commit();
    const uint32_t st = (kt % kStages) * L::kTile >> 4;  // descriptor units

    // S = (q * scale) K^T: this warp's 16 rows x 64 keys, in registers
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = ((kk >> 2) * kPanel + (kk & 3) * 32) >> 4;
      wgmma_m64n64_ss(s, dq + off, dk + st + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the tile that holds n_valid: keys past it take no weight
    if (kt == n_tiles - 1) {
      const int rem = a.n_valid - kt * kKeys;
      if (rem < kKeys) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + 2 * t4 + e >= rem)
              s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
      }
    }

    // online softmax: running max per row (g and g + 8), in f32
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // O and l scale by exp(m_old - m_new); a warp whose rows all kept
    // their max (the common case past the first tiles) skips it: alpha is 1
    if (__any_sync(0xffffffffu, mx0 != m0 || mx1 != m1)) {
      const float alpha0 = exp2_approx((m0 - mx0) * kLog2e);
      const float alpha1 = exp2_approx((m1 - mx1) * kLog2e);
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        o[4 * n] *= alpha0;
        o[4 * n + 1] *= alpha0;
        o[4 * n + 2] *= alpha1;
        o[4 * n + 3] *= alpha1;
      }
      l[0] *= alpha0;
      l[1] *= alpha0;
      l[2] *= alpha1;
      l[3] *= alpha1;
    }
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * kLog2e, mb1 = mx1 * kLog2e;
    // p = exp(s - m) rounded to bf16, repacked as the A fragments of P V:
    // k-step kk covers keys 16 kk .. 16 kk + 15, n-tiles 2 kk and 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j >> 1][(j & 1) * 2] =
          pack_bf16(exp2_approx(fmaf(s[4 * j], kLog2e, -mb0)),
                    exp2_approx(fmaf(s[4 * j + 1], kLog2e, -mb0)));
      pa[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(exp2_approx(fmaf(s[4 * j + 2], kLog2e, -mb1)),
                    exp2_approx(fmaf(s[4 * j + 3], kLog2e, -mb1)));
    }

    // O += P V, P from registers and V (keys x hd) MN-major in shared
    // memory; l += P 1, the sum of the rounded weights that P V uses
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dvk = dv + st + ((kk * 16 * 128) >> 4);
      if constexpr (DP == 64)
        wgmma_m64n64_rs_t(o, pa[kk], dvk);
      else
        wgmma_m64n128_rs_t(o, pa[kk], dvk);
      wgmma_m64n8_rs(l, pa[kk], d1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(l);
  }

  // O / l as bf16 into this warpgroup's own Q rows (once all four warps'
  // products have read them), then out in 16-byte rows
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[2];
  unsigned char* qs = smem + L::q_off + wg * L::kTile;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    const int byte = 4 * t4;
    *reinterpret_cast<uint32_t*>(qs + swz<DP>(r0, n) + byte) =
        pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(qs + swz<DP>(r1, n) + byte) =
        pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  __syncwarp();
  bf16* out = a.out + (long)blockIdx.z * a.s * c + (long)h * a.hd;
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = 16 * warp + idx / kChunks, ci = idx % kChunks;
    const int t = q0 + wg * kRows + r;
    if (t < a.s && ci * 8 < a.hd)
      *reinterpret_cast<uint4*>(out + t * c + ci * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<DP>(r, ci));
  }
}

template <int DP>
int launch(const Args& a, int b, cudaStream_t st) {
  auto kern = packed_kernel<DP>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DP>::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.s + kGroups * kRows - 1) / (kGroups * kRows), a.nh, b);
  kern<<<grid, kThreads, Smem<DP>::bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (b, s, 3 * nh * hd); out: (b, s, nh * hd); 1 <= n_valid <= s.  hd a
// multiple of 8 up to 80 (bf16) or of 4 (f32), pointers 16-byte aligned.
// bf16 takes the kernel above; f32, and bf16 with score_bf16 set (variant
// v3 of tools/microbench_attn.py), take attention.cu's.
extern "C" int ptk_packed_masked_attention(const void* qkv, void* out, int b,
                                           int s, int nh, int hd,
                                           int n_valid, float scale,
                                           int dtype, int score_bf16,
                                           void* stream) {
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype != ptk::kBF16 || score_bf16)
    return ptk::packed_attention_f32_or_bf16_scores(
        qkv, out, b, s, nh, hd, n_valid, scale, dtype, score_bf16, st);
  if (hd > 80 || hd % 8 || n_valid < 1 || n_valid > s)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.qkv = static_cast<const bf16*>(qkv);
  a.out = static_cast<bf16*>(out);
  a.s = s;
  a.nh = nh;
  a.hd = hd;
  a.n_valid = n_valid;
  a.scale = scale;
  return hd <= 64 ? launch<64>(a, b, st) : launch<128>(a, b, st);
}
