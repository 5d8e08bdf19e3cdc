// K4 relpos_patch_attention: ViTDet attention with the decomposed
// relative-position bias, read straight from a packed qkv buffer.
//
// Replaces protosam_tpu/ops/vitdet_flash.py `_global_packed_kernel` (:264,
// its pallas_call :344) and `_window_packed_flat_kernel` (:478, its
// pallas_call :557).  Over every square P x P patch of qkv (B, Hp, Wp, 3C)
// (P = 14 windows of the window-padded grid, or P = H = W for the global
// layers), per head:
//   out[q] = softmax_k(scale * q.k + bias_h[q, row(k)] + bias_w[q, col(k)]) v
// over all P^2 keys of q's patch, with the compact per-query bias
// (B, Hp, Wp, nh * 2P) laid out [bias_h(P) | bias_w(P)] per head.  Window
// pad tokens take part as keys, as in the reference.
//
// What bounds it on an H100 (tools/roofline.py `_relpos_patch_attention`):
// the global geometry (P = 64, 4096 keys per query) by operations, 4 * hd
// flops per score on the bf16 tensor cores; the windowed one (196 keys) by
// bytes, each qkv, bias and output element moved once.
//
// The design, FlashAttention-2 style on mma.sync:
// - A block owns 64 query rows of one (patch, head); each of its 4 warps
//   owns 16 rows end to end.  Where the registers allow, three blocks share
//   an SM, so other warps' products hide a warp's softmax and loads.  Q is scaled by `scale` in f32, rounded to bf16
//   (as the JAX kernels do) and kept as mma A fragments for the whole loop.
// - S = Q K^T runs on mma.sync.m16n8k16 (bf16 in, f32 accumulate) with K
//   read by ldmatrix; the 16 x 64 scores stay in registers.  The bias is
//   added inside those accumulator fragments.  At P = 64 a key tile is one
//   key row: bias_h is one value per query row per tile and bias_w, a
//   function of the column only, sits in registers for the whole loop.
//   Other P read row(k) and col(k) from a per-block table built once, so
//   the key loop does no integer division; keys past P^2 (the ragged last
//   tile of a window, 196 = 3 * 64 + 4) point at a -inf bias column.
// - The online softmax (running max and sum in f32) reduces across the
//   four lanes of a quad with shuffles; P is rounded to bf16 and repacked
//   in place as A fragments of P V (two n8 score tiles are one k16
//   fragment), and the row sum adds the rounded weights that PV uses.  V is
//   read by ldmatrix.trans; O is accumulated in registers and written once.
// - K and V tiles load through a two-stage cp.async ring (16 bytes a copy,
//   zero-filled past hd and past the patch): tile kt + 1 is in flight
//   while tile kt's products run, with one __syncthreads per tile.  Rows
//   are padded by 16 bytes so ldmatrix reads without bank conflicts.
// f32 inputs (the parity type) take attention.cu's CUDA-core instantiation.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace ptk {
int relpos_attention_f32(const void* qkv, const void* bias, void* out, int b,
                         int hp, int wp, int nh, int hd, int patch,
                         float scale, cudaStream_t stream);
}  // namespace ptk

namespace {

using namespace ptk;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kKeys = 64;           // keys per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTileP = 64;  // the patch whose key rows are the key tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* qkv;
  const bf16* bias;
  bf16* out;
  int hp, wp, nh, hd, patch, nwy, nwx;
  float scale;
};

// Dynamic shared memory: the Q tile (kRows rows), two K and two V stages
// (64 rows each), all of DP + 8 bf16; the block's bias rows (kRows x
// (2P + 2) bf16, the last two columns -inf and 0); and for P != 64 the
// per-token tables (token offset, bias columns) of the padded patch.
__host__ __device__ constexpr int padded_tokens(int patch) {
  return (patch * patch + kRows - 1) / kRows * kRows;
}

template <int DP>
size_t smem_bytes(int patch, bool rowtile) {
  return sizeof(bf16) * (kRows + 4 * kKeys) * (DP + 8) +
         sizeof(bf16) * kRows * (2 * patch + 2) +
         (rowtile ? 0
                  : (size_t)padded_tokens(patch) *
                        (sizeof(int) + sizeof(uint32_t)));
}

// Blocks per SM the registers must allow: three (168 registers a thread)
// wherever ptxas fits the kernel in that without spills; the P = 64 kernel
// at hd 64 and 80 keeps bias_w in registers too and needs more.
template <int DP, bool ROWTILE>
constexpr int min_blocks() {
  return ROWTILE && DP >= 64 ? 1 : 3;
}

// grid: (ceil(P^2 / kRows) query tiles, nh, batch * patches)
template <int DP, bool ROWTILE>
__global__ void __launch_bounds__(kThreads, (min_blocks<DP, ROWTILE>()))
    relpos_kernel(Args a) {
  constexpr int LD = DP + 8;       // bf16 row pitch of Q/K/V tiles
  constexpr int kChunks = DP / 8;  // 16-byte copies per row
  static_assert(kRows % kKeys == 0, "query tiles cover key tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRows * LD;  // stages 0 and 1
  bf16* vs = ks + 2 * kKeys * LD;
  bf16* bs = vs + 2 * kKeys * LD;

  const int patch = ROWTILE ? kRowTileP : a.patch;
  const int lb = 2 * patch + 2;  // bf16 pitch of the bias rows
  const int n_k = patch * patch;
  const int n_tiles = (n_k + kKeys - 1) / kKeys;
  int* ktok = reinterpret_cast<int*>(bs + kRows * lb);
  uint32_t* kbias = reinterpret_cast<uint32_t*>(ktok + padded_tokens(patch));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row and column
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int per_img = a.nwy * a.nwx;
  const int img = blockIdx.z / per_img;
  const int wy = blockIdx.z % per_img / a.nwx, wx = blockIdx.z % a.nwx;
  const long c = (long)a.nh * a.hd;
  const int two_p = 2 * patch;
  // token index of the patch's first token
  const long origin =
      ((long)img * a.hp + (long)wy * patch) * a.wp + (long)wx * patch;
  const bf16* qkv = a.qkv + origin * 3 * c;

  if constexpr (!ROWTILE) {
    // per key: its token offset from the origin, and its bias_h and bias_w
    // columns; keys past P^2 take the -inf and 0 columns
    for (int t = tid; t < padded_tokens(patch); t += kThreads) {
      const bool ok = t < n_k;
      const int r = ok ? t / patch : 0, col = ok ? t % patch : 0;
      ktok[t] = r * a.wp + col;
      kbias[t] = ok ? (uint32_t)r | (uint32_t)(patch + col) << 16
                    : (uint32_t)two_p | (uint32_t)(two_p + 1) << 16;
    }
    __syncthreads();
  }
  // token offset of patch token t from the origin
  auto tok = [&](int t) -> long {
    if constexpr (ROWTILE)
      return (long)(t >> 6) * a.wp + (t & 63);
    else
      return ktok[t];
  };
  // tokens [t0, t0 + rows) of channels [chan, chan + hd) into a tile
  auto load_tile = [&](bf16* dst, int t0, long chan, int rows) {
#pragma unroll 4
    for (int idx = tid; idx < rows * kChunks; idx += kThreads) {
      const int r = idx / kChunks, d0 = idx % kChunks * 8;
      const int t = t0 + r;
      const bool ok = t < n_k && d0 < a.hd;
      const bf16* src = ok ? qkv + tok(t) * 3 * c + chan + d0 : a.qkv;
      cp_async16(smem_u32(dst + r * LD + d0), src, ok);
    }
  };

  load_tile(qs, q0, (long)h * a.hd, kRows);
  load_tile(ks, 0, c + (long)h * a.hd, kKeys);
  load_tile(vs, 0, 2 * c + (long)h * a.hd, kKeys);
  cp_async_commit();
  // the block's bias rows, two bf16 a copy, while Q and the first K/V
  // tile are in flight; rows past the patch are 0
  const uint32_t sentinel = pack_bf16(-INFINITY, 0.f);
  for (int idx = tid; idx < kRows * (patch + 1); idx += kThreads) {
    const int r = idx / (patch + 1), j = idx % (patch + 1);
    const int t = q0 + r;
    uint32_t v = 0u;
    if (j == patch)
      v = sentinel;
    else if (t < n_k)
      v = reinterpret_cast<const uint32_t*>(
          a.bias + (origin + tok(t)) * a.nh * two_p + h * two_p)[j];
    reinterpret_cast<uint32_t*>(bs + r * lb)[j] = v;
  }
  cp_async_wait_all();
  __syncthreads();

  // this warp's Q as A fragments, times scale, rounded to bf16
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldsm_x4(qf[kk], smem_u32(qs + (16 * warp + (lane & 15)) * LD + 16 * kk +
                             (lane >> 4) * 8));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(qf[kk][i]);
      qf[kk][i] = pack_bf16(f.x * a.scale, f.y * a.scale);
    }
  }
  // this thread's two rows: g and g + 8 of the warp's 16
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const bf16* b0 = bs + r0 * lb;
  const bf16* b1 = bs + r1 * lb;
  // P = 64: bias_w at this thread's score columns, the same in every tile
  uint32_t bw[ROWTILE ? 8 : 1][2];
  if constexpr (ROWTILE) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bw[j][0] = *reinterpret_cast<const uint32_t*>(b0 + patch + 8 * j +
                                                    2 * t4);
      bw[j][1] = *reinterpret_cast<const uint32_t*>(b1 + patch + 8 * j +
                                                    2 * t4);
    }
  }

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt > 0) {  // tile kt has landed; every warp is done with kt - 1
      cp_async_wait_all();
      __syncthreads();
    }
    if (kt + 1 < n_tiles) {  // prefetch tile kt + 1 into the other stage
      const int st = (kt + 1) & 1;
      load_tile(ks + st * kKeys * LD, (kt + 1) * kKeys, c + (long)h * a.hd,
                kKeys);
      load_tile(vs + st * kKeys * LD, (kt + 1) * kKeys,
                2 * c + (long)h * a.hd, kKeys);
    }
    cp_async_commit();
    const bf16* kst = ks + (kt & 1) * kKeys * LD;
    const bf16* vst = vs + (kt & 1) * kKeys * LD;

    // S = (q * scale) K^T: 8 n-tiles of 8 keys, in registers
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(kst + (16 * jp + (lane >> 4) * 8 + (lane & 7)) *
                                      LD +
                            16 * kk + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // + bias_h[q, row(k)] + bias_w[q, col(k)], in the fragments
    if constexpr (ROWTILE) {
      const float bh0 = __bfloat162float(b0[kt]);
      const float bh1 = __bfloat162float(b1[kt]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 w0 = unpack_bf16(bw[j][0]), w1 = unpack_bf16(bw[j][1]);
        s[j][0] += bh0 + w0.x;
        s[j][1] += bh0 + w0.y;
        s[j][2] += bh1 + w1.x;
        s[j][3] += bh1 + w1.y;
      }
    } else {
      const uint32_t* tab = kbias + kt * kKeys + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t ix = tab[8 * j + e];
          const uint32_t lo = ix & 0xffffu, hi = ix >> 16;
          s[j][e] += __bfloat162float(b0[lo]) + __bfloat162float(b0[hi]);
          s[j][2 + e] += __bfloat162float(b1[lo]) + __bfloat162float(b1[hi]);
        }
      }
    }

    // online softmax: running max and sum per row, in f32
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2_approx((m0 - mx0) * kLog2e);
    const float alpha1 = exp2_approx((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * kLog2e, mb1 = mx1 * kLog2e;
    // p = exp(s - m) rounded to bf16, repacked as the A fragments of P V:
    // k-step kk covers keys 16 kk .. 16 kk + 15, n-tiles 2 kk and 2 kk + 1
    uint32_t pa[4][4];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t p01 =
          pack_bf16(exp2_approx(fmaf(s[j][0], kLog2e, -mb0)),
                    exp2_approx(fmaf(s[j][1], kLog2e, -mb0)));
      const uint32_t p23 =
          pack_bf16(exp2_approx(fmaf(s[j][2], kLog2e, -mb1)),
                    exp2_approx(fmaf(s[j][3], kLog2e, -mb1)));
      const float2 f01 = unpack_bf16(p01), f23 = unpack_bf16(p23);
      ls0 += f01.x + f01.y;  // the weights PV really uses
      ls1 += f23.x + f23.y;
      pa[j >> 1][(j & 1) * 2] = p01;
      pa[j >> 1][(j & 1) * 2 + 1] = p23;
    }
    l0 = l0 * alpha0 + ls0;  // per-thread partial sums, reduced at the end
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V, V read transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_u32(vst +
                                  (16 * kk + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * LD +
                                  16 * np + (lane >> 4) * 8));
        mma_bf16(o[2 * np], pa[kk], b[0], b[1]);
        mma_bf16(o[2 * np + 1], pa[kk], b[2], b[3]);
      }
    }
  }

  // O / l as bf16 into this warp's own rows of the Q tile, then out in
  // 16-byte rows
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(qs + r0 * LD + 8 * n + 2 * t4) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(qs + r1 * LD + 8 * n + 2 * t4) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = 16 * warp + idx / kChunks, d0 = idx % kChunks * 8;
    const int t = q0 + r;
    if (t < n_k && d0 < a.hd)
      *reinterpret_cast<uint4*>(a.out + (origin + tok(t)) * c +
                                (long)h * a.hd + d0) =
          *reinterpret_cast<const uint4*>(qs + r * LD + d0);
  }
}

template <int DP, bool ROWTILE>
int launch(const Args& a, int n_patches, cudaStream_t st) {
  const size_t smem = smem_bytes<DP>(a.patch, ROWTILE);
  auto kern = relpos_kernel<DP, ROWTILE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.patch * a.patch + kRows - 1) / kRows, a.nh, n_patches);
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool ROWTILE>
int dispatch_dp(const Args& a, int n_patches, cudaStream_t st) {
  switch ((a.hd + 15) / 16 * 16) {
    case 16: return launch<16, ROWTILE>(a, n_patches, st);
    case 32: return launch<32, ROWTILE>(a, n_patches, st);
    case 48: return launch<48, ROWTILE>(a, n_patches, st);
    case 64: return launch<64, ROWTILE>(a, n_patches, st);
    case 80: return launch<80, ROWTILE>(a, n_patches, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: (b, hp, wp, 3 * nh * hd); bias: (b, hp, wp, nh * 2 * patch);
// out: (b, hp, wp, nh * hd); hp and wp multiples of patch, patch <= 64, hd
// a multiple of 8 up to 80, pointers 16-byte aligned.  bf16 takes the
// kernel above, f32 attention.cu's.
extern "C" int ptk_relpos_patch_attention(const void* qkv, const void* bias,
                                          void* out, int b, int hp, int wp,
                                          int nh, int hd, int patch,
                                          float scale, int dtype,
                                          void* stream) {
  if (b == 0 || hp == 0 || wp == 0) return (int)cudaGetLastError();
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == ptk::kF32)
    return ptk::relpos_attention_f32(qkv, bias, out, b, hp, wp, nh, hd,
                                     patch, scale, st);
  if (dtype != ptk::kBF16 || patch > kRowTileP)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.qkv = static_cast<const bf16*>(qkv);
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.hp = hp;
  a.wp = wp;
  a.nh = nh;
  a.hd = hd;
  a.patch = patch;
  a.nwy = hp / patch;
  a.nwx = wp / patch;
  a.scale = scale;
  const int n_patches = b * a.nwy * a.nwx;
  return patch == kRowTileP ? dispatch_dp<true>(a, n_patches, st)
                            : dispatch_dp<false>(a, n_patches, st);
}
