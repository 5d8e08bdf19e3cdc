// K8 quantize_rows and K9 int8_dense: the int8 W8A8 dense path.
//
// Replaces JAX protosam_tpu/ops/quant.py `quantize_symmetric` (:37) and
// `int8_dense` (:51), which are not Pallas kernels: XLA fuses the quantize
// into the int8 dot's operand stream and the dequant into its output.
// Here the quantize of both operands is one kernel (K8), and the dequant is
// the epilogue of the product (K9).  Both hold JAX's numerics bit for bit:
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
// written).  One launch takes both operands of a layer: the blocks before
// `xs.blocks` quantize the activation rows, the rest the weight rows
// (nn.Linear's (N, K) rows are its output channels, JAX's per-channel
// scale of the (K, N) kernel).  A team of 1, 2, 4 or 8 warps holds a row in
// registers as V 16-byte vectors a lane (V = 4, or 8 where a row needs it:
// f32 rows past K = 4096), read once; the amax is a shuffle reduction, across
// a team's warps through shared memory, and the codes go out from the same
// registers.  Residency sets the rate: a lane holding 16 vectors needs
// 164 registers, one block of 8 warps an SM, and reached 38% of the bound;
// at V = 4 a thread takes at most 64 registers, four blocks an SM, and
// several warps share a long row.  The exact divide costs about a tenth
// (tools/stamp_int8.py, `reciprocal`) and stays, for JAX's bits.  Rows
// that are not a whole number of 16-byte vectors, or longer than 8 warps
// hold, take a loop kernel that reads the row a second time.
//
// K9: bound by the int8 tensor-core rate (1979 TOP/s at 700 W).  A
// persistent, warp-specialised GEMM on Hopper's s8 wgmma, built as K6
// (csrc/dense_residual.cu) is:
// - A (M, K) and B (N, K) int8 are both K-major as they stand, the only
//   layout wgmma takes for 8-bit operands.  A CTA owns 128 x 256 output
//   tiles: two consumer warpgroups of 64 rows, each issuing SS wgmma
//   m64n256k32 with a 64 x 256 s32 accumulator (128 registers a thread),
//   and one loader warp (288 threads, at most 168 registers a thread).  The
//   accumulator is exact: |sum| <= K * 127^2 < 2^31 for K < 133,000.
// - Loads: one loader thread keeps a ring of four TMA stages full, each an
//   A tile (128 rows x 128 codes, 16 KB) and a B tile (256 x 128, 32 KB),
//   128B-swizzled, with a full and an empty mbarrier a stage (arrivals
//   release at CTA scope).  A consumer warpgroup keeps one stage's products
//   in flight and frees the stage before once they complete.  TMA fills
//   rows past M or N and columns past K with zeros.
// - Persistent grid: min(tiles, SMs) CTAs; CTA b takes tiles b, b + G, ...,
//   numbered column index fastest, so a row block's column tiles run in one
//   wave and B stays in L2.  The ring's phases carry across tiles, so the
//   loader runs into the next tile while the consumers write out the last.
// - Epilogue: the loader warp also copies each tile's sw and bias (256
//   each, f32) into a double-buffered shared tile before its k-tiles, and
//   the consumers load their rows' sx before the products, so the epilogue
//   reads no global memory.  Each thread holds column pairs of the wgmma D
//   fragments; a warp writes its 16 rows, dequantized and cast, 128 bytes
//   a row at a time into a staging tile of its own, reads them back as
//   16-byte vectors and stores whole 128-byte lines, masked to M and N (a
//   vector that crosses N, or any vector where N is not a multiple of 16
//   bytes, one element at a time).  Storing the D fragments' pairs straight
//   to device memory, 16 bytes of a row a warp instruction, took about 6.5
//   us a tile at every K, twice the products at K = 768
//   (tools/stamp_int8.py, `pairs`).  The epilogue (about 2.3 us) still
//   does not overlap the products; two warpgroups taking turns on separate
//   128 x 128 tiles hid it but were no faster at K <= 1024: the 128-wide
//   products run slower, and a four-warp epilogue takes longer.
// - No split-K and no atomics: reruns are bit-identical.  K is a multiple
//   of 16 (TMA's 16-byte row stride; the wrapper raises otherwise).  Waits
//   trap after about two seconds (cluster.cuh), so a broken pipeline ends
//   the launch with an error instead of hanging the card.
#include <atomic>
#include <cstdint>
#include <initializer_list>

#include <cuda.h>

#include "cluster.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace ptk;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ K8

constexpr int kQuantThreads = 256;
constexpr int kQuantWarps = kQuantThreads / 32;

// a set of rows of one input type: (rows, k) -> codes (rows, k) and a
// scale a row; `team` warps a row, `blocks` blocks of kQuantWarps / team
// rows
struct RowSet {
  const void* x;
  int8_t* q;
  float* scale;
  long rows;
  int team;
  long blocks;
};

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
    const float2 f = unpack_bf16(u[i]);
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

// one row of `set` a team: block `block` of the set, K a multiple of
// W = 16 / sizeof(Tin), K / W <= 32 V team
template <typename Tin, int V>
__device__ __forceinline__ void quantize_team(const RowSet& set, long block,
                                              int k, float* red) {
  constexpr int W = 16 / sizeof(Tin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team = set.team;
  const long row = block * (kQuantWarps / team) + warp / team;
  const int tl = (warp % team) * 32 + lane;  // this thread in its team
  const int span = 32 * team;
  const int nvec = k / W;
  const bool live = row < set.rows;
  const Tin* xr = static_cast<const Tin*>(set.x) + (live ? row : 0) * k;
  uint4 raw[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int at = span * i + tl;
    raw[i] = live && at < nvec
                 ? *reinterpret_cast<const uint4*>(xr + (long)at * W)
                 : make_uint4(0u, 0u, 0u, 0u);  // +0.0 in both types
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float v[W];
    unpack(raw[i], v);
#pragma unroll
    for (int j = 0; j < W; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  amax = warp_max(amax);
  if (team > 1) {  // the same in the whole block
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    const int first = warp - warp % team;
    amax = red[first];
    for (int w = 1; w < team; ++w) amax = fmaxf(amax, red[first + w]);
  }
  if (!live) return;
  const float s = row_scale(amax);
  if (tl == 0) set.scale[row] = s;
  int8_t* qr = set.q + row * k;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int at = span * i + tl;
    if (at >= nvec) continue;
    float v[W];
    unpack(raw[i], v);
    store_codes<W>(qr + (long)at * W, v, s);
  }
}

// at V = 4, four blocks an SM (64 registers a thread)
template <typename Tx, typename Tw, int V>
__global__ void __launch_bounds__(kQuantThreads, V == 4 ? 4 : 2)
quantize_rows_kernel(RowSet xs, RowSet ws, int k) {
  __shared__ float red[kQuantWarps];
  if (blockIdx.x < xs.blocks)
    quantize_team<Tx, V>(xs, blockIdx.x, k, red);
  else
    quantize_team<Tw, V>(ws, blockIdx.x - xs.blocks, k, red);
}

// any K: one warp a row, strided scalar loads, the row read a second time
// for the codes
template <typename Tin>
__device__ __forceinline__ void quantize_row_loop(const RowSet& set,
                                                  long block, int k) {
  const long row = block * kQuantWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= set.rows) return;
  const Tin* xr = static_cast<const Tin*>(set.x) + row * k;
  float amax = 0.f;
  for (int i = lane; i < k; i += 32) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  const float s = row_scale(warp_max(amax));
  if (lane == 0) set.scale[row] = s;
  int8_t* qr = set.q + row * k;
  for (int i = lane; i < k; i += 32) qr[i] = (int8_t)code(to_f32(xr[i]), s);
}

template <typename Tx, typename Tw>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_loop_kernel(RowSet xs, RowSet ws, int k) {
  if (blockIdx.x < xs.blocks)
    quantize_row_loop<Tx>(xs, blockIdx.x, k);
  else
    quantize_row_loop<Tw>(ws, blockIdx.x - xs.blocks, k);
}

// the fewest warps a row (1, 2, 4 or 8) that hold a row of k elements as
// W-element vectors, V a lane; 0 where none does or k is not whole vectors
int team_for(int k, int w, int v) {
  if (k % w) return 0;
  for (int t = 1; t <= kQuantWarps; t *= 2)
    if (32L * t * v >= k / w) return t;
  return 0;
}

void set_blocks(RowSet& set, int team) {
  set.team = team;
  const int per = kQuantWarps / team;  // rows a block
  set.blocks = (set.rows + per - 1) / per;
}

template <typename Tx, typename Tw>
int launch_quant(RowSet xs, RowSet ws, int k, cudaStream_t stream) {
  constexpr int Wx = 16 / sizeof(Tx), Ww = 16 / sizeof(Tw);
  // an empty set takes no block, whatever its team
  auto team = [&](const RowSet& set, int w, int v) {
    return set.rows == 0 ? 1 : team_for(k, w, v);
  };
  for (const int v : {4, 8}) {
    const int tx = team(xs, Wx, v), tw = team(ws, Ww, v);
    if (tx == 0 || tw == 0) continue;
    set_blocks(xs, tx);
    set_blocks(ws, tw);
    const long grid = xs.blocks + ws.blocks;
    if (grid >= (1L << 31)) return (int)cudaErrorInvalidValue;
    if (v == 4)
      quantize_rows_kernel<Tx, Tw, 4>
          <<<(unsigned)grid, kQuantThreads, 0, stream>>>(xs, ws, k);
    else
      quantize_rows_kernel<Tx, Tw, 8>
          <<<(unsigned)grid, kQuantThreads, 0, stream>>>(xs, ws, k);
    return (int)cudaGetLastError();
  }
  set_blocks(xs, 1);
  set_blocks(ws, 1);
  const long grid = xs.blocks + ws.blocks;
  if (grid >= (1L << 31)) return (int)cudaErrorInvalidValue;
  quantize_rows_loop_kernel<Tx, Tw>
      <<<(unsigned)grid, kQuantThreads, 0, stream>>>(xs, ws, k);
  return (int)cudaGetLastError();
}

template <typename Tx>
int launch_quant_w(const RowSet& xs, const RowSet& ws, int w_dtype, int k,
                   cudaStream_t s) {
  if (w_dtype == kF32) return launch_quant<Tx, float>(xs, ws, k, s);
  if (w_dtype == kBF16) return launch_quant<Tx, bf16>(xs, ws, k, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ K9

constexpr int kBM = 128;       // rows a tile: two warpgroups of 64
constexpr int kBN = 256;       // columns a tile: the wgmma's N
constexpr int kBK = 128;       // k a stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kThreads = 288;  // two consumer warpgroups + a loader warp

// dynamic shared memory, from a 1024-byte aligned base
constexpr int kATile = kBM * kBK;
constexpr int kBTile = kBN * kBK;
constexpr int kEpiTile = 2 * kBN * 4;  // a tile's sw and bias, f32
constexpr int kAOff = 0;
constexpr int kBOff = kAOff + kStages * kATile;
constexpr int kEpiOff = kBOff + kStages * kBTile;
// a consumer warp's output staging tile: 16 rows of 128 bytes
constexpr int kStageRows = 16, kStageTile = kStageRows * 128;
constexpr int kStageOff = kEpiOff + 2 * kEpiTile;
constexpr int kBarOff = kStageOff + 8 * kStageTile;
// barriers: full[kStages], empty[kStages], the epilogue tiles' full[2] and
// empty[2]
constexpr int kFull = 0, kEmpty = kStages, kEpiFull = 2 * kStages,
              kEpiEmpty = kEpiFull + 2;
constexpr int kSmemBytes = kBarOff + 8 * (kEpiEmpty + 2) + 1024;
static_assert(kSmemBytes <= 232448, "more than a block's shared memory");

struct DenseArgs {
  const float* sx;
  const float* sw;
  const float* bias;  // null: no bias
  void* out;
  int m, n, k;
  int tiles_n;  // column tiles
  int tiles;
};

__device__ __forceinline__ float dequant(int acc, float sx, float sw,
                                         float b, bool has_bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  return has_bias ? __fadd_rn(y, b) : y;
}

// two adjacent outputs into the staging tile
__device__ __forceinline__ void stage_pair(unsigned char* p, float v0,
                                           float v1, float) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void stage_pair(unsigned char* p, float v0,
                                           float v1, bf16) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}

// 16 bytes of staged outputs, columns [col, col + 16 / sizeof(Tout)) of
// row `row`: one store where they lie inside N on a 16-byte boundary,
// else one element at a time up to N
template <typename Tout>
__device__ __forceinline__ void store16(Tout* out, long at, int col, int n,
                                        const uint4& v) {
  constexpr int kE = 16 / sizeof(Tout);
  if (n % kE == 0 && col + kE <= n) {
    *reinterpret_cast<uint4*>(out + at) = v;
    return;
  }
  const Tout* e = reinterpret_cast<const Tout*>(&v);
#pragma unroll
  for (int i = 0; i < kE; ++i)
    if (col + i < n) out[at + i] = e[i];
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
    int8_dense_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap, DenseArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int ktiles = (a.k + kBK - 1) / kBK;
  const bool has_bias = a.bias != nullptr;
  auto bar = [&](int i) { return base + kBarOff + 8u * i; };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar(kFull + i), 1);
      mbar_init(bar(kEmpty + i), 2);  // one arrival a consumer warpgroup
    }
    for (int e = 0; e < 2; ++e) {
      mbar_init(bar(kEpiFull + e), 32);    // every loader lane
      mbar_init(bar(kEpiEmpty + e), 256);  // every consumer thread
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ------------------------------------------ loader
    const int lane = tid - 256;
    int i = 0, e = 0;
    uint32_t ph = 0, eph = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int m0 = t / a.tiles_n * kBM;
      const int n0 = t % a.tiles_n * kBN;
      // the tile's weight scales and bias, by the whole warp: every load
      // issued before the first store, so they wait on memory once
      float swv[kBN / 32], bv[kBN / 32];
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) {
        const int col = n0 + 32 * c + lane;
        swv[c] = col < a.n ? __ldg(a.sw + col) : 0.f;
        bv[c] = has_bias && col < a.n ? __ldg(a.bias + col) : 0.f;
      }
      mbar_wait(bar(kEpiEmpty + e), eph ^ 1);
      float* ep = reinterpret_cast<float*>(smem + kEpiOff + e * kEpiTile);
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) {
        ep[32 * c + lane] = swv[c];
        ep[kBN + 32 * c + lane] = bv[c];
      }
      mbar_arrive(bar(kEpiFull + e));
      if (++e == 2) {
        e = 0;
        eph ^= 1;
      }
      if (lane == 0) {
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(bar(kEmpty + i), ph ^ 1);
          mbar_expect_tx(bar(kFull + i), kATile + kBTile);
          tma_load_2d(base + kAOff + i * kATile, &amap, bar(kFull + i),
                      kt * kBK, m0);
          tma_load_2d(base + kBOff + i * kBTile, &bmap, bar(kFull + i),
                      kt * kBK, n0);
          if (++i == kStages) {
            i = 0;
            ph ^= 1;
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int w = tid >> 7;  // rows [64 w, 64 w + 64) of the tile
  const int tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column
  const uint64_t da = wgmma_desc(base + kAOff + w * (kATile / 2), 16, 1024);
  const uint64_t db = wgmma_desc(base + kBOff, 16, 1024);
  Tout* out = static_cast<Tout*>(a.out);

  int acc[kBN / 2];
  int i = 0, e = 0;
  uint32_t ph = 0, eph = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int m0 = t / a.tiles_n * kBM;
    const int n0 = t % a.tiles_n * kBN;
    // acc[4 j + 2 h + c]: tile row 64 w + 16 warp + g + 8 h, column
    // 8 j + 2 t4 + c; the rows' sx are loaded before the products
    const int r0 = 64 * w + 16 * warp + g;
    float sxr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      sxr[h] = row < a.m ? __ldg(a.sx + row) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) acc[j] = 0;
    int prev = 0;  // the stage whose products are still in flight
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(bar(kFull + i), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64n256k32_s8_ss(acc, da + ((i * kATile + kk * 32) >> 4),
                               db + ((i * kBTile + kk * 32) >> 4), 1);
      wgmma_commit();
      // the previous k-tile's products are done: free its stage
      wgmma_wait<1>();
      mbar_arrive(bar(kEmpty + prev), tw == 0 && kt > 0);
      prev = i;
      if (++i == kStages) {
        i = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar(kEmpty + prev), tw == 0);

    mbar_wait(bar(kEpiFull + e), eph);
    const float* ep =
        reinterpret_cast<const float*>(smem + kEpiOff + e * kEpiTile);
    // the warp's 16 rows go out in chunks of 128 bytes a row: its pairs
    // into its staging tile (16-byte units XOR-swizzled by row, so neither
    // side conflicts on banks), then back as 16-byte vectors, 8 lanes a
    // row, stored whole lines at a time
    constexpr int kChunkCols = 128 / (int)sizeof(Tout);  // 64 bf16, 32 f32
    unsigned char* stg = smem + kStageOff + (tid >> 5) * kStageTile;
#pragma unroll
    for (int ch = 0; ch < kBN / kChunkCols; ++ch) {
#pragma unroll
      for (int jj = 0; jj < kChunkCols / 8; ++jj) {
        const int j = ch * kChunkCols / 8 + jj, cl = 8 * j + 2 * t4;
        const float2 swp = *reinterpret_cast<const float2*>(ep + cl);
        const float2 bp = *reinterpret_cast<const float2*>(ep + kBN + cl);
        const int bo = (8 * jj + 2 * t4) * (int)sizeof(Tout);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          stage_pair(stg + r * 128 + (((bo >> 4) ^ (r & 7)) << 4) + (bo & 15),
                     dequant(acc[4 * j + 2 * h], sxr[h], swp.x, bp.x,
                             has_bias),
                     dequant(acc[4 * j + 2 * h + 1], sxr[h], swp.y, bp.y,
                             has_bias),
                     Tout{});
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kStageRows / 4; ++i) {
        const int r = lane / 8 + 4 * i, c = lane % 8;
        const int row = m0 + 64 * w + 16 * warp + r;
        const int col = n0 + ch * kChunkCols + c * (16 / (int)sizeof(Tout));
        const uint4 v = *reinterpret_cast<const uint4*>(
            stg + r * 128 + ((c ^ (r & 7)) << 4));
        if (row < a.m && col < a.n)
          store16(out, (long)row * a.n + col, col, a.n, v);
      }
      __syncwarp();
    }
    // this thread has read the tile's sw and bias: the buffer may refill
    mbar_arrive(bar(kEpiEmpty + e));
    if (++e == 2) {
      e = 0;
      eph ^= 1;
    }
  }
}

// raises the kernel's dynamic shared-memory limit on the current device,
// once a device (the attribute belongs to the device's context)
template <typename Tout>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};  // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < kCachedDevices ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(int8_dense_kernel<Tout>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <typename Tout>
int launch_dense(const CUtensorMap& am, const CUtensorMap& bm,
                 const DenseArgs& a, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  const cudaError_t e = allow_smem<Tout>();
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(a.tiles < sms ? a.tiles : sms);
  int8_dense_kernel<Tout><<<grid, kThreads, kSmemBytes, stream>>>(am, bm, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Both operands of a layer in one launch: x (m, k) of x_dtype -> qx (m, k)
// int8, sx (m,) f32; w (n, k) of w_dtype -> qw, sw likewise.  m or n may be
// 0 (that operand is skipped); pointers 16-byte aligned.
extern "C" int ptk_quantize_operands(const void* x, void* qx, void* sx,
                                     long m, int x_dtype, const void* w,
                                     void* qw, void* sw, long n, int w_dtype,
                                     int k, void* stream) {
  if ((m == 0 && n == 0) || k == 0) return (int)cudaGetLastError();
  const RowSet xs{x, static_cast<int8_t*>(qx), static_cast<float*>(sx), m,
                  1, 0};
  const RowSet ws{w, static_cast<int8_t*>(qw), static_cast<float*>(sw), n,
                  1, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch_quant_w<float>(xs, ws, w_dtype, k, s);
  if (x_dtype == kBF16) return launch_quant_w<bf16>(xs, ws, w_dtype, k, s);
  return (int)cudaErrorInvalidValue;
}

// x: (n_rows, k) of in_dtype; q: (n_rows, k) int8; scale: (n_rows,) f32;
// pointers 16-byte aligned.  One operand on the same kernel.
extern "C" int ptk_quantize_rows(const void* x, void* q, void* scale,
                                 long n_rows, int k, int in_dtype,
                                 void* stream) {
  return ptk_quantize_operands(x, q, scale, n_rows, in_dtype, nullptr,
                               nullptr, nullptr, 0, kF32, k, stream);
}

// a: (m, k) int8; b: (n, k) int8; sx: (m,), sw: (n,), bias: (n,) f32 or
// null; out: (m, n) of out_dtype; k a multiple of 16, pointers 16-byte
// aligned.
extern "C" int ptk_int8_dense(const void* a, const void* b, const void* sx,
                              const void* sw, const void* bias, void* out,
                              int m, int n, int k, int out_dtype,
                              void* stream) {
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  if (k <= 0 || k % 16 || (out_dtype != kF32 && out_dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap am, bm;
  if (!tensor_map(&am, enc, a, m, k, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !tensor_map(&bm, enc, b, n, k, kBN, kBK, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_DATA_TYPE_UINT8))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (n + kBN - 1) / kBN;
  const long tiles = (long)((m + kBM - 1) / kBM) * tiles_n;
  if (tiles >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const DenseArgs args{static_cast<const float*>(sx),
                       static_cast<const float*>(sw),
                       static_cast<const float*>(bias), out, m, n, k,
                       tiles_n, (int)tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == kF32 ? launch_dense<float>(am, bm, args, s)
                           : launch_dense<bf16>(am, bm, args, s);
}
