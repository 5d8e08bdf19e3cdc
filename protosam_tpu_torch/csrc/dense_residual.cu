// K6 dense_residual: the SAM encoder's attention projection with its
// residual add, bf16 in and out, f32 sums, on Hopper's warpgroup tensor
// cores.
//
// Replaces protosam_tpu/ops/mlp_pallas.py `dense_residual` (:88, kernel
// `_dense_kernel` :80, its pallas_call :99):
//   out = x W^T + b + residual
// for x (M, K), W (N, K) in the nn.Linear layout, as stored.  Sums are in
// f32; bias and residual are added in f32 and the output rounded once.
//
// What bounds it on an H100 (tools/roofline.py `_dense_residual`):
// operations, 2 M K N flops on the bf16 tensor cores (989 TFLOP/s): 0.0271
// ms at ViT-H's projection (M = 8192, K = N = 1280), 0.52 ms at the fc2
// geometry of tools/bench_fc2.py (39200 x 5120 -> 1280).  Only wgmma
// reaches that rate, and only if the tiles reach shared memory without the
// consumers spending instructions or waits on them.
//
// The design: a persistent, warp-specialised GEMM.
// - A CTA owns 128 x 160 output tiles: two consumer warpgroups, one per 64
//   rows, each issuing SS wgmma m64n160k16 with both operands K-major and
//   128B-swizzled in shared memory, and a 64 x 160 f32 accumulator in
//   registers (80 a thread); and one loader warp.  Nine warps cap a thread
//   at 168 registers (three of them share one of the SM's four register
//   files), which the 80-register accumulator fits.  N = 1280 is 8 x 160.
// - Loads: one loader thread keeps a ring of five stages full by TMA,
//   each an x tile (128 rows x 64 k, 16 KB) and a W tile (160 x 64, 20 KB),
//   with a full and an empty mbarrier a stage.  Arrivals release at CTA
//   scope.  Each warpgroup keeps one k-tile's products in flight while it
//   waits for the next tile, and frees a stage once the products that read
//   it have completed.
// - Persistent grid: min(tiles, SMs) CTAs; CTA b takes tiles b, b + G, ...
//   numbered with the column index fastest, so the column tiles of one row
//   block run in the same wave: x is read from device memory about once,
//   and W (3.3 MB at the projection, 13 MB at fc2) stays in L2.  The ring's
//   phases carry across tiles, so the loader runs ahead into the next tile
//   while the consumers write out the last one.
// - Epilogue: once a tile's k-tiles are all requested, the loader also
//   requests its residual tile (128 x 160 bf16, 40 KB, unswizzled) into a
//   buffer of its own, so it arrives during the last k-tiles; the
//   consumers free the buffer when they have read it.  Each thread holds
//   pairs of adjacent columns in the wgmma D fragments: it loads its bias
//   pairs before any store (global loads may not pass the stores: nothing
//   tells the compiler that b and out do not overlap), adds bias and
//   residual in f32, rounds once and stores bf16 pairs, masked to M and N.
//   184 KB of ring and 40 KB of residual: one CTA an SM.
// - Edges: TMA zero-fills rows past M, W rows past N and columns past K, so
//   a ragged K adds zeros.  K is a multiple of 8 (TMA's 16-byte row
//   stride).  The residual takes TMA where N is a multiple of 8 too; any
//   other N reads it from device memory in the epilogue, and an odd N
//   loads and stores one element at a time.
// - Waits trap after about two seconds (cluster.cuh), so a broken pipeline
//   ends the launch with an error instead of hanging the card.
// No atomics and no split-K: each output is one chain of products in a
// fixed order, so reruns are bit-identical.
#include <atomic>
#include <cstdint>

#include <cuda.h>

#include "cluster.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace ptk;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // rows a tile: two warpgroups of 64
constexpr int kBN = 160;       // columns a tile: the wgmma's N
constexpr int kBK = 64;        // k a stage: one 128-byte swizzled row
constexpr int kStages = 5;
constexpr int kThreads = 288;  // two consumer warpgroups + a loader warp

// dynamic shared memory, from a 1024-byte aligned base
constexpr int kXTile = kBM * 128;
constexpr int kWTile = kBN * 128;
constexpr int kResRow = kBN * 2;  // bytes of a residual row
constexpr int kResTile = kBM * kResRow;
constexpr int kXOff = 0;
constexpr int kWOff = kXOff + kStages * kXTile;
constexpr int kResOff = kWOff + kStages * kWTile;
constexpr int kBarOff = kResOff + kResTile;
// barriers: full[kStages], empty[kStages], the residual's full and empty
constexpr int kFull = 0, kEmpty = kStages, kResFull = 2 * kStages,
              kResEmpty = kResFull + 1;
constexpr int kSmemBytes = kBarOff + 8 * (kResEmpty + 1) + 1024;
static_assert(kSmemBytes <= 232448, "more than a block's shared memory");

struct Args {
  const bf16* b;
  const bf16* res;
  bf16* out;
  int m, k, n;
  int tiles_n;  // column tiles
  int tiles;
  bool res_tma;  // the residual through TMA: n % 8 == 0
};

// elements i, i + 1 of p as a packed pair: one 4-byte load where n is even
// (4-byte aligned), else one at a time with i + 1 < n checked (`at` is the
// offset of column i, `col` its column)
__device__ __forceinline__ uint32_t load_pair(const bf16* p, long at, int col,
                                              int n) {
  if ((n & 1) == 0) return *reinterpret_cast<const uint32_t*>(p + at);
  const bf16 hi = col + 1 < n ? p[at + 1] : __float2bfloat16(0.f);
  __nv_bfloat162 v;
  v.x = p[at];
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1)
    dense_residual_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap rmap, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int ktiles = (a.k + kBK - 1) / kBK;
  auto bar = [&](int i) { return base + kBarOff + 8u * i; };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar(kFull + i), 1);
      mbar_init(bar(kEmpty + i), 2);  // one arrival a consumer warpgroup
    }
    mbar_init(bar(kResFull), 1);
    mbar_init(bar(kResEmpty), 256);  // every consumer thread
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ------------------------------------------ loader
    if (tid == 256) {
      int i = 0;
      uint32_t ph = 0, rph = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int m0 = t / a.tiles_n * kBM;
        const int n0 = t % a.tiles_n * kBN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(bar(kEmpty + i), ph ^ 1);
          mbar_expect_tx(bar(kFull + i), kXTile + kWTile);
          tma_load_2d(base + kXOff + i * kXTile, &xmap, bar(kFull + i),
                      kt * kBK, m0);
          tma_load_2d(base + kWOff + i * kWTile, &wmap, bar(kFull + i),
                      kt * kBK, n0);
          if (++i == kStages) {
            i = 0;
            ph ^= 1;
          }
        }
        if (a.res_tma) {
          mbar_wait(bar(kResEmpty), rph ^ 1);
          mbar_expect_tx(bar(kResFull), kResTile);
          tma_load_2d(base + kResOff, &rmap, bar(kResFull), n0, m0);
          rph ^= 1;
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int w = tid >> 7;  // rows [64 w, 64 w + 64) of the tile
  const int tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column
  const uint64_t dx = wgmma_desc(base + kXOff + w * (kXTile / 2), 16, 1024);
  const uint64_t dw = wgmma_desc(base + kWOff, 16, 1024);

  float acc[kBN / 2];
  int i = 0;
  uint32_t ph = 0, rph = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int m0 = t / a.tiles_n * kBM;
    const int n0 = t % a.tiles_n * kBN;
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) acc[e] = 0.f;
    int prev = 0;  // the stage whose products are still in flight
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(bar(kFull + i), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n160_ss(acc, dx + ((i * kXTile + kk * 32) >> 4),
                         dw + ((i * kWTile + kk * 32) >> 4), 1);
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
    mbar_arrive(bar(kEmpty + prev), tw == 0 && ktiles > 0);

    // acc[4 j + 2 h + c]: tile row 64 w + 16 warp + g + 8 h, column
    // 8 j + 2 t4 + c
    uint32_t bias[kBN / 8];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      bias[j] = col < a.n ? load_pair(a.b, col, col, a.n) : 0u;
    }
    if (a.res_tma) mbar_wait(bar(kResFull), rph);
    const int r0 = 64 * w + 16 * warp + g;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int cl = 8 * j + 2 * t4, col = n0 + cl;
      if (col >= a.n) continue;
      const float2 bb = unpack_bf16(bias[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r0 + 8 * h;
        if (row >= a.m) continue;
        const long at = (long)row * a.n + col;
        const float2 rr = unpack_bf16(
            a.res_tma ? *reinterpret_cast<const uint32_t*>(
                            smem + kResOff + (r0 + 8 * h) * kResRow + 2 * cl)
                      : load_pair(a.res, at, col, a.n));
        const float y0 = acc[4 * j + 2 * h] + bb.x + rr.x;
        const float y1 = acc[4 * j + 2 * h + 1] + bb.y + rr.y;
        if ((a.n & 1) == 0) {
          *reinterpret_cast<uint32_t*>(a.out + at) = pack_bf16(y0, y1);
        } else {
          a.out[at] = __float2bfloat16(y0);
          if (col + 1 < a.n) a.out[at + 1] = __float2bfloat16(y1);
        }
      }
    }
    // this thread has read its residual: the buffer may be refilled
    mbar_arrive(bar(kResEmpty), a.res_tma);
    rph ^= 1;
  }
}

// raises the kernel's dynamic shared-memory limit on the current device,
// once a device (the attribute belongs to the device's context)
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};  // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < kCachedDevices ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(dense_residual_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace

// x: (m, k); w: (n, k); b: (n,); res, out: (m, n); all bf16.  k a
// multiple of 8; pointers 16-byte aligned (TMA reads x, w and, where n is
// a multiple of 8, res).
extern "C" int ptk_dense_residual(const void* x, const void* w,
                                  const void* b, const void* res, void* out,
                                  long m, int k, int n, void* stream) {
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  // TMA coordinates are 32-bit
  if (k % 8 || m > (1L << 30)) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // k == 0 loads no k-tile (out = b + residual), and n % 8 != 0 reads no
  // residual tile: maps that are never read describe a stand-in at `out`
  const uint64_t kd = k > 0 ? k : kBK;
  const bool res_tma = n % 8 == 0;
  CUtensorMap xm, wm, rm;
  if (!tensor_map(&xm, enc, k > 0 ? x : out, m, kd, kBM, kBK) ||
      !tensor_map(&wm, enc, k > 0 ? w : out, n, kd, kBN, kBK) ||
      !tensor_map(&rm, enc, res_tma ? res : out, m, res_tma ? n : kBN, kBM,
                  kBN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (n + kBN - 1) / kBN;
  const long tiles = (m + kBM - 1) / kBM * tiles_n;
  if (tiles >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const Args a{static_cast<const bf16*>(b), static_cast<const bf16*>(res),
               static_cast<bf16*>(out), (int)m, k, n, tiles_n, (int)tiles,
               res_tma};
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  dense_residual_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(xm, wm, rm, a);
  return (int)cudaGetLastError();
}
