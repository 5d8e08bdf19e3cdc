// K7 mlp_fused: the SAM encoder's MLP with its residual add, bf16 in and
// out, f32 sums, on Hopper's warpgroup tensor cores.
//
// Replaces protosam_tpu/ops/mlp_pallas.py `mlp_fused` (:125, kernel
// `_kernel` :46, its pallas_call :165):
//   out = gelu_tanh(x W1^T + b1) W2^T + b2 (+ residual)
// for x (M, C), W1 (H, C), W2 (C, H) in the nn.Linear layout.  As the TPU
// kernel does, the hidden activation is rounded to bf16 once, before the
// second product, and the output once, at the end.  The GELU's tanh is
// tanh.approx.f32 (relative error about 2^-11, well inside the bf16
// rounding of the hidden activation that follows it).
//
// What bounds it on an H100 (tools/roofline.py `_mlp_fused`): operations,
// 4 M C H flops on the bf16 tensor cores: 0.217 ms at ViT-H's M = 8192,
// C = 1280, H = 5120.  What decides how close a kernel comes is the traffic
// into each SM: W1 and W2 are 26 MB at ViT-H, every row tile has to see all
// of them, and the (M, H) hidden activation must not reach device memory.
// A 64-row tile's f32 output alone (64 x 1280 x 4 = 320 KB) is larger than
// an SM's register file, so no block can own whole output rows.
//
// The design: a cluster of eight CTAs owns 128 rows and splits the output
// columns, CTA r the slice [r ns, (r + 1) ns) with ns = C / 8 rounded up to
// 8 (160 at ViT-H); each hidden chunk is computed once in the cluster and
// shared through distributed shared memory.
// - A CTA is two consumer warpgroups, one per 64 rows, each with a 64 x 160
//   f32 fc2 accumulator in registers (80 a thread), and one loader warp.
//   Nine warps put three on one of the SM's four register files, which caps
//   every thread at 168 registers.  A cluster of four (320 columns, a
//   160-register accumulator) spilled under that cap, also with setmaxnreg
//   moving registers to the consumers; without a loader warp it fitted (255
//   registers) but its loads then went out between the products, and it
//   ran 10% slower than this kernel.
// - A cluster step covers 512 hidden units.  CTA r computes fc1 for units
//   [512 s + 64 r, + 64): m64n64k16 wgmma over C in k64 tiles, x (128 x 64)
//   and W1 (64 x 64) both K-major and 128B-swizzled in shared memory; then
//   + b1, GELU in f32, rounded to bf16 and packed in place as the register
//   A fragments of fc2 (the wgmma D layout is the A layout of the next
//   product), so nothing moves between threads.
// - Exchange: each thread stores its 16 packed registers at its own thread
//   index in a double-buffered exchange tile (8 KB a warpgroup); thread 0 of
//   the warpgroup then fences at cluster scope and arrives on a barrier in
//   each of the seven peers, and every thread waits (acquire, cluster
//   scope) for the peers' arrivals on its own.  Warpgroup w of every CTA
//   computed the same 64 rows, so a thread reads its own index of each
//   CTA's tile (ld.shared::cluster) and holds the chunk's A fragments as
//   they are.  A peer overwrites a buffer only two steps on, after the
//   barrier of the step between, which every reader passes only after its
//   reads.
// - fc2: the eight chunks in a fixed order, 0 to 7, so reruns are bit-
//   identical: register-A m64n160k16 wgmma against this CTA's W2 tile (ns
//   columns x 64 hidden units, K-major).
// - Loads: TMA into two mbarrier rings, full/empty per stage: four stages
//   of x + W1 (24 KB) and four of W2 (20 KB).  x is the same for the eight
//   CTAs, so each loads an eighth of the 128 rows and
//   multicasts it to all; a stage is refilled once all sixteen warpgroups
//   of the cluster have released it.  One thread of the loader warp keeps
//   both rings full, polling their empty barriers.  With 32 KB of exchange
//   tiles that is 209 KB of shared memory, one CTA an SM.
// - Edges: TMA zero-fills rows past M, W1 rows and W2 columns past H (so
//   gelu(0) = 0 adds nothing) and columns past C; stores are masked to M,
//   to the slice and to C.
// - Waits trap after about two seconds (cluster.cuh), so a broken pipeline
//   ends the launch with an error instead of hanging the card.
// Per launch at ViT-H's M = 8192 the cluster reads the weights once: 64
// clusters x 26 MB = 1.7 GB from L2, and x 0.2 GB (against 13.4 GB for a
// 16-row block that reads both matrices).  The hidden activation is never
// written to device memory.
#include <cstdint>

#include <cuda.h>

#include "cluster.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace ptk;
using bf16 = __nv_bfloat16;

constexpr int kCluster = 8;                    // CTAs a cluster
constexpr int kRows = 128;                     // rows a cluster
constexpr int kChunk = 64;                     // hidden units a CTA a step
constexpr int kStep = kCluster * kChunk;       // hidden units a cluster step
constexpr int kK = 64;                         // fc1 k-tile: a 128-byte row
constexpr int kCols = 160;                     // output columns a CTA, N
constexpr int kStages = 4;                     // x/W1 ring
constexpr int kStages2 = 4;                    // W2 ring
constexpr int kThreads = 288;                  // two warpgroups + a loader

// dynamic shared memory, from a 1024-byte aligned base
constexpr int kXTile = kRows * 128;            // 128 rows x 64 k
constexpr int kXSlice = kXTile / kCluster;     // the rows one CTA multicasts
constexpr int kW1Tile = kChunk * 128;          // 64 hidden units x 64 k
constexpr int kW2Tile = kCols * 128;           // 160 columns x 64 hidden
constexpr int kXchg = 128 * 64;                // one warpgroup's chunk
constexpr int kXOff = 0;
constexpr int kW1Off = kXOff + kStages * kXTile;
constexpr int kW2Off = kW1Off + kStages * kW1Tile;
constexpr int kXchgOff = kW2Off + kStages2 * kW2Tile;
constexpr int kBarOff = kXchgOff + 2 * 2 * kXchg;
// full[kStages], empty[kStages], full2[kStages2], empty2[kStages2],
// ready[buffer][warpgroup]
constexpr int kFull = 0, kEmpty = kStages, kFull2 = 2 * kStages,
              kEmpty2 = kFull2 + kStages2, kReady = kEmpty2 + kStages2;
constexpr int kSmemBytes = kBarOff + 8 * (kReady + 4) + 1024;
static_assert(kSmemBytes <= 232448, "more than a block's shared memory");

struct Args {
  const bf16* b1;
  const bf16* b2;
  const bf16* res;  // may be null
  bf16* out;
  long m;
  int c, h, ns;  // ns: the output columns a CTA owns
};

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True) / torch gelu(approximate="tanh")
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  float t;
  asm("tanh.approx.f32 %0, %1;\n"
      : "=f"(t)
      : "f"(k0 * fmaf(0.044715f * v, v * v, v)));
  return 0.5f * v * (1.f + t);
}

// grid: 8 CTAs for every 128 rows
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
        mlp_fused_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap w1map,
                         const __grid_constant__ CUtensorMap w2map, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const uint32_t r = cluster_rank();
  const long m0 = (long)(blockIdx.x / kCluster) * kRows;
  const int steps = (a.h + kStep - 1) / kStep;
  const int ktiles = (a.c + kK - 1) / kK;
  auto bar = [&](int i) { return base + kBarOff + 8u * i; };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar(kFull + i), 1);
      mbar_init(bar(kEmpty + i), 2 * kCluster);  // every warpgroup
    }
    for (int i = 0; i < kStages2; ++i) {
      mbar_init(bar(kFull2 + i), 1);
      mbar_init(bar(kEmpty2 + i), 2);
    }
    for (int i = 0; i < 4; ++i) mbar_init(bar(kReady + i), kCluster - 1);
    fence_mbar_init();
  }
  cluster_sync();  // no peer signals a barrier before it exists

  if (tid >= 256) {  // ------------------------------------------ loader
    if (tid == 256) {
      // one thread keeps both rings full: x (an eighth of the rows,
      // multicast) and W1 k-tiles, and W2 tiles of this CTA's columns, one
      // hidden chunk a stage; each load goes out as soon as its stage is
      // free in every CTA that it writes
      int i = 0, i2 = 0, s = 0, kt = 0, s2 = 0, j2 = 0;
      uint32_t ph = 0, ph2 = 0;
      long long idle_since = clock64();
      while (s < steps || s2 < steps) {
        bool sent = false;
        if (s < steps && mbar_test<true>(bar(kEmpty + i), ph ^ 1)) {
          mbar_expect_tx(bar(kFull + i), kXTile + kW1Tile);
          tma_load_2d_multicast(base + kXOff + i * kXTile + r * kXSlice,
                                &xmap, bar(kFull + i), kt * kK,
                                (int)(m0 + r * (kRows / kCluster)),
                                (1u << kCluster) - 1);
          tma_load_2d(base + kW1Off + i * kW1Tile, &w1map, bar(kFull + i),
                      kt * kK, s * kStep + r * kChunk);
          if (++i == kStages) {
            i = 0;
            ph ^= 1;
          }
          if (++kt == ktiles) {
            kt = 0;
            ++s;
          }
          sent = true;
        }
        if (s2 < steps && mbar_test<false>(bar(kEmpty2 + i2), ph2 ^ 1)) {
          mbar_expect_tx(bar(kFull2 + i2), kW2Tile);
          tma_load_2d(base + kW2Off + i2 * kW2Tile, &w2map, bar(kFull2 + i2),
                      s2 * kStep + j2 * kChunk, (int)r * a.ns);
          if (++i2 == kStages2) {
            i2 = 0;
            ph2 ^= 1;
          }
          if (++j2 == kCluster) {
            j2 = 0;
            ++s2;
          }
          sent = true;
        }
        if (sent)
          idle_since = clock64();
        else if (clock64() - idle_since > kWaitTrapCycles)
          __trap();
      }
    }
    cluster_sync();  // no CTA leaves while a peer still reads it
    return;
  }

  // ----------------------------------------------------------- consumers
  const int w = tid >> 7;  // rows [64 w, 64 w + 64) of the cluster's 128
  const int tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column
  const uint64_t dx = wgmma_desc(base + kXOff + w * (kXTile / 2), 16, 1024);
  const uint64_t dw1 = wgmma_desc(base + kW1Off, 16, 1024);
  const uint64_t dw2 = wgmma_desc(base + kW2Off, 16, 1024);

  float acc[kCols / 2];
#pragma unroll
  for (int e = 0; e < kCols / 2; ++e) acc[e] = 0.f;
  int i = 0, i2 = 0;
  uint32_t ph = 0, ph2 = 0;

  for (int s = 0; s < steps; ++s) {
    // fc1: this group's 64 rows x the CTA's 64 hidden units, over C
    float hacc[32];
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(bar(kFull + i), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_ss(hacc, dx + ((i * kXTile + kk * 32) >> 4),
                        dw1 + ((i * kW1Tile + kk * 32) >> 4),
                        kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      // free the stage in every CTA: each one's x slice is in all of them
      mbar_arrive_cluster(bar(kEmpty + i), tw % kCluster, tw < kCluster);
      if (++i == kStages) {
        i = 0;
        ph ^= 1;
      }
    }
    fence_regs(hacc);

    // + b1, GELU, rounded to bf16 and packed as the A fragments of fc2:
    // k16 step kk covers hidden units 16 kk .. 16 kk + 15 of the chunk
    const int h0 = s * kStep + (int)r * kChunk;
    const int b = s & 1;
    const uint32_t slot = kXchgOff + (b * 2 + w) * kXchg + tw * 16;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t f[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        const int hc = h0 + 8 * j + 2 * t4;
        float2 bb = make_float2(0.f, 0.f);
        if (hc < a.h)
          bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(a.b1 + hc));
        f[2 * jj] = pack_bf16(gelu_tanh(hacc[4 * j] + bb.x),
                              gelu_tanh(hacc[4 * j + 1] + bb.y));
        f[2 * jj + 1] = pack_bf16(gelu_tanh(hacc[4 * j + 2] + bb.x),
                                  gelu_tanh(hacc[4 * j + 3] + bb.y));
      }
      // exchange: 16 bytes a k16 step, at this thread's index
      *reinterpret_cast<uint4*>(smem + slot + kk * 2048) =
          make_uint4(f[0], f[1], f[2], f[3]);
    }
    named_bar_sync(1 + w, 128);
    if (tw == 0) {
      fence_cluster();
#pragma unroll
      for (int p = 1; p < kCluster; ++p)
        mbar_arrive_cluster(bar(kReady + 2 * b + w), (r + p) % kCluster);
    }
    mbar_wait<true>(bar(kReady + 2 * b + w), (s >> 1) & 1);

    // fc2: acc += chunk j (64 rows x 64 hidden) x W2 tile, j = 0 .. 7
#pragma unroll
    for (int j = 0; j < kCluster; ++j) {
      uint32_t fa[4][4];
      const uint32_t src = mapa(base + slot, j);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 v = ld_cluster_v4(src + kk * 2048);
        fa[kk][0] = v.x;
        fa[kk][1] = v.y;
        fa[kk][2] = v.z;
        fa[kk][3] = v.w;
      }
      mbar_wait(bar(kFull2 + i2), ph2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n160_rs(acc, fa[kk],
                         dw2 + ((i2 * kW2Tile + kk * 32) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_cluster(bar(kEmpty2 + i2), r, tw == 0);
      if (++i2 == kStages2) {
        i2 = 0;
        ph2 ^= 1;
      }
    }
  }

  // + b2 (+ residual) in f32, one rounding; rows past M, columns past
  // the slice or past C are not stored
  const int col0 = (int)r * a.ns;
  const long row0 = m0 + 64 * w + 16 * warp + g;
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
    const int cl = 8 * n + 2 * t4;
    const int col = col0 + cl;
    if (cl >= a.ns || col >= a.c) continue;
    const float2 bb =
        unpack_bf16(*reinterpret_cast<const uint32_t*>(a.b2 + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = row0 + 8 * half;
      if (row >= a.m) continue;
      float y0 = acc[4 * n + 2 * half] + bb.x;
      float y1 = acc[4 * n + 2 * half + 1] + bb.y;
      if (a.res != nullptr) {
        const float2 rr = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(a.res + row * a.c + col));
        y0 += rr.x;
        y1 += rr.y;
      }
      *reinterpret_cast<uint32_t*>(a.out + row * a.c + col) =
          pack_bf16(y0, y1);
    }
  }
  cluster_sync();  // no CTA leaves while a peer still reads it
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link to
// libcuda); null where it is missing
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 (rows, cols) matrix read in boxes of box_rows x 64
// columns, 128B-swizzled; reads past either edge fill zeros
bool tensor_map(CUtensorMap* map, EncodeTiled enc, const void* ptr,
                uint64_t rows, uint64_t cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {kK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const CUtensorMap& xm, const CUtensorMap& w1m,
           const CUtensorMap& w2m, const Args& a, cudaStream_t st) {
  auto kern = mlp_fused_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.m + kRows - 1) / kRows) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters == 0) return (int)cudaErrorLaunchOutOfResources;
  kern<<<cfg.gridDim, cfg.blockDim, kSmemBytes, st>>>(xm, w1m, w2m, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, res, out: (m, c); w1: (h, c); b1: (h,); w2: (c, h); b2: (c,); all
// bf16, res may be null.  c and h multiples of 16, c <= 1280; pointers
// 16-byte aligned (TMA reads x, w1 and w2).
extern "C" int ptk_mlp_fused(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* res,
                             void* out, long m, int c, int h, void* stream) {
  if (m == 0) return (int)cudaGetLastError();
  if (c % 16 || h % 16 || c > 1280 || h == 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int ns = ((c + kCluster - 1) / kCluster + 7) / 8 * 8;
  CUtensorMap xm, w1m, w2m;
  if (!tensor_map(&xm, enc, x, m, c, kRows / kCluster) ||
      !tensor_map(&w1m, enc, w1, h, c, kChunk) ||
      !tensor_map(&w2m, enc, w2, c, h, kCols))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
               static_cast<const bf16*>(res), static_cast<bf16*>(out), m, c,
               h, ns};
  const auto st = static_cast<cudaStream_t>(stream);
  return launch(xm, w1m, w2m, a, st);
}
