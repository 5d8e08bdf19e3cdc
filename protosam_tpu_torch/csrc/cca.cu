// K3 cca_label: 8-connected component labels of a batch of binary masks.
//
// Replaces the Pallas kernel protosam_tpu/ops/cca_pallas.py `_kernel`
// (:171, launched by `_call`), reached through ops/cca.py
// `label_components`.  Result contract (bit-equal with
// ops/cca._label_components_xla): every foreground pixel holds the minimum
// flat index (within its own image) of its component; background holds
// 2^30.
//
// The TPU kernel iterates neighbour-min and segmented row/column scans to
// a fixed point inside VMEM.  On the card that loop would be one launch or
// one host check per iteration.  Here the labels come from block-based
// union-find (Playne & Hawick 2018; the BUF/BKE family) in three launches
// and no host round trip:
//   1. local:   one block owns a 32 x 32 tile of one image.  It loads the
//               tile's mask into shared memory, runs union-find over local
//               indices there (shared-memory atomicMin links, path splitting)
//               and writes to `out` the *global* flat index of each
//               foreground pixel's local root, 2^30 on background; each
//               local root also starts its own tree in the scratch forest.
//               Row-major order inside a tile is the global row-major order
//               restricted to the tile, so a local root is the minimum
//               global index of its piece of the component.
//   2. border:  only the pixels of each tile's first row (NW, N, NE) and
//               first column (NW, W, SW) unite across tile borders: the
//               local roots of both ends unite in the forest, with the
//               same min-linking and path splitting.  That covers every
//               8-connected edge between tiles, the diagonals at tile
//               corners included; at 32 x 32 fewer than 1/16 of the pixels
//               take part, and the forest holds local roots only.
//   3. resolve: per tile, each local root walks to its root once and shares
//               it through shared memory; every foreground pixel rewrites
//               `out` in place as root - image offset.
// In passes 1-2 every write to a parent is an atomicMin to an ancestor, so
// a parent only decreases and stays in its component; a union links the
// larger root under the smaller and retries until both sides share one
// root.  So parent <= child everywhere, every root is its tree's minimum
// index, and the labels do not depend on the order of the atomics: reruns
// are bit-identical.  In pass 3 the forest is fixed, and the walks split
// their paths with plain stores of ancestors.
//
// Bound on the card: bytes.  The mask is read once and `out` written
// twice and read once; the old one-pass merge walked unbounded chains in
// L2 from every pixel.  Here the dependent walks over single pixels stay in
// shared memory, and the global walks start only from local roots.
#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr int kTile = 32;                 // tile side (rows and columns)
constexpr int kRowsPerThread = 4;         // 32 x 8 threads cover 32 rows
constexpr int kThreads = kTile * kTile / kRowsPerThread;
constexpr int kBorderTiles = 4;           // tiles per border-pass block
constexpr int kBorderLanes = 2 * kTile;   // first row + first column

struct Geometry {
  int h, w, tiles_x, tiles_y;
  // image, tile row and tile column of tile t (images major)
  __device__ void tile(int t, int& img, int& y0, int& x0) const {
    const int per_img = tiles_x * tiles_y;
    img = t / per_img;
    const int r = t - img * per_img;
    y0 = (r / tiles_x) * kTile;
    x0 = (r % tiles_x) * kTile;
  }
};

// root of x; each node on the way is pointed at its grandparent (path
// splitting), and every write is an atomicMin to an ancestor
__device__ __forceinline__ int find_split(int* lab, int x) {
  volatile int* v = lab;
  int p = v[x];
  while (p != x) {
    const int gp = v[p];
    if (gp != p) atomicMin(lab + x, gp);
    x = p;
    p = gp;
  }
  return x;
}

__device__ void unite(int* lab, int a, int b) {
  while (true) {
    a = find_split(lab, a);
    b = find_split(lab, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // b is (or was) a root with b > a: hang it under a.  If another thread
    // moved b first, continue from the parent it found there.
    const int old = atomicMin(lab + b, a);
    if (old == b) return;
    b = old;
  }
}

// loc: each pixel's local root (global flat index), 2^30 on background;
// lab: the parent forest over local roots (other entries are never read)
__global__ void __launch_bounds__(kThreads)
cca_local(const unsigned char* __restrict__ mask, int* __restrict__ loc,
          int* __restrict__ lab, Geometry g) {
  __shared__ int par[kTile * kTile];
  __shared__ unsigned char fg[kTile][kTile + 1];
  int img, y0, x0;
  g.tile(blockIdx.x, img, y0, x0);
  const long base = (long)img * g.h * g.w;
  const int lx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int x = x0 + lx;

  // pixels outside the image are background
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ty + k * (kTile / kRowsPerThread), y = y0 + ly;
    const bool on = x < g.w && y < g.h && mask[base + (long)y * g.w + x];
    fg[ly][lx] = on;
    par[ly * kTile + lx] = ly * kTile + lx;
  }
  __syncthreads();

  // W and N always; NW only when neither W nor N joins it already, NE only
  // when N does not (W and N edges are never skipped, so every skipped edge
  // has a two-edge path that some pixel unites)
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ty + k * (kTile / kRowsPerThread), i = ly * kTile + lx;
    if (!fg[ly][lx]) continue;
    const bool wf = lx > 0 && fg[ly][lx - 1];
    const bool nf = ly > 0 && fg[ly - 1][lx];
    if (wf) unite(par, i, i - 1);
    if (nf) {
      unite(par, i, i - kTile);
    } else if (ly > 0) {
      if (!wf && lx > 0 && fg[ly - 1][lx - 1]) unite(par, i, i - kTile - 1);
      if (lx < kTile - 1 && fg[ly - 1][lx + 1]) unite(par, i, i - kTile + 1);
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ty + k * (kTile / kRowsPerThread), y = y0 + ly;
    if (x >= g.w || y >= g.h) continue;
    const int i = (int)(base + (long)y * g.w + x);
    int root = kBig;
    if (fg[ly][lx]) {
      // the forest is fixed now: a plain walk
      int r = ly * kTile + lx;
      while (par[r] != r) r = par[r];
      root = (int)(base + (long)(y0 + r / kTile) * g.w + x0 + r % kTile);
      if (root == i) lab[i] = i;
    }
    loc[i] = root;
  }
}

// every walk starts at a local root, and unions link roots, so the global
// forest holds local roots only: loc is never written here
__global__ void __launch_bounds__(kBorderTiles * kBorderLanes)
cca_border(const int* __restrict__ loc, int* __restrict__ lab, Geometry g,
           int n_tiles) {
  const int t = blockIdx.x * kBorderTiles + threadIdx.x / kBorderLanes;
  const int lane = threadIdx.x % kBorderLanes;
  if (t >= n_tiles || lane == kBorderLanes - 1) return;
  int img, y0, x0;
  g.tile(t, img, y0, x0);
  // lanes 0-31: the first row; lanes 32-62: the first column below it
  const bool row = lane < kTile;
  const int y = row ? y0 : y0 + lane - kTile + 1;
  const int x = row ? x0 + lane : x0;
  if (y >= g.h || x >= g.w) return;
  const long base = (long)img * g.h * g.w;
  const int i = (int)(base + (long)y * g.w + x);
  const int li = loc[i];
  if (li == kBig) return;
  const auto join = [&](int j) { unite(lab, li, loc[j]); };
  const auto on = [&](int j) { return loc[j] != kBig; };
  if (row && y > 0) {
    // N; NW and NE only where N does not join them (NW-N and N-NE are W
    // edges, which are never skipped)
    const int up = i - g.w;
    if (on(up)) {
      join(up);
    } else {
      if (x > 0 && on(up - 1)) join(up - 1);
      if (x < g.w - 1 && on(up + 1)) join(up + 1);
    }
  }
  if (x0 > 0 && x == x0) {
    // W; NW below the first row (the row lanes took it there) unless W
    // or N joins it; SW unless W or S joins it (W-NW and W-SW are N edges,
    // N-NW and S-SW W edges, and neither kind is skipped)
    const bool wf = on(i - 1);
    if (wf) join(i - 1);
    if (!wf && !row && y > 0 && !on(i - g.w) && on(i - g.w - 1))
      join(i - g.w - 1);
    if (!wf && y < g.h - 1 && !on(i + g.w) && on(i + g.w - 1))
      join(i + g.w - 1);
  }
}

// per tile: each local root walks to its root once (splitting the path on
// the way: the forest is fixed, so any ancestor is a valid parent) and
// shares it through shared memory; loc becomes the output in place
__global__ void __launch_bounds__(kThreads)
cca_resolve(int* loc, int* __restrict__ lab, Geometry g) {
  __shared__ int root[kTile * kTile];
  int img, y0, x0;
  g.tile(blockIdx.x, img, y0, x0);
  const long base = (long)img * g.h * g.w;
  const int lx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int x = x0 + lx;
  const int tile0 = (int)(base + (long)y0 * g.w + x0);
  int v[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ty + k * (kTile / kRowsPerThread), y = y0 + ly;
    const int i = (int)(base + (long)y * g.w + x);
    v[k] = x < g.w && y < g.h ? loc[i] : kBig;
    if (v[k] == i) {
      int r = i, p = lab[r];
      while (p != r) {
        const int gp = lab[p];
        if (gp != p) lab[r] = gp;
        r = p;
        p = gp;
      }
      root[ly * kTile + lx] = r;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ty + k * (kTile / kRowsPerThread), y = y0 + ly;
    if (x >= g.w || y >= g.h) continue;
    int o = kBig;
    if (v[k] != kBig) {
      // the local root lies in this tile: its slot
      const int rel = v[k] - tile0;
      const int ry = rel / g.w;
      o = (int)(root[ry * kTile + rel - ry * g.w] - base);
    }
    loc[base + (long)y * g.w + x] = o;
  }
}

}  // namespace

// mask: (B, H, W) uint8, nonzero = foreground; scratch: (B, H, W) int32,
// the forest of local roots; out: (B, H, W) int32, first each pixel's
// local root, then its label.  B*H*W must stay below 2^30.
extern "C" int ptk_cca_label(const void* mask, void* scratch, void* out,
                             int b, int h, int w, void* stream) {
  if ((long)b * h * w == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g{h, w, (w + kTile - 1) / kTile, (h + kTile - 1) / kTile};
  const int n_tiles = b * g.tiles_x * g.tiles_y;
  int* lab = static_cast<int*>(scratch);
  int* loc = static_cast<int*>(out);
  cca_local<<<n_tiles, kThreads, 0, st>>>(
      static_cast<const unsigned char*>(mask), loc, lab, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cca_border<<<(n_tiles + kBorderTiles - 1) / kBorderTiles,
               kBorderTiles * kBorderLanes, 0, st>>>(loc, lab, g, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cca_resolve<<<n_tiles, kThreads, 0, st>>>(loc, lab, g);
  return (int)cudaGetLastError();
}
