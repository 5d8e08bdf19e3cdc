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
// one host check per iteration.  Here the labels come from union-find with
// three launches and no host round trip:
//   1. init:     fg label = own flat index, bg = 2^30;
//   2. merge:    each fg pixel unites with its W, NW, N and NE fg
//                neighbours (every 8-connected edge is seen once);
//   3. compress: label = root of the pixel's tree.
// A union always links the larger root under the smaller with atomicMin
// and retries until both sides share one root (Playne & Hawick 2018), so
// parent <= child everywhere and every root is its tree's minimum index.
// The final labels therefore do not depend on the order of the atomics.
//
// Bound on the card: latency of dependent loads while walking trees in L2
// (the label grid of a 1024^2 slice is 4 MB).  The design keeps one
// thread per pixel and no shared memory; compress writes each pixel's
// root back, which shortens the walks of later threads.
#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;

__global__ void cca_init(const unsigned char* __restrict__ mask,
                         int* __restrict__ lab, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) lab[i] = mask[i] ? i : kBig;
}

__device__ __forceinline__ int find_root(volatile const int* lab, int x) {
  int p = lab[x];
  while (p != x) {
    x = p;
    p = lab[x];
  }
  return x;
}

__device__ void unite(int* lab, int a, int b) {
  volatile const int* vlab = lab;
  while (true) {
    a = find_root(vlab, a);
    b = find_root(vlab, b);
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

__global__ void cca_merge(const unsigned char* __restrict__ mask,
                          int* __restrict__ lab, int n, int h, int w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || !mask[i]) return;
  const int r = i % (h * w);
  const int y = r / w, x = r % w;
  if (x > 0 && mask[i - 1]) unite(lab, i, i - 1);
  if (y > 0) {
    const int up = i - w;
    if (x > 0 && mask[up - 1]) unite(lab, i, up - 1);
    if (mask[up]) unite(lab, i, up);
    if (x < w - 1 && mask[up + 1]) unite(lab, i, up + 1);
  }
}

__global__ void cca_compress(const unsigned char* __restrict__ mask,
                             int* __restrict__ lab, int* __restrict__ out,
                             int n, int hw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (!mask[i]) {
    out[i] = kBig;
    return;
  }
  // the forest is fixed during this launch, and writing a root into lab[i]
  // only shortens other threads' walks
  const int root = find_root(lab, i);
  lab[i] = root;
  out[i] = root - (i / hw) * hw;
}

}  // namespace

// mask: (B, H, W) uint8, nonzero = foreground; scratch: (B, H, W) int32;
// out: (B, H, W) int32.  B*H*W must stay below 2^30.
extern "C" int ptk_cca_label(const void* mask, void* scratch, void* out,
                             int b, int h, int w, void* stream) {
  const int n = b * h * w;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* lab = static_cast<int*>(scratch);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cca_init<<<grid, kThreads, 0, st>>>(m, lab, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cca_merge<<<grid, kThreads, 0, st>>>(m, lab, n, h, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cca_compress<<<grid, kThreads, 0, st>>>(m, lab, static_cast<int*>(out), n,
                                          h * w);
  return (int)cudaGetLastError();
}
