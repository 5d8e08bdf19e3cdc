// Felzenszwalb-Huttenlocher graph segmentation (single-channel 2D).
//
// Native replacement for skimage.segmentation.felzenszwalb as used by the
// reference's offline superpixel pseudo-label generation
// (data/data_processing.ipynb: felzenszwalb(img2d, min_size=400, sigma=1),
// scale k=1): gaussian smoothing, 8-connected intensity-difference edges,
// Kruskal joins under the adaptive threshold int(C) + k/|C|, then a
// min_size merge pass.  Labels are compacted to 0..n-1.
//
// A copy of protosam_tpu/native/felzenszwalb.cc.  Built at first use by
// native/build.py (g++ -O3 -shared -fPIC into protosam_tpu_torch/_build/).
// Keep std::sort and its comparator as they are: equal-weight edges then
// join in the same order, and the labels stay bit-equal to the JAX copy's
// when both are built with the same compiler.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct DSU {
  std::vector<int32_t> parent, rank_, size;
  explicit DSU(int n) : parent(n), rank_(n, 0), size(n, 1) {
    for (int i = 0; i < n; ++i) parent[i] = i;
  }
  int find(int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  int join(int a, int b) {
    a = find(a); b = find(b);
    if (a == b) return a;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    if (rank_[a] == rank_[b]) ++rank_[a];
    return a;
  }
};

struct Edge {
  float w;
  int32_t a, b;
};

void gaussian_blur(const float* src, float* dst, int h, int w, float sigma) {
  if (sigma <= 0) {
    memcpy(dst, src, sizeof(float) * h * w);
    return;
  }
  const int r = std::max(1, (int)std::ceil(3 * sigma));
  std::vector<float> k(2 * r + 1);
  float sum = 0;
  for (int i = -r; i <= r; ++i) {
    k[i + r] = std::exp(-(float)(i * i) / (2 * sigma * sigma));
    sum += k[i + r];
  }
  for (auto& v : k) v /= sum;
  std::vector<float> tmp(h * w);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      float acc = 0;
      for (int i = -r; i <= r; ++i) {
        int xx = std::min(std::max(x + i, 0), w - 1);
        acc += src[y * w + xx] * k[i + r];
      }
      tmp[y * w + x] = acc;
    }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      float acc = 0;
      for (int i = -r; i <= r; ++i) {
        int yy = std::min(std::max(y + i, 0), h - 1);
        acc += tmp[yy * w + x] * k[i + r];
      }
      dst[y * w + x] = acc;
    }
}

}  // namespace

extern "C" {

// img: (h, w) float32 -> labels (h, w) int32, returns number of segments
int felzenszwalb_2d(const float* img, int h, int w, float scale, float sigma,
                    int min_size, int32_t* labels_out) {
  const int n = h * w;
  std::vector<float> smooth(n);
  gaussian_blur(img, smooth.data(), h, w, sigma);

  std::vector<Edge> edges;
  edges.reserve(4 * n);
  const int dx[4] = {1, 0, 1, -1};
  const int dy[4] = {0, 1, 1, 1};
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int d = 0; d < 4; ++d) {
        const int nx = x + dx[d], ny = y + dy[d];
        if (nx < 0 || nx >= w || ny >= h) continue;
        const int a = y * w + x, b = ny * w + nx;
        edges.push_back({std::fabs(smooth[a] - smooth[b]), a, b});
      }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& l, const Edge& r) { return l.w < r.w; });

  DSU dsu(n);
  std::vector<float> threshold(n, scale);
  for (const Edge& e : edges) {
    const int a = dsu.find(e.a), b = dsu.find(e.b);
    if (a == b) continue;
    if (e.w <= threshold[a] && e.w <= threshold[b]) {
      const int r = dsu.join(a, b);
      threshold[r] = e.w + scale / dsu.size[r];
    }
  }
  // min-size merge pass
  for (const Edge& e : edges) {
    const int a = dsu.find(e.a), b = dsu.find(e.b);
    if (a != b && (dsu.size[a] < min_size || dsu.size[b] < min_size))
      dsu.join(a, b);
  }

  // compact labels to 0..k-1
  std::vector<int32_t> remap(n, -1);
  int next = 0;
  for (int i = 0; i < n; ++i) {
    const int r = dsu.find(i);
    if (remap[r] < 0) remap[r] = next++;
    labels_out[i] = remap[r];
  }
  return next;
}

}  // extern "C"
