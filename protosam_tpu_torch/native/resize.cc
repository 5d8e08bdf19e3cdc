// The float32 resizes of slice stacks for data/prepare.py: the two-tap
// INTER_LINEAR path OpenCV 5 takes for channel counts other than 1, 3 and 4
// (``_resize_generic``; the medical ingest's (H, W, Z) stacks), and the
// gather of an INTER_NEAREST resize of one plane (``resize_nearest``).
// Each linear pass is a weighted sum of two taps, both products and their
// sum rounded to float32 in that order, as numpy's ``a * w0 + b * w1``
// rounds them; the caller computes the taps and weights.
//
// Built at first use by native/build.py (g++ -O3 -shared -fPIC into
// protosam_tpu_torch/_build/).  No product may fuse with its sum, so
// contraction into fma is off for this file.

#pragma GCC optimize("fp-contract=off")

#include <cstdint>

extern "C" {

// One plane: src (h, w) -> tmp (h, nw) -> out (nh, nw), the horizontal
// pass tmp[y, x] = src[y, xlo[x]] * xw0[x] + src[y, xhi[x]] * xw1[x],
// then the vertical out[y] = tmp[ylo[y]] * yw0[y] + tmp[yhi[y]] * yw1[y].
void rs_linear(const float* src, int64_t h, int64_t w, int64_t nh,
               int64_t nw, const int64_t* xlo, const int64_t* xhi,
               const float* xw0, const float* xw1, const int64_t* ylo,
               const int64_t* yhi, const float* yw0, const float* yw1,
               float* tmp, float* out) {
  for (int64_t y = 0; y < h; ++y) {
    const float* s = src + y * w;
    float* t = tmp + y * nw;
    for (int64_t x = 0; x < nw; ++x) {
      const float p = s[xlo[x]] * xw0[x];
      const float q = s[xhi[x]] * xw1[x];
      t[x] = p + q;
    }
  }
  for (int64_t y = 0; y < nh; ++y) {
    const float* a = tmp + ylo[y] * nw;
    const float* b = tmp + yhi[y] * nw;
    const float w0 = yw0[y], w1 = yw1[y];
    float* o = out + y * nw;
    for (int64_t x = 0; x < nw; ++x) {
      const float p = a[x] * w0;
      const float q = b[x] * w1;
      o[x] = p + q;
    }
  }
}

// A nearest resize of one plane: src (h, w) -> out (nh, nw),
// out[y, x] = src[yidx[y], xidx[x]].
void rs_nearest(const float* src, int64_t w, int64_t nh, int64_t nw,
                const int64_t* xidx, const int64_t* yidx, float* out) {
  for (int64_t y = 0; y < nh; ++y) {
    const float* s = src + yidx[y] * w;
    float* o = out + y * nw;
    for (int64_t x = 0; x < nw; ++x) o[x] = s[xidx[x]];
  }
}

}  // extern "C"
