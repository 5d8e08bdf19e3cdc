// nifti_feeder: native NIfTI-1 volume parser + slice preprocessor (a copy
// of protosam_tpu/native/nifti_feeder.cc without its file reading).
//
// Replaces the per-scan Python read->resize->normalize loop of the reference
// data layer (SimpleITK read + cv2.resize + numpy normalize,
// reference dataloaders/ManualAnnoDatasetv2.py:151-227) with a single C++
// pass.  The caller reads the file (gunzipping .nii.gz) and hands over its
// bytes, so the library needs no zlib.
//
// C ABI (ctypes):
//   nf_parse_volume(buf, len, dims[3] out, spacing[3] out, data** out) -> int
//       parses the bytes of a .nii file into a malloc'd float32 buffer in
//       (z, y, x) order with scl slope/inter applied.  Returns 0 on success.
//   nf_preprocess(vol, z, y, x, out_hw, mode, mean, std, out*) -> int
//       bilinear-resizes every slice to (out_hw, out_hw) (cv2.INTER_LINEAR
//       semantics: half-pixel centers) and normalizes:
//       mode 0: (x - mean) / std  (CT global stats)
//       mode 1: volume z-score    (MR)
//   nf_resize_nearest(...)  nearest (torch legacy floor) for label volumes.
//   nf_free(ptr)
//
// Built at first use by native/build.py (g++ -O3 -shared -fPIC), the JAX
// copy's flags, so nf_preprocess gives the JAX copy's bits.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

template <typename T>
void convert(const uint8_t* src, float* dst, size_t count, float slope,
             float inter) {
  const T* s = reinterpret_cast<const T*>(src);
  for (size_t i = 0; i < count; ++i) dst[i] = (float)s[i] * slope + inter;
}

inline int16_t rd16(const uint8_t* p) { int16_t v; memcpy(&v, p, 2); return v; }
inline int32_t rd32(const uint8_t* p) { int32_t v; memcpy(&v, p, 4); return v; }
inline float rdf(const uint8_t* p) { float v; memcpy(&v, p, 4); return v; }

}  // namespace

extern "C" {

int nf_parse_volume(const uint8_t* buf, int64_t len, int64_t dims[3],
                    float spacing[3], float** data_out) {
  if (len < 352) return 1;
  const uint8_t* h = buf;
  if (rd32(h) != 348) return 2;  // sizeof_hdr

  const int64_t nx = rd16(h + 42), ny = rd16(h + 44);
  const int64_t nz = rd16(h + 40) >= 3 ? rd16(h + 46) : 1;
  const int16_t datatype = rd16(h + 70);
  const float sx = rdf(h + 80), sy = rdf(h + 84), sz = rdf(h + 88);
  const int64_t vox_offset = (int64_t)rdf(h + 108);
  if (vox_offset < 348 || vox_offset > len || nx < 1 || ny < 1 || nz < 1)
    return 2;
  float slope = rdf(h + 112), inter = rdf(h + 116);
  if (slope == 0.0f) slope = 1.0f;

  const size_t count = (size_t)(nx * ny * nz);
  const uint8_t* body = buf + vox_offset;
  const size_t avail = (size_t)(len - vox_offset);
  float* out = (float*)malloc(count * sizeof(float));
  if (!out) return 3;

  // disk order is Fortran (x fastest) == C-order of the (z, y, x) view
  switch (datatype) {
    case 2:    if (avail < count)     { free(out); return 4; }
               convert<uint8_t>(body, out, count, slope, inter); break;
    case 4:    if (avail < count * 2) { free(out); return 4; }
               convert<int16_t>(body, out, count, slope, inter); break;
    case 8:    if (avail < count * 4) { free(out); return 4; }
               convert<int32_t>(body, out, count, slope, inter); break;
    case 16:   if (avail < count * 4) { free(out); return 4; }
               convert<float>(body, out, count, slope, inter); break;
    case 64:   if (avail < count * 8) { free(out); return 4; }
               convert<double>(body, out, count, slope, inter); break;
    case 256:  if (avail < count)     { free(out); return 4; }
               convert<int8_t>(body, out, count, slope, inter); break;
    case 512:  if (avail < count * 2) { free(out); return 4; }
               convert<uint16_t>(body, out, count, slope, inter); break;
    default:   free(out); return 5;
  }

  dims[0] = nz; dims[1] = ny; dims[2] = nx;
  spacing[0] = sx; spacing[1] = sy; spacing[2] = sz;
  *data_out = out;
  return 0;
}

// cv2.INTER_LINEAR semantics: src = (dst + 0.5) * scale - 0.5, border clamp
int nf_preprocess(const float* vol, int64_t z, int64_t y, int64_t x,
                  int64_t out_hw, int mode, float mean, float std_,
                  float* out) {
  if (mode == 1) {  // MR per-volume z-score
    double s = 0, s2 = 0;
    const size_t n = (size_t)(z * y * x);
    for (size_t i = 0; i < n; ++i) { s += vol[i]; }
    mean = (float)(s / n);
    for (size_t i = 0; i < n; ++i) {
      const double d = vol[i] - mean; s2 += d * d;
    }
    std_ = (float)std::sqrt(s2 / n);
  }
  const float sy = (float)y / out_hw, sx = (float)x / out_hw;
  for (int64_t k = 0; k < z; ++k) {
    const float* sl = vol + k * y * x;
    float* dst = out + k * out_hw * out_hw;
    for (int64_t i = 0; i < out_hw; ++i) {
      float fy = (i + 0.5f) * sy - 0.5f;
      if (fy < 0) fy = 0;
      int64_t y0 = (int64_t)fy;
      if (y0 > y - 2) y0 = y - 2 >= 0 ? y - 2 : 0;
      float wy = fy - y0;
      if (wy > 1) wy = 1;
      for (int64_t j = 0; j < out_hw; ++j) {
        float fx = (j + 0.5f) * sx - 0.5f;
        if (fx < 0) fx = 0;
        int64_t x0 = (int64_t)fx;
        if (x0 > x - 2) x0 = x - 2 >= 0 ? x - 2 : 0;
        float wx = fx - x0;
        if (wx > 1) wx = 1;
        const int64_t x1 = x0 + 1 < x ? x0 + 1 : x - 1;
        const int64_t y1 = y0 + 1 < y ? y0 + 1 : y - 1;
        const float v =
            sl[y0 * x + x0] * (1 - wy) * (1 - wx) +
            sl[y0 * x + x1] * (1 - wy) * wx +
            sl[y1 * x + x0] * wy * (1 - wx) +
            sl[y1 * x + x1] * wy * wx;
        dst[i * out_hw + j] = (v - mean) / std_;
      }
    }
  }
  return 0;
}

// torch-legacy nearest (floor(i * in/out)) for label volumes
int nf_resize_nearest(const float* vol, int64_t z, int64_t y, int64_t x,
                      int64_t out_hw, float* out) {
  for (int64_t k = 0; k < z; ++k) {
    const float* sl = vol + k * y * x;
    float* dst = out + k * out_hw * out_hw;
    for (int64_t i = 0; i < out_hw; ++i) {
      int64_t yi = (int64_t)(i * (double)y / out_hw);
      if (yi > y - 1) yi = y - 1;
      for (int64_t j = 0; j < out_hw; ++j) {
        int64_t xj = (int64_t)(j * (double)x / out_hw);
        if (xj > x - 1) xj = x - 1;
        dst[i * out_hw + j] = sl[yi * x + xj];
      }
    }
  }
  return 0;
}

void nf_free(float* p) { free(p); }

}  // extern "C"
