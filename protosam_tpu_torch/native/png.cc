// PNG scanline unfiltering (the five filters of the PNG specification,
// section 9: None, Sub, Up, Average, Paeth) for data/png.py, which inflates
// the image data with Python's zlib and hands the filtered rows here.
//
// Built at first use by native/build.py (g++ -O3 -shared -fPIC into
// protosam_tpu_torch/_build/).  Integer arithmetic only: the result is the
// same bytes libpng produces.

#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: h rows of 1 + row_bytes bytes (the filter type, then the filtered
// bytes); out: h rows of row_bytes bytes; bpp: bytes a pixel (1-4).
// Returns 0, or 1 + the index of the first row whose filter type is not
// 0-4 (nothing is decoded past it).
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t row_bytes,
                     int64_t bpp, uint8_t* out) {
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t kind = raw[r * (row_bytes + 1)];
    const uint8_t* x = raw + r * (row_bytes + 1) + 1;
    uint8_t* cur = out + r * row_bytes;
    const uint8_t* up = r ? cur - row_bytes : nullptr;
    switch (kind) {
      case 0:
        for (int64_t i = 0; i < row_bytes; ++i) cur[i] = x[i];
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = uint8_t(x[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = uint8_t(x[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          cur[i] = uint8_t(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = uint8_t(x[i] + pred);
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

}  // extern "C"
