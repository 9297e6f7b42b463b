// gsmpm_tpu_torch native IO tier: PNG scanline unfiltering.
//
// A PNG stores each row of an 8-bit image behind a filter byte: 0 none,
// 1 sub (left), 2 up, 3 average of left and up, 4 Paeth of left, up and
// up-left. Undoing Sub, Average and Paeth is a serial recurrence along the
// row, which numpy cannot vectorise; here it is one pass over the inflated
// bytes (zlib's inflate stays in Python). The numpy twin is
// gsmpm_tpu_torch/io/dataset.py:_unfilter_numpy; io/_native.py binds this
// entry point with ctypes.
//
// Build: gsmpm_tpu_torch/utils/build.py (g++ -O3 -std=c++17 -shared -fPIC
// -pthread, with gsmpm_native.cpp and gsmpm_video.cpp).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// raw: h rows of (1 filter byte + stride bytes); out: h * stride bytes;
// bpp: bytes per pixel (1-4). Returns 0, -1 on bad sizes, or y + 1 for
// the first row whose filter byte is not 0-4 (out is then partial).
int gsn_png_unfilter(const uint8_t* raw, long long h, long long stride,
                     int bpp, uint8_t* out) {
  if (h < 0 || stride < 0 || bpp < 1 || bpp > 8) return -1;
  const std::vector<uint8_t> zeros(static_cast<size_t>(stride), 0);
  for (long long y = 0; y < h; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const uint8_t* f = line + 1;
    const uint8_t* up = y ? out + (y - 1) * stride : zeros.data();
    uint8_t* cur = out + y * stride;
    const long long lead = bpp < stride ? bpp : stride;
    switch (line[0]) {
      case 0:
        std::memcpy(cur, f, static_cast<size_t>(stride));
        break;
      case 1:
        std::memcpy(cur, f, static_cast<size_t>(lead));
        for (long long i = bpp; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(f[i] + cur[i - bpp]);
        break;
      case 2:
        for (long long i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(f[i] + up[i]);
        break;
      case 3:
        for (long long i = 0; i < lead; ++i)
          cur[i] = static_cast<uint8_t>(f[i] + (up[i] >> 1));
        for (long long i = bpp; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(f[i] + ((cur[i - bpp] + up[i]) >> 1));
        break;
      case 4:
        for (long long i = 0; i < lead; ++i)
          cur[i] = static_cast<uint8_t>(f[i] + up[i]);
        for (long long i = bpp; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(
              f[i] + paeth(cur[i - bpp], up[i], up[i - bpp]));
        break;
      default:
        return static_cast<int>(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
