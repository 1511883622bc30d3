// Host C++ (not a CUDA kernel): PNG scanline unfiltering and the depth
// fold of the port's depth-PNG reader, in one pass over the inflated
// image.  It stands in for the unfilter and fold of the JAX package's
// C++ extension (native/awr_host.cpp); the chunk parse and the inflate
// stay in Python (stdlib zlib, which drops the GIL), and this function
// is called through ctypes, which drops it too, so loader threads
// overlap.
//
// Built at first use with the host C++ compiler into build/awr_tpu_torch/
// (awr_tpu_torch/kernels.py).  Bound by memory: one read of the inflated
// rows, one write of the unfiltered bytes and of the float32 depth.
//
// Depth fold (reference nyu_loader.py:71-74):
//   bpp 3 / 4 (8-bit RGB / RGBA): depth = blue + 256 * green; PNG stores
//     R, G, B[, A], so blue is byte 2 and green byte 1 of a pixel.
//   bpp 2 (16-bit gray): depth = the big-endian uint16.

#include <cstdint>
#include <cstdlib>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

// raw: height rows of (1 + width * bpp) bytes, each a filter byte and the
// filtered row.  pixels: (height, width * bpp) bytes, the unfiltered image
// (written).  depth: (height, width) float32 (written).  Returns 0, or
// 1 + the index of the first row whose filter byte is not 0-4.
extern "C" int awr_png_unfilter_depth(const uint8_t* raw, int64_t height,
                                      int64_t width, int bpp,
                                      uint8_t* pixels, float* depth) {
  const int64_t stride = width * bpp;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const uint8_t filter = line[0];
    const uint8_t* src = line + 1;
    uint8_t* cur = pixels + y * stride;
    const uint8_t* prev = y ? cur - stride : nullptr;
    switch (filter) {
      case 0:  // None
        for (int64_t i = 0; i < stride; ++i) cur[i] = src[i];
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          cur[i] = uint8_t(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          const int upleft = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = uint8_t(src[i] + paeth(left, up, upleft));
        }
        break;
      default:
        return int(y) + 1;
    }
    float* drow = depth + y * width;
    if (bpp == 2) {
      for (int64_t x = 0; x < width; ++x)
        drow[x] = float((uint32_t(cur[2 * x]) << 8) | cur[2 * x + 1]);
    } else {
      for (int64_t x = 0; x < width; ++x) {
        const uint8_t* px = cur + x * bpp;
        drow[x] = float(px[2]) + 256.0f * float(px[1]);
      }
    }
  }
  return 0;
}
