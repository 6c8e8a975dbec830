// PNG scanline unfiltering (PNG specification, section 9: filter types 0-4)
// for the port's PNG decoder, mre_tpu_torch/data/images.py::decode_png.
// Average (3) and Paeth (4) rows predict each byte from the byte decoded to
// its left, so a row runs byte by byte; PIL's encoder picks those filters
// for many rows. Called through ctypes, which releases the GIL, so the image
// pipeline's threads decode in parallel.
#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: height rows of [filter byte | stride bytes]; out: height x stride.
// Returns 0, or 1 + the index of the first row with an unknown filter type.
int png_unfilter(const uint8_t *raw, int64_t height, int64_t stride, int64_t bpp,
                 uint8_t *out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t *line = raw + y * (stride + 1);
    const int ftype = line[0];
    const uint8_t *src = line + 1;
    uint8_t *cur = out + y * stride;
    const uint8_t *prev = y > 0 ? out + (y - 1) * stride : nullptr;
    if (ftype > 4) return static_cast<int>(y + 1);
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev != nullptr ? prev[i] : 0;
      const int c = prev != nullptr && i >= bpp ? prev[i - bpp] : 0;
      int pred = 0;
      if (ftype == 1) {
        pred = a;
      } else if (ftype == 2) {
        pred = b;
      } else if (ftype == 3) {
        pred = (a + b) >> 1;
      } else if (ftype == 4) {
        const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
        pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
      }
      cur[i] = static_cast<uint8_t>(src[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
