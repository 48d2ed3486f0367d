/* Undo the row filters of a decompressed, non-interlaced PNG image.
 *
 * `raw` holds `height` rows of 1 + `stride` bytes: a row's filter type, then
 * its filtered bytes. `out` receives height x stride pixel bytes. `bpp` is
 * the bytes of one pixel (at least 1): the filters predict a byte from the
 * byte `bpp` to its left, the one above and the one above-left, each 0
 * outside the image (PNG specification, section 9).
 *
 * Returns 0, or 1 + the index of the first row whose filter type is not
 * one of the five; rows after it are not written.
 *
 * A plain C interface, called through ctypes, which releases the GIL for
 * the call: decode threads run it in parallel.
 */
#include <stdint.h>
#include <string.h>

static inline int iabs(int v) { return v < 0 ? -v : v; }

int64_t mde_png_unfilter(const uint8_t *raw, uint8_t *out, int64_t height, int64_t stride,
                         int64_t bpp) {
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t *in = raw + r * (stride + 1) + 1;
    uint8_t *cur = out + r * stride;
    const uint8_t *up = r ? cur - stride : NULL;
    int64_t i;
    switch (raw[r * (stride + 1)]) {
      case 0: /* None */
        memcpy(cur, in, (size_t)stride);
        break;
      case 1: /* Sub */
        for (i = 0; i < stride && i < bpp; ++i) cur[i] = in[i];
        for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
        break;
      case 2: /* Up */
        if (up) {
          for (i = 0; i < stride; ++i) cur[i] = (uint8_t)(in[i] + up[i]);
        } else {
          memcpy(cur, in, (size_t)stride);
        }
        break;
      case 3: /* Average */
        for (i = 0; i < stride && i < bpp; ++i) cur[i] = (uint8_t)(in[i] + ((up ? up[i] : 0) >> 1));
        if (up) {
          for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + ((cur[i - bpp] + up[i]) >> 1));
        } else {
          for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + (cur[i - bpp] >> 1));
        }
        break;
      case 4: /* Paeth; with no row above it predicts the left byte, as Sub */
        for (i = 0; i < stride && i < bpp; ++i) cur[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        if (up) {
          for (; i < stride; ++i) {
            int a = cur[i - bpp], b = up[i], c = up[i - bpp];
            int pa = iabs(b - c), pb = iabs(a - c), pc = iabs(a + b - 2 * c);
            int pred = pb <= pc ? b : c;
            pred = pa <= pb && pa <= pc ? a : pred;
            cur[i] = (uint8_t)(in[i] + pred);
          }
        } else {
          for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}
