// The port's native image loader: threaded PNG/JPEG decode + resize, linked
// against zlib alone (no libpng, no libjpeg).
//
// The real Canon captures' l/r views are decoded and resized here when the
// dataset engine is ``native`` (dfdp/datasets.py). The output is the JAX
// package's native engine's (sdirt_tpu/native/src/sdirt_loader.cc, libpng +
// libjpeg): float32 CHW raw sample values written into a caller's buffer.
//
//   * Resize: the JAX engine's Catmull-Rom (a = -0.75, cv2's half-pixel
//     mapping, normalised taps) and cv2's nearest rule, copied with its float
//     arithmetic: a horizontal pass per decoded row, then a vertical pass.
//     Grey input is replicated to the output channels; a colour file read
//     with one channel gives its first (R).
//   * PNG: chunks (IHDR, PLTE, IDAT, IEND; CRCs of critical chunks checked),
//     zlib inflate, the five scanline filters, Adam7 de-interlacing, and the
//     libpng transforms the JAX engine asks for: palette -> RGB, 1/2/4-bit
//     grey -> 8-bit by bit replication, tRNS -> alpha and alpha stripped
//     (so tRNS changes no sample), 16-bit samples in host order.
//   * JPEG: a translation of io/jpeg.py (8-bit baseline and extended
//     sequential Huffman, 1 or 3 components, sampling 1x1 / 2x1 / 2x2,
//     interleaved or per-component scans, restart markers; the islow IDCT
//     with libjpeg's range-limit wraparound, fancy upsampling and jdcolor's
//     fixed-point YCbCr -> RGB), equal to it sample for sample. Whatever
//     io/jpeg.py refuses (progressive, lossless, arithmetic coding, 12-bit,
//     2- and 4-component files) is refused here.
//
// A file that cannot be read, is corrupt, truncated or refused gives -1:
// every read is bounds-checked, nothing exits, aborts or jumps out of a
// thread, and no exception leaves the C functions.
//
// C ABI (ctypes), the JAX engine's:
//   sdirt_decode_resize(path, out, th, tw, channels, interp)
//     returns -1 on failure, 0 for 8-bit sources, 1 for 16-bit PNGs
//   sdirt_load_batch(paths, n, out, th, tw, channels, interp, n_threads,
//                    bit16 /* optional [n] out: 0/1 per file, may be null */)
//     returns 0, or minus the number of files that failed
// interp: 0 = nearest, 1 = bicubic. Outputs raw sample values (8-bit:
// 0..255, 16-bit PNG: 0..65535); the caller normalises.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Resize (sdirt_tpu/native/src/sdirt_loader.cc:39-156, unchanged arithmetic)
// ---------------------------------------------------------------------------

inline float cubic_w(float x) {
  // cv2 INTER_CUBIC kernel (a = -0.75)
  const float a = -0.75f;
  x = std::fabs(x);
  if (x <= 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

struct CubicTaps {
  std::vector<int> idx;    // [n][4] clamped source indices
  std::vector<float> w;    // [n][4] normalized weights
};

CubicTaps make_taps(int n_out, int n_src) {
  CubicTaps t;
  t.idx.resize((size_t)n_out * 4);
  t.w.resize((size_t)n_out * 4);
  const float s = (float)n_src / n_out;
  for (int o = 0; o < n_out; o++) {
    float f = (o + 0.5f) * s - 0.5f;   // half-pixel mapping (cv2 convention)
    int i0 = (int)std::floor(f);
    float d = f - i0;
    float wsum = 0.0f;
    for (int j = 0; j < 4; j++) {
      int si = i0 - 1 + j;
      si = si < 0 ? 0 : (si >= n_src ? n_src - 1 : si);
      float wgt = cubic_w((j - 1) - d);
      t.idx[o * 4 + j] = si;
      t.w[o * 4 + j] = wgt;
      wsum += wgt;
    }
    for (int j = 0; j < 4; j++) t.w[o * 4 + j] /= wsum;
  }
  return t;
}

std::vector<int> make_nearest(int n_out, int n_src) {
  // cv2 INTER_NEAREST: floor of the non-centered source index
  std::vector<int> idx(n_out);
  const float s = (float)n_src / n_out;
  for (int o = 0; o < n_out; o++) {
    int i = (int)(o * s);
    idx[o] = i >= n_src ? n_src - 1 : i;
  }
  return idx;
}

// Streaming resizer: feed source rows (interleaved uint8/uint16), collects
// horizontally-resized float rows, finishes with a vertical pass.
struct StreamResizer {
  int sw, sh, sc, tw, th, out_c, interp;
  CubicTaps tx;
  std::vector<int> nx;
  std::vector<float> hrows;   // [out_c, sh, tw]
  float* out;                 // [out_c, th, tw]

  void init(int sw_, int sh_, int sc_, int tw_, int th_, int out_c_,
            int interp_, float* out_) {
    sw = sw_; sh = sh_; sc = sc_; tw = tw_; th = th_; out_c = out_c_;
    interp = interp_; out = out_;
    if (interp == 1)
      tx = make_taps(tw, sw);
    else
      nx = make_nearest(tw, sw);
    hrows.resize((size_t)out_c * sh * tw);
  }

  template <typename T>
  void feed_row(int y, const T* row) {
    for (int ch = 0; ch < out_c; ch++) {
      int c = ch < sc ? ch : 0;  // gray -> replicate
      float* dst = hrows.data() + ((size_t)ch * sh + y) * tw;
      if (interp == 1) {
        const int* id = tx.idx.data();
        const float* wt = tx.w.data();
        for (int ox = 0; ox < tw; ox++, id += 4, wt += 4) {
          dst[ox] = wt[0] * (float)row[(size_t)id[0] * sc + c] +
                    wt[1] * (float)row[(size_t)id[1] * sc + c] +
                    wt[2] * (float)row[(size_t)id[2] * sc + c] +
                    wt[3] * (float)row[(size_t)id[3] * sc + c];
        }
      } else {
        for (int ox = 0; ox < tw; ox++)
          dst[ox] = (float)row[(size_t)nx[ox] * sc + c];
      }
    }
  }

  void finish() {
    if (interp == 1) {
      CubicTaps ty = make_taps(th, sh);
      for (int ch = 0; ch < out_c; ch++) {
        const float* plane = hrows.data() + (size_t)ch * sh * tw;
        for (int oy = 0; oy < th; oy++) {
          const int* id = ty.idx.data() + oy * 4;
          const float* wt = ty.w.data() + oy * 4;
          const float *r0 = plane + (size_t)id[0] * tw,
                      *r1 = plane + (size_t)id[1] * tw,
                      *r2 = plane + (size_t)id[2] * tw,
                      *r3 = plane + (size_t)id[3] * tw;
          float* dst = out + ((size_t)ch * th + oy) * tw;
          for (int ox = 0; ox < tw; ox++)
            dst[ox] = wt[0] * r0[ox] + wt[1] * r1[ox] + wt[2] * r2[ox] +
                      wt[3] * r3[ox];
        }
      }
    } else {
      std::vector<int> ny = make_nearest(th, sh);
      for (int ch = 0; ch < out_c; ch++) {
        const float* plane = hrows.data() + (size_t)ch * sh * tw;
        for (int oy = 0; oy < th; oy++)
          std::memcpy(out + ((size_t)ch * th + oy) * tw,
                      plane + (size_t)ny[oy] * tw, sizeof(float) * tw);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
// libpng's default limits on the width and the height
const uint32_t kPngMaxDim = 1000000;

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

struct PngInfo {
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  int nc = 0;                      // samples per stored pixel
  int oc = 0;                      // samples per output pixel (alpha stripped)
  uint8_t pal[256 * 3] = {};       // palette, zero past its entries (libpng)
};

bool png_header(const uint8_t* b, PngInfo* pi) {
  pi->w = be32(b);
  pi->h = be32(b + 4);
  pi->depth = b[8];
  pi->ctype = b[9];
  pi->interlace = b[12];
  if (pi->w == 0 || pi->h == 0 || pi->w > kPngMaxDim || pi->h > kPngMaxDim)
    return false;
  if (b[10] != 0 || b[11] != 0 || pi->interlace > 1) return false;
  const int d = pi->depth;
  switch (pi->ctype) {
    case 0:  // grey
      pi->nc = 1; pi->oc = 1;
      return d == 1 || d == 2 || d == 4 || d == 8 || d == 16;
    case 2:  // RGB
      pi->nc = 3; pi->oc = 3;
      return d == 8 || d == 16;
    case 3:  // palette
      pi->nc = 1; pi->oc = 3;
      return d == 1 || d == 2 || d == 4 || d == 8;
    case 4:  // grey + alpha
      pi->nc = 2; pi->oc = 1;
      return d == 8 || d == 16;
    case 6:  // RGBA
      pi->nc = 4; pi->oc = 3;
      return d == 8 || d == 16;
  }
  return false;
}

// Inflates the IDAT chunks' concatenated zlib stream on demand.
struct Inflater {
  const std::vector<std::pair<const uint8_t*, uint32_t>>& idat;
  size_t next = 0;
  z_stream zs;
  bool live = false;

  explicit Inflater(const std::vector<std::pair<const uint8_t*, uint32_t>>& c)
      : idat(c) {
    std::memset(&zs, 0, sizeof(zs));
    live = inflateInit(&zs) == Z_OK;
  }
  ~Inflater() {
    if (live) inflateEnd(&zs);
  }

  // Fills dst with exactly n bytes of the stream; false if it ends first
  // or is corrupt.
  bool read(uint8_t* dst, size_t n) {
    if (!live) return false;
    zs.next_out = dst;
    zs.avail_out = (uInt)n;
    while (zs.avail_out > 0) {
      if (zs.avail_in == 0) {
        if (next >= idat.size()) return false;
        zs.next_in = const_cast<Bytef*>(idat[next].first);
        zs.avail_in = idat[next].second;
        next++;
        continue;
      }
      int ret = inflate(&zs, Z_NO_FLUSH);
      if (ret == Z_STREAM_END) return zs.avail_out == 0;
      if (ret != Z_OK) return false;
    }
    return true;
  }
};

// Undo one scanline's filter in place; prev is the previous reconstructed
// scanline of the same pass (zeros for its first).
bool unfilter(int ft, uint8_t* cur, const uint8_t* prev, size_t n, size_t bpp) {
  switch (ft) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < n; i++) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < n; i++) cur[i] = (uint8_t)(cur[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < n; i++) {
        int a = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = (uint8_t)(cur[i] + ((a + prev[i]) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; i++) {
        int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i],
            c = i >= bpp ? prev[i - bpp] : 0;
        int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[i] = (uint8_t)(cur[i] + pred);
      }
      return true;
  }
  return false;
}

// One reconstructed scanline of n pixels -> n * oc output samples, with the
// libpng transforms the JAX engine sets (palette -> RGB, low-bit grey
// expanded, alpha stripped, 16-bit samples in host order).
template <typename T>
void convert_row(const PngInfo& pi, const uint8_t* raw, uint32_t n, T* out) {
  const int nc = pi.nc, oc = pi.oc, d = pi.depth;
  if (d == 16) {
    for (uint32_t x = 0; x < n; x++)
      for (int c = 0; c < oc; c++) {
        const uint8_t* s = raw + ((size_t)x * nc + c) * 2;
        out[(size_t)x * oc + c] = (T)(s[0] << 8 | s[1]);
      }
  } else if (d == 8 && pi.ctype != 3) {
    for (uint32_t x = 0; x < n; x++)
      for (int c = 0; c < oc; c++) out[(size_t)x * oc + c] = raw[(size_t)x * nc + c];
  } else {
    const int mask = (1 << d) - 1;
    const int scale = 255 / mask;   // bit replication: 1 -> 255, 2 -> 85, 4 -> 17
    for (uint32_t x = 0; x < n; x++) {
      size_t bit = (size_t)x * d;
      int v = d == 8 ? raw[x] : (raw[bit >> 3] >> (8 - d - (int)(bit & 7))) & mask;
      if (pi.ctype == 3) {
        for (int c = 0; c < 3; c++) out[(size_t)x * 3 + c] = pi.pal[v * 3 + c];
      } else {
        out[x] = (T)(v * scale);
      }
    }
  }
}

template <typename T>
bool png_pixels(const PngInfo& pi, Inflater* inf, StreamResizer* rs) {
  const size_t bpp = std::max<size_t>(1, (size_t)pi.nc * pi.depth / 8);
  const size_t oc = pi.oc;
  if (!pi.interlace) {
    const size_t rowbytes = ((size_t)pi.w * pi.nc * pi.depth + 7) / 8;
    std::vector<uint8_t> prev(rowbytes + 1, 0), cur(rowbytes + 1);
    std::vector<T> row((size_t)pi.w * oc);
    for (uint32_t y = 0; y < pi.h; y++) {
      if (!inf->read(cur.data(), rowbytes + 1)) return false;
      if (!unfilter(cur[0], cur.data() + 1, prev.data() + 1, rowbytes, bpp))
        return false;
      convert_row(pi, cur.data() + 1, pi.w, row.data());
      rs->feed_row((int)y, row.data());
      cur.swap(prev);
    }
    return true;
  }
  // Adam7: the seven passes' pixels are placed into the whole image
  static const int sx[7] = {0, 4, 0, 2, 0, 1, 0}, sy[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int dx[7] = {8, 8, 4, 4, 2, 2, 1}, dy[7] = {8, 8, 8, 4, 4, 2, 2};
  std::vector<T> img((size_t)pi.w * pi.h * oc);
  for (int p = 0; p < 7; p++) {
    uint32_t pw = pi.w > (uint32_t)sx[p] ? (pi.w - sx[p] + dx[p] - 1) / dx[p] : 0;
    uint32_t ph = pi.h > (uint32_t)sy[p] ? (pi.h - sy[p] + dy[p] - 1) / dy[p] : 0;
    if (pw == 0 || ph == 0) continue;
    const size_t rowbytes = ((size_t)pw * pi.nc * pi.depth + 7) / 8;
    std::vector<uint8_t> prev(rowbytes + 1, 0), cur(rowbytes + 1);
    std::vector<T> row((size_t)pw * oc);
    for (uint32_t r = 0; r < ph; r++) {
      if (!inf->read(cur.data(), rowbytes + 1)) return false;
      if (!unfilter(cur[0], cur.data() + 1, prev.data() + 1, rowbytes, bpp))
        return false;
      convert_row(pi, cur.data() + 1, pw, row.data());
      T* dst = img.data() + ((size_t)(sy[p] + r * dy[p]) * pi.w) * oc;
      for (uint32_t i = 0; i < pw; i++)
        std::memcpy(dst + (size_t)(sx[p] + i * dx[p]) * oc, row.data() + i * oc,
                    oc * sizeof(T));
      cur.swap(prev);
    }
  }
  for (uint32_t y = 0; y < pi.h; y++)
    rs->feed_row((int)y, img.data() + (size_t)y * pi.w * oc);
  return true;
}

// Returns -1 on failure, 0 for 8-bit, 1 for 16-bit sources.
int decode_png(const uint8_t* data, size_t size, StreamResizer* rs, int th,
               int tw, int out_c, int interp, float* out) {
  if (size < 8 || std::memcmp(data, kPngSig, 8) != 0) return -1;
  PngInfo pi;
  bool have_hdr = false, have_pal = false, have_end = false;
  std::vector<std::pair<const uint8_t*, uint32_t>> idat;
  size_t pos = 8;
  while (!have_end) {
    if (size - pos < 12) return -1;                      // truncated
    const uint32_t len = be32(data + pos);
    if (len > 0x7FFFFFFFu || size - pos - 12 < len) return -1;
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    const bool critical = !(type[0] & 0x20);
    if (critical &&
        crc32(crc32(0L, Z_NULL, 0), type, len + 4) != be32(body + len))
      return -1;
    if (!have_hdr && std::memcmp(type, "IHDR", 4) != 0) return -1;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (have_hdr || len != 13 || !png_header(body, &pi)) return -1;
      have_hdr = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (pi.ctype == 3) {               // a suggested palette elsewhere is unused
        if (len % 3 != 0 || len == 0 || len > 768) return -1;
        std::memcpy(pi.pal, body, len);
        have_pal = true;
      }
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (len) idat.emplace_back(body, len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      have_end = true;
    } else if (critical) {
      return -1;                                         // unknown critical chunk
    }
    // tRNS and the other ancillary chunks change no sample of the output
    pos += 12 + (size_t)len;
  }
  if (idat.empty() || (pi.ctype == 3 && !have_pal)) return -1;
  rs->init((int)pi.w, (int)pi.h, pi.oc, tw, th, out_c, interp, out);
  Inflater inf(idat);
  bool ok = pi.depth == 16 ? png_pixels<uint16_t>(pi, &inf, rs)
                           : png_pixels<uint8_t>(pi, &inf, rs);
  if (!ok) return -1;
  rs->finish();
  return pi.depth == 16 ? 1 : 0;
}

// ---------------------------------------------------------------------------
// JPEG (io/jpeg.py, translated)
// ---------------------------------------------------------------------------

// natural (row-major) index of each zigzag position; positions past the end
// go to a spare slot 64 that a corrupt run writes into
const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

inline int zz(int k) { return k < 64 ? kZigzag[k] : 64; }

// the largest image decoded (16384 x 16384): the coefficients are kept
// whole, 4 bytes each
const int64_t kJpegMaxPixels = (int64_t)1 << 28;

// jidctint.c constants, FIX(x) at CONST_BITS = 13
const int kConstBits = 13, kPass1Bits = 2;
const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270;
const int64_t F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137;
const int64_t F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// A Huffman table as a 16-bit look-ahead: (code length << 8) | symbol, 0 for
// no code.
struct Huffman {
  std::vector<uint32_t> lut;
  bool build(const uint8_t* counts, const uint8_t* syms, size_t nsyms) {
    lut.assign(1 << 16, 0);
    uint32_t code = 0;
    size_t k = 0;
    for (int bits = 1; bits <= 16; bits++) {
      for (int i = 0; i < counts[bits - 1]; i++) {
        if (k >= nsyms) return false;
        uint64_t lo = (uint64_t)code << (16 - bits), hi = (uint64_t)(code + 1) << (16 - bits);
        for (uint64_t j = lo; j < hi && j < (1u << 16); j++)
          lut[j] = (uint32_t)bits << 8 | syms[k];
        code++;
        k++;
      }
      code <<= 1;
    }
    return true;
  }
};

// Bits of one unstuffed entropy-coded segment, zeros past its end (as
// libjpeg inserts them); the caller checks that no more bits were used than
// the segment holds.
struct BitReader {
  std::vector<uint8_t> buf;      // the segment + a zero tail
  size_t nbits = 0, p = 0;
  // 64 symbols of at most 16 + 15 bits each: a block's reads past the end
  // stay inside the tail
  static const size_t kTail = 512;

  void load(const std::vector<uint8_t>& seg) {
    buf.assign(seg.size() + kTail, 0);
    std::memcpy(buf.data(), seg.data(), seg.size());
    nbits = seg.size() * 8;
    p = 0;
  }
  inline uint32_t peek16() const {
    const uint8_t* b = buf.data() + (p >> 3);
    uint32_t w = (uint32_t)b[0] << 16 | (uint32_t)b[1] << 8 | b[2];
    return (w >> (8 - (p & 7))) & 0xFFFF;
  }
  inline bool symbol(const Huffman& h, int* sym) {
    uint32_t e = h.lut[peek16()];
    if (!e) return false;                                // bad Huffman code
    p += e >> 8;
    *sym = e & 255;
    return true;
  }
  inline int32_t value(int s) {                          // s in 1..15
    int32_t v = (int32_t)(peek16() >> (16 - s));
    p += s;
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
};

struct Component {
  int id, h, v, tq;
  int bw, bh, width, height;     // blocks per row / column, samples
  std::vector<int32_t> coef;     // [bh * bw][64], natural order
  bool scanned = false;
};

struct Jpeg {
  const uint8_t* data;
  size_t size;
  int64_t qt[16][64];
  bool have_qt[16] = {};
  Huffman dc[16], ac[16];
  bool have_dc[16] = {}, have_ac[16] = {};
  std::vector<Component> comps;
  bool have_frame = false, jfif = false;
  int adobe = -1;                 // Adobe APP14 transform, -1 if absent
  int restart = 0;
  int height = 0, width = 0, hmax = 0, vmax = 0, mcux = 0, mcuy = 0;
};

// io/jpeg.py:_scan_segments: the entropy-coded data at pos, unstuffed and
// split at its restart markers; *end is the marker that ends the scan.
void scan_segments(const Jpeg& j, size_t pos, std::vector<std::vector<uint8_t>>* segs,
                   size_t* end) {
  const uint8_t* a = j.data + pos;
  const size_t n = j.size - pos;
  size_t e = n;
  for (size_t i = 0; i + 1 < n; i++) {
    if (a[i] != 0xFF) continue;
    uint8_t nx = a[i + 1];
    if (nx != 0x00 && (nx < 0xD0 || nx > 0xD7) && nx != 0xFF) {
      e = i;
      break;
    }
  }
  std::vector<uint8_t> keep(e, 1);
  std::vector<size_t> bounds{0};
  for (size_t i = 0; i + 1 < e; i++) {
    if (a[i] != 0xFF) continue;
    uint8_t nx = a[i + 1];
    if (nx == 0x00)
      keep[i + 1] = 0;
    else if (nx == 0xFF)
      keep[i] = 0;
    else if (nx >= 0xD0 && nx <= 0xD7)
      bounds.push_back(i);
  }
  bounds.push_back(e);
  segs->clear();
  for (size_t s = 0; s + 1 < bounds.size(); s++) {
    size_t lo = bounds[s] + (s ? 2 : 0), hi = bounds[s + 1];
    std::vector<uint8_t> seg;
    for (size_t i = lo; i < hi; i++)
      if (keep[i]) seg.push_back(a[i]);
    segs->push_back(std::move(seg));
  }
  *end = pos + e;
}

// One block's coefficients (io/jpeg.py:_decode_scan's inner loop).
bool decode_block(BitReader* br, const Huffman& dc, const Huffman& ac,
                  int64_t* pred, int32_t* blk) {
  std::memset(blk, 0, 64 * sizeof(int32_t));
  int s;
  if (!br->symbol(dc, &s) || s > 15) return false;
  if (s) *pred += br->value(s);
  blk[0] = (int32_t)*pred;
  for (int k = 1; k < 64;) {
    int sym;
    if (!br->symbol(ac, &sym)) return false;
    int r = sym >> 4;
    s = sym & 15;
    if (s) {
      k += r;
      int32_t v = br->value(s);
      int at = zz(k);
      if (at < 64) blk[at] = v;
      k++;
    } else if (r == 15) {
      k += 16;
    } else {
      break;
    }
  }
  return br->p <= br->nbits;
}

bool decode_scan(Jpeg* j, const uint8_t* body, size_t len, size_t* pos) {
  if (!j->have_frame || len < 1) return false;
  const int ns = body[0];
  if (ns < 1 || ns > 4 || len < (size_t)3 + 2 * ns) return false;
  // per selected component (by index in the frame): its tables
  int sel[4], td[4], ta[4];
  for (int i = 0; i < ns; i++) {
    int cid = body[1 + 2 * i], tab = body[2 + 2 * i];
    sel[i] = -1;
    for (size_t c = 0; c < j->comps.size(); c++)
      if (j->comps[c].id == cid) {
        sel[i] = (int)c;
        break;
      }
    if (sel[i] < 0) return false;
    td[sel[i]] = tab >> 4;
    ta[sel[i]] = tab & 15;
    if (!j->have_dc[tab >> 4] || !j->have_ac[tab & 15]) return false;
  }
  if (body[1 + 2 * ns] != 0 || body[2 + 2 * ns] != 63) return false;  // progressive
  std::vector<std::vector<uint8_t>> segs;
  scan_segments(*j, *pos, &segs, pos);
  // per MCU, the (component, block offset) pairs; block of MCU m = offset +
  // base(m)
  std::vector<std::pair<int, int>> order;
  int n_mcus, nbx = 0;
  if (ns == 1) {
    const Component& c = j->comps[sel[0]];
    nbx = (c.width + 7) / 8;
    n_mcus = nbx * ((c.height + 7) / 8);
    order.emplace_back(sel[0], 0);
  } else {
    for (int i = 0; i < ns; i++) {
      const Component& c = j->comps[sel[i]];
      for (int y = 0; y < c.v; y++)
        for (int x = 0; x < c.h; x++) order.emplace_back(sel[i], y * c.bw + x);
    }
    n_mcus = j->mcux * j->mcuy;
  }
  const int per_seg = j->restart ? j->restart : n_mcus;
  BitReader br;
  size_t seg_i = 0;
  int64_t preds[3] = {0, 0, 0};
  for (int m = 0; m < n_mcus; m++) {
    if (m % per_seg == 0) {
      if (seg_i >= segs.size()) return false;            // truncated scan
      br.load(segs[seg_i++]);
      std::memset(preds, 0, sizeof(preds));
    }
    for (const auto& [ci, off] : order) {
      Component& c = j->comps[ci];
      size_t index;
      if (ns == 1) {
        index = (size_t)(m / nbx) * c.bw + m % nbx;
      } else {
        int my = m / j->mcux, mx = m % j->mcux;
        index = (size_t)off + (size_t)my * c.v * c.bw + (size_t)mx * c.h;
      }
      if (index >= (size_t)c.bw * c.bh) return false;
      if (!decode_block(&br, j->dc[td[ci]], j->ac[ta[ci]], &preds[ci],
                        c.coef.data() + index * 64))
        return false;
    }
  }
  for (int i = 0; i < ns; i++) j->comps[sel[i]].scanned = true;
  return true;
}

bool read_frame(Jpeg* j, const uint8_t* b, size_t len) {
  if (len < 6) return false;
  const int precision = b[0], nf = b[5];
  j->height = b[1] << 8 | b[2];
  j->width = b[3] << 8 | b[4];
  if (precision != 8 || (nf != 1 && nf != 3)) return false;     // refused
  if (j->height == 0 || j->width == 0 || len < (size_t)6 + 3 * nf) return false;
  if ((int64_t)j->height * j->width > kJpegMaxPixels) return false;
  j->comps.assign(nf, Component());
  j->hmax = j->vmax = 0;
  for (int i = 0; i < nf; i++) {
    Component& c = j->comps[i];
    c.id = b[6 + 3 * i];
    c.h = b[7 + 3 * i] >> 4;
    c.v = b[7 + 3 * i] & 15;
    c.tq = b[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 15) return false;
    j->hmax = std::max(j->hmax, c.h);
    j->vmax = std::max(j->vmax, c.v);
  }
  j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (Component& c : j->comps) {
    c.bw = j->mcux * c.h;
    c.bh = j->mcuy * c.v;
    c.width = (j->width * c.h + j->hmax - 1) / j->hmax;
    c.height = (j->height * c.v + j->vmax - 1) / j->vmax;
    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    c.scanned = false;
  }
  j->have_frame = true;
  return true;
}

bool read_tables(Jpeg* j, int marker, const uint8_t* b, size_t len) {
  size_t p = 0;
  if (marker == 0xC4) {                                     // DHT
    while (p < len) {
      if (len - p < 17) return false;
      int tc = b[p] >> 4, th = b[p] & 15;
      size_t n = 0;
      for (int i = 0; i < 16; i++) n += b[p + 1 + i];
      size_t avail = len - p - 17;
      Huffman& h = tc == 0 ? j->dc[th] : j->ac[th];
      if (tc > 1 || !h.build(b + p + 1, b + p + 17, std::min(n, avail)) || n > avail)
        return false;
      (tc == 0 ? j->have_dc : j->have_ac)[th] = true;
      p += 17 + n;
    }
  } else {                                                  // DQT
    while (p < len) {
      int pq = b[p] >> 4, tq = b[p] & 15;
      size_t need = pq ? 129 : 65;
      if (pq > 1 || len - p < need) return false;
      for (int k = 0; k < 64; k++)
        j->qt[tq][kZigzag[k]] = pq ? (b[p + 1 + 2 * k] << 8 | b[p + 2 + 2 * k])
                                   : b[p + 1 + k];
      j->have_qt[tq] = true;
      p += need;
    }
  }
  return true;
}

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// jidctint.c's butterflies; x[i * stride] are the 8 inputs, o the outputs
// before descaling.
inline void idct_1d(const int64_t* x, int stride, int64_t* o) {
  int64_t x0 = x[0], x1 = x[stride], x2 = x[2 * stride], x3 = x[3 * stride];
  int64_t x4 = x[4 * stride], x5 = x[5 * stride], x6 = x[6 * stride], x7 = x[7 * stride];
  int64_t z1 = (x2 + x6) * F0541;
  int64_t tmp2 = z1 + x6 * -F1847;
  int64_t tmp3 = z1 + x2 * F0765;
  int64_t tmp0 = (x0 + x4) * ((int64_t)1 << kConstBits);
  int64_t tmp1 = (x0 - x4) * ((int64_t)1 << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x7, t1 = x5, t2 = x3, t3 = x1;
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * F1175;
  t0 *= F0298;
  t1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = tmp10 + t3; o[7] = tmp10 - t3;
  o[1] = tmp11 + t2; o[6] = tmp11 - t2;
  o[2] = tmp12 + t1; o[5] = tmp12 - t1;
  o[3] = tmp13 + t0; o[4] = tmp13 - t0;
}

// libjpeg's post-IDCT range limit (jdmaster.c), indexed by sample & 1023
inline uint8_t range_limit(int64_t x) {
  int v = (int)(x & 1023);
  v = v >= 512 ? v - 1024 : v;
  v += 128;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Dequantise and inverse-transform one block into an 8x8 tile of dst.
void idct_islow(const int32_t* coef, const int64_t* qt, uint8_t* dst, size_t pitch) {
  int64_t c[64], ws[64], o[8];
  for (int i = 0; i < 64; i++) c[i] = (int64_t)coef[i] * qt[i];
  for (int col = 0; col < 8; col++) {                    // pass 1: columns
    idct_1d(c + col, 8, o);
    for (int r = 0; r < 8; r++) ws[r * 8 + col] = descale(o[r], kConstBits - kPass1Bits);
  }
  for (int row = 0; row < 8; row++) {                    // pass 2: rows
    idct_1d(ws + row * 8, 1, o);
    for (int x = 0; x < 8; x++)
      dst[row * pitch + x] = range_limit(descale(o[x], kConstBits + kPass1Bits + 3));
  }
}

// A component's samples, cropped to its size, upsampled by (fh, fv) as
// io/jpeg.py:_upsample (fancy h2v1 / h2v2, box for planes <= 2 wide).
bool upsample(const std::vector<int32_t>& x, int h, int w, int fh, int fv,
              std::vector<int32_t>* out, int* oh, int* ow) {
  if (fh == 1 && fv == 1) {
    *out = x;
    *oh = h;
    *ow = w;
    return true;
  }
  if (!(fh == 2 && (fv == 1 || fv == 2))) return false;   // refused sampling
  *oh = h * fv;
  *ow = w * 2;
  out->assign((size_t)*oh * *ow, 0);
  int32_t* o = out->data();
  const size_t W = *ow;
  if (w <= 2) {
    for (int r = 0; r < *oh; r++)
      for (int c = 0; c < *ow; c++) o[r * W + c] = x[(size_t)(r / fv) * w + c / 2];
    return true;
  }
  if (fv == 1) {
    for (int r = 0; r < h; r++) {
      const int32_t* s = x.data() + (size_t)r * w;
      for (int c = 0; c < w; c++) {
        int32_t left = s[c > 0 ? c - 1 : 0], right = s[c + 1 < w ? c + 1 : w - 1];
        o[r * W + 2 * c] = (3 * s[c] + left + 1) >> 2;
        o[r * W + 2 * c + 1] = (3 * s[c] + right + 2) >> 2;
      }
    }
    return true;
  }
  std::vector<int32_t> colsum((size_t)w);
  for (int r = 0; r < 2 * h; r++) {
    int src = r / 2;
    int nb = r % 2 == 0 ? (src > 0 ? src - 1 : 0) : (src + 1 < h ? src + 1 : h - 1);
    const int32_t* s = x.data() + (size_t)src * w;
    const int32_t* t = x.data() + (size_t)nb * w;
    for (int c = 0; c < w; c++) colsum[c] = 3 * s[c] + t[c];
    for (int c = 0; c < w; c++) {
      int32_t left = colsum[c > 0 ? c - 1 : 0], right = colsum[c + 1 < w ? c + 1 : w - 1];
      o[r * W + 2 * c] = (3 * colsum[c] + left + 8) >> 4;
      o[r * W + 2 * c + 1] = (3 * colsum[c] + right + 7) >> 4;
    }
  }
  return true;
}

struct YccTables {
  int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    // jdcolor.c build_ycc_rgb_table, 16-bit scale
    auto fix = [](double v) { return (int64_t)(v * 65536.0 + 0.5); };
    const int64_t half = (int64_t)1 << 15;
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + half) >> 16;
      cb_b[i] = (fix(1.77200) * x + half) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clip255(int64_t v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// Returns -1 on failure (or a refused file), 0 otherwise.
int decode_jpeg(const uint8_t* data, size_t size, StreamResizer* rs, int th,
                int tw, int out_c, int interp, float* out) {
  if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  Jpeg j;
  j.data = data;
  j.size = size;
  size_t pos = 2;
  bool eoi = false;
  while (pos < size) {
    if (data[pos] != 0xFF) return -1;                    // marker expected
    while (pos < size && data[pos] == 0xFF) pos++;
    if (pos >= size) return -1;
    const int marker = data[pos++];
    if (marker == 0xD9) {                                // EOI
      eoi = true;
      break;
    }
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
    if (size - pos < 2) return -1;
    const size_t length = (size_t)data[pos] << 8 | data[pos + 1];
    if (length < 2 || size - pos < length) return -1;
    const uint8_t* body = data + pos + 2;
    const size_t blen = length - 2;
    pos += length;
    if (marker == 0xC0 || marker == 0xC1) {              // SOF0 / SOF1
      if (!read_frame(&j, body, blen)) return -1;
    } else if (marker >= 0xC2 && marker <= 0xCF && marker != 0xC4 &&
               marker != 0xC8) {
      return -1;                      // progressive, lossless, arithmetic, ...
    } else if (marker == 0xC4 || marker == 0xDB) {
      if (!read_tables(&j, marker, body, blen)) return -1;
    } else if (marker == 0xDD) {                         // DRI
      if (blen < 2) return -1;
      j.restart = body[0] << 8 | body[1];
    } else if (marker == 0xE0 && blen >= 5 && std::memcmp(body, "JFIF\0", 5) == 0) {
      j.jfif = true;
    } else if (marker == 0xEE && blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
      j.adobe = body[11];
    } else if (marker == 0xDA) {                         // SOS
      if (!decode_scan(&j, body, blen, &pos)) return -1;
    }
  }
  if (!eoi || !j.have_frame) return -1;
  std::vector<std::vector<uint8_t>> planes;
  for (const Component& c : j.comps) {
    if (!c.scanned || !j.have_qt[c.tq]) return -1;
    if (j.hmax % c.h || j.vmax % c.v) return -1;
    const size_t pitch = (size_t)c.bw * 8;
    std::vector<uint8_t> full(pitch * c.bh * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, j.qt[c.tq],
                   full.data() + (size_t)by * 8 * pitch + bx * 8, pitch);
    std::vector<int32_t> crop((size_t)c.height * c.width);
    for (int y = 0; y < c.height; y++)
      for (int x = 0; x < c.width; x++)
        crop[(size_t)y * c.width + x] = full[(size_t)y * pitch + x];
    std::vector<int32_t> up;
    int uh, uw;
    if (!upsample(crop, c.height, c.width, j.hmax / c.h, j.vmax / c.v, &up, &uh, &uw))
      return -1;
    if (uh < j.height || uw < j.width) return -1;
    std::vector<uint8_t> plane((size_t)j.height * j.width);
    for (int y = 0; y < j.height; y++)
      for (int x = 0; x < j.width; x++)
        plane[(size_t)y * j.width + x] = (uint8_t)up[(size_t)y * uw + x];
    planes.push_back(std::move(plane));
  }
  const size_t n = (size_t)j.height * j.width;
  const int nc = (int)planes.size();
  std::vector<uint8_t> img(n * nc);
  if (nc == 1) {
    img = planes[0];
  } else {
    bool rgb = j.adobe >= 0 ? j.adobe == 0
                            : (!j.jfif && j.comps[0].id == 82 && j.comps[1].id == 71 &&
                               j.comps[2].id == 66);
    static const YccTables t;
    for (size_t i = 0; i < n; i++) {
      int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      if (rgb) {
        img[3 * i] = (uint8_t)y;
        img[3 * i + 1] = (uint8_t)cb;
        img[3 * i + 2] = (uint8_t)cr;
      } else {
        img[3 * i] = clip255(y + t.cr_r[cr]);
        img[3 * i + 1] = clip255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        img[3 * i + 2] = clip255(y + t.cb_b[cb]);
      }
    }
  }
  rs->init(j.width, j.height, nc, tw, th, out_c, interp, out);
  for (int y = 0; y < j.height; y++) rs->feed_row(y, img.data() + (size_t)y * j.width * nc);
  rs->finish();
  return 0;
}

bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  long size = ok ? std::ftell(f) : -1;
  ok = ok && size >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    data->resize((size_t)size);
    ok = std::fread(data->data(), 1, (size_t)size, f) == (size_t)size;
  }
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" {

int sdirt_decode_resize(const char* path, float* out, int th, int tw,
                        int channels, int interp) {
  if (th < 1 || tw < 1 || channels < 1) return -1;
  try {
    std::vector<uint8_t> data;
    if (!read_file(path, &data) || data.size() < 2) return -1;
    StreamResizer rs;
    if (data[0] == 0x89 && data[1] == 'P')
      return decode_png(data.data(), data.size(), &rs, th, tw, channels, interp, out);
    if (data[0] == 0xFF && data[1] == 0xD8)
      return decode_jpeg(data.data(), data.size(), &rs, th, tw, channels, interp, out);
    return -1;
  } catch (...) {  // out of memory: a failed decode, not a dead process
    return -1;
  }
}

int sdirt_load_batch(const char** paths, int n, float* out, int th, int tw,
                     int channels, int interp, int n_threads, int* bit16) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failed(0);
  size_t stride = (size_t)channels * th * tw;
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = sdirt_decode_resize(paths[i], out + stride * i, th, tw,
                                   channels, interp);
      if (bit16) bit16[i] = rc == 1 ? 1 : 0;
      if (rc < 0) failed.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n ? n_threads : n;
  for (int t = 0; t < nt; t++) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failed.load() == 0 ? 0 : -(int)failed.load();
}

}  // extern "C"
