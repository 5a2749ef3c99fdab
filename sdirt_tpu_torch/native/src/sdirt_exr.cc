// OpenEXR decoder of the PyTorch port's native engine (single-part
// scanline; NONE/ZIPS/ZIP/PIZ), a copy of the JAX package's
// sdirt_tpu/native/src/sdirt_exr.cc with this header rewritten.
//
// FlyingThings3D's and Middlebury-FS's disparity maps are EXR files. The
// numpy codec (sdirt_tpu_torch/io/exr.py) spends most of a read in Python
// loops; this is the same algorithm in C++, with bit-identical output
// (tests/test_torch_native.py holds it against io/exr.py and against the
// JAX package's build of the same source).
//
// Format references: the OpenEXR file-format specification (openexr.com) —
// ImfZip.cpp (byte reorder + delta predictor), ImfHuf.cpp (canonical
// Huffman with 6-bit packed lengths + RLE symbol), ImfWav.cpp (2D 14/16-bit
// wavelet), ImfPizCompressor.cpp (bitmap LUT + channel layout).
//
// Built by sdirt_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -pthread -std=c++17 sdirt_exr.cc -lz
//
// C ABI:
//   sdirt_exr_info(path, &h, &w, &c)            -> 0 ok / -1 error
//   sdirt_exr_decode(path, out /* h*w*c f32, channel-interleaved in
//                    alphabetical channel order (cv2 BGR for R/G/B) */)
//                                               -> 0 ok / -1 error

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Channel {
  std::string name;
  int pixel_type;  // 0 UINT, 1 HALF, 2 FLOAT
};

struct ExrHeader {
  int width = 0, height = 0, xmin = 0, ymin = 0;
  int compression = -1;
  std::vector<Channel> channels;  // alphabetical (storage) order
  size_t table_pos = 0;           // byte offset of the chunk offset table
};

constexpr int kMagic = 20000630;

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      int e = -1;
      do {
        e++;
        man <<= 1;
      } while (!(man & 0x400));
      bits = sign | ((uint32_t)(127 - 15 - e) << 23) | ((man & 0x3FF) << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline int type_size(int t) { return t == 1 ? 2 : 4; }

int lines_per_chunk(int comp) {
  switch (comp) {
    case 0: return 1;   // NONE
    case 2: return 1;   // ZIPS
    case 3: return 16;  // ZIP
    case 4: return 32;  // PIZ
    default: return -1;
  }
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  if (n <= 0) {
    fclose(f);
    return false;
  }
  buf->resize((size_t)n);
  rewind(f);
  bool ok = fread(buf->data(), 1, (size_t)n, f) == (size_t)n;
  fclose(f);
  return ok;
}

template <typename T>
bool rd(const std::vector<uint8_t>& b, size_t pos, T* out) {
  if (pos + sizeof(T) > b.size()) return false;
  std::memcpy(out, b.data() + pos, sizeof(T));
  return true;
}

bool read_cstring(const std::vector<uint8_t>& b, size_t* pos, std::string* s) {
  size_t start = *pos;
  while (*pos < b.size() && b[*pos] != 0) (*pos)++;
  if (*pos >= b.size()) return false;
  s->assign((const char*)b.data() + start, *pos - start);
  (*pos)++;
  return true;
}

bool parse_header(const std::vector<uint8_t>& buf, ExrHeader* hd) {
  int32_t magic = 0, version = 0;
  if (!rd(buf, 0, &magic) || !rd(buf, 4, &version)) return false;
  if (magic != kMagic) return false;
  if (version & (0x200 | 0x800 | 0x1000)) return false;  // tiled/deep/multi
  size_t pos = 8;
  while (true) {
    if (pos >= buf.size()) return false;
    if (buf[pos] == 0) {
      pos++;
      break;
    }
    std::string name, type;
    if (!read_cstring(buf, &pos, &name)) return false;
    if (!read_cstring(buf, &pos, &type)) return false;
    int32_t size = 0;
    if (!rd(buf, pos, &size)) return false;
    pos += 4;
    if (pos + (size_t)size > buf.size() || size < 0) return false;
    if (name == "channels") {
      size_t p = pos, end = pos + size;
      while (p < end && buf[p] != 0) {
        Channel ch;
        if (!read_cstring(buf, &p, &ch.name)) return false;
        int32_t pt = 0;
        if (!rd(buf, p, &pt)) return false;
        ch.pixel_type = pt;
        p += 16;  // pixelType + pLinear/reserved + xSampling + ySampling
        hd->channels.push_back(ch);
      }
    } else if (name == "compression") {
      hd->compression = buf[pos];
    } else if (name == "dataWindow") {
      int32_t v[4];
      std::memcpy(v, buf.data() + pos, 16);
      hd->xmin = v[0];
      hd->ymin = v[1];
      hd->width = v[2] - v[0] + 1;
      hd->height = v[3] - v[1] + 1;
    }
    pos += size;
  }
  hd->table_pos = pos;
  if (hd->width <= 0 || hd->height <= 0 || hd->channels.empty()) return false;
  if (lines_per_chunk(hd->compression) < 0) return false;
  // channels are already stored sorted; keep storage order
  return true;
}

// ---- ZIP post-inflate filtering (ImfZip::uncompress) ----------------------
void zip_unfilter(std::vector<uint8_t>* data) {
  uint8_t* b = data->data();
  size_t n = data->size();
  for (size_t i = 1; i < n; i++) b[i] = (uint8_t)(b[i - 1] + b[i] - 128);
  std::vector<uint8_t> out(n);
  const uint8_t *t1 = b, *t2 = b + (n + 1) / 2;
  for (size_t i = 0; i < n;) {
    out[i++] = *t1++;
    if (i < n) out[i++] = *t2++;
  }
  data->swap(out);
}

// ---- PIZ: Huffman (ImfHuf.cpp) --------------------------------------------
struct BitReader {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t c = 0;
  int lc = 0;
  bool ok = true;

  int get(int nbits) {
    while (lc < nbits) {
      if (pos >= n) {
        ok = false;
        return 0;
      }
      c = (c << 8) | p[pos++];
      lc += 8;
    }
    lc -= nbits;
    int out = (int)((c >> lc) & ((1u << nbits) - 1));
    c &= (lc >= 64) ? ~0ull : ((1ull << lc) - 1);
    return out;
  }
};

constexpr int kHufDecBits = 14;
constexpr int kShortZerorun = 59, kLongZerorun = 63;
constexpr int kShortestLongRun = 2 + kLongZerorun - kShortZerorun;  // 6

bool huf_unpack_enc_table(BitReader* br, int im, int iM,
                          std::vector<uint8_t>* lengths,
                          std::vector<uint64_t>* codes) {
  int count = iM + 1;
  lengths->assign(count, 0);
  codes->assign(count, 0);
  for (int i = im; i <= iM;) {
    int l = br->get(6);
    if (!br->ok) return false;
    if (l == kLongZerorun) {
      int run = br->get(8) + kShortestLongRun;
      if (i + run > count + 1) return false;
      i += run;
    } else if (l >= kShortZerorun) {
      int run = l - kShortZerorun + 2;
      if (i + run > count + 1) return false;
      i += run;
    } else {
      (*lengths)[i++] = (uint8_t)l;
    }
  }
  // canonical codes
  uint64_t n[59] = {0};
  for (int i = 0; i < count; i++) n[(*lengths)[i]]++;
  uint64_t c = 0, base[59] = {0};
  for (int l = 58; l > 0; --l) {
    uint64_t nc = (c + n[l]) >> 1;
    base[l] = c;
    c = nc;
  }
  uint64_t nxt[59];
  std::memcpy(nxt, base, sizeof(base));
  for (int i = 0; i < count; i++) {
    int l = (*lengths)[i];
    if (l > 0) (*codes)[i] = nxt[l]++;
  }
  return true;
}

bool huf_decode(const std::vector<uint8_t>& lengths,
                const std::vector<uint64_t>& codes, const uint8_t* data,
                size_t nbytes, int64_t n_bits, int rlc, uint16_t* out,
                size_t n_out) {
  // 14-bit fast table; longer codes resolved per-length
  std::vector<uint8_t> tbl_len(1 << kHufDecBits, 0);
  std::vector<uint32_t> tbl_sym(1 << kHufDecBits, 0);
  struct LongCode {
    uint64_t code;
    uint32_t sym;
    uint8_t len;
  };
  std::vector<LongCode> longs;
  for (size_t s = 0; s < lengths.size(); s++) {
    int l = lengths[s];
    if (!l) continue;
    if (l <= kHufDecBits) {
      uint64_t lo = codes[s] << (kHufDecBits - l);
      uint64_t hi = lo + (1ull << (kHufDecBits - l));
      for (uint64_t i = lo; i < hi; i++) {
        tbl_len[i] = (uint8_t)l;
        tbl_sym[i] = (uint32_t)s;
      }
    } else {
      longs.push_back({codes[s], (uint32_t)s, (uint8_t)l});
    }
  }

  uint64_t c = 0;
  int lc = 0;
  size_t pos = 0, oi = 0;
  size_t end = (size_t)((n_bits + 7) / 8);
  if (end > nbytes) return false;
  while (oi < n_out) {
    while (lc < kHufDecBits + 8 && pos < end) {
      c = (c << 8) | data[pos++];
      lc += 8;
    }
    if (lc <= 0) return false;
    uint64_t idx = lc >= kHufDecBits ? (c >> (lc - kHufDecBits))
                                     : (c << (kHufDecBits - lc));
    idx &= (1u << kHufDecBits) - 1;
    int l = tbl_len[idx];
    uint32_t sym;
    if (l) {
      if (l > lc) return false;
      sym = tbl_sym[idx];
      lc -= l;
    } else {
      bool found = false;
      for (const auto& lcode : longs) {
        while (lc < lcode.len && pos < end) {
          c = (c << 8) | data[pos++];
          lc += 8;
        }
        if (lc < lcode.len) continue;
        if (((c >> (lc - lcode.len)) & ((1ull << lcode.len) - 1)) ==
            lcode.code) {
          sym = lcode.sym;
          lc -= lcode.len;
          found = true;
          break;
        }
      }
      if (!found) return false;
    }
    c &= (lc >= 64) ? ~0ull : ((1ull << lc) - 1);
    if ((int)sym == rlc) {
      if (lc < 8) {
        if (pos >= end) return false;
        c = (c << 8) | data[pos++];
        lc += 8;
      }
      lc -= 8;
      uint32_t cs = (uint32_t)((c >> lc) & 0xFF);
      c &= (lc >= 64) ? ~0ull : ((1ull << lc) - 1);
      if (oi == 0 || oi + cs > n_out) return false;
      uint16_t prev = out[oi - 1];
      for (uint32_t k = 0; k < cs; k++) out[oi++] = prev;
    } else {
      out[oi++] = (uint16_t)sym;
    }
  }
  return true;
}

// ---- PIZ: 2D wavelet decode (ImfWav.cpp wav2Decode) -----------------------
inline void wdec14(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  int16_t ls = (int16_t)l, hs = (int16_t)h;
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = (int16_t)ai;
  int16_t bs = (int16_t)(ai - hi);
  *a = (uint16_t)as;
  *b = (uint16_t)bs;
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  int m = l, d = h;
  int bb = (m - (d >> 1)) & 0xFFFF;
  int aa = (d + bb - 0x8000) & 0xFFFF;
  *b = (uint16_t)bb;
  *a = (uint16_t)aa;
}

void wav2_decode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = nx > ny ? ny : nx;
  int p = 1, p2;
  while (p <= n) p <<= 1;
  p >>= 1;
  p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + (size_t)oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    uint16_t* px = py;
    for (; py <= ey; py += oy2) {
      px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t *p01 = px + ox1, *p10 = px + oy1, *p11 = p10 + ox1;
        if (w14) {
          wdec14(*px, *p10, &i00, &i10);
          wdec14(*p01, *p11, &i01, &i11);
          wdec14(i00, i01, px, p01);
          wdec14(i10, i11, p10, p11);
        } else {
          wdec16(*px, *p10, &i00, &i10);
          wdec16(*p01, *p11, &i01, &i11);
          wdec16(i00, i01, px, p01);
          wdec16(i10, i11, p10, p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14)
          wdec14(*px, *p10, &i00, p10), *px = i00;
        else
          wdec16(*px, *p10, &i00, p10), *px = i00;
      }
    }
    if (ny & p) {
      px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14)
          wdec14(*px, *p01, &i00, p01), *px = i00;
        else
          wdec16(*px, *p01, &i00, p01), *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// ---- PIZ chunk (ImfPizCompressor::uncompress) -----------------------------
bool piz_uncompress(const uint8_t* raw, size_t nraw, int w, int n_lines,
                    const std::vector<Channel>& chans,
                    std::vector<uint8_t>* out_bytes) {
  if (nraw < 4) return false;
  uint16_t minNZ, maxNZ;
  std::memcpy(&minNZ, raw, 2);
  std::memcpy(&maxNZ, raw + 2, 2);
  size_t p = 4;
  std::vector<uint8_t> bitmap(8192, 0);
  if (minNZ <= maxNZ) {
    size_t nb = (size_t)maxNZ - minNZ + 1;
    if (maxNZ >= 8192 || p + nb > nraw) return false;
    std::memcpy(bitmap.data() + minNZ, raw + p, nb);
    p += nb;
  }
  std::vector<uint16_t> lut;
  lut.reserve(65536);
  for (uint32_t i = 0; i < 65536; i++)
    if (i == 0 || (bitmap[i >> 3] & (1u << (i & 7)))) lut.push_back((uint16_t)i);
  uint16_t max_value = (uint16_t)(lut.size() - 1);

  int32_t length;
  if (!p || p + 4 > nraw) return false;
  std::memcpy(&length, raw + p, 4);
  p += 4;
  if (length < 20 || p + (size_t)length > nraw) return false;
  const uint8_t* huf = raw + p;

  int32_t im, iM, n_bits;
  std::memcpy(&im, huf, 4);
  std::memcpy(&iM, huf + 4, 4);
  std::memcpy(&n_bits, huf + 12, 4);
  if (im < 0 || iM < im || iM > 65536) return false;

  BitReader br{huf + 20, (size_t)length - 20};
  std::vector<uint8_t> lengths;
  std::vector<uint64_t> codes;
  if (!huf_unpack_enc_table(&br, im, iM, &lengths, &codes)) return false;
  // bitstream starts at the byte after the packed table
  size_t bs_off = 20 + br.pos;
  if (br.lc >= 8) return false;  // table reader never holds a full byte

  size_t total = 0;
  std::vector<size_t> chan_elems(chans.size());
  for (size_t ci = 0; ci < chans.size(); ci++) {
    chan_elems[ci] = (size_t)w * (type_size(chans[ci].pixel_type) / 2) * n_lines;
    total += chan_elems[ci];
  }
  std::vector<uint16_t> data(total);
  if (!huf_decode(lengths, codes, huf + bs_off, (size_t)length - bs_off,
                  n_bits, iM, data.data(), total))
    return false;

  size_t off = 0;
  for (size_t ci = 0; ci < chans.size(); ci++) {
    int sz = type_size(chans[ci].pixel_type) / 2;  // u16s per sample
    int cnx = w * sz;
    for (int j = 0; j < sz; j++)
      wav2_decode(data.data() + off + j, w, sz, n_lines, cnx, max_value);
    off += chan_elems[ci];
  }
  for (auto& v : data) v = lut[v];

  // interleave back: per line, per channel, raw row bytes
  out_bytes->clear();
  size_t row_bytes = 0;
  for (const auto& ch : chans) row_bytes += (size_t)w * type_size(ch.pixel_type);
  out_bytes->resize(row_bytes * n_lines);
  uint8_t* dst = out_bytes->data();
  for (int li = 0; li < n_lines; li++) {
    size_t chan_off = 0;
    for (size_t ci = 0; ci < chans.size(); ci++) {
      int sz = type_size(chans[ci].pixel_type) / 2;
      const uint16_t* src = data.data() + chan_off + (size_t)li * w * sz;
      std::memcpy(dst, src, (size_t)w * sz * 2);
      dst += (size_t)w * sz * 2;
      chan_off += chan_elems[ci];
    }
  }
  return true;
}

bool decode_exr_impl(const char* path, float* out, int* oh, int* ow, int* oc) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return false;
  ExrHeader hd;
  if (!parse_header(buf, &hd)) return false;
  int h = hd.height, w = hd.width;
  int nch = (int)hd.channels.size();
  if (oh) *oh = h;
  if (ow) *ow = w;
  if (oc) *oc = nch;
  if (!out) return true;  // info-only call

  int lpc = lines_per_chunk(hd.compression);
  int n_chunks = (h + lpc - 1) / lpc;
  if (hd.table_pos + (size_t)n_chunks * 8 > buf.size()) return false;

  // cv2-compatible channel output order: BGR(A) when R/G/B named
  std::vector<int> out_idx(nch);
  {
    bool rgb = false;
    int r = -1, g = -1, b = -1;
    for (int i = 0; i < nch; i++) {
      if (hd.channels[i].name == "R") r = i;
      if (hd.channels[i].name == "G") g = i;
      if (hd.channels[i].name == "B") b = i;
    }
    rgb = r >= 0 && g >= 0 && b >= 0;
    for (int i = 0; i < nch; i++) out_idx[i] = i;
    if (rgb && nch >= 3) {
      std::vector<int> order;
      order.push_back(b);
      order.push_back(g);
      order.push_back(r);
      for (int i = 0; i < nch; i++)
        if (i != r && i != g && i != b) order.push_back(i);
      for (int o = 0; o < nch; o++) out_idx[order[o]] = o;
    }
  }

  size_t row_bytes = 0;
  for (const auto& ch : hd.channels)
    row_bytes += (size_t)w * type_size(ch.pixel_type);

  std::vector<uint8_t> raw_lines;
  for (int ci = 0; ci < n_chunks; ci++) {
    int64_t off;
    std::memcpy(&off, buf.data() + hd.table_pos + (size_t)ci * 8, 8);
    if (off < 0 || (size_t)off + 8 > buf.size()) return false;
    int32_t y, nbytes;
    std::memcpy(&y, buf.data() + off, 4);
    std::memcpy(&nbytes, buf.data() + off + 4, 4);
    if (nbytes < 0 || (size_t)off + 8 + nbytes > buf.size()) return false;
    const uint8_t* payload = buf.data() + off + 8;
    int y0 = y - hd.ymin;
    if (y0 < 0 || y0 >= h) return false;
    int n_lines = lpc < h - y0 ? lpc : h - y0;
    size_t expect = row_bytes * n_lines;

    const uint8_t* lines = payload;
    if ((size_t)nbytes < expect) {
      if (hd.compression == 4) {
        if (!piz_uncompress(payload, (size_t)nbytes, w, n_lines, hd.channels,
                            &raw_lines))
          return false;
      } else {
        raw_lines.resize(expect);
        uLongf dest_len = expect;
        if (uncompress(raw_lines.data(), &dest_len, payload, nbytes) != Z_OK ||
            dest_len != expect)
          return false;
        zip_unfilter(&raw_lines);
      }
      lines = raw_lines.data();
    } else if ((size_t)nbytes != expect) {
      return false;
    }

    // scatter: per line, per channel (storage order), w samples
    const uint8_t* p = lines;
    for (int li = 0; li < n_lines; li++) {
      for (int cin = 0; cin < nch; cin++) {
        int pt = hd.channels[cin].pixel_type;
        float* dst = out + ((size_t)(y0 + li) * w) * nch + out_idx[cin];
        if (pt == 1) {
          const uint16_t* s = (const uint16_t*)p;
          for (int x = 0; x < w; x++) dst[(size_t)x * nch] = half_to_float(s[x]);
          p += (size_t)w * 2;
        } else if (pt == 2) {
          const float* s = (const float*)p;
          for (int x = 0; x < w; x++) dst[(size_t)x * nch] = s[x];
          p += (size_t)w * 4;
        } else {
          const uint32_t* s = (const uint32_t*)p;
          for (int x = 0; x < w; x++) dst[(size_t)x * nch] = (float)s[x];
          p += (size_t)w * 4;
        }
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

int sdirt_exr_info(const char* path, int* h, int* w, int* c) {
  return decode_exr_impl(path, nullptr, h, w, c) ? 0 : -1;
}

int sdirt_exr_decode(const char* path, float* out) {
  return decode_exr_impl(path, out, nullptr, nullptr, nullptr) ? 0 : -1;
}

}  // extern "C"
