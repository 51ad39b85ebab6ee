// jpeg_decode: the host runtime's JPEG decoder, built with pronerf_native.cpp
// into one library (pronerf_tpu_torch/native/__init__.py) and bound with
// ctypes.
//
// It decodes a JPEG to the pixels libjpeg-turbo gives PIL with its defaults,
// bit for bit, and is the C++ twin of pronerf_tpu_torch/utils/jpeg.py's
// decode_jpeg_plain, step for step:
//
//  - Huffman decoding of baseline (SOF0), extended sequential (SOF1, 8-bit)
//    and progressive (SOF2) scans: jdhuff.c's decode_mcu, and jdphuff.c's DC
//    first / DC refine / AC first (end-of-band runs) / AC refine (correction
//    bits); restart intervals reset the DC predictors and the EOB run;
//  - dequantisation with the table latched at the component's first scan,
//    then jidctint.c's islow IDCT (CONST_BITS 13, PASS1_BITS 2, the +128
//    centre and the range-limit table, indexed by the sample & 1023);
//  - jdsample.c's fancy upsampling for h2v1 and h2v2 (box filter for a plane
//    of 2 columns or fewer), edges repeated as jdmainct.c repeats them;
//  - jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS 16).
//
// Anything it does not decode exactly (arithmetic coding, 12-bit, lossless,
// hierarchical, 2 or 4 components, RGB coding, other samplings, DNL, an
// incomplete progressive file, truncated or corrupt data) is an error whose
// message names it; the Python side raises UnsupportedJPEG with it.
//
// C ABI: jpeg_header (dimensions) and jpeg_decode (pixels); each returns 0,
// or 1 with a message in err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Unsupported {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Unsupported{msg}; }

std::string hex_marker(int m) {
  char s[8];
  std::snprintf(s, sizeof s, "0x%02X", m);
  return s;
}

// jpeg_natural_order: the natural index of the k-th zigzag coefficient
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// PIL.Image.open's limit (2 * MAX_IMAGE_PIXELS): imageio raises past it
const int64_t kMaxPixels = 178956970;

inline int16_t wrap16(int64_t x) { return (int16_t)(uint16_t)(x & 0xFFFF); }

struct Huff {
  bool defined = false;
  uint8_t bits[16];
  std::vector<uint8_t> vals;
};

// (code length << 8) | symbol for each 16-bit window; 0 where no code starts
struct Lut {
  std::vector<uint16_t> t;
  void build(const Huff& h, bool is_dc, const char* what) {
    if (!h.defined) fail(std::string("no Huffman table for ") + what);
    t.assign(1 << 16, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      // no all-ones code: checked before the codes of this length are filled
      if (code + h.bits[len - 1] >= (1 << len))
        fail(std::string("bad Huffman table (") + what + ")");
      for (int i = 0; i < h.bits[len - 1]; ++i) {
        int sym = h.vals[k++];
        if (is_dc && sym > 15)
          fail(std::string("bad Huffman table (") + what + ")");
        int lo = code << (16 - len);
        std::fill(t.begin() + lo, t.begin() + lo + (1 << (16 - len)),
                  (uint16_t)((len << 8) | sym));
        ++code;
      }
      code <<= 1;
    }
  }
};

struct Component {
  int cid, h, v, tq;
  int bw, bh, wb, hb, dw, dh;
  bool latched = false;
  int q[64];
  int bits[64];
  std::vector<int16_t> coefs;
};

// The bits of one restart interval, stuffing undone, with 8 zero bytes after
struct Bits {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;
  inline uint64_t window() const {
    int64_t b = pos >> 3;
    if (b > n) fail("truncated or corrupt entropy-coded data");
    uint64_t w;
    std::memcpy(&w, p + b, 8);
    return __builtin_bswap64(w) << (pos & 7);
  }
  inline int huff(const Lut& lut) {
    int e = lut.t[window() >> 48];
    if (!e) fail("corrupt entropy-coded data");
    pos += e >> 8;
    return e & 255;
  }
  inline int get(int n_bits) {  // n_bits in 1..16
    int v = (int)(window() >> (64 - n_bits));
    pos += n_bits;
    return v;
  }
  inline int bit() { return get(1); }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (int)((-1u) << s) + 1 : r;
}

struct Decoder {
  const uint8_t* data;
  int64_t n;
  int sof = -1, width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff huff[2][4];
  int restart = 0;
  bool jfif = false;
  int adobe = -1;
  int scans = 0;
  int64_t pos = 2;

  Decoder(const uint8_t* d, int64_t len) : data(d), n(len) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
  }

  // the next marker, from pos: extraneous bytes and fill bytes skipped
  int next_marker() {
    while (pos < n && data[pos] != 0xFF) ++pos;
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) fail("truncated file (no EOI marker)");
    return data[pos++];
  }

  void frame_header(int marker, const uint8_t* s, int len) {
    if (sof >= 0) fail("a second frame header");
    if (len < 6) fail("short frame header");
    int prec = s[0], nf = s[5];
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    if (prec != 8) fail(std::to_string(prec) + "-bit samples");
    if (height == 0) fail("a height of 0 (the height in a DNL marker)");
    if (width == 0) fail("a width of 0");
    if (height > 65500 || width > 65500)  // jdinput.c: JPEG_MAX_DIMENSION
      fail("an image of " + std::to_string(width) + "x" +
           std::to_string(height) + " (more than 65500 a side)");
    if ((int64_t)width * height > kMaxPixels)  // PIL's decompression bomb
      fail("an image of " + std::to_string(width) + "x" +
           std::to_string(height) + " (PIL refuses more than " +
           std::to_string(kMaxPixels) + " pixels)");
    if (nf != 1 && nf != 3)
      fail(std::to_string(nf) + " components" +
           (nf == 4 ? " (CMYK or YCCK)" : ""));
    if (len < 6 + 3 * nf) fail("short frame header");
    sof = marker;
    comps.resize(nf);
    for (int i = 0; i < nf; ++i) {
      Component& c = comps[i];
      c.cid = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("component " + std::to_string(c.cid) + ": sampling " +
             std::to_string(c.h) + "x" + std::to_string(c.v));
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (auto& c : comps) {
      int he = hmax / c.h, ve = vmax / c.v;
      bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                ((he == 1 && ve == 1) || (he == 2 && ve == 1) ||
                 (he == 2 && ve == 2));
      if (!ok) {
        std::string f = "sampling factors";
        for (auto& d : comps)
          f += " " + std::to_string(d.h) + "x" + std::to_string(d.v);
        fail(f + " (4:4:4, 4:2:2 and 4:2:0 are read)");
      }
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    int64_t dc_codes = 0;
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.wb = (c.dw + 7) / 8;
      c.hb = (c.dh + 7) / 8;
      std::fill(c.bits, c.bits + 64, -1);
      dc_codes += (int64_t)c.wb * c.hb;
    }
    // every block's DC is a Huffman code of at least one bit
    if (dc_codes > 8 * n)
      fail("truncated file (fewer bytes than the frame's blocks need)");
  }

  void dqt(const uint8_t* s, int len) {
    int p = 0;
    while (p < len) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      if (tq > 3 || pq > 1)
        fail("quantisation table " + std::to_string(tq) + " of precision " +
             std::to_string(pq));
      int sz = pq ? 128 : 64;
      if (p + 1 + sz > len) fail("short DQT segment");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] =
            pq ? (s[p + 1 + 2 * k] << 8) | s[p + 2 + 2 * k] : s[p + 1 + k];
      qt_defined[tq] = true;
      p += 1 + sz;
    }
  }

  // huff[cls][t], the table a scan's selector names
  const Huff& table(int cls, int t) const {
    if (t > 3)
      fail("Huffman table " + std::to_string(t) + " (tables 0 to 3 exist)");
    return huff[cls][t];
  }

  void dht(const uint8_t* s, int len) {
    int p = 0;
    while (p < len) {
      if (p + 17 > len) fail("short DHT segment");
      int tc = s[p] >> 4, th = s[p] & 15, count = 0;
      for (int i = 0; i < 16; ++i) count += s[p + 1 + i];
      if (tc > 1 || th > 3 || count > 256 || p + 17 + count > len)
        fail("bad DHT segment");
      Huff& h = huff[tc][th];
      h.defined = true;
      std::memcpy(h.bits, s + p + 1, 16);
      h.vals.assign(s + p + 17, s + p + 17 + count);
      p += 17 + count;
    }
  }

  // the scan's data from pos: restart intervals unstuffed into `buf`
  // (each followed by 8 zero bytes), their starts and RSTn numbers; pos is
  // left at the marker that ends the scan
  void scan_data(std::vector<uint8_t>& buf, std::vector<int64_t>& starts,
                 std::vector<int64_t>& ends, std::vector<int>& rsts) {
    buf.clear();
    buf.reserve(n - pos + 64);
    starts.assign(1, 0);
    ends.clear();
    rsts.clear();
    while (true) {
      const uint8_t* f =
          (const uint8_t*)std::memchr(data + pos, 0xFF, n - pos);
      if (!f) fail("truncated file (scan data without an ending marker)");
      int64_t i = f - data;
      buf.insert(buf.end(), data + pos, data + i);
      int64_t j = i + 1;
      while (j < n && data[j] == 0xFF) ++j;
      if (j >= n) fail("truncated file");
      if (data[j] == 0) {
        buf.push_back(0xFF);
        pos = j + 1;
      } else {
        ends.push_back((int64_t)buf.size());
        buf.insert(buf.end(), 8, 0);
        if (data[j] >= 0xD0 && data[j] <= 0xD7) {
          rsts.push_back(data[j] - 0xD0);
          starts.push_back((int64_t)buf.size());
          pos = j + 1;
        } else {
          pos = i;
          return;
        }
      }
    }
  }

  // jdapimin.c's default_decompress_parms, which runs when the first scan
  // is reached: 3 components are YCbCr unless an Adobe marker without JFIF
  // says transform 0, or the component ids spell R, G, B
  void check_colour() const {
    if (comps.size() != 3 || jfif) return;
    if (adobe == 0) fail("RGB coding (Adobe transform 0)");
    if (adobe < 0 && comps[0].cid == 82 && comps[1].cid == 71 &&
        comps[2].cid == 66)
      fail("RGB coding (component ids R, G, B)");
  }

  void scan(const uint8_t* s, int len) {
    if (sof < 0) fail("a scan before the frame header");
    if (!scans) check_colour();
    int ns = len > 0 ? s[0] : 0;
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) fail("bad scan header");
    std::vector<Component*> sc;
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int cid = s[1 + 2 * i];
      Component* c = nullptr;
      for (auto& d : comps)
        if (d.cid == cid) c = &d;
      if (!c || std::find(sc.begin(), sc.end(), c) != sc.end())
        fail("scan names component " + std::to_string(cid));
      sc.push_back(c);
      td[i] = s[2 + 2 * i] >> 4;
      ta[i] = s[2 + 2 * i] & 15;
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (ns > 1) {
      int blocks = 0;
      for (auto* c : sc) blocks += c->h * c->v;
      if (blocks > 10) fail("more than 10 blocks an MCU");
    }
    for (auto* c : sc) {  // latch_quant_tables
      if (!c->latched) {
        if (!qt_defined[c->tq])
          fail("no quantisation table " + std::to_string(c->tq));
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
    }
    bool progressive = sof == 0xC2;
    if (progressive) {
      if ((ss == 0 && se != 0) || (ss && (ss > se || se > 63 || ns != 1)) ||
          (ah && al != ah - 1) || al > 13)
        fail("bad progression Ss=" + std::to_string(ss) +
             " Se=" + std::to_string(se) + " Ah=" + std::to_string(ah) +
             " Al=" + std::to_string(al));
      for (auto* c : sc)
        for (int k = ss; k <= se; ++k) {
          if (ah != std::max(c->bits[k], 0) || (ss && c->bits[0] < 0))
            fail("bad progression order");
          c->bits[k] = al;
        }
    } else {
      ss = 0;
      se = 63;
      for (auto* c : sc) std::fill(c->bits, c->bits + 64, 0);
    }

    // blocks in coding order: (index in the scan, coefficient offset)
    std::vector<std::pair<int, int64_t>> blocks;
    int per_mcu;
    if (ns == 1) {
      Component* c = sc[0];
      per_mcu = 1;
      blocks.reserve((size_t)c->hb * c->wb);
      for (int by = 0; by < c->hb; ++by)
        for (int bx = 0; bx < c->wb; ++bx)
          blocks.push_back({0, ((int64_t)by * c->bw + bx) * 64});
    } else {
      per_mcu = 0;
      for (auto* c : sc) per_mcu += c->h * c->v;
      blocks.reserve((size_t)mcux * mcuy * per_mcu);
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx)
          for (int si = 0; si < ns; ++si) {
            Component* c = sc[si];
            for (int yy = 0; yy < c->v; ++yy)
              for (int xx = 0; xx < c->h; ++xx)
                blocks.push_back(
                    {si, ((int64_t)(my * c->v + yy) * c->bw + mx * c->h + xx) *
                             64});
          }
    }
    int64_t n_mcu = (int64_t)blocks.size() / per_mcu;
    int64_t ri = restart ? restart : n_mcu;
    int64_t n_int = (n_mcu + ri - 1) / ri;

    std::vector<uint8_t> buf;
    std::vector<int64_t> starts, ends;
    std::vector<int> rsts;
    scan_data(buf, starts, ends, rsts);
    if ((int64_t)ends.size() < n_int)
      fail("missing or misplaced restart marker");
    for (int64_t i = 0; i + 1 < n_int; ++i)
      if (rsts[i] != i % 8) fail("missing or misplaced restart marker");

    Lut dcl[4], acl[4];
    if (!progressive) {
      for (int i = 0; i < ns; ++i) {
        dcl[i].build(table(0, td[i]), true, "DC");
        acl[i].build(table(1, ta[i]), false, "AC");
      }
    } else if (ss == 0 && ah == 0) {
      for (int i = 0; i < ns; ++i) dcl[i].build(table(0, td[i]), true, "DC");
    } else if (ss) {
      acl[0].build(table(1, ta[0]), false, "AC");
    }
    int16_t* cf[4];
    for (int i = 0; i < ns; ++i) cf[i] = sc[i]->coefs.data();

    for (int64_t it = 0; it < n_int; ++it) {
      Bits b{buf.data() + starts[it], ends[it] - starts[it]};
      size_t lo = (size_t)(it * ri * per_mcu);
      size_t hi = std::min(blocks.size(), (size_t)((it + 1) * ri * per_mcu));
      if (!progressive)
        seq_interval(b, blocks, lo, hi, dcl, acl, cf);
      else if (ss == 0 && ah == 0)
        dc_first(b, blocks, lo, hi, dcl, al, cf);
      else if (ss == 0)
        dc_refine(b, blocks, lo, hi, al, cf);
      else if (ah == 0)
        ac_first(b, blocks, lo, hi, acl[0], ss, se, al, cf[0]);
      else
        ac_refine(b, blocks, lo, hi, acl[0], ss, se, al, cf[0]);
      if (b.pos > 8 * b.n)
        fail("truncated or corrupt entropy-coded data");
    }
    ++scans;
  }

  using Blocks = std::vector<std::pair<int, int64_t>>;

  static void seq_interval(Bits& b, const Blocks& bl, size_t lo, size_t hi,
                           const Lut* dcl, const Lut* acl, int16_t** cf) {
    int64_t pred[4] = {0, 0, 0, 0};
    for (size_t i = lo; i < hi; ++i) {
      int ci = bl[i].first;
      int16_t* blk = cf[ci] + bl[i].second;
      int s = b.huff(dcl[ci]);
      if (s) pred[ci] += extend(b.get(s), s);
      blk[0] = wrap16(pred[ci]);
      const Lut& lut = acl[ci];
      for (int k = 1; k < 64; ++k) {
        int rs = b.huff(lut);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) fail("corrupt entropy-coded data");
          blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
        } else if (r == 15) {
          k += 15;
        } else {
          break;
        }
      }
    }
  }

  static void dc_first(Bits& b, const Blocks& bl, size_t lo, size_t hi,
                       const Lut* dcl, int al, int16_t** cf) {
    int64_t pred[4] = {0, 0, 0, 0};
    for (size_t i = lo; i < hi; ++i) {
      int ci = bl[i].first;
      int s = b.huff(dcl[ci]);
      if (s) pred[ci] += extend(b.get(s), s);
      cf[ci][bl[i].second] = wrap16(pred[ci] * ((int64_t)1 << al));
    }
  }

  static void dc_refine(Bits& b, const Blocks& bl, size_t lo, size_t hi,
                        int al, int16_t** cf) {
    for (size_t i = lo; i < hi; ++i)
      if (b.bit()) cf[bl[i].first][bl[i].second] |= (int16_t)(1 << al);
  }

  static void ac_first(Bits& b, const Blocks& bl, size_t lo, size_t hi,
                       const Lut& lut, int ss, int se, int al, int16_t* cf) {
    int64_t eobrun = 0;
    for (size_t i = lo; i < hi; ++i) {
      if (eobrun) {
        --eobrun;
        continue;
      }
      int16_t* blk = cf + bl[i].second;
      for (int k = ss; k <= se; ++k) {
        int rs = b.huff(lut);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > se) fail("corrupt entropy-coded data");
          blk[kNatural[k]] = wrap16((int64_t)extend(b.get(s), s) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = (int64_t)1 << r;
          if (r) eobrun += b.get(r);
          --eobrun;
          break;
        }
      }
    }
  }

  static void ac_refine(Bits& b, const Blocks& bl, size_t lo, size_t hi,
                        const Lut& lut, int ss, int se, int al, int16_t* cf) {
    const int p1 = 1 << al, m1 = -(1 << al);
    int64_t eobrun = 0;
    for (size_t i = lo; i < hi; ++i) {
      int16_t* blk = cf + bl[i].second;
      int k = ss;
      if (!eobrun) {
        for (; k <= se; ++k) {
          int rs = b.huff(lut);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = b.bit() ? p1 : m1;
          } else if (r != 15) {
            eobrun = (int64_t)1 << r;
            if (r) eobrun += b.get(r);
            break;
          }
          do {
            int16_t* c = blk + kNatural[k];
            if (*c) {
              if (b.bit() && !(*c & p1))
                *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
            } else if (--r < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (s) {
            if (k > se) fail("corrupt entropy-coded data");
            blk[kNatural[k]] = (int16_t)s;
          }
        }
      }
      if (eobrun) {
        for (; k <= se; ++k) {
          int16_t* c = blk + kNatural[k];
          if (*c && b.bit() && !(*c & p1))
            *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        }
        --eobrun;
      }
    }
  }

  // markers up to the frame header (header_only) or to EOI
  void run(bool header_only) {
    while (true) {
      int m = next_marker();
      if (m == 0xD9) break;
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (pos + 2 > n) fail("truncated file");
      int len = (data[pos] << 8) | data[pos + 1];
      if (len < 2 || pos + len > n) fail("truncated file");
      const uint8_t* s = data + pos + 2;
      int body = len - 2;
      pos += len;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          frame_header(m, s, body);
          if (header_only) return;
          for (auto& c : comps)
            c.coefs.assign((size_t)c.bw * c.bh * 64, 0);
          break;
        case 0xC3: fail("lossless (SOF3)");
        case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
          fail("hierarchical (marker " + hex_marker(m) + ")");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
          fail("arithmetic coding (marker " + hex_marker(m) + ")");
        case 0xDC: fail("a DNL marker");
        case 0xDB: dqt(s, body); break;
        case 0xC4: dht(s, body); break;
        case 0xDD:
          if (body != 2) fail("bad DRI segment");
          restart = (s[0] << 8) | s[1];
          break;
        case 0xDA: scan(s, body); break;
        case 0xFE: break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            if (m == 0xE0 && body >= 5 && !std::memcmp(s, "JFIF\0", 5))
              jfif = true;
            if (m == 0xEE && body >= 12 && !std::memcmp(s, "Adobe", 5))
              adobe = s[11];
            break;
          }
          fail("marker " + hex_marker(m));
      }
    }
    if (header_only) fail("no frame header");
    if (!scans) fail("no scan");
    for (auto& c : comps)
      for (int k = 0; k < 10; ++k)
        if (c.bits[k] != 0)
          fail("a progressive file whose first coefficients are incomplete "
               "(libjpeg smooths its blocks)");
  }
};

inline bool fits16(int64_t v) { return v >= -32768 && v <= 32767; }

// libjpeg-turbo's SIMD islow IDCT keeps a pass's inputs and the sums of
// pairs of them in 16 bits, where its C code (the model) does not: past
// them the two differ, and no encoder's coefficients get there
inline bool pass_fits16(const int64_t* x) {
  for (int k = 0; k < 8; ++k)
    if (!fits16(x[k])) return false;
  return fits16(x[0] + x[4]) && fits16(x[0] - x[4]) && fits16(x[2] + x[6]) &&
         fits16(x[7] + x[3]) && fits16(x[5] + x[1]) && fits16(x[7] + x[1]) &&
         fits16(x[5] + x[3]);
}

[[noreturn]] void fail_past16() {
  fail("dequantised coefficients past 16 bits (libjpeg-turbo's SIMD IDCT "
       "saturates them)");
}

// jidctint.c: jpeg_idct_islow on one dequantised block -> 8x8 samples
void idct_islow(const int16_t* coef, const int* q, uint8_t* out,
                int64_t stride) {
  static uint8_t limit[1024];
  static bool init = false;
  if (!init) {  // jdmaster.c's post-IDCT range limit, by the sample & 1023
    for (int i = 0; i < 1024; ++i)
      limit[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
    init = true;
  }
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    int64_t x[8];
    for (int k = 0; k < 8; ++k) x[k] = (int64_t)coef[8 * k + c] * q[8 * k + c];
    if (!pass_fits16(x)) fail_past16();
    int64_t z2 = x[2], z3 = x[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137, tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (x[0] + x[4]) * 8192, tmp1 = (x[0] - x[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3, z5 = (z3 + z4) * 9633;
    t0 *= 2446;
    t1 *= 16819;
    t2 *= 25172;
    t3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int64_t half = 1 << 10;
    ws[8 * 0 + c] = (tmp10 + t3 + half) >> 11;
    ws[8 * 7 + c] = (tmp10 - t3 + half) >> 11;
    ws[8 * 1 + c] = (tmp11 + t2 + half) >> 11;
    ws[8 * 6 + c] = (tmp11 - t2 + half) >> 11;
    ws[8 * 2 + c] = (tmp12 + t1 + half) >> 11;
    ws[8 * 5 + c] = (tmp12 - t1 + half) >> 11;
    ws[8 * 3 + c] = (tmp13 + t0 + half) >> 11;
    ws[8 * 4 + c] = (tmp13 - t0 + half) >> 11;
  }
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    const int64_t* x = ws + 8 * r;
    if (!pass_fits16(x)) fail_past16();
    int64_t z2 = x[2], z3 = x[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137, tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = ((int64_t)x[0] + x[4]) * 8192;
    int64_t tmp1 = ((int64_t)x[0] - x[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3, z5 = (z3 + z4) * 9633;
    t0 *= 2446;
    t1 *= 16819;
    t2 *= 25172;
    t3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int64_t half = 1 << 17;
    int64_t y[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
    uint8_t* o = out + r * stride;
    for (int i = 0; i < 8; ++i) {
      int64_t v = (y[i] + half) >> 18;
      // the range-limit table wraps past +-512, where the SIMD code
      // saturates
      if (v < -512 || v > 511)
        fail("an IDCT output past the range limit's +-512");
      o[i] = limit[v & 1023];
    }
  }
}

// A component's [dh, dw] samples (row stride `stride`) upsampled by (he, ve)
// and cropped to the image's [H, W], into `out` (row stride W)
void upsample(const uint8_t* in, int64_t stride, int dw, int dh, int he,
              int ve, uint8_t* out, int W, int H) {
  std::vector<int> sums(dw);
  for (int oy = 0; oy < H; ++oy) {
    uint8_t* o = out + (int64_t)oy * W;
    const uint8_t* x = in + (int64_t)(oy / ve) * stride;
    if (he == 1) {
      std::memcpy(o, x, W);
    } else if (dw <= 2) {  // h2v1 / h2v2 box
      for (int ox = 0; ox < W; ++ox) o[ox] = x[ox >> 1];
    } else if (ve == 1) {  // h2v1 fancy
      for (int i = 0; i < dw; ++i) {
        int c = 3 * x[i];
        int l = x[i > 0 ? i - 1 : 0], r = x[i + 1 < dw ? i + 1 : dw - 1];
        if (2 * i < W) o[2 * i] = (uint8_t)((c + l + 1) >> 2);
        if (2 * i + 1 < W) o[2 * i + 1] = (uint8_t)((c + r + 2) >> 2);
      }
    } else {  // h2v2 fancy: the nearer row x3 plus the row above / below
      int row = oy >> 1;
      int nb = (oy & 1) ? std::min(row + 1, dh - 1) : std::max(row - 1, 0);
      const uint8_t* y = in + (int64_t)nb * stride;
      for (int i = 0; i < dw; ++i) sums[i] = 3 * x[i] + y[i];
      for (int i = 0; i < dw; ++i) {
        int c = 3 * sums[i];
        int l = sums[i > 0 ? i - 1 : 0], r = sums[i + 1 < dw ? i + 1 : dw - 1];
        if (2 * i < W) o[2 * i] = (uint8_t)((c + l + 8) >> 4);
        if (2 * i + 1 < W) o[2 * i + 1] = (uint8_t)((c + r + 7) >> 4);
      }
    }
  }
}

void decode(Decoder& d, uint8_t* out) {
  const int W = d.width, H = d.height, nc = (int)d.comps.size();
  std::vector<std::vector<uint8_t>> planes(nc);
  for (int ci = 0; ci < nc; ++ci) {
    Component& c = d.comps[ci];
    int64_t stride = (int64_t)c.bw * 8;
    std::vector<uint8_t> samples((size_t)stride * c.bh * 8);
    for (int by = 0; by < c.hb; ++by)  // blocks past dw, dh are not read
      for (int bx = 0; bx < c.wb; ++bx)
        idct_islow(c.coefs.data() + ((int64_t)by * c.bw + bx) * 64, c.q,
                   samples.data() + (int64_t)by * 8 * stride + bx * 8, stride);
    planes[ci].resize((size_t)W * H);
    upsample(samples.data(), stride, c.dw, c.dh, d.hmax / c.h, d.vmax / c.v,
             planes[ci].data(), W, H);
  }
  if (nc == 1) {
    std::memcpy(out, planes[0].data(), (size_t)W * H);
    return;
  }
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  const int64_t fix_r = (int64_t)(1.40200 * 65536 + 0.5);
  const int64_t fix_b = (int64_t)(1.77200 * 65536 + 0.5);
  const int64_t fix_gr = (int64_t)(0.71414 * 65536 + 0.5);
  const int64_t fix_gb = (int64_t)(0.34414 * 65536 + 0.5);
  for (int i = 0; i < 256; ++i) {  // jdcolor.c: build_ycc_rgb_table
    int64_t x = i - 128;
    cr_r[i] = (int)((fix_r * x + 32768) >> 16);
    cb_b[i] = (int)((fix_b * x + 32768) >> 16);
    cr_g[i] = -fix_gr * x;
    cb_g[i] = -fix_gb * x + 32768;
  }
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  const uint8_t *Y = planes[0].data(), *Cb = planes[1].data(),
                *Cr = planes[2].data();
  for (int64_t p = 0; p < (int64_t)W * H; ++p) {
    int y = Y[p], cb = Cb[p], cr = Cr[p];
    out[3 * p] = clamp(y + cr_r[cr]);
    out[3 * p + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * p + 2] = clamp(y + cb_b[cb]);
  }
}

int report(const std::string& msg, char* err, int32_t err_len) {
  if (err && err_len > 0) std::snprintf(err, err_len, "%s", msg.c_str());
  return 1;
}

// runs `body`; an error (ours, or the allocator's) becomes the return 1
template <class F>
int guarded(F body, char* err, int32_t err_len) {
  try {
    body();
    return 0;
  } catch (const Unsupported& e) {
    return report(e.msg, err, err_len);
  } catch (const std::exception& e) {
    return report(std::string("cannot decode: ") + e.what(), err, err_len);
  }
}

}  // namespace

extern "C" {

// dims: [height, width, components]
int jpeg_header(const uint8_t* data, int64_t n, int32_t* dims, char* err,
                int32_t err_len) {
  return guarded(
      [&] {
        Decoder d(data, n);
        d.run(true);
        dims[0] = d.height;
        dims[1] = d.width;
        dims[2] = (int32_t)d.comps.size();
      },
      err, err_len);
}

// out: uint8 [height, width, components], out_size bytes
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                int64_t out_size, char* err, int32_t err_len) {
  return guarded(
      [&] {
        Decoder d(data, n);
        d.run(false);
        if ((int64_t)d.width * d.height * (int64_t)d.comps.size() != out_size)
          fail("output buffer of another size");
        decode(d, out);
      },
      err, err_len);
}

}  // extern "C"
