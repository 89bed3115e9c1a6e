// Baseline JFIF writer equal byte for byte to cv2.imencode(".jpg") of an
// 8-bit BGR image (OpenCV through libjpeg-turbo with jpeg_set_defaults and
// jpeg_set_quality(q, force_baseline=TRUE)): a JFIF 1.01 APP0 (density 1:1,
// unit 0), one DQT marker a table, SOF0 with Y sampled 2x2 and Cb, Cr 1x1,
// one DHT marker a table (the four standard tables), no restart interval,
// no optimized tables. Every step is libjpeg-turbo's integer arithmetic:
//   - jpeg_quality_scaling and jpeg_add_quant_table (the baseline clamp);
//   - the fixed-point RGB -> YCbCr tables of jccolor.c (16 fraction bits);
//   - the edge replication of jcprepct.c and jcsample.c: the last row and
//     column repeated to whole blocks, the bottom to an even row count
//     before the chroma downsample and the downsampled rows to whole MCUs;
//   - h2v2_downsample, the 2x2 mean with the bias 1, 2, 1, 2 along a row;
//   - jpeg_fdct_islow on the samples less 128;
//   - quantize with compute_reciprocal's reciprocal, correction and shift;
//   - the dummy blocks of jccoefct.c at the right and bottom of the last
//     MCUs (zero AC, the DC of the block before);
//   - the sequential Huffman coder of jchuff.c with 0xFF byte stuffing and
//     1-bits padding the last byte.
// Plain C interface for ctypes: popnet_jpeg_encode_bound gives the bytes an
// output buffer needs, popnet_jpeg_encode writes the file into one.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {   // zigzag position -> natural (row-major) index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const unsigned kStdLuminance[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const unsigned kStdChrominance[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// the standard Huffman tables (JPEG Annex K.3): 16 counts, then the symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// a table's code and code length of each symbol (jpeg_make_c_derived_tbl)
struct HuffTable {
  unsigned code[256];
  int size[256];

  HuffTable(const uint8_t* bits, const uint8_t* vals) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    unsigned c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = c++;
        size[vals[k]] = len;
      }
      c <<= 1;
    }
  }
};

struct Writer {
  uint8_t* out;
  long long cap, n = 0;
  uint32_t acc = 0;   // pending bits, right-aligned
  int nacc = 0;
  bool overflow = false;

  void byte(int b) {
    if (n < cap) out[n] = (uint8_t)b; else overflow = true;
    ++n;
  }
  void word(int w) { byte(w >> 8); byte(w & 0xFF); }
  void bits(uint32_t code, int size) {   // size <= 16
    acc = (acc << size) | (code & ((1u << size) - 1));
    nacc += size;
    while (nacc >= 8) {
      int b = (acc >> (nacc - 8)) & 0xFF;
      byte(b);
      if (b == 0xFF) byte(0);
      nacc -= 8;
    }
  }
  void flush() { if (nacc > 0) bits(0x7F, 7); nacc = 0; acc = 0; }
};

// jcparam.c: jpeg_quality_scaling, then jpeg_add_quant_table with the
// baseline clamp
void quant_table(const unsigned* basic, int quality, unsigned* q) {
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)basic[i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 32767) t = 32767;
    if (t > 255) t = 255;
    q[i] = (unsigned)t;
  }
}

// jcdctmgr.c compute_reciprocal for DCTELEM = int16: reciprocal,
// correction (rounding) and shift of a divisor
struct Divisor {
  uint16_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;   // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint16_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {(uint16_t)fq, c, r - 16};
}

// jfdctint.c jpeg_fdct_islow (CONST_BITS 13, PASS1_BITS 2), in place
inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

void fdct_islow(int32_t* data) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  for (int pass = 0; pass < 2; ++pass) {
    const int stride = pass == 0 ? 1 : 8, step = pass == 0 ? 8 : 1;
    const int even_shift = pass == 0 ? 0 : 2, odd_shift = pass == 0 ? 13 - 2 : 13 + 2;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t* d = data + ctr * step;
      int64_t tmp0 = d[0 * stride] + d[7 * stride], tmp7 = d[0 * stride] - d[7 * stride];
      int64_t tmp1 = d[1 * stride] + d[6 * stride], tmp6 = d[1 * stride] - d[6 * stride];
      int64_t tmp2 = d[2 * stride] + d[5 * stride], tmp5 = d[2 * stride] - d[5 * stride];
      int64_t tmp3 = d[3 * stride] + d[4 * stride], tmp4 = d[3 * stride] - d[4 * stride];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = (int32_t)((tmp10 + tmp11) * 4);
        d[4 * stride] = (int32_t)((tmp10 - tmp11) * 4);
      } else {
        d[0] = descale(tmp10 + tmp11, even_shift);
        d[4 * stride] = descale(tmp10 - tmp11, even_shift);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      d[2 * stride] = descale(z1 + tmp13 * F0765, odd_shift);
      d[6 * stride] = descale(z1 + tmp12 * -F1847, odd_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      d[7 * stride] = descale(tmp4 + z1 + z3, odd_shift);
      d[5 * stride] = descale(tmp5 + z2 + z4, odd_shift);
      d[3 * stride] = descale(tmp6 + z2 + z3, odd_shift);
      d[1 * stride] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

// one 8x8 block of a plane (samples already padded to the block): DCT and
// quantization into coef (natural order)
void encode_block(const uint8_t* plane, int stride, int y0, int x0, const Divisor* div,
                  int16_t* coef) {
  int32_t ws[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) ws[y * 8 + x] = (int32_t)plane[(y0 + y) * stride + x0 + x] - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int16_t t = (int16_t)ws[i];
    uint16_t a = (uint16_t)(t < 0 ? -t : t);
    uint32_t p = (uint32_t)(uint16_t)(a + div[i].corr) * div[i].recip;
    p >>= div[i].shift + 16;
    int16_t v = (int16_t)p;
    coef[i] = t < 0 ? (int16_t)-v : v;
  }
}

inline int nbits(int v) {
  int n = 0;
  while (v) { ++n; v >>= 1; }
  return n;
}

void huff_block(Writer& w, const int16_t* coef, int& last_dc, const HuffTable& dc,
                const HuffTable& ac) {
  int t = coef[0] - last_dc;
  last_dc = coef[0];
  int t2 = t;
  if (t < 0) { t = -t; --t2; }
  int n = nbits(t);
  w.bits(dc.code[n], dc.size[n]);
  if (n) w.bits((uint32_t)t2, n);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    t = coef[kNatural[k]];
    if (t == 0) { ++r; continue; }
    while (r > 15) { w.bits(ac.code[0xF0], ac.size[0xF0]); r -= 16; }
    t2 = t;
    if (t < 0) { t = -t; --t2; }
    n = nbits(t);
    int sym = (r << 4) + n;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits((uint32_t)t2, n);
    r = 0;
  }
  if (r > 0) w.bits(ac.code[0], ac.size[0]);
}

void marker_dht(Writer& w, int index, const uint8_t* bits, const uint8_t* vals, int nvals) {
  w.byte(0xFF); w.byte(0xC4);
  w.word(2 + 1 + 16 + nvals);
  w.byte(index);
  for (int i = 0; i < 16; ++i) w.byte(bits[i]);
  for (int i = 0; i < nvals; ++i) w.byte(vals[i]);
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// bytes the file of an h x w image can take at most (the headers, and each
// block's worst case with every byte stuffed)
long long popnet_jpeg_encode_bound(int h, int w) {
  long long mcus = (long long)((h + 15) / 16) * ((w + 15) / 16);
  return 1024 + mcus * 6 * 2 * 220;
}

// bgr: h x w x 3 uint8, rows contiguous. Writes the file into out (cap
// bytes) and its length into n_out; returns 0, or 1 with the reason in err.
int popnet_jpeg_encode(const uint8_t* bgr, int h, int w, int quality, uint8_t* out,
                       long long cap, long long* n_out, char* err, int errlen) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) {
    set_err(err, errlen, "image sides must be 1..65535");
    return 1;
  }
  if (quality < 1 || quality > 100) {
    set_err(err, errlen, "quality must be 1..100");
    return 1;
  }
  unsigned qt[2][64];
  quant_table(kStdLuminance, quality, qt[0]);
  quant_table(kStdChrominance, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint16_t)(qt[t][i] * 8));

  // jccolor.c rgb_ycc_start's tables (SCALEBITS 16)
  const int64_t ONE = 1 << 16, HALF = 1 << 15, CBCR = (int64_t)128 << 16;
  auto fix = [&](double x) { return (int64_t)(x * ONE + 0.5); };
  int64_t tab[8][256];
  for (int i = 0; i < 256; ++i) {
    tab[0][i] = fix(0.29900) * i;
    tab[1][i] = fix(0.58700) * i;
    tab[2][i] = fix(0.11400) * i + HALF;
    tab[3][i] = -fix(0.16874) * i;
    tab[4][i] = -fix(0.33126) * i;
    tab[5][i] = fix(0.50000) * i + CBCR + HALF - 1;   // B -> Cb and R -> Cr
    tab[6][i] = -fix(0.41869) * i;
    tab[7][i] = -fix(0.08131) * i;
  }

  // Y padded by edge replication to whole blocks; the chroma planes to
  // whole MCUs of the 2x2 downsample (rows past ceil(h / 2) repeat the
  // last downsampled row)
  const int mcu_x = (w + 15) / 16, mcu_y = (h + 15) / 16;
  const int yw = mcu_x * 16, yh = mcu_y * 16;
  const int cw = mcu_x * 8, ch = mcu_y * 8;
  const int yblocks_w = (w + 7) / 8, yblocks_h = (h + 7) / 8;
  std::vector<uint8_t> Y((size_t)yw * yh), Cb((size_t)cw * ch), Cr((size_t)cw * ch);
  std::vector<uint8_t> fcb((size_t)(h + 1) * yw), fcr((size_t)(h + 1) * yw);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = bgr + ((size_t)y * w + x) * 3;
      int b = p[0], g = p[1], r = p[2];
      Y[(size_t)y * yw + x] = (uint8_t)((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
      fcb[(size_t)y * yw + x] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
      fcr[(size_t)y * yw + x] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
    }
    for (int x = w; x < yw; ++x) {
      Y[(size_t)y * yw + x] = Y[(size_t)y * yw + w - 1];
      fcb[(size_t)y * yw + x] = fcb[(size_t)y * yw + w - 1];
      fcr[(size_t)y * yw + x] = fcr[(size_t)y * yw + w - 1];
    }
  }
  for (int y = h; y < yh; ++y) std::memcpy(&Y[(size_t)y * yw], &Y[(size_t)(h - 1) * yw], yw);
  if (h % 2) {
    std::memcpy(&fcb[(size_t)h * yw], &fcb[(size_t)(h - 1) * yw], yw);
    std::memcpy(&fcr[(size_t)h * yw], &fcr[(size_t)(h - 1) * yw], yw);
  }
  const int crows = (h + 1) / 2;
  for (int j = 0; j < ch; ++j) {
    int jj = j < crows ? j : crows - 1;
    const uint8_t* b0 = &fcb[(size_t)(2 * jj) * yw];
    const uint8_t* b1 = b0 + yw;
    const uint8_t* r0 = &fcr[(size_t)(2 * jj) * yw];
    const uint8_t* r1 = r0 + yw;
    for (int i = 0; i < cw; ++i) {
      int bias = (i & 1) ? 2 : 1;
      Cb[(size_t)j * cw + i] =
          (uint8_t)((b0[2 * i] + b0[2 * i + 1] + b1[2 * i] + b1[2 * i + 1] + bias) >> 2);
      Cr[(size_t)j * cw + i] =
          (uint8_t)((r0[2 * i] + r0[2 * i + 1] + r1[2 * i] + r1[2 * i + 1] + bias) >> 2);
    }
  }

  Writer wr{out, cap};
  wr.byte(0xFF); wr.byte(0xD8);
  static const uint8_t app0[16] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1};
  for (uint8_t b : app0) wr.byte(b);
  wr.byte(0); wr.byte(0);
  for (int t = 0; t < 2; ++t) {
    wr.byte(0xFF); wr.byte(0xDB); wr.word(67); wr.byte(t);
    for (int i = 0; i < 64; ++i) wr.byte((int)qt[t][kNatural[i]]);
  }
  wr.byte(0xFF); wr.byte(0xC0); wr.word(17); wr.byte(8); wr.word(h); wr.word(w); wr.byte(3);
  static const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  for (uint8_t b : comps) wr.byte(b);
  marker_dht(wr, 0x00, kDcLumBits, kDcVals, 12);
  marker_dht(wr, 0x10, kAcLumBits, kAcLumVals, 162);
  marker_dht(wr, 0x01, kDcChrBits, kDcVals, 12);
  marker_dht(wr, 0x11, kAcChrBits, kAcChrVals, 162);
  static const uint8_t sos[14] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  for (uint8_t b : sos) wr.byte(b);

  HuffTable dc0(kDcLumBits, kDcVals), ac0(kAcLumBits, kAcLumVals);
  HuffTable dc1(kDcChrBits, kDcVals), ac1(kAcChrBits, kAcChrVals);
  int last_dc[3] = {0, 0, 0};
  int16_t blk[4][64], coef[64];
  for (int my = 0; my < mcu_y; ++my) {
    for (int mx = 0; mx < mcu_x; ++mx) {
      // jccoefct.c: blocks right of or below the image's blocks are dummy
      // blocks, zero but for the DC of the block before them
      for (int yi = 0; yi < 2; ++yi) {
        for (int xi = 0; xi < 2; ++xi) {
          int16_t* c = blk[yi * 2 + xi];
          int by = my * 2 + yi, bx = mx * 2 + xi;
          if (by < yblocks_h && bx < yblocks_w) {
            encode_block(Y.data(), yw, by * 8, bx * 8, div[0], c);
          } else {
            std::memset(c, 0, 64 * sizeof(int16_t));
            c[0] = by < yblocks_h ? blk[yi * 2 + xi - 1][0] : blk[yi * 2 - 1][0];
          }
        }
      }
      for (int k = 0; k < 4; ++k) huff_block(wr, blk[k], last_dc[0], dc0, ac0);
      encode_block(Cb.data(), cw, my * 8, mx * 8, div[1], coef);
      huff_block(wr, coef, last_dc[1], dc1, ac1);
      encode_block(Cr.data(), cw, my * 8, mx * 8, div[1], coef);
      huff_block(wr, coef, last_dc[2], dc1, ac1);
    }
  }
  wr.flush();
  wr.byte(0xFF); wr.byte(0xD9);
  if (wr.overflow) {
    set_err(err, errlen, "output buffer too small");
    return 1;
  }
  *n_out = wr.n;
  return 0;
}

}  // extern "C"
