// Baseline, extended-sequential and progressive JPEG decoding on the host,
// rounding as libjpeg-turbo's default decompression does (the ISLOW integer
// IDCT, fancy "triangle" upsampling, the fixed-point YCbCr -> BGR tables),
// so a frame equals what cv2.imread gives for it bit for bit.
//
// A progressive frame (SOF2) is decoded as libjpeg's jdphuff.c does: every
// scan adds to a whole-image coefficient buffer (DC first and refinement
// scans, interleaved or not; AC first scans with spectral selection and
// end-of-band runs; AC refinement scans with their correction bits and
// zero-run history), then the buffer goes through the sequential path's
// IDCT, upsampling and colour conversion. A non-interleaved scan covers the
// component's own blocks, an interleaved one the padded MCUs. Huffman
// tables may change between scans; a component's quantization table is
// latched at its first scan (libjpeg's latch_quant_tables), sequential
// frames included. Where the scans leave one of coefficients 1-9 of a
// component short of full precision, libjpeg-turbo smooths the blocks
// (decompress_smooth_data); such a file is refused.
//
// C interface (ctypes, popnet_tpu_torch/data/image_io.py):
//   popnet_jpeg_info(data, n, &height, &width, &orientation, err, errlen)
//   popnet_jpeg_decode(data, n, out, err, errlen)   out: height * width * 3 BGR
// Both return 0, or -1 with a reason in `err`. `orientation` is the EXIF
// orientation tag of the first APP1 "Exif" segment (1 where there is none);
// the caller applies it. Refused: incomplete progressive frames (above),
// lossless, hierarchical and arithmetic-coded frames, sample precisions
// other than 8 bits, 2 or 4+ components, and three-component frames that
// are not YCbCr (an Adobe APP14 transform 0, or component ids 'R', 'G',
// 'B' without JFIF).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
    std::string what;
};

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
    bool defined = false;
    // canonical decoding (JPEG F.2.2.3): maxcode[l] the largest code of
    // length l (-1 if none), valptr[l] the index of its first symbol
    int32_t mincode[17], maxcode[18], valptr[17];
    uint8_t values[256];
    // 9-bit lookahead: length << 8 | symbol, 0 where the code is longer
    uint16_t fast[512];
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int dc_table = 0, ac_table = 0;
    int bw = 0, bh = 0;            // blocks of the coefficient buffer (MCU-aligned)
    int width_in_blocks = 0, height_in_blocks = 0;
    int dw = 0, dh = 0;            // downsampled width and height
    std::vector<int16_t> coef;     // bw * bh blocks of 64, natural order
    int dc_pred = 0;
    bool latched = false;          // the quantization table, copied at the first scan
    uint16_t quant[64] = {};
    int coef_bits[64];             // progressive: the last scan's Al a coefficient, -1 none
    Component() { std::fill(coef_bits, coef_bits + 64, -1); }
};

// zigzag index -> natural index; a corrupt run that steps past 63 lands on
// 63, as on the guard entries of libjpeg's jpeg_natural_order
constexpr int kNatural(int k) { return k < 64 ? kZigzag[k] : 63; }

class Decoder {
  public:
    Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

    void header();
    void decode(uint8_t* out);
    int height = 0, width = 0, orientation = 1;

  private:
    const uint8_t* d_;
    size_t n_;
    size_t pos_ = 0;
    uint16_t quant_[4][64] = {};
    bool quant_defined_[4] = {};
    Huffman dc_[4], ac_[4];
    std::vector<Component> comps_;
    int max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
    int restart_interval_ = 0;
    bool saw_jfif_ = false, saw_adobe_ = false;
    int adobe_transform_ = 0;
    bool frame_seen_ = false, any_scan_ = false, exif_seen_ = false;
    bool progressive_ = false;
    int eobrun_ = 0;               // progressive AC scans: blocks left in an end-of-band run

    // the entropy-coded segment's bit reader
    uint64_t bits_ = 0;
    int nbits_ = 0;
    bool hit_marker_ = false;

    uint8_t byte() {
        if (pos_ >= n_) throw Error{"truncated file"};
        return d_[pos_++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }
    int next_marker();
    void read_dqt(int len);
    void read_dht(int len);
    void read_sof(int len);
    void read_app(int marker, int len);
    void read_scan(int len);
    void parse_exif(const uint8_t* p, size_t len);

    void fill();
    int get_bits(int k);
    int decode_huff(const Huffman& h);
    void decode_block(Component& c, int16_t* blk);
    void dc_first(Component& c, int16_t* blk, int al);
    void dc_refine(int16_t* blk, int al);
    void ac_first(Component& c, int16_t* blk, int ss, int se, int al);
    void ac_refine(Component& c, int16_t* blk, int ss, int se, int al);
    void check_complete() const;
    void restart();
    void idct_plane(const Component& c, std::vector<uint8_t>& plane) const;
};

void build_huffman(Huffman& h, const uint8_t counts[16], const uint8_t* symbols, int total) {
    std::memcpy(h.values, symbols, total);
    std::memset(h.fast, 0, sizeof(h.fast));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        h.valptr[l] = k;
        h.mincode[l] = code;
        code += counts[l - 1];
        k += counts[l - 1];
        h.maxcode[l] = counts[l - 1] ? code - 1 : -1;
        if (code > (1 << l)) throw Error{"bad Huffman table"};
        code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    // lookahead of the codes of up to 9 bits
    code = 0;
    k = 0;
    for (int l = 1; l <= 9; ++l) {
        for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
            int shift = 9 - l;
            for (int j = 0; j < (1 << shift); ++j)
                h.fast[(code << shift) | j] = static_cast<uint16_t>((l << 8) | h.values[k]);
        }
        code <<= 1;
    }
    h.defined = true;
}

int Decoder::next_marker() {
    // skip to the next 0xFF, then over fill bytes
    uint8_t b = byte();
    while (b != 0xFF) b = byte();
    do {
        b = byte();
    } while (b == 0xFF);
    return b;
}

void Decoder::read_dqt(int len) {
    size_t end = pos_ + len;
    while (pos_ < end) {
        int pq_tq = byte();
        int pq = pq_tq >> 4, tq = pq_tq & 15;
        if (tq > 3 || pq > 1) throw Error{"bad quantization table"};
        for (int i = 0; i < 64; ++i)
            quant_[tq][kZigzag[i]] = static_cast<uint16_t>(pq ? u16() : byte());
        quant_defined_[tq] = true;
    }
    if (pos_ != end) throw Error{"bad DQT length"};
}

void Decoder::read_dht(int len) {
    size_t end = pos_ + len;
    while (pos_ < end) {
        int tc_th = byte();
        int tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3) throw Error{"bad Huffman table id"};
        uint8_t counts[16];
        int total = 0;
        for (int i = 0; i < 16; ++i) {
            counts[i] = byte();
            total += counts[i];
        }
        if (total > 256) throw Error{"bad Huffman table"};
        uint8_t symbols[256];
        for (int i = 0; i < total; ++i) symbols[i] = byte();
        build_huffman(tc ? ac_[th] : dc_[th], counts, symbols, total);
    }
    if (pos_ != end) throw Error{"bad DHT length"};
}

void Decoder::read_sof(int len) {
    if (frame_seen_) throw Error{"two frame headers"};
    frame_seen_ = true;
    int precision = byte();
    height = u16();
    width = u16();
    int nc = byte();
    if (len != 6 + 3 * nc) throw Error{"bad SOF length"};
    if (precision != 8)
        throw Error{"sample precision " + std::to_string(precision) +
                    " bits (only 8-bit JPEG is read)"};
    if (height == 0) throw Error{"no height in the frame header (DNL is not read)"};
    if (width == 0) throw Error{"zero width"};
    if (nc == 4) throw Error{"4 components (CMYK or YCCK)"};
    if (nc != 1 && nc != 3) throw Error{std::to_string(nc) + " components"};
    comps_.resize(nc);
    for (auto& c : comps_) {
        c.id = byte();
        int hv = byte();
        c.h = hv >> 4;
        c.v = hv & 15;
        c.tq = byte();
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
            throw Error{"bad component sampling"};
        max_h_ = std::max(max_h_, c.h);
        max_v_ = std::max(max_v_, c.v);
    }
    mcus_x_ = (width + 8 * max_h_ - 1) / (8 * max_h_);
    mcus_y_ = (height + 8 * max_v_ - 1) / (8 * max_v_);
    for (auto& c : comps_) {
        c.bw = mcus_x_ * c.h;
        c.bh = mcus_y_ * c.v;
        c.dw = (width * c.h + max_h_ - 1) / max_h_;
        c.dh = (height * c.v + max_v_ - 1) / max_v_;
        c.width_in_blocks = (c.dw + 7) / 8;
        c.height_in_blocks = (c.dh + 7) / 8;
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
}

void Decoder::parse_exif(const uint8_t* p, size_t len) {
    // "Exif\0\0", then a TIFF header and IFD0; the orientation is tag 0x0112
    if (len < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = p + 6;
    size_t tl = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto rd16 = [&](size_t o) -> uint32_t {
        return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](size_t o) -> uint32_t {
        return le ? (t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) | (uint32_t(t[o + 3]) << 24))
                  : ((uint32_t(t[o]) << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) | t[o + 3]);
    };
    if (rd16(2) != 42) return;
    size_t ifd = rd32(4);
    if (ifd + 2 > tl) return;
    size_t count = rd16(ifd);
    for (size_t i = 0; i < count; ++i) {
        size_t e = ifd + 2 + 12 * i;
        if (e + 12 > tl) return;
        if (rd16(e) == 0x0112 && rd16(e + 2) == 3) {
            orientation = static_cast<int>(rd16(e + 8));
            return;
        }
    }
}

void Decoder::read_app(int marker, int len) {
    const uint8_t* p = d_ + pos_;
    if (pos_ + len > n_) throw Error{"truncated file"};
    if (marker == 0xE0 && len >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) saw_jfif_ = true;
    if (marker == 0xE1 && !exif_seen_) {
        if (len >= 6 && std::memcmp(p, "Exif\0\0", 6) == 0) {
            exif_seen_ = true;
            parse_exif(p, len);
        }
    }
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
        saw_adobe_ = true;
        adobe_transform_ = p[11];
    }
    pos_ += len;
}

void Decoder::header() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error{"not a JPEG (no SOI marker)"};
    pos_ = 2;
    for (;;) {
        int m = next_marker();
        if (m == 0xDA) {  // SOS: the header ends here
            pos_ -= 2;
            break;
        }
        if (m == 0xD9) throw Error{"no scan before EOI"};
        if (m >= 0xD0 && m <= 0xD7) continue;
        if (m == 0x01) continue;
        int len = u16() - 2;
        if (len < 0) throw Error{"bad segment length"};
        switch (m) {
            case 0xC0:
            case 0xC1:
                read_sof(len);
                break;
            case 0xC2:
                progressive_ = true;
                read_sof(len);
                break;
            case 0xC3:
                throw Error{"lossless JPEG (SOF3) is not read"};
            case 0xC5:
            case 0xC6:
            case 0xC7:
                throw Error{"hierarchical JPEG is not read"};
            case 0xC9:
            case 0xCA:
            case 0xCB:
            case 0xCD:
            case 0xCE:
            case 0xCF:
                throw Error{"arithmetic-coded JPEG is not read"};
            case 0xC4:
                read_dht(len);
                break;
            case 0xCC:
                throw Error{"arithmetic-coded JPEG is not read"};
            case 0xDB:
                read_dqt(len);
                break;
            case 0xDD:
                restart_interval_ = u16();
                pos_ += len - 2;
                break;
            default:
                if (m >= 0xE0 && m <= 0xEF) read_app(m, len);
                else pos_ += len;
        }
        if (pos_ > n_) throw Error{"truncated file"};
    }
    if (!frame_seen_) throw Error{"no frame header before the scan"};
    if (comps_.size() == 3) {
        bool rgb;
        if (saw_jfif_) rgb = false;
        else if (saw_adobe_) rgb = adobe_transform_ == 0;
        else rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
        if (rgb) throw Error{"RGB colour (Adobe transform 0 or R, G, B component ids)"};
    }
}

void Decoder::fill() {
    while (nbits_ <= 56) {
        uint8_t b = 0;
        if (!hit_marker_ && pos_ < n_) {
            b = d_[pos_];
            if (b == 0xFF) {
                size_t q = pos_ + 1;
                while (q < n_ && d_[q] == 0xFF) ++q;   // fill bytes
                if (q < n_ && d_[q] == 0x00) {
                    pos_ = q + 1;
                } else {
                    hit_marker_ = true;   // a marker: feed zeros, as libjpeg does
                    pos_ = q - 1;
                    b = 0;
                }
            } else {
                ++pos_;
            }
        } else if (pos_ >= n_) {
            hit_marker_ = true;
        }
        bits_ |= static_cast<uint64_t>(b) << (56 - nbits_);
        nbits_ += 8;
    }
}

int Decoder::get_bits(int k) {
    if (k == 0) return 0;
    if (nbits_ < k) fill();
    int v = static_cast<int>(bits_ >> (64 - k));
    bits_ <<= k;
    nbits_ -= k;
    return v;
}

int Decoder::decode_huff(const Huffman& h) {
    if (nbits_ < 16) fill();
    uint16_t f = h.fast[bits_ >> (64 - 9)];
    if (f) {
        int l = f >> 8;
        bits_ <<= l;
        nbits_ -= l;
        return f & 0xFF;
    }
    int code = static_cast<int>(bits_ >> (64 - 9));
    int l = 9;
    while (l < 16) {
        ++l;
        code = static_cast<int>(bits_ >> (64 - l));
        if (h.maxcode[l] >= 0 && code <= h.maxcode[l]) break;
    }
    if (h.maxcode[l] < 0 || code > h.maxcode[l]) throw Error{"corrupt Huffman data"};
    bits_ <<= l;
    nbits_ -= l;
    return h.values[h.valptr[l] + code - h.mincode[l]];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

void Decoder::decode_block(Component& c, int16_t* blk) {
    const Huffman& dc = dc_[c.dc_table];
    const Huffman& ac = ac_[c.ac_table];
    int s = decode_huff(dc);
    if (s > 16) throw Error{"corrupt DC coefficient"};
    int diff = s ? extend(get_bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
        int rs = decode_huff(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) throw Error{"corrupt AC coefficients"};
            blk[kZigzag[k]] = static_cast<int16_t>(extend(get_bits(s), s));
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

// jdphuff.c decode_mcu_DC_first: the DC difference, scaled by 2^Al
void Decoder::dc_first(Component& c, int16_t* blk, int al) {
    int s = decode_huff(dc_[c.dc_table]);
    if (s > 16) throw Error{"corrupt DC coefficient"};
    int diff = s ? extend(get_bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
}

// jdphuff.c decode_mcu_DC_refine: one more bit of the DC coefficient
void Decoder::dc_refine(int16_t* blk, int al) {
    if (get_bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
}

// jdphuff.c decode_mcu_AC_first: the band Ss..Se, scaled by 2^Al, or one
// block of an end-of-band run
void Decoder::ac_first(Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
        --eobrun_;
        return;
    }
    const Huffman& ac = ac_[c.ac_table];
    for (int k = ss; k <= se; ++k) {
        int rs = decode_huff(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            int v = extend(get_bits(s), s);
            blk[kNatural(k)] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
        } else if (r == 15) {
            k += 15;
        } else {
            eobrun_ = 1 << r;
            if (r) eobrun_ += get_bits(r);
            --eobrun_;
            break;
        }
    }
}

// jdphuff.c decode_mcu_AC_refine: newly nonzero coefficients of +-2^Al and
// a correction bit for every coefficient already nonzero that the band's
// zero runs and end-of-band run pass over
void Decoder::ac_refine(Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -p1;
    auto correct = [&](int16_t* coef) {
        if (get_bits(1) && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun_ == 0) {
        const Huffman& ac = ac_[c.ac_table];
        for (; k <= se; ++k) {
            int rs = decode_huff(ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                s = get_bits(1) ? p1 : m1;
            } else if (r != 15) {
                eobrun_ = 1 << r;
                if (r) eobrun_ += get_bits(r);
                break;
            }
            // pass over the nonzero coefficients (correcting them) and r zero ones
            do {
                int16_t* coef = &blk[kNatural(k)];
                if (*coef != 0) {
                    correct(coef);
                } else if (--r < 0) {
                    break;
                }
                ++k;
            } while (k <= se);
            if (s) blk[kNatural(k)] = static_cast<int16_t>(s);
        }
    }
    if (eobrun_ > 0) {
        for (; k <= se; ++k) {
            int16_t* coef = &blk[kNatural(k)];
            if (*coef != 0) correct(coef);
        }
        --eobrun_;
    }
}

// jdcoefct.c smoothing_ok at the end of the input: libjpeg-turbo smooths
// the blocks (decompress_smooth_data) where a component's DC is known and
// one of its coefficients 1-9 is short of full precision; the port refuses
void Decoder::check_complete() const {
    if (!progressive_) return;
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
        const Component& c = comps_[ci];
        if (!c.latched) return;
        for (int k = 0; k <= 9; ++k)
            if (c.quant[kZigzag[k]] == 0) return;
        if (c.coef_bits[0] < 0) return;
        for (int k = 1; k <= 9; ++k)
            if (c.coef_bits[k] != 0)
                throw Error{"incomplete progressive JPEG: its scans leave coefficient " +
                            std::to_string(k) + " of component " + std::to_string(ci) +
                            (c.coef_bits[k] < 0 ? " unsent"
                                                : " short by " + std::to_string(c.coef_bits[k]) +
                                                      " bits") +
                            ", and libjpeg's block smoothing of such frames is not read"};
    }
}

void Decoder::restart() {
    // discard the buffered bits, then read the RSTn marker
    bits_ = 0;
    nbits_ = 0;
    hit_marker_ = false;
    while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
    while (pos_ + 1 < n_ && d_[pos_ + 1] == 0xFF) ++pos_;
    if (pos_ + 1 < n_ && d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) pos_ += 2;
    for (auto& c : comps_) c.dc_pred = 0;
    eobrun_ = 0;
}

void Decoder::read_scan(int len) {
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) throw Error{"bad SOS"};
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
        int id = byte(), tables = byte();
        Component* found = nullptr;
        for (auto& c : comps_)
            if (c.id == id) found = &c;
        if (!found) throw Error{"scan names an unknown component"};
        found->dc_table = tables >> 4;
        found->ac_table = tables & 15;
        if (found->dc_table > 3 || found->ac_table > 3) throw Error{"bad Huffman table id"};
        sc.push_back(found);
    }
    int ss = byte(), se = byte(), ahl = byte();
    int ah = ahl >> 4, al = ahl & 15;
    // the tables this scan decodes with (jdhuff.c, jdphuff.c start_pass)
    bool need_dc, need_ac;
    if (!progressive_) {
        if (ss != 0 || se != 63 || ahl != 0)
            throw Error{"progressive scan parameters in a sequential frame"};
        need_dc = need_ac = true;
    } else {
        bool dc_band = ss == 0;
        bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
        if (ah != 0 && al != ah - 1) bad = true;
        if (al > 13) bad = true;
        if (bad) throw Error{"bad progressive scan parameters"};
        need_dc = dc_band && ah == 0;
        need_ac = !dc_band;
        for (auto* c : sc)
            for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
    for (auto* c : sc) {
        if ((need_dc && !dc_[c->dc_table].defined) || (need_ac && !ac_[c->ac_table].defined))
            throw Error{"scan uses an undefined Huffman table"};
        if (!c->latched) {
            if (!quant_defined_[c->tq]) throw Error{"undefined quantization table"};
            std::memcpy(c->quant, quant_[c->tq], sizeof(c->quant));
            c->latched = true;
        }
    }
    for (auto* c : sc) c->dc_pred = 0;
    eobrun_ = 0;
    bits_ = 0;
    nbits_ = 0;
    hit_marker_ = false;
    auto block = [&](Component& c, int16_t* blk) {
        if (!progressive_) decode_block(c, blk);
        else if (ss == 0 && ah == 0) dc_first(c, blk, al);
        else if (ss == 0) dc_refine(blk, al);
        else if (ah == 0) ac_first(c, blk, ss, se, al);
        else ac_refine(c, blk, ss, se, al);
    };

    int todo = restart_interval_;
    auto mcu_start = [&]() {
        if (restart_interval_) {
            if (todo == 0) {
                restart();
                todo = restart_interval_;
            }
            --todo;
        }
    };
    if (ns == 1) {
        // non-interleaved: the component's own blocks in raster order
        Component& c = *sc[0];
        for (int by = 0; by < c.height_in_blocks; ++by)
            for (int bx = 0; bx < c.width_in_blocks; ++bx) {
                mcu_start();
                block(c, &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64]);
            }
    } else {
        for (int my = 0; my < mcus_y_; ++my)
            for (int mx = 0; mx < mcus_x_; ++mx) {
                mcu_start();
                for (auto* cp : sc) {
                    Component& c = *cp;
                    for (int v = 0; v < c.v; ++v)
                        for (int h = 0; h < c.h; ++h) {
                            size_t bx = static_cast<size_t>(mx) * c.h + h;
                            size_t by = static_cast<size_t>(my) * c.v + v;
                            block(c, &c.coef[(by * c.bw + bx) * 64]);
                        }
                }
            }
    }
    // the scan's data ends at the next marker
    while (pos_ < n_ && !(d_[pos_] == 0xFF && pos_ + 1 < n_ && d_[pos_ + 1] != 0x00 &&
                          !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7)))
        ++pos_;
    any_scan_ = true;
}

// jidctint.c's ISLOW constants
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// the post-IDCT range limit: value v (centred on 0) -> table[(v) & 1023]
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) {
            if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
            else if (i < 512) t[i] = 255;
            else if (i < 896) t[i] = 0;
            else t[i] = static_cast<uint8_t>(i - 896);
        }
    }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
            ip[48] == 0 && ip[56] == 0) {
            int dcval = static_cast<int>((int64_t(ip[0]) * qp[0]) * (1 << PASS1_BITS));
            for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
            continue;
        }
        int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = int64_t(ip[0]) * qp[0];
        z3 = int64_t(ip[32]) * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                tmp12 = tmp1 - tmp2;
        tmp0 = int64_t(ip[56]) * qp[56];
        tmp1 = int64_t(ip[40]) * qp[40];
        tmp2 = int64_t(ip[24]) * qp[24];
        tmp3 = int64_t(ip[8]) * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS - PASS1_BITS;
        wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
        wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
        wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
        wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
        wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
        wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
        wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
        wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
    }
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + static_cast<size_t>(r) * stride;
        if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
            wp[7] == 0) {
            uint8_t v = kRange.t[descale(wp[0], PASS1_BITS + 3) & 1023];
            std::memset(op, v, 8);
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        op[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
        op[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
        op[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
        op[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
        op[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
        op[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
        op[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
        op[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
    }
}

void Decoder::idct_plane(const Component& c, std::vector<uint8_t>& plane) const {
    size_t stride = static_cast<size_t>(c.bw) * 8;
    plane.assign(stride * c.bh * 8, 0);
    // the blocks libjpeg reconstructs: those inside the component's own width and height
    for (int by = 0; by < c.height_in_blocks; ++by)
        for (int bx = 0; bx < c.width_in_blocks; ++bx)
            idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                       &plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                       static_cast<int>(stride));
}

// One component upsampled to full resolution (`width` x `height`), as
// jdsample.c does by default: fancy (triangle) filters for 2h1v, 1h2v and
// 2h2v (2h only where the component is wider than 2 samples), sample
// replication otherwise; rows above the first and below the last real row
// repeat them (jdmainct.c's context rows).
std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane, const Component& c, int max_h,
                              int max_v, int width, int height) {
    size_t stride = static_cast<size_t>(c.bw) * 8;
    int fh = max_h / c.h, fv = max_v / c.v;
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    auto row = [&](int r) -> const uint8_t* {
        if (r < 0) r = 0;
        if (r > c.dh - 1) r = c.dh - 1;
        return &plane[static_cast<size_t>(r) * stride];
    };
    if (fh * c.h != max_h || fv * c.v != max_v) throw Error{"fractional sampling factors"};
    std::vector<uint8_t> line(static_cast<size_t>(c.dw) * fh + 8);
    for (int y = 0; y < height; ++y) {
        uint8_t* op = &out[static_cast<size_t>(y) * width];
        const bool fancy_h2 = fh == 2 && c.dw > 2;
        if (fh == 1 && fv == 1) {
            std::memcpy(op, row(y), width);
        } else if (fv == 2 && (fh == 1 || fancy_h2)) {
            int inrow = y / 2;
            bool below = y & 1;
            const uint8_t* in0 = row(inrow);
            const uint8_t* in1 = row(below ? inrow + 1 : inrow - 1);
            if (fh == 1) {
                int bias = below ? 2 : 1;
                for (int x = 0; x < width; ++x) op[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
            } else {
                uint8_t* lp = line.data();
                int thiscolsum = in0[0] * 3 + in1[0];
                int nextcolsum = in0[1] * 3 + in1[1];
                *lp++ = static_cast<uint8_t>((thiscolsum * 4 + 8) >> 4);
                *lp++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
                int lastcolsum = thiscolsum;
                thiscolsum = nextcolsum;
                for (int i = 2; i < c.dw; ++i) {
                    nextcolsum = in0[i] * 3 + in1[i];
                    *lp++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
                    *lp++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
                    lastcolsum = thiscolsum;
                    thiscolsum = nextcolsum;
                }
                *lp++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
                *lp++ = static_cast<uint8_t>((thiscolsum * 4 + 7) >> 4);
                std::memcpy(op, line.data(), width);
            }
        } else if (fv == 1 && fancy_h2) {
            const uint8_t* in = row(y);
            uint8_t* lp = line.data();
            int v = in[0];
            *lp++ = static_cast<uint8_t>(v);
            *lp++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
            for (int i = 1; i < c.dw - 1; ++i) {
                v = in[i] * 3;
                *lp++ = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
                *lp++ = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
            }
            v = in[c.dw - 1];
            *lp++ = static_cast<uint8_t>((v * 3 + in[c.dw - 2] + 1) >> 2);
            *lp++ = static_cast<uint8_t>(v);
            std::memcpy(op, line.data(), width);
        } else {
            // replication (jdsample.c's h2v1/h2v2/int upsample)
            const uint8_t* in = &plane[static_cast<size_t>(y / fv) * stride];
            for (int x = 0; x < width; ++x) op[x] = in[x / fh];
        }
    }
    return out;
}

// jdcolor.c's fixed-point YCbCr -> RGB tables
struct ColorTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    ColorTables() {
        constexpr int SCALEBITS = 16;
        constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
        auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SCALEBITS) + 0.5); };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
    }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void Decoder::decode(uint8_t* out) {
    for (;;) {
        int m = next_marker();
        if (m == 0xD9) break;
        if (m >= 0xD0 && m <= 0xD7) continue;
        if (m == 0x01) continue;
        int len = u16() - 2;
        if (len < 0) throw Error{"bad segment length"};
        if (m == 0xDA) {
            read_scan(len);
            if (pos_ >= n_) break;
            continue;
        }
        switch (m) {
            case 0xC4: read_dht(len); break;
            case 0xDB: read_dqt(len); break;
            case 0xDD:
                restart_interval_ = u16();
                pos_ += len - 2;
                break;
            case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
            case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
                throw Error{"a second frame header"};
            default:
                pos_ += len;
        }
        if (pos_ > n_) throw Error{"truncated file"};
    }
    if (!any_scan_) throw Error{"no scan"};
    check_complete();
    std::vector<std::vector<uint8_t>> full;
    for (auto& c : comps_) {
        std::vector<uint8_t> plane;
        idct_plane(c, plane);
        full.push_back(upsample(plane, c, max_h_, max_v_, width, height));
    }
    size_t npix = static_cast<size_t>(width) * height;
    if (comps_.size() == 1) {
        const uint8_t* y = full[0].data();
        for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
        return;
    }
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
    for (size_t i = 0; i < npix; ++i) {
        int y = Y[i], cb = Cb[i], cr = Cr[i];
        out[3 * i + 2] = clamp255(y + kColor.cr_r[cr]);
        out[3 * i + 1] = clamp255(y + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
        out[3 * i + 0] = clamp255(y + kColor.cb_b[cb]);
    }
}

void set_error(char* err, int errlen, const std::string& what) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", what.c_str());
}

}  // namespace

extern "C" {

int popnet_jpeg_info(const uint8_t* data, long long n, int* height, int* width,
                     int* orientation, char* err, int errlen) {
    try {
        Decoder dec(data, static_cast<size_t>(n));
        dec.header();
        *height = dec.height;
        *width = dec.width;
        *orientation = dec.orientation;
        return 0;
    } catch (const Error& e) {
        set_error(err, errlen, e.what);
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
    }
    return -1;
}

int popnet_jpeg_decode(const uint8_t* data, long long n, uint8_t* out, char* err, int errlen) {
    try {
        Decoder dec(data, static_cast<size_t>(n));
        dec.header();
        dec.decode(out);
        return 0;
    } catch (const Error& e) {
        set_error(err, errlen, e.what);
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
    }
    return -1;
}

}  // extern "C"
