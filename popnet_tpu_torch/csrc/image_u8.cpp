// cv2 5.0.0's uint8 resize (INTER_LINEAR) and affine warp (INTER_CUBIC,
// BORDER_CONSTANT) of interleaved 8-bit images on the host, in the
// arithmetic cv2 uses for them, so the results equal cv2's bit for bit
// (held against cv2 by tests/test_torch_jpeg.py).
//
// C interface (ctypes, popnet_tpu_torch/data/augment_host.py):
//   popnet_resize_linear_u8(src, h, w, cn, dst, dh, dw)
//   popnet_resize_linear_scaled_u8(src, h, w, cn, dst, dh, dw, fx, fy)
//   popnet_warp_affine_cubic_u8(src, h, w, cn, dst, dh, dw, inv, border)
// `inv` is the inverse map (dst -> src) as 6 doubles, which cv2 computes
// from the forward one in float64 before warping; `border` the constant
// the taps off the image read. Both return 0, or -1 on a bad shape.
//
// The resize is cv2's own fixed-point code: per axis the source coordinate
// (d + 0.5) * scale - 0.5 in float64 (scale = 1 / (dst / src)), rounded
// to float32, its floor the tap and its fraction the weight, as 11-bit
// fixed point (INTER_RESIZE_COEF_BITS); along x a tap off either edge
// moves onto it with weight 0, along y the weights stay and the rows are
// clipped. A horizontal pass into int32, then cv2's vector vertical pass,
// ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) rounded by 2 bits, over
// the whole row. An exact 2x downscale in both axes is cv2's INTER_AREA
// fast path: (a + b + c + d + 2) >> 2 where the 2x2 cell lies inside the
// image, and the mean of the taps that do, rounded half to even, where it
// overhangs the last row or column.
//
// The two entries differ as cv2.resize(im, (dw, dh)) and cv2.resize(im,
// None, fx=fx, fy=fy) differ: given sizes, scale = src / dst along each
// axis; given factors, the sizes are w * fx and h * fy rounded half to
// even and scale = 1 / fx, 1 / fy, so a coordinate maps by the factor and
// not by the ratio of the rounded sizes.
//
// The warp is float32, as cv2 5.0.0 computes it (found by probing cv2 with
// float32 delta images, whose warps round to the uint8 ones): the source
// coordinate x * m0 + (y * m1 + m2) (m the inverse map rounded to
// float32), the bicubic weights of its fraction (`cubic_coeffs`), each
// row of 4 taps a chain of fused multiply-adds, then the 4 rows likewise,
// rounded half to even and saturated; a tap off the image reads `border`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int RESIZE_BITS = 11, RESIZE_SCALE = 1 << RESIZE_BITS;

inline uint8_t sat_u8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int16_t sat_i16(int v) {
    return static_cast<int16_t>(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}
inline int round_f(float v) { return static_cast<int>(std::nearbyint(v)); }

// cv2's per-axis taps and 11-bit weights (resize.cpp, INTER_LINEAR): along
// x a tap off either edge moves onto it with weight 0 (`clamp`); along y
// the weights stay and the rows are clipped to the image
void linear_axis(int src, int dst, double scale, bool clamp, std::vector<int>& ofs,
                 std::vector<int16_t>& w) {
    ofs.resize(dst);
    w.resize(2 * dst);
    for (int d = 0; d < dst; ++d) {
        float f = static_cast<float>((d + 0.5) * scale - 0.5);
        int s = static_cast<int>(std::floor(f));
        f -= s;
        if (clamp && s < 0) {
            f = 0.f;
            s = 0;
        }
        if (clamp && s >= src - 1) {
            f = 0.f;
            s = src - 1;
        }
        ofs[d] = s;
        w[2 * d] = sat_i16(round_f((1.f - f) * RESIZE_SCALE));
        w[2 * d + 1] = sat_i16(round_f(f * RESIZE_SCALE));
    }
}

// cv2's bicubic weights (A = -0.75) of a fraction t in float32, in the
// form its warp evaluates them: the outer taps as A * t * (t - 1)^2 and
// A * t^2 * (1 - t), the inner one as a fused (A + 2) t^3 - (A + 3) t^2 + 1,
// the last so that the four sum to 1
__attribute__((always_inline)) inline void cubic_coeffs(float t, float* c) {
    const float A = -0.75f;
    c[0] = A * (t * ((t - 1.f) * (t - 1.f)));
    c[1] = std::fma(std::fma(A + 2.f, t, -(A + 3.f)), t * t, 1.f);
    c[3] = A * ((t * t) * (1.f - t));
    c[2] = ((1.f - c[0]) - c[1]) - c[3];
}

__attribute__((always_inline)) inline int warp_cubic(const uint8_t* src, int h, int w, int cn,
                                                     uint8_t* dst, int dh, int dw, const double* inv,
                                                     int border) {
    if (h < 1 || w < 1 || dh < 1 || dw < 1 || cn < 1 || cn > 4) return -1;
    float m[6];
    for (int i = 0; i < 6; ++i) m[i] = static_cast<float>(inv[i]);
    const float bv = static_cast<float>(border);
    const size_t sstep = static_cast<size_t>(w) * cn;
    for (int y = 0; y < dh; ++y) {
        uint8_t* d = dst + static_cast<size_t>(y) * dw * cn;
        const float fy = static_cast<float>(y);
        for (int x = 0; x < dw; ++x, d += cn) {
            const float fxx = static_cast<float>(x);
            float sx = fxx * m[0] + (fy * m[1] + m[2]);
            float sy = fxx * m[3] + (fy * m[4] + m[5]);
            float flx = std::floor(sx), fly = std::floor(sy);
            float cx[4], cy[4];
            cubic_coeffs(sx - flx, cx);
            cubic_coeffs(sy - fly, cy);
            // the top-left tap; far off the image every tap reads the border
            long long ix = static_cast<long long>(std::max(-16.f, std::min(flx, w + 16.f))) - 1;
            long long iy = static_cast<long long>(std::max(-16.f, std::min(fly, h + 16.f))) - 1;
            const bool inside = ix >= 0 && ix + 3 < w && iy >= 0 && iy + 3 < h;
            for (int k = 0; k < cn; ++k) {
                float rows[4];
                for (int r = 0; r < 4; ++r) {
                    float p[4];
                    if (inside) {
                        const uint8_t* S = src + (iy + r) * sstep + ix * cn + k;
                        for (int c = 0; c < 4; ++c) p[c] = static_cast<float>(S[c * cn]);
                    } else {
                        long long yy = iy + r;
                        for (int c = 0; c < 4; ++c) {
                            long long xx = ix + c;
                            p[c] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                                       ? static_cast<float>(src[yy * sstep + xx * cn + k]) : bv;
                        }
                    }
                    rows[r] = std::fma(p[3], cx[3], std::fma(p[2], cx[2], std::fma(p[1], cx[1], p[0] * cx[0])));
                }
                float v = std::fma(rows[3], cy[3], std::fma(rows[2], cy[2], std::fma(rows[1], cy[1], rows[0] * cy[0])));
                d[k] = sat_u8(round_f(v));
            }
        }
    }
    return 0;
}

// the same code with hardware fused multiply-adds where the CPU has them
// (std::fma is exact either way; without the instruction it is a slow
// library call)
__attribute__((target("fma"))) int warp_cubic_fma(const uint8_t* src, int h, int w, int cn,
                                                  uint8_t* dst, int dh, int dw, const double* inv,
                                                  int border) {
    return warp_cubic(src, h, w, cn, dst, dh, dw, inv, border);
}

int warp_cubic_plain(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int dh, int dw,
                     const double* inv, int border) {
    return warp_cubic(src, h, w, cn, dst, dh, dw, inv, border);
}

// cv2's INTER_AREA fast path of an exact 2x downscale (dw = w / 2 and dh =
// h / 2 rounded): a cell inside the image is (a + b + c + d + 2) >> 2, a
// cell that overhangs the last row or column the mean of the taps inside,
// as float32, rounded half to even.
void area_2x(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int dh, int dw) {
    const size_t sstep = static_cast<size_t>(w) * cn, dstep = static_cast<size_t>(dw) * cn;
    for (int y = 0; y < dh; ++y) {
        const int sy0 = 2 * y;
        uint8_t* d = dst + y * dstep;
        for (int x = 0; x < dw; ++x) {
            const int sx0 = 2 * x;
            for (int k = 0; k < cn; ++k) {
                if (sy0 + 2 <= h && sx0 + 2 <= w) {
                    const uint8_t* s0 = src + sy0 * sstep + sx0 * cn + k;
                    const uint8_t* s1 = s0 + sstep;
                    d[x * cn + k] = static_cast<uint8_t>((s0[0] + s0[cn] + s1[0] + s1[cn] + 2) >> 2);
                    continue;
                }
                int sum = 0, count = 0;
                for (int sy = sy0; sy < std::min(sy0 + 2, h); ++sy)
                    for (int sx = sx0; sx < std::min(sx0 + 2, w); ++sx, ++count)
                        sum += src[sy * sstep + sx * cn + k];
                d[x * cn + k] = count ? sat_u8(round_f(static_cast<float>(sum) / count)) : 0;
            }
        }
    }
}

// The linear resize with per-axis source steps sx, sy (source pixels a
// destination pixel).
int resize_linear(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int dh, int dw,
                  double sx, double sy) {
    const size_t dstep = static_cast<size_t>(dw) * cn, sstep = static_cast<size_t>(w) * cn;
    std::vector<int> xo, yo;
    std::vector<int16_t> xw, yw;
    linear_axis(w, dw, sx, true, xo, xw);
    linear_axis(h, dh, sy, false, yo, yw);
    // the horizontal pass, one int32 row per source row used
    std::vector<int32_t> rows(static_cast<size_t>(h) * dstep);
    std::vector<char> done(h, 0);
    auto hrow = [&](int y) -> const int32_t* {
        int32_t* r = &rows[static_cast<size_t>(y) * dstep];
        if (!done[y]) {
            const uint8_t* s = src + y * sstep;
            for (int x = 0; x < dw; ++x) {
                int x0 = xo[x] * cn;
                int a0 = xw[2 * x], a1 = xw[2 * x + 1];
                bool edge = xo[x] + 1 >= w;
                for (int k = 0; k < cn; ++k)
                    r[x * cn + k] = s[x0 + k] * a0 + (edge ? 0 : s[x0 + cn + k] * a1);
            }
            done[y] = 1;
        }
        return r;
    };
    const int n = static_cast<int>(dstep);
    for (int y = 0; y < dh; ++y) {
        const int32_t* S0 = hrow(std::min(std::max(yo[y], 0), h - 1));
        const int32_t* S1 = hrow(std::min(std::max(yo[y] + 1, 0), h - 1));
        int b0 = yw[2 * y], b1 = yw[2 * y + 1];
        uint8_t* d = dst + y * dstep;
        for (int x = 0; x < n; ++x) {
            int v0 = std::max(-32768, std::min(32767, S0[x] >> 4));
            int v1 = std::max(-32768, std::min(32767, S1[x] >> 4));
            int t = ((v0 * b0) >> 16) + ((v1 * b1) >> 16);
            t = std::max(-32768, std::min(32767, t));
            d[x] = sat_u8((t + 2) >> 2);
        }
    }
    return 0;
}

bool bad_shape(int h, int w, int cn, int dh, int dw) {
    return h < 1 || w < 1 || dh < 1 || dw < 1 || cn < 1 || cn > 4;
}

}  // namespace

extern "C" {

int popnet_resize_linear_u8(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int dh,
                            int dw) {
    if (bad_shape(h, w, cn, dh, dw)) return -1;
    if (dh == h && dw == w) {
        std::memcpy(dst, src, static_cast<size_t>(w) * cn * h);
        return 0;
    }
    if (w == 2 * dw && h == 2 * dh) {   // INTER_AREA's 2x2 fast path
        area_2x(src, h, w, cn, dst, dh, dw);
        return 0;
    }
    return resize_linear(src, h, w, cn, dst, dh, dw, 1.0 / (static_cast<double>(dw) / w),
                         1.0 / (static_cast<double>(dh) / h));
}

// dh, dw: the sizes the caller rounded from h * fy, w * fx (half to even).
int popnet_resize_linear_scaled_u8(const uint8_t* src, int h, int w, int cn, uint8_t* dst,
                                   int dh, int dw, double fx, double fy) {
    if (bad_shape(h, w, cn, dh, dw) || !(fx > 0) || !(fy > 0)) return -1;
    const double sx = 1.0 / fx, sy = 1.0 / fy;
    if (dh == h && dw == w && sx == 1.0 && sy == 1.0) {
        std::memcpy(dst, src, static_cast<size_t>(w) * cn * h);
        return 0;
    }
    if (sx == 2.0 && sy == 2.0) {   // cv2 takes an exact 2x as INTER_AREA's fast path
        area_2x(src, h, w, cn, dst, dh, dw);
        return 0;
    }
    return resize_linear(src, h, w, cn, dst, dh, dw, sx, sy);
}

int popnet_warp_affine_cubic_u8(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int dh,
                                int dw, const double* inv, int border) {
    if (__builtin_cpu_supports("fma")) return warp_cubic_fma(src, h, w, cn, dst, dh, dw, inv, border);
    return warp_cubic_plain(src, h, w, cn, dst, dh, dw, inv, border);
}

}  // extern "C"
