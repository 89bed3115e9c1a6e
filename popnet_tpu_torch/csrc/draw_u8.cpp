// cv2's line and circle rasterizer on an 8-bit, 3-channel image, in place:
// OpenCV 5.0.0's drawing.cpp for LINE_8 and shift 0, step for step.
//   - line, thickness 1: the 8-connected Bresenham walk of LineIterator
//     (left to right) over the line clipped to the image;
//   - line, thickness > 1: clipped to the image grown by the thickness on
//     every side, then ThickLine, a quad in 16-bit fixed point
//     (XY_SHIFT) filled by FillConvexPoly (its outline drawn by Line2, then
//     its scanlines), and a filled integer Circle of radius
//     (thickness * 2^15 + 2^15) >> 16 at each end;
//   - circle, thickness 1: the midpoint Circle; thickness < 0: the filled
//     Circle; thickness > 1: EllipseEx, the polygon of ellipse2Poly (cv2's
//     angle step by radius, its table of sines, cvRound) drawn as an open
//     PolyLine of thick segments.
// Every pixel a call sets takes the same colour, so the order of cv2's
// writes does not matter, only the set of pixels. Plain C interface for
// ctypes.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

const int XY_SHIFT = 16;
const int64_t XY_ONE = (int64_t)1 << XY_SHIFT;

struct Pt {
  int64_t x, y;
  bool operator!=(const Pt& o) const { return x != o.x || y != o.y; }
};

struct Image {
  uint8_t* data;
  int h, w;
  uint8_t c[3];

  void put(int64_t x, int64_t y) {
    uint8_t* p = data + ((size_t)y * w + (size_t)x) * 3;
    p[0] = c[0]; p[1] = c[1]; p[2] = c[2];
  }
  void put_clipped(int64_t x, int64_t y) {
    if (0 <= x && x < w && 0 <= y && y < h) put(x, y);
  }
  void hline(int64_t y, int64_t x1, int64_t x2) {
    for (int64_t x = x1; x <= x2; ++x) put(x, y);
  }
};

// cvRound: round half to even
inline int64_t cv_round(double v) { return (int64_t)std::nearbyint(v); }

// drawing.cpp clipLine(Size2l, Point2l&, Point2l&)
bool clip_line(int64_t width, int64_t height, Pt& p1, Pt& p2) {
  if (width <= 0 || height <= 0) return false;
  int64_t right = width - 1, bottom = height - 1;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// Line: LineIterator(img, pt1, pt2, 8, leftToRight=true)
void line_int(Image& img, Pt p1, Pt p2) {
  if ((uint64_t)p1.x >= (uint64_t)img.w || (uint64_t)p2.x >= (uint64_t)img.w ||
      (uint64_t)p1.y >= (uint64_t)img.h || (uint64_t)p2.y >= (uint64_t)img.h) {
    if (!clip_line(img.w, img.h, p1, p2)) return;
  }
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  int64_t sx = 1, sy = 1;
  if (dx < 0) {   // left to right: start from pt2
    dx = -dx;
    dy = -dy;
    p1 = p2;
  }
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy), plus_delta = dx + dx, minus_delta = -(dy + dy);
  // the major axis always steps; the minor one where err was negative
  int64_t count = dx + 1, x = p1.x, y = p1.y;
  for (int64_t i = 0; i < count; ++i) {
    img.put(x, y);
    bool minor = err < 0;
    err += minus_delta + (minor ? plus_delta : 0);
    if (vert) {
      y += sy;              // major step
      if (minor) x += sx;
    } else {
      x += sx;
      if (minor) y += sy;
    }
  }
}

// Line2: a line between 16-bit fixed-point ends (FillConvexPoly's outline)
void line2(Image& img, Pt p1, Pt p2) {
  if (!clip_line((int64_t)img.w << XY_SHIFT, (int64_t)img.h << XY_SHIFT, p1, p2)) return;
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
  int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
  int64_t x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    if (j) std::swap(p1, p2);
    x_step = XY_ONE;
    y_step = (dy << XY_SHIFT) / (ax | 1);
    ecount = (int)((p2.x - p1.x) >> XY_SHIFT);
  } else {
    dx = (dx ^ i) - i;
    if (i) std::swap(p1, p2);
    x_step = (dx << XY_SHIFT) / (ay | 1);
    y_step = XY_ONE;
    ecount = (int)((p2.y - p1.y) >> XY_SHIFT);
  }
  p1.x += XY_ONE >> 1;
  p1.y += XY_ONE >> 1;
  img.put_clipped((int)((p2.x + (XY_ONE >> 1)) >> XY_SHIFT),
                  (int)((p2.y + (XY_ONE >> 1)) >> XY_SHIFT));
  if (ax > ay) {
    p1.x >>= XY_SHIFT;
    while (ecount >= 0) {
      img.put_clipped((int)p1.x, (int)(p1.y >> XY_SHIFT));
      p1.x++;
      p1.y += y_step;
      ecount--;
    }
  } else {
    p1.y >>= XY_SHIFT;
    while (ecount >= 0) {
      img.put_clipped((int)(p1.x >> XY_SHIFT), (int)p1.y);
      p1.x += x_step;
      p1.y++;
      ecount--;
    }
  }
}

// FillConvexPoly for LINE_8, the vertices in 16-bit fixed point
void fill_convex_poly(Image& img, const Pt* v, int npts) {
  struct Edge {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];
  const int64_t delta = XY_ONE >> 1;
  int imin = 0, edges = npts;
  Pt p0 = v[npts - 1];
  int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
  for (int i = 0; i < npts; ++i) {
    Pt p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    line2(img, p0, p);   // the outline
    p0 = p;
  }
  xmin = (xmin + delta) >> XY_SHIFT;
  xmax = (xmax + delta) >> XY_SHIFT;
  ymin = (ymin + delta) >> XY_SHIFT;
  ymax = (ymax + delta) >> XY_SHIFT;
  if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= img.w || (int)ymin >= img.h)
    return;
  ymax = std::min<int64_t>(ymax, img.h - 1);
  edge[0].idx = edge[1].idx = imin;
  int y = (int)ymin;
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          int ty = (int)((v[idx].y + delta) >> XY_SHIFT);
          if (ty > y) {
            int64_t xs = v[idx0].x, xe = v[idx].x;
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + ((int64_t)ty - y)) / (2 * ((int64_t)ty - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) {
        left = 1;
        right = 0;
      }
      int xx1 = (int)((edge[left].x + delta) >> XY_SHIFT);
      int xx2 = (int)((edge[right].x + delta) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < img.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= img.w) xx2 = img.w - 1;
        img.hline(y, xx1, xx2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= (int)ymax);
}

// Circle: the midpoint circle, its outline or (fill) its spans
void circle_int(Image& img, int64_t cx, int64_t cy, int64_t radius, bool fill) {
  const int64_t W = img.w, H = img.h;
  int64_t err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  bool inside = cx >= radius && cx < W - radius && cy >= radius && cy < H - radius;
  auto row = [&](int64_t y, int64_t xa, int64_t xb) {   // one row's two points or its span
    if (inside) {
      if (fill) img.hline(y, xa, xb); else { img.put(xa, y); img.put(xb, y); }
      return;
    }
    if ((uint64_t)y >= (uint64_t)H) return;
    if (fill) {
      img.hline(y, xa, xb);
    } else {
      if (xa >= 0) img.put(xa, y);
      if (xb < W) img.put(xb, y);
    }
  };
  while (dx >= dy) {
    int64_t y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int64_t x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      row(y11, x11, x12);
      row(y12, x11, x12);
      row(y21, x21, x22);
      row(y22, x21, x22);
    } else if (x11 < W && x12 >= 0 && y21 < H && y22 >= 0) {
      if (fill) {
        x11 = std::max<int64_t>(x11, 0);
        x12 = std::min<int64_t>(x12, W - 1);
      }
      row(y11, x11, x12);
      row(y12, x11, x12);
      if (x21 < W && x22 >= 0) {
        if (fill) {
          x21 = std::max<int64_t>(x21, 0);
          x22 = std::min<int64_t>(x22, W - 1);
        }
        row(y21, x21, x22);
        row(y22, x21, x22);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    int64_t mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// ThickLine for LINE_8; flags: bit 0 caps p0, bit 1 caps p1
void thick_line(Image& img, Pt p0, Pt p1, int thickness, int flags, int shift) {
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  p1.x <<= XY_SHIFT - shift;
  p1.y <<= XY_SHIFT - shift;
  if (thickness <= 1) {   // the ends rounded to pixels, then Line
    p0.x = (p0.x + (XY_ONE >> 1)) >> XY_SHIFT;
    p0.y = (p0.y + (XY_ONE >> 1)) >> XY_SHIFT;
    p1.x = (p1.x + (XY_ONE >> 1)) >> XY_SHIFT;
    p1.y = (p1.y + (XY_ONE >> 1)) >> XY_SHIFT;
    line_int(img, p0, p1);
    return;
  }
  const double INV_XY_ONE = 1. / XY_ONE;
  double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
  double r = dx * dx + dy * dy;
  int odd = thickness & 1;
  thickness <<= XY_SHIFT - 1;
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (thickness + odd * XY_ONE * 0.5) / std::sqrt(r);
    Pt dp{cv_round(dy * r), cv_round(dx * r)};
    Pt pt[4] = {{p0.x + dp.x, p0.y + dp.y}, {p0.x - dp.x, p0.y - dp.y},
                {p1.x - dp.x, p1.y - dp.y}, {p1.x + dp.x, p1.y + dp.y}};
    fill_convex_poly(img, pt, 4);
  }
  for (int i = 0; i < 2; ++i) {
    if (flags & (i + 1)) {
      int64_t cx = (p0.x + (XY_ONE >> 1)) >> XY_SHIFT, cy = (p0.y + (XY_ONE >> 1)) >> XY_SHIFT;
      circle_int(img, cx, cy, (thickness + (XY_ONE >> 1)) >> XY_SHIFT, true);
    }
    p0 = p1;
  }
}

// drawing.cpp SinTable: sin(k degrees), k = 0..450, as the float table cv2
// holds (the sines rounded to 7 decimals)
float sin_table(int k) {
  static float table[451];
  static bool ready = false;
  if (!ready) {
    for (int i = 0; i <= 450; ++i)
      table[i] = (float)(std::round(std::sin(i * M_PI / 180.0) * 1e7) / 1e7);
    ready = true;
  }
  return table[k];
}

// EllipseEx of a circle (axes r, r; angle 0; arc 0..360) at thickness >= 0,
// centre and radius in 16-bit fixed point
void ellipse_circle(Image& img, Pt center, int64_t radius, int thickness) {
  int delta = (int)((radius + (XY_ONE >> 1)) >> XY_SHIFT);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  // ellipse2Poly(center, (r, r), 0, 0, 360, delta): alpha = cos 0 = 1, beta = 0
  const float alpha = sin_table(450), beta = sin_table(0);
  std::vector<Pt> v;
  Pt prev{(int64_t)-1, (int64_t)-1};   // cv2's 0xFFFFFFFFFFFFFFFF
  for (int i = 0; i < 360 + delta; i += delta) {
    int angle = i > 360 ? 360 : i;
    double x = (double)radius * sin_table(450 - angle);
    double y = (double)radius * sin_table(angle);
    double px = (double)center.x + x * alpha - y * beta;
    double py = (double)center.y + x * beta + y * alpha;
    Pt pt;
    pt.x = cv_round(px / XY_ONE) << XY_SHIFT;
    pt.y = cv_round(py / XY_ONE) << XY_SHIFT;
    pt.x += cv_round(px - pt.x);
    pt.y += cv_round(py - pt.y);
    if (pt != prev) {
      v.push_back(pt);
      prev = pt;
    }
  }
  if (v.size() == 1) v.assign(2, center);
  // PolyLine, open: the first segment caps both ends, the others their end
  int flags = 3;
  Pt p0 = v[0];
  for (size_t i = 1; i < v.size(); ++i) {
    thick_line(img, p0, v[i], thickness, flags, XY_SHIFT);
    p0 = v[i];
    flags = 2;
  }
}

}  // namespace

extern "C" {

// img: h x w x 3 uint8, rows contiguous; color: 3 bytes. Returns 0.
int popnet_draw_line(uint8_t* img, int h, int w, int x1, int y1, int x2, int y2,
                     const uint8_t* color, int thickness) {
  Image im{img, h, w, {color[0], color[1], color[2]}};
  Pt p1{x1, y1}, p2{x2, y2};
  if (thickness > 1) {
    // a thick line is first clipped to the image grown by the thickness on
    // every side (clipLine(Rect)); nothing is drawn if none of it is left
    const int64_t t = thickness;
    p1 = Pt{p1.x + t, p1.y + t};
    p2 = Pt{p2.x + t, p2.y + t};
    if (!clip_line((int64_t)w + 2 * t, (int64_t)h + 2 * t, p1, p2)) return 0;
    p1 = Pt{p1.x - t, p1.y - t};
    p2 = Pt{p2.x - t, p2.y - t};
  }
  thick_line(im, p1, p2, thickness, 3, 0);
  return 0;
}

int popnet_draw_circle(uint8_t* img, int h, int w, int cx, int cy, int radius,
                       const uint8_t* color, int thickness) {
  Image im{img, h, w, {color[0], color[1], color[2]}};
  if (thickness > 1)
    ellipse_circle(im, Pt{(int64_t)cx << XY_SHIFT, (int64_t)cy << XY_SHIFT},
                   (int64_t)radius << XY_SHIFT, thickness);
  else
    circle_int(im, cx, cy, radius, thickness < 0);
  return 0;
}

}  // extern "C"
