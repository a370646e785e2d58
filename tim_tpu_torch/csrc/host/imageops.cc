// Pillow's per-pixel RandAugment loops on uint8 RGB frames, on the host,
// with Pillow's arithmetic (libImaging, versions 9 to 12):
//
// - affine_u8: Image.transform(size, AFFINE, a, resample, fillcolor=fill)
//   (Geometry.c). NEAREST takes ImagingScaleAffine when a[1] == a[3] == 0
//   (double positions summed pixel by pixel), else affine_fixed (16.16
//   fixed point) when the four corners map inside +-32768, else the double
//   loop of ImagingTransformAffine. BILINEAR and BICUBIC take the generic
//   transform: pixel centres (x + 0.5, y + 0.5), a source position outside
//   [0, W) x [0, H) leaves the fill colour, taps clamped to the edge
//   columns, rows below the first tap row that fall outside the image
//   repeat the row above; BILINEAR truncates, BICUBIC (a = -1 cubic
//   convolution) clips to [0, 255] and truncates.
// - smooth_u8: Image.filter(ImageFilter.SMOOTH) (Filter.c's 3x3 kernel in
//   float32: weights 1/13 and 5/13, 0.5 added and truncated), the border
//   rows and columns copied, frames narrower or shorter than 3 copied.
//
// Each function runs over a clip of count frames of H x W x 3 bytes.
// Built with g++ into tim_tpu_torch/build/ with jpeg.cc by
// tim_tpu_torch/utils/jpeg.py; a plain C interface for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int floor_int(double v) {  // libImaging's FLOOR
  return v < 0.0 ? static_cast<int>(std::floor(v)) : static_cast<int>(v);
}

inline int coord(double v) {  // Geometry.c's COORD
  return v < 0.0 ? -1 : static_cast<int>(v);
}

inline int clamp_index(int v, int n) { return v < 0 ? 0 : (v < n ? v : n - 1); }

inline bool check_fixed(const double* a, int x, int y) {
  return std::fabs(x * a[0] + y * a[1] + a[2]) < 32768.0 &&
         std::fabs(x * a[3] + y * a[4] + a[5]) < 32768.0;
}

inline int fix16(double v) { return floor_int(v * 65536.0 + 0.5); }

inline void put(uint8_t* out, const uint8_t* in) {
  out[0] = in[0];
  out[1] = in[1];
  out[2] = in[2];
}

// NEAREST with a[1] == a[3] == 0: a column table, then one row at a time.
void scale_affine(const uint8_t* in, int H, int W, uint8_t* out, const double* a,
                  std::vector<int>& xintab) {
  xintab.assign(W, 0);
  double xo = a[2] + a[0] * 0.5, yo = a[5] + a[4] * 0.5;
  int xmin = W, xmax = 0;
  for (int x = 0; x < W; x++) {
    int xin = coord(xo);
    if (xin >= 0 && xin < W) {
      xmax = x + 1;
      if (x < xmin) xmin = x;
      xintab[x] = xin;
    }
    xo += a[0];
  }
  for (int y = 0; y < H; y++) {
    int yi = coord(yo);
    if (yi >= 0 && yi < H) {
      const uint8_t* row = in + static_cast<size_t>(yi) * W * 3;
      uint8_t* o = out + static_cast<size_t>(y) * W * 3;
      for (int x = xmin; x < xmax; x++) put(o + 3 * x, row + 3 * xintab[x]);
    }
    yo += a[4];
  }
}

void fixed_affine(const uint8_t* in, int H, int W, uint8_t* out, const double* a) {
  int a0 = fix16(a[0]), a1 = fix16(a[1]), a3 = fix16(a[3]), a4 = fix16(a[4]);
  int a2 = fix16(a[2] + a[0] * 0.5 + a[1] * 0.5);
  int a5 = fix16(a[5] + a[3] * 0.5 + a[4] * 0.5);
  for (int y = 0; y < H; y++) {
    int xx = a2, yy = a5;
    uint8_t* o = out + static_cast<size_t>(y) * W * 3;
    for (int x = 0; x < W; x++) {
      int xin = xx >> 16;
      if (xin >= 0 && xin < W) {
        int yin = yy >> 16;
        if (yin >= 0 && yin < H) put(o + 3 * x, in + (static_cast<size_t>(yin) * W + xin) * 3);
      }
      xx += a0;
      yy += a3;
    }
    a2 += a1;
    a5 += a4;
  }
}

void float_affine(const uint8_t* in, int H, int W, uint8_t* out, const double* a) {
  double xo = a[2] + a[1] * 0.5 + a[0] * 0.5;
  double yo = a[5] + a[4] * 0.5 + a[3] * 0.5;
  for (int y = 0; y < H; y++) {
    double xx = xo, yy = yo;
    uint8_t* o = out + static_cast<size_t>(y) * W * 3;
    for (int x = 0; x < W; x++) {
      int xin = coord(xx);
      if (xin >= 0 && xin < W) {
        int yin = coord(yy);
        if (yin >= 0 && yin < H) put(o + 3 * x, in + (static_cast<size_t>(yin) * W + xin) * 3);
      }
      xx += a[0];
      yy += a[3];
    }
    xo += a[1];
    yo += a[4];
  }
}

inline double cubic(double v1, double v2, double v3, double v4, double d) {
  double p1 = v2;
  double p2 = -v1 + v3;
  double p3 = 2 * (v1 - v2) + v3 - v4;
  double p4 = -v1 + v2 - v3 + v4;
  return p1 + d * (p2 + d * (p3 + d * p4));
}

// The generic transform at BILINEAR (2) or BICUBIC (3).
void generic_affine(const uint8_t* in, int H, int W, uint8_t* out, const double* a,
                    int resample) {
  const size_t stride = static_cast<size_t>(W) * 3;
  for (int y = 0; y < H; y++) {
    uint8_t* o = out + y * stride;
    const double yc = y + 0.5;
    for (int x = 0; x < W; x++) {
      const double xc = x + 0.5;
      double xin = a[0] * xc + a[1] * yc + a[2];
      double yin = a[3] * xc + a[4] * yc + a[5];
      if (xin < 0.0 || xin >= W || yin < 0.0 || yin >= H) continue;
      xin -= 0.5;
      yin -= 0.5;
      int sx = floor_int(xin), sy = floor_int(yin);
      double dx = xin - sx, dy = yin - sy;
      uint8_t* px = o + 3 * x;
      if (resample == 2) {
        const int c0 = clamp_index(sx, W) * 3, c1 = clamp_index(sx + 1, W) * 3;
        const uint8_t* r0 = in + clamp_index(sy, H) * stride;
        const bool below = sy + 1 >= 0 && sy + 1 < H;
        const uint8_t* r1 = in + (below ? sy + 1 : 0) * stride;
        for (int b = 0; b < 3; b++) {
          double v1 = r0[c0 + b] + (r0[c1 + b] - r0[c0 + b]) * dx;
          double v2 = v1;
          if (below) v2 = r1[c0 + b] + (r1[c1 + b] - r1[c0 + b]) * dx;
          v1 = v1 + (v2 - v1) * dy;
          px[b] = static_cast<uint8_t>(v1);
        }
      } else {
        sx--;
        sy--;
        int c[4];
        for (int k = 0; k < 4; k++) c[k] = clamp_index(sx + k, W) * 3;
        const uint8_t* rows[4];
        bool inside[4];
        rows[0] = in + clamp_index(sy, H) * stride;
        inside[0] = true;
        for (int k = 1; k < 4; k++) {
          inside[k] = sy + k >= 0 && sy + k < H;
          rows[k] = in + (inside[k] ? sy + k : 0) * stride;
        }
        for (int b = 0; b < 3; b++) {
          double v[4];
          for (int k = 0; k < 4; k++) {
            if (inside[k]) {
              const uint8_t* r = rows[k] + b;
              v[k] = cubic(r[c[0]], r[c[1]], r[c[2]], r[c[3]], dx);
            } else {
              v[k] = v[k - 1];
            }
          }
          double s = cubic(v[0], v[1], v[2], v[3], dy);
          px[b] = s <= 0.0 ? 0 : (s >= 255.0 ? 255 : static_cast<uint8_t>(s));
        }
      }
    }
  }
}

inline float row3(const uint8_t* r, size_t i, float k0, float k1, float k2) {
  return static_cast<float>(r[i - 3]) * k0 + static_cast<float>(r[i]) * k1 +
         static_cast<float>(r[i + 3]) * k2;
}

inline uint8_t clip8f(float v) {
  if (v <= 0.0f) return 0;
  if (v >= 255.0f) return 255;
  return static_cast<uint8_t>(v);
}

void smooth_one(const uint8_t* in, int H, int W, uint8_t* out) {
  const size_t stride = static_cast<size_t>(W) * 3;
  if (H < 3 || W < 3) {
    std::memcpy(out, in, stride * H);
    return;
  }
  const float edge = 1.0f / 13.0f, centre = 5.0f / 13.0f, offset = 0.0f + 0.5f;
  std::memcpy(out, in, stride);
  for (int y = 1; y < H - 1; y++) {
    const uint8_t* up = in + (y - 1) * stride;
    const uint8_t* mid = in + y * stride;
    const uint8_t* down = in + (y + 1) * stride;
    uint8_t* o = out + y * stride;
    put(o, mid);
    for (size_t i = 3; i < stride - 3; i++) {
      float s = offset;
      s += row3(down, i, edge, edge, edge);
      s += row3(mid, i, edge, centre, edge);
      s += row3(up, i, edge, edge, edge);
      o[i] = clip8f(s);
    }
    put(o + stride - 3, mid + stride - 3);
  }
  std::memcpy(out + (H - 1) * stride, in + (H - 1) * stride, stride);
}

}  // namespace

extern "C" {

// Image.transform((W, H), AFFINE, a, resample, fillcolor=fill) of count
// uint8 RGB frames; resample is 0 (NEAREST), 2 (BILINEAR) or 3 (BICUBIC),
// checked by the caller.
void affine_u8(const uint8_t* in, int count, int H, int W, uint8_t* out, const double* a,
               int resample, const uint8_t* fill) {
  const size_t frame = static_cast<size_t>(H) * W * 3;
  const bool scale = resample == 0 && a[1] == 0 && a[3] == 0;
  const bool fixed = resample == 0 && !scale && check_fixed(a, 0, 0) &&
                     check_fixed(a, W, H) && check_fixed(a, 0, H) && check_fixed(a, W, 0);
  std::vector<int> xintab;
  for (int i = 0; i < count; i++) {
    const uint8_t* src = in + frame * i;
    uint8_t* dst = out + frame * i;
    for (size_t p = 0; p < frame; p += 3) put(dst + p, fill);
    if (resample != 0)
      generic_affine(src, H, W, dst, a, resample);
    else if (scale)
      scale_affine(src, H, W, dst, a, xintab);
    else if (fixed)
      fixed_affine(src, H, W, dst, a);
    else
      float_affine(src, H, W, dst, a);
  }
}

// Image.filter(ImageFilter.SMOOTH) of count uint8 RGB frames.
void smooth_u8(const uint8_t* in, int count, int H, int W, uint8_t* out) {
  const size_t frame = static_cast<size_t>(H) * W * 3;
  for (int i = 0; i < count; i++) smooth_one(in + frame * i, H, W, out + frame * i);
}

}  // extern "C"
