// The host degradation engine of the PyTorch port: the C++ counterpart of
// the JAX package's csrc/degrade.cpp, computing the same chain without
// OpenCV (the card's host has none).
//
// One call degrades a batch of GT images through the VSPBFR chain (random
// iso / aniso Gaussian blur -> optional hazy blend -> random bilinear
// downscale -> gaussian noise -> JPEG round-trip -> upscale -> uint8
// quantise; `dataset.py:327-372` upstream) on a pool of std::threads, one
// std::mt19937 stream per seed, with the JAX engine's parameters and draw
// order: kernel, haze, scale, one normal per value, quality. OpenCV's parts
// are written out here:
//
//   - filter2D: direct cross-correlation, centre anchor, REFLECT_101 border
//     (taps below FLT_MIN skipped);
//   - resize INTER_LINEAR: cv2's coordinates (f = (j + 0.5) src / dst - 0.5
//     in double, clamped taps), the rows' two-tap pass then the columns';
//   - convertTo: round half to even and saturate to uint8, and uint8 times
//     float(1 / 255) back;
//   - imencode / imdecode at a quality: libjpeg's integer round-trip
//     (baseline 4:2:0; jccolor, jcsample h2v2, jfdctint, quantisation,
//     jidctint with its range-limit table, jdsample h2v2 fancy, jdcolor),
//     equal bit for bit to `vspbfr_tpu_torch/data/host_jpeg.py`.
//
// Built by `vspbfr_tpu_torch/data/native.py` with g++ -O3 -fPIC -shared
// -std=c++17 -ffp-contract=off -pthread (no -march=native: every x86-64
// host computes the same bits). C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Params {
  int blur_half_lo = 19, blur_half_hi = 20;  // kernel = 2*randint+1
  float sigma_lo = 0.1f, sigma_hi = 10.0f;
  float down_lo = 0.8f, down_hi = 8.0f;
  float noise_lo = 0.0f, noise_hi = 20.0f;   // sigma in /255 units
  float jpeg_lo = 60.0f, jpeg_hi = 100.0f;
  float hazy_prob = 0.008f;
  float hazy_lo = 0.75f, hazy_hi = 0.95f;
};

// An (h, w, 3) float image, row-major, channels interleaved.
struct Image {
  int h = 0, w = 0;
  std::vector<float> v;
  Image() = default;
  Image(int h_, int w_) : h(h_), w(w_), v(static_cast<size_t>(h_) * w_ * 3) {}
};

float uniform(std::mt19937& g, float lo, float hi) {
  return std::uniform_real_distribution<float>(lo, hi)(g);
}

// iso/aniso bivariate gaussian (my_degradations.py:77-99), normalised
std::vector<float> sample_kernel(std::mt19937& g, const Params& p, int* ks_out) {
  int half = std::uniform_int_distribution<int>(p.blur_half_lo, p.blur_half_hi)(g);
  int ks = half * 2 + 1;
  bool iso = std::uniform_int_distribution<int>(0, 1)(g) == 0;
  float sx = uniform(g, p.sigma_lo, p.sigma_hi);
  float sy = uniform(g, p.sigma_lo, p.sigma_hi);
  float th = uniform(g, -static_cast<float>(M_PI), static_cast<float>(M_PI));

  double a, b, c;  // inverse covariance entries [[a, b], [b, c]]
  if (iso) {
    a = c = 1.0 / (static_cast<double>(sx) * sx);
    b = 0.0;
  } else {
    double ct = std::cos(th), st = std::sin(th);
    double ix = 1.0 / (static_cast<double>(sx) * sx);
    double iy = 1.0 / (static_cast<double>(sy) * sy);
    // inv(U D U^T) = U inv(D) U^T
    a = ct * ct * ix + st * st * iy;
    b = ct * st * (ix - iy);
    c = st * st * ix + ct * ct * iy;
  }
  std::vector<float> k(static_cast<size_t>(ks) * ks);
  double sum = 0.0;
  int c0 = ks / 2;
  for (int y = 0; y < ks; ++y) {
    for (int x = 0; x < ks; ++x) {
      double dx = x - c0, dy = y - c0;
      double q = a * dx * dx + 2.0 * b * dx * dy + c * dy * dy;
      double v = std::exp(-0.5 * q);
      k[y * ks + x] = static_cast<float>(v);
      sum += v;
    }
  }
  // cv::Mat /= s scales by 1 / s
  const float inv = static_cast<float>(1.0 / static_cast<float>(sum));
  for (float& v : k) v *= inv;
  *ks_out = ks;
  return k;
}

// OpenCV's borderInterpolate for BORDER_REFLECT_101
int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

constexpr int kChunk = 48;  // outputs a register block of the blur (16 px)

// filter2D(src, -1, k, anchor centre, delta 0, BORDER_REFLECT_101). Each
// output sums its taps in one order on any host; an AVX2 host runs 8 lanes
// a multiply-add where others run 4 (no FMA: -ffp-contract=off)
__attribute__((target_clones("avx2", "default")))
Image blur(const Image& src, const std::vector<float>& k, int ks) {
  const int p = ks / 2, h = src.h, w = src.w;
  const int pw = w + 2 * p, row = pw * 3 + kChunk;  // slack for the last block
  std::vector<float> pad(static_cast<size_t>(h + 2 * p) * row, 0.f);
  for (int y = 0; y < h + 2 * p; ++y) {
    const float* s = src.v.data() + static_cast<size_t>(reflect101(y - p, h)) * w * 3;
    float* d = pad.data() + static_cast<size_t>(y) * row;
    for (int x = 0; x < pw; ++x) {
      const float* px = s + reflect101(x - p, w) * 3;
      d[x * 3] = px[0]; d[x * 3 + 1] = px[1]; d[x * 3 + 2] = px[2];
    }
  }
  Image out(h, w);
  const int n = w * 3;
  for (int y = 0; y < h; ++y) {
    float* o = out.v.data() + static_cast<size_t>(y) * n;
    for (int x0 = 0; x0 < n; x0 += kChunk) {
      float acc[kChunk] = {};
      for (int ky = 0; ky < ks; ++ky) {
        const float* r = pad.data() + static_cast<size_t>(y + ky) * row + x0;
        const float* kr = k.data() + ky * ks;
        for (int kx = 0; kx < ks; ++kx) {
          const float kv = kr[kx];
          // a tap below FLT_MIN (0, or subnormal: the tails of a narrow
          // Gaussian) moves no sum of [0, 1] samples and costs a
          // microcode assist a multiply on x86
          if (kv < FLT_MIN) continue;
          const float* s = r + kx * 3;
          for (int i = 0; i < kChunk; ++i) acc[i] += kv * s[i];
        }
      }
      std::copy(acc, acc + std::min(kChunk, n - x0), o + x0);
    }
  }
  return out;
}

struct Taps {
  std::vector<int> i0, i1;
  std::vector<float> a0, a1;
};

// cv2 INTER_LINEAR taps of one axis: f = (j + 0.5) * src / dst - 0.5
Taps linear_taps(int dst, int src) {
  Taps t;
  t.i0.resize(dst); t.i1.resize(dst); t.a0.resize(dst); t.a1.resize(dst);
  const double scale = 1.0 / (static_cast<double>(dst) / src);
  for (int j = 0; j < dst; ++j) {
    double f = (j + 0.5) * scale - 0.5;
    double fl = std::floor(f);
    int i = static_cast<int>(fl);
    float a = static_cast<float>(f - fl);
    if (i < 0 || i >= src - 1) a = 0.f;
    i = std::min(std::max(i, 0), src - 1);
    t.i0[j] = i;
    t.i1[j] = std::min(i + 1, src - 1);
    t.a0[j] = 1.f - a;
    t.a1[j] = a;
  }
  return t;
}

// resize(src, (w, h), INTER_LINEAR): the rows' pass, then the columns'
Image resize(const Image& src, int w, int h) {
  Taps tx = linear_taps(w, src.w), ty = linear_taps(h, src.h);
  std::vector<float> rows(static_cast<size_t>(src.h) * w * 3);
  for (int y = 0; y < src.h; ++y) {
    const float* s = src.v.data() + static_cast<size_t>(y) * src.w * 3;
    float* d = rows.data() + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < 3; ++c)
        d[x * 3 + c] = s[tx.i0[x] * 3 + c] * tx.a0[x] + s[tx.i1[x] * 3 + c] * tx.a1[x];
  }
  Image out(h, w);
  for (int y = 0; y < h; ++y) {
    const float* r0 = rows.data() + static_cast<size_t>(ty.i0[y]) * w * 3;
    const float* r1 = rows.data() + static_cast<size_t>(ty.i1[y]) * w * 3;
    float* d = out.v.data() + static_cast<size_t>(y) * w * 3;
    for (int i = 0; i < w * 3; ++i) d[i] = r0[i] * ty.a0[y] + r1[i] * ty.a1[y];
  }
  return out;
}

// convertTo(CV_8U, 255): round half to even, saturate
uint8_t to_u8(float v) {
  long r = std::lrint(v * 255.0f);
  return static_cast<uint8_t>(std::min(255L, std::max(0L, r)));
}

// ---------------------------------------------------------------- JPEG ---

constexpr int kScale = 16;
constexpr int32_t kHalf = 1 << (kScale - 1);
constexpr int32_t fix(double x) { return static_cast<int32_t>(x * (1 << kScale) + 0.5); }

constexpr int kConst = 13, kPass1 = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270;
constexpr int32_t F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137;
constexpr int32_t F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// libjpeg's quality scaling of the Annex K tables (baseline: 1..255)
void quality_tables(int quality, int32_t* tl, int32_t* tc) {
  static const int32_t luma[64] = {
      16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
      14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
      18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
      49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
  static const int32_t chroma[64] = {
      17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
      24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
      99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
      99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
  int q = std::min(100, std::max(1, quality));
  int scale = q < 50 ? 5000 / q : 200 - 2 * q;
  for (int i = 0; i < 64; ++i) {
    tl[i] = std::min(255, std::max(1, (luma[i] * scale + 50) / 100));
    tc[i] = std::min(255, std::max(1, (chroma[i] * scale + 50) / 100));
  }
}

// jpeg_fdct_islow, in place on d[row * 8 + col]
void fdct(int64_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    const int n = pass == 0 ? kConst - kPass1 : kConst + kPass1;
    for (int line = 0; line < 8; ++line) {
      int64_t* v = d + line * stride;
      int64_t tmp0 = v[0] + v[7 * step], tmp7 = v[0] - v[7 * step];
      int64_t tmp1 = v[step] + v[6 * step], tmp6 = v[step] - v[6 * step];
      int64_t tmp2 = v[2 * step] + v[5 * step], tmp5 = v[2 * step] - v[5 * step];
      int64_t tmp3 = v[3 * step] + v[4 * step], tmp4 = v[3 * step] - v[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        v[0] = (tmp10 + tmp11) * (1 << kPass1);
        v[4 * step] = (tmp10 - tmp11) * (1 << kPass1);
      } else {
        v[0] = descale(tmp10 + tmp11, kPass1);
        v[4 * step] = descale(tmp10 - tmp11, kPass1);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      v[2 * step] = descale(z1 + tmp13 * F0765, n);
      v[6 * step] = descale(z1 - tmp12 * F1847, n);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298; tmp5 *= F2053; tmp6 *= F3072; tmp7 *= F1501;
      z1 *= -F0899; z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      v[7 * step] = descale(tmp4 + z1 + z3, n);
      v[5 * step] = descale(tmp5 + z2 + z4, n);
      v[3 * step] = descale(tmp6 + z2 + z3, n);
      v[step] = descale(tmp7 + z1 + z4, n);
    }
  }
}

// one pass of jpeg_idct_islow over in[k * step] -> out[k * step]
void idct_line(const int64_t* in, int64_t* out, int step, int n) {
  int64_t z1 = (in[2 * step] + in[6 * step]) * F0541;
  int64_t tmp2 = z1 - in[6 * step] * F1847;
  int64_t tmp3 = z1 + in[2 * step] * F0765;
  int64_t tmp0 = (in[0] + in[4 * step]) * (int64_t(1) << kConst);
  int64_t tmp1 = (in[0] - in[4 * step]) * (int64_t(1) << kConst);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = in[7 * step], t1 = in[5 * step], t2 = in[3 * step], t3 = in[step];
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * F1175;
  t0 *= F0298; t1 *= F2053; t2 *= F3072; t3 *= F1501;
  z1 *= -F0899; z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  t0 += z1 + z3; t1 += z2 + z4; t2 += z2 + z3; t3 += z1 + z4;
  out[0] = descale(tmp10 + t3, n);
  out[7 * step] = descale(tmp10 - t3, n);
  out[step] = descale(tmp11 + t2, n);
  out[6 * step] = descale(tmp11 - t2, n);
  out[2 * step] = descale(tmp12 + t1, n);
  out[5 * step] = descale(tmp12 - t1, n);
  out[3 * step] = descale(tmp13 + t0, n);
  out[4 * step] = descale(tmp13 - t0, n);
}

// libjpeg's post-IDCT range limit, indexed by (v & 1023)
uint8_t idct_limit(int64_t v) {
  int x = static_cast<int>(v & 1023);
  if (x < 128) return static_cast<uint8_t>(x + 128);
  if (x < 512) return 255;
  if (x < 896) return 0;
  return static_cast<uint8_t>(x - 896);
}

// FDCT, quantise, dequantise, IDCT of every 8x8 block of a (ph, pw) plane
// of whole blocks, in place (samples 0..255)
void roundtrip_plane(std::vector<int32_t>& p, int ph, int pw, const int32_t* tbl) {
  int64_t blk[64], ws[64], out[64];
  for (int by = 0; by < ph; by += 8) {
    for (int bx = 0; bx < pw; bx += 8) {
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          blk[r * 8 + c] = p[static_cast<size_t>(by + r) * pw + bx + c] - 128;
      fdct(blk);
      for (int i = 0; i < 64; ++i) {
        int64_t q8 = static_cast<int64_t>(tbl[i]) * 8, t = blk[i];
        int64_t m = ((t < 0 ? -t : t) + (q8 >> 1)) / q8;
        blk[i] = (t < 0 ? -m : m) * tbl[i];
      }
      for (int c = 0; c < 8; ++c) idct_line(blk + c, ws + c, 8, kConst - kPass1);
      for (int r = 0; r < 8; ++r) idct_line(ws + r * 8, out + r * 8, 1, kConst + kPass1 + 3);
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          p[static_cast<size_t>(by + r) * pw + bx + c] = idct_limit(out[r * 8 + c]);
    }
  }
}

// h2v2 upsampling of the real (ceil(h/2), ceil(w/2)) part of a chroma
// plane of row length pw to (h, w): fancy, or box when at most 2 wide
std::vector<int32_t> upsample(const std::vector<int32_t>& c, int pw, int h, int w) {
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  std::vector<int32_t> out(static_cast<size_t>(h) * w);
  auto at = [&](int y, int x) { return c[static_cast<size_t>(y) * pw + x]; };
  std::vector<int32_t> col(cw);
  for (int y = 0; y < h; ++y) {
    int near = y / 2;
    if (cw <= 2) {
      for (int x = 0; x < w; ++x) out[static_cast<size_t>(y) * w + x] = at(near, x / 2);
      continue;
    }
    int far = std::min(std::max(y % 2 == 0 ? near - 1 : near + 1, 0), ch - 1);
    for (int j = 0; j < cw; ++j) col[j] = 3 * at(near, j) + at(far, j);
    for (int x = 0; x < w; ++x) {
      int j = x / 2, odd = x % 2;
      int side = std::min(std::max(odd ? j + 1 : j - 1, 0), cw - 1);
      out[static_cast<size_t>(y) * w + x] = (3 * col[j] + col[side] + 8 - odd) >> 4;
    }
  }
  return out;
}

// cv2.imdecode(cv2.imencode(".jpg", img, [QUALITY, quality])) of an (h, w, 3)
// uint8 image, channel 0 blue (host_jpeg.py, step for step)
void jpeg_roundtrip(const uint8_t* img, uint8_t* dst, int h, int w, int quality) {
  int32_t tl[64], tc[64];
  quality_tables(quality, tl, tc);
  const int yh = 8 * ((h + 7) / 8), yw = 8 * ((w + 7) / 8);
  const int ch = (h + 1) / 2, cph = 8 * ((h + 15) / 16), cpw = 8 * ((w + 15) / 16);
  std::vector<int32_t> yf(static_cast<size_t>(h) * w), cbf(yf.size()), crf(yf.size());
  const int32_t off = (128 << kScale) + kHalf - 1;
  for (size_t i = 0; i < yf.size(); ++i) {
    int32_t b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
    yf[i] = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + kHalf) >> kScale;
    cbf[i] = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off) >> kScale;
    crf[i] = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off) >> kScale;
  }
  std::vector<int32_t> yp(static_cast<size_t>(yh) * yw);
  for (int y = 0; y < yh; ++y)
    for (int x = 0; x < yw; ++x)
      yp[static_cast<size_t>(y) * yw + x] = yf[static_cast<size_t>(std::min(y, h - 1)) * w + std::min(x, w - 1)];
  roundtrip_plane(yp, yh, yw, tl);
  std::vector<int32_t> chroma[2];
  const std::vector<int32_t>* full[2] = {&cbf, &crf};
  for (int k = 0; k < 2; ++k) {
    std::vector<int32_t> d(static_cast<size_t>(cph) * cpw);
    const std::vector<int32_t>& f = *full[k];
    for (int cy = 0; cy < cph; ++cy) {
      int yy = std::min(cy, ch - 1);
      int r0 = std::min(2 * yy, h - 1), r1 = std::min(2 * yy + 1, h - 1);
      for (int cx = 0; cx < cpw; ++cx) {
        int c0 = std::min(2 * cx, w - 1), c1 = std::min(2 * cx + 1, w - 1);
        int32_t s = f[static_cast<size_t>(r0) * w + c0] + f[static_cast<size_t>(r0) * w + c1] +
                    f[static_cast<size_t>(r1) * w + c0] + f[static_cast<size_t>(r1) * w + c1];
        d[static_cast<size_t>(cy) * cpw + cx] = (s + 1 + (cx & 1)) >> 2;
      }
    }
    roundtrip_plane(d, cph, cpw, tc);
    chroma[k] = upsample(d, cpw, h, w);
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      size_t i = static_cast<size_t>(y) * w + x;
      int32_t yv = yp[static_cast<size_t>(y) * yw + x];
      int32_t cb = chroma[0][i] - 128, cr = chroma[1][i] - 128;
      int32_t b = yv + ((fix(1.772) * cb + kHalf) >> kScale);
      int32_t g = yv + ((-fix(0.34414) * cb + kHalf - fix(0.71414) * cr) >> kScale);
      int32_t r = yv + ((fix(1.402) * cr + kHalf) >> kScale);
      dst[3 * i] = static_cast<uint8_t>(std::min(255, std::max(0, b)));
      dst[3 * i + 1] = static_cast<uint8_t>(std::min(255, std::max(0, g)));
      dst[3 * i + 2] = static_cast<uint8_t>(std::min(255, std::max(0, r)));
    }
  }
}

// ---------------------------------------------------------------- chain ---

void degrade_one(const float* gt, float* out, int h, int w, uint64_t seed,
                 const Params& p) {
  std::mt19937 g(static_cast<uint32_t>(seed ^ (seed >> 32)));
  Image src(h, w);
  std::copy(gt, gt + src.v.size(), src.v.begin());

  // 1. blur
  int ks = 0;
  std::vector<float> k = sample_kernel(g, p, &ks);
  Image lq = blur(src, k, ks);

  // 2. hazy blend
  if (uniform(g, 0.f, 1.f) < p.hazy_prob) {
    float alpha = uniform(g, p.hazy_lo, p.hazy_hi);
    for (float& v : lq.v) v = v * alpha + (1.0f - alpha);
  }

  // 3. random downscale
  float scale = uniform(g, p.down_lo, p.down_hi);
  int dw = std::max(1, static_cast<int>(w / scale));
  int dh = std::max(1, static_cast<int>(h / scale));
  lq = resize(lq, dw, dh);

  // 4. gaussian noise (sigma in /255 units), clipped to [0,1]
  float sigma = uniform(g, p.noise_lo, p.noise_hi) / 255.0f;
  std::normal_distribution<float> nd(0.f, 1.f);
  for (float& v : lq.v) v = std::min(1.0f, std::max(0.0f, v + sigma * nd(g)));

  // 5. JPEG round-trip
  int quality = static_cast<int>(uniform(g, p.jpeg_lo, p.jpeg_hi));
  std::vector<uint8_t> u8(lq.v.size()), dec(lq.v.size());
  for (size_t i = 0; i < u8.size(); ++i) u8[i] = to_u8(lq.v[i]);
  jpeg_roundtrip(u8.data(), dec.data(), dh, dw, quality);
  const float inv = static_cast<float>(1.0 / 255.0);
  for (size_t i = 0; i < dec.size(); ++i) lq.v[i] = dec[i] * inv;

  // 6. resize back + uint8 quantise
  lq = resize(lq, w, h);
  for (size_t i = 0; i < lq.v.size(); ++i) out[i] = to_u8(lq.v[i]) * inv;
}

}  // namespace

extern "C" {

// gt/out: (n, h, w, 3) float32, [0, 1]. seeds: (n,) uint64.
// Returns 0 on success.
int vspbfr_degrade_batch(const float* gt, float* out, int n, int h, int w,
                         const uint64_t* seeds, int n_threads) {
  Params p;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      degrade_one(gt + static_cast<size_t>(i) * h * w * 3,
                  out + static_cast<size_t>(i) * h * w * 3, h, w, seeds[i], p);
    }
  };
  int t = std::min(n_threads, n);
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return 0;
}

// (h, w, 3) uint8 -> its JPEG round-trip at `quality`. Returns 0.
int vspbfr_jpeg_roundtrip(const uint8_t* img, uint8_t* out, int h, int w,
                          int quality) {
  jpeg_roundtrip(img, out, h, w, quality);
  return 0;
}

int vspbfr_degrade_abi_version() { return 2; }

}  // extern "C"
